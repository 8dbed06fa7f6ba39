"""One run of one cell: set-up, the measured window, the check.

Set-up makes the panel's FASTA and CSVs from the seed, makes every panel
ready as the CLI does (the FASTA read, a FusionMapper a CSV, the default
table packed and uploaded), makes the sample's pairs from the seed and
drives the sample's first WARM_BATCHES batches through every step to warm
them. The window then drives
whole samples back to back through the one warm engine: for each,
`scan_pair_block_multi` over the sample's matrices (batches of the
engine's size, no copy), `flush`, and `finish_scan` a panel, which writes
its HTML and JSON reports into the run's directory and frees the matches.
A sample that starts before `seconds` have passed is finished. After the
window the program's outputs are held to the reference (checks.py).

Without `trace`, the result holds the cell's end-to-end metrics; where one
of them is read from the device's trace, the whole window runs under
torch.profiler, tracing the device alone. With `trace`, the engine's stage
timers are on (GENEFUSE_STAGE_TIMERS) and the window's second sample runs
under torch.profiler; the result then holds the per-layer metrics in
place of the end-to-end ones.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import subprocess
import tempfile
import time
from typing import Callable, Dict, Optional

from . import checks, panel as panels, probe_work, registry, trace as tracing, traffic

PROFILED_SAMPLE = 1  # the window's second sample: the first after a whole one
WARM_BATCHES = 4


class Spans:
    """The benchmark's own spans: host intervals by name (perf_counter
    seconds), also marked for torch.profiler while `marked`."""

    def __init__(self):
        self.intervals: Dict[str, list] = {}
        self.marked = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.marked:
            import torch

            rf = torch.profiler.record_function(f"gf.{name}")
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.intervals.setdefault(name, []).append((t0, time.perf_counter()))


class Record:
    """What a run measured, for the per-layer readers (gfbench/metrics)."""

    def __init__(self, spans: Spans, timers: dict, window_s: float, samples: int, pairs: int,
                 ed_jobs: int, profile: Optional[dict], probe_bound: Callable[[], dict]):
        self.spans = spans.intervals
        self.timers = timers
        self.window_s = window_s
        self.samples = samples
        self.pairs = pairs
        self.ed_jobs = ed_jobs
        self.profile = profile
        self._probe_bound = probe_bound
        self._probe = None

    def span_total(self, name: str) -> Optional[float]:
        iv = self.spans.get(name)
        return sum(t - s for s, t in iv) if iv else None

    def timer(self, label: str):
        return self.timers.get(label, (0.0, 0))

    def probe_bound(self) -> dict:
        if self._probe is None:
            self._probe = self._probe_bound()
        return self._probe

    def probe_counted(self) -> bool:
        return self._probe is not None


def _timers(engine) -> dict:
    return {k: (v[0], v[1]) for k, v in (engine._timers or {}).items()}


def _card(torch) -> dict:
    """The card's name, power limit and the software beside every number."""
    out = dict(torch=torch.__version__, cuda=torch.version.cuda, host_cores=os.cpu_count())
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        out["nvidia_smi"] = r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"unavailable: {e}"
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", sizes: Optional[dict] = None, say=print) -> dict:
    """Run cell `name` once -> the result line's object. `sizes` overrides
    configuration and traffic keys ({"config": {...}, "traffic": {...}}),
    for the tests' small runs on the CPU. `say` prints provenance."""
    import torch

    from genefuserust_tpu_torch.config import Settings
    from genefuserust_tpu_torch.core.mapper import FusionMapper
    from genefuserust_tpu_torch.core.read import SequenceRead
    from genefuserust_tpu_torch.core.scanner import finish_scan
    from genefuserust_tpu_torch.io import fasta
    from genefuserust_tpu_torch.ops import cuda as kernels
    from genefuserust_tpu_torch.ops.index import build_packed_index, layout_name
    from genefuserust_tpu_torch.parallel.engine import TorchEngine

    from .reference import Reference, Settings as RefSettings

    wl = registry.workload(name)
    cfg = {**registry.config(wl["config"]), **(sizes or {}).get("config", {})}
    mix = {**registry.traffic(wl["traffic"]), **(sizes or {}).get("traffic", {})}
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    settings = Settings(**cfg["settings"])
    spans = Spans()
    rundir = tempfile.mkdtemp(prefix="gfbench-")
    try:
        p = panels.make_panel(cfg, seed, rundir)

        # the panel made ready, as a CLI job does before its first pair
        t0 = time.perf_counter()
        contigs = fasta.read_all(p.fasta, force_upper_case=False)
        mappers = []
        for csv in p.csvs:
            with spans("index_build"):
                mappers.append(FusionMapper(contigs, csv, settings,
                                            multi_csv_mode=len(p.csvs) > 1))
        timers_env = os.environ.pop("GENEFUSE_STAGE_TIMERS", None)
        if trace:
            os.environ["GENEFUSE_STAGE_TIMERS"] = "1"
        try:
            engine = TorchEngine(settings, batch_size=cfg["batch_pairs"], device=device,
                                 pipeline_depth=cfg["pipeline_depth"])
        finally:
            os.environ.pop("GENEFUSE_STAGE_TIMERS", None)
            if timers_env is not None:
                os.environ["GENEFUSE_STAGE_TIMERS"] = timers_env
        layouts = []
        for m in mappers:
            with spans("table_pack"):
                packed = build_packed_index(m.indexer)
                engine.use_packed(packed, mapper=m)
                sync()
            layouts.append(layout_name(packed))
        del packed
        panel_ready_s = time.perf_counter() - t0

        pool = traffic.generate(mix, p.genes, p.exon_starts, p.gene_start, seed,
                                read_cls=SequenceRead)
        names = ["sample"] if len(p.csvs) == 1 else [f"sample_{os.path.basename(c)[:-4]}"
                                                     for c in p.csvs]
        html = [os.path.join(rundir, n + ".html") for n in names]
        js = [os.path.join(rundir, n + ".json") for n in names]
        command = f"gfbench {name}"

        def sample(block=pool) -> dict:
            for m in mappers:
                m.fusion_results = []  # cluster_matches appends to it
            with spans("sample"):
                t_s = time.perf_counter()
                with spans("scan"):
                    engine.scan_pair_block_multi(mappers, block)
                with spans("flush"):
                    engine.flush()
                got = checks.program_outcome(mappers)
                t_f = time.perf_counter()
                for i, m in enumerate(mappers):
                    with spans("finish_scan"):
                        finish_scan(m, html[i], js[i], command, settings)
                t_e = time.perf_counter()
            reports = []
            for h, j in zip(html, js):
                with open(j) as f:
                    reports.append(checks.report_block(f.read()))
                os.remove(h)
                os.remove(j)
            return dict(start=t_s, end=t_e, finish=t_e - t_f, outcome=got, reports=reports,
                        cpu=time.process_time())

        with open(os.devnull, "w") as devnull, contextlib.redirect_stdout(devnull):
            # warm-up: every path of a sample, over its first WARM_BATCHES batches
            sample(pool.head(min(len(pool), WARM_BATCHES * cfg["batch_pairs"])))
            sync()
            spans.intervals.pop("finish_scan", None)
            done, prof, wprof = [], None, None
            trace_window = not trace and on_card and any(
                m["source"] == "device_trace" for m in registry.metrics_of(name, "end_to_end"))
            with contextlib.ExitStack() as stack:
                if trace_window:
                    from torch.profiler import ProfilerActivity, profile

                    wprof = stack.enter_context(profile(activities=[ProfilerActivity.CUDA]))
                timers0, jobs0 = _timers(engine), engine.ed_stats["jobs"]
                cpu0 = time.process_time()
                t_w0 = time.perf_counter()
                setup_s = t_w0 - t_start
                while True:
                    if trace and len(done) == PROFILED_SAMPLE:
                        from torch.profiler import ProfilerActivity, profile

                        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
                        spans.marked = True
                        with profile(activities=acts) as prof:
                            done.append(sample())
                            sync()
                        spans.marked = False
                    else:
                        done.append(sample())
                    if time.perf_counter() - t_w0 >= seconds and (
                            not trace or len(done) > PROFILED_SAMPLE):
                        break
                sync()
                cpu_s = time.process_time() - cpu0  # every thread's, over the window
        window_s = done[-1]["end"] - done[0]["start"]
        n_pairs = len(done) * len(pool)
        busy_s = tracing.device_busy(wprof) if wprof is not None else None
        timers1 = _timers(engine)
        timers = {k: (v[0] - timers0.get(k, (0.0, 0))[0], v[1] - timers0.get(k, (0.0, 0))[1])
                  for k, v in timers1.items()}
        ed_jobs = engine.ed_stats["jobs"] - jobs0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        profile = tracing.from_profiler(prof, "gf.sample") if prof is not None else None
        del engine, mappers, contigs, prof, wprof
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        say(dict(provenance=dict(
            cell=name, seed=seed, device=torch.cuda.get_device_name() if on_card else "cpu",
            **_card(torch), table_layouts=sorted(set(layouts)),
            producer_workers=os.environ.get("GENEFUSE_PRODUCER_WORKERS", "1"),
            launches=launches, memory_peak_bytes=peak, panel_ready_s=panel_ready_s,
            samples=len(done),
            sample_s=[round(d["end"] - d["start"], 4) for d in done],
            scan_s=[round(t - s, 4) for s, t in spans.intervals["scan"][1:]],
            finish_s=[round(d["finish"], 4) for d in done],
            cpu_s=round(cpu_s, 4),
            sample_cpu_s=[round(b["cpu"] - a["cpu"], 4) for a, b in zip(
                [dict(cpu=cpu0)] + done[:-1], done)],
            window_busy_s=busy_s,
            torch_threads=torch.get_num_threads(),
            baseline="72.8k pairs/s (BASELINE.md row 5, a CPU bar whose caveat makes it "
                     "provenance only; not a metric)")))

        # the reference, once the window has closed and the program is freed
        t_ref = time.perf_counter()
        program_pairs = set().union(*(d["outcome"] for d in done))
        pairs = checks.check_set(pool, seed, program_pairs)
        ref = Reference(p.fasta, p.csvs, RefSettings(**cfg["settings"]))
        ref_pairs, ref_reports = checks.reference_outcome(ref, pool, pairs)
        numbers = checks.compare([(d["outcome"], d["reports"]) for d in done], ref_pairs,
                                 ref_reports, pairs)
        say(dict(check=dict(pairs_checked=len(pairs), samples=len(done),
                            reference_matches=sum(len(v) for v in ref_pairs.values()),
                            reference_fusions=sum(r.count('\n\t\t"') for r in ref_reports),
                            reference_s=round(time.perf_counter() - t_ref, 3))))
        v = checks.verdict(numbers)

        rec = Record(spans, timers, window_s, len(done), n_pairs, ed_jobs, profile,
                     lambda: probe_work.probe_bound(pool.left.seq, pool.left.qual,
                                                    pool.right.seq, pool.right.qual,
                                                    len(p.csvs)))
        if trace:
            metrics = {}
            for m in registry.metrics_of(name, "per_layer"):
                val = registry.reader(m["name"]).read(rec)
                if val is not None:
                    metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        else:
            mpairs = n_pairs / 1e6
            e2e = dict(pairs_per_s=n_pairs / window_s, setup_s=setup_s,
                       device_ms_per_mpair=busy_s * 1e3 / mpairs if busy_s else None)
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in registry.metrics_of(name, "end_to_end")
                       if e2e[m["name"]] is not None}
        dev = dict(platform="gpu" if on_card else "cpu",
                   kind=torch.cuda.get_device_name() if on_card else "cpu", count=1,
                   memory_peak_bytes=peak)
        out = dict(correct=v["correct"], attempted=n_pairs,
                   failed=numbers["pairs_differing"],
                   metrics=metrics, device=dev)
        if trace and profile:
            dev.update(busy_s=profile["busy_s"], window_s=profile["window_s"])
            top = sorted(profile["by_symbol"].items(), key=lambda kv: -kv[1])[:10]
            idle = sorted(profile["idle"].items(), key=lambda kv: -kv[1])[:10]
            out["breakdown"] = dict(device_ops=[[k, s] for k, s in top],
                                    idle_gaps=[[k, s] for k, s in idle])
            if rec.probe_counted():
                say(dict(probe_bound={k: rec.probe_bound()[k] for k in
                                      ("rows", "bases", "kmers", "merged", "panels", "bytes",
                                       "bound_ms")}))
        out["checks"] = v["checks"]
        return out
    finally:
        shutil.rmtree(rundir, ignore_errors=True)
