"""The port's CLI and driver accept `--engine tpu`, the JAX reference's
default engine name, as a second name of `--engine cuda`: the same
`TorchEngine`, and reports byte-equal to `--engine cuda`'s (timestamps
stripped), here with `--device cpu`."""

import re

import pytest

from genefuserust_tpu.utils.synthetic import (
    make_panel,
    plant_fusion_pairs,
    write_fastq_files,
    write_panel_files,
)
from genefuserust_tpu_torch import cli
from genefuserust_tpu_torch.config import Settings
from genefuserust_tpu_torch.driver import RunConfig, make_engine
from genefuserust_tpu_torch.parallel.engine import TorchEngine

_TS = re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d+ \+00:00")


def test_parser_takes_tpu_and_keeps_cuda_the_default():
    p = cli.build_parser()
    base = ["-1", "r1.fq", "-f", "p.csv", "-r", "ref.fa"]
    assert p.parse_args(base).engine == "cuda"
    assert p.parse_args([*base, "--engine", "tpu"]).engine == "tpu"
    with pytest.raises(SystemExit):
        p.parse_args([*base, "--engine", "gpu"])


def test_make_engine_tpu_is_the_cuda_engine():
    config = RunConfig("r1.fq", "", "p.csv", "o.html", "o.json", "ref.fa", engine="tpu",
                       device="cpu", mesh="1")
    engines = [make_engine(kind, config.settings, config.device, config.mesh, config.thread_num)
               for kind in ("cuda", config.engine)]
    for eng in engines:
        assert type(eng) is TorchEngine
        assert [str(d) for d in eng.devices] == ["cpu"]
    assert engines[0].pipeline_depth == engines[1].pipeline_depth
    with pytest.raises(ValueError):
        make_engine("gpu", Settings(), device="cpu")


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    panel = make_panel(seed=21)
    pairs = plant_fusion_pairs(panel, n_support=6, n_background=50, seed=4)
    ref, csv = write_panel_files(panel, str(tmp))
    r1, r2 = write_fastq_files(pairs, str(tmp))
    return tmp, ref, csv, r1, r2


@pytest.mark.parametrize("paired", [True, False])
def test_engine_tpu_reports_equal_engine_cuda(cli_files, paired):
    tmp, ref, csv, r1, r2 = cli_files
    reads = ["-1", r1] + (["-2", r2] if paired else [])
    out = {}
    for engine in ("cuda", "tpu"):
        h, j = str(tmp / f"{engine}{paired}.html"), str(tmp / f"{engine}{paired}.json")
        assert cli.main([*reads, "-f", csv, "-r", ref, "-h", h, "-j", j, "--engine", engine,
                         "--device", "cpu"]) == 0
        out[engine] = tuple(_TS.sub("<ts>", open(f).read()) for f in (h, j))
    assert out["tpu"] == out["cuda"]
    assert '"fusions"' in out["tpu"][1] and "<html" in out["tpu"][0].lower()
