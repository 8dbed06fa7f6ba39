"""The port stands alone: no module of genefuserust_tpu_torch, and not
chip_smoke.py, imports jax, the JAX package, bench.py or the JAX package's
tools/ (the port keeps its own copies of what it needs from them); and the port's
copy of the read generator gives bench.gen_block's pairs."""

import ast
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "genefuserust_tpu_torch"


def _port_files():
    out = ["chip_smoke.py"]
    for root, dirs, files in os.walk(os.path.join(REPO, PORT)):
        dirs[:] = sorted(d for d in dirs if d not in ("build", "__pycache__"))
        out += sorted(os.path.relpath(os.path.join(root, f), REPO)
                      for f in files if f.endswith(".py"))
    return out


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "bench", "genefuserust_tpu", "tools")


def forbidden_imports(source: str, relpath: str):
    """-> [(line, module)] for each import in `source` (the file at
    `relpath` from the repo root) of jax, bench or the JAX package: import
    statements at any depth, relative imports resolved against the file's
    package, and importlib.import_module / __import__ of a literal name."""
    parent = os.path.dirname(relpath)
    package = parent.split(os.sep) if parent else []
    bad = []
    for node in ast.walk(ast.parse(source)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[: len(package) - node.level + 1]
                # a relative import that leaves the port reaches the repo root
                names = [".".join(base + [node.module or ""]) if base[:1] == [PORT]
                         else "genefuserust_tpu"]
            else:
                names = [node.module]
        elif isinstance(node, ast.Call):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if (fname in ("import_module", "__import__") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                names = [node.args[0].value]
        bad += [(node.lineno, n) for n in names if _forbidden(n)]
    return bad


@pytest.mark.parametrize("relpath", _port_files())
def test_port_file_imports_nothing_of_jax_or_the_reference(relpath):
    with open(os.path.join(REPO, relpath)) as f:
        assert forbidden_imports(f.read(), relpath) == []


def test_scan_covers_every_module_of_the_port():
    """The walk reaches the modules of each slice, the sharded index's, the
    multi-process helpers and the entry point included."""
    files = set(_port_files())
    for rel in ("parallel/mesh.py", "parallel/sharded_index.py", "parallel/sharded_engine.py",
                "parallel/engine.py", "parallel/distributed.py", "ops/map_read.py", "ops/cuda.py",
                "entry.py", "driver.py", "profiling/scale_proof.py",
                "profiling/large_tables.py"):
        assert os.path.join(PORT, rel) in files, rel


PLANTED = {
    "import_jax": ("import jax\n", f"{PORT}/ops/x.py"),
    "jax_numpy_in_function": ("def f():\n    import jax.numpy as jnp\n", f"{PORT}/x.py"),
    "from_reference": ("from genefuserust_tpu import native\n", f"{PORT}/x.py"),
    "reference_submodule": ("import genefuserust_tpu.core.scanner\n", "chip_smoke.py"),
    "from_reference_submodule": ("from genefuserust_tpu.config import KMER\n", "chip_smoke.py"),
    "bench": ("import bench\n", "chip_smoke.py"),
    "from_bench": ("from bench import gen_block\n", "chip_smoke.py"),
    "relative_out_of_the_port": ("from ..genefuserust_tpu import config\n", f"{PORT}/x.py"),
    "import_module": ("import importlib\nimportlib.import_module('jax')\n", f"{PORT}/x.py"),
    "jax_tools": ("from tools.scale_proof import gen_genome\n",
                  f"{PORT}/profiling/x.py"),
}


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_planted_import_is_caught(case):
    source, relpath = PLANTED[case]
    assert len(forbidden_imports(source, relpath)) == 1


def test_port_imports_are_allowed():
    source = ("from genefuserust_tpu_torch.ops import cuda\n"
              "from ..config import KMER\nfrom . import native\nimport torch\n")
    assert forbidden_imports(source, f"{PORT}/ops/x.py") == []


@pytest.mark.parametrize("seed", [1, 7])
def test_gen_block_matches_bench(tmp_path, seed):
    """The port's read generator gives bench.gen_block(profile="real")'s
    pairs for the same panel and seed."""
    import bench
    from genefuserust_tpu.config import Settings
    from genefuserust_tpu.core.mapper import FusionMapper
    from genefuserust_tpu.utils.synthetic import make_panel, write_panel_files
    from genefuserust_tpu_torch.config import Settings as PortSettings
    from genefuserust_tpu_torch.core.mapper import FusionMapper as PortMapper
    from genefuserust_tpu_torch.utils.synthetic import gen_block

    panel = make_panel()
    _, csv = write_panel_files(panel, str(tmp_path))
    exp = bench.gen_block(FusionMapper(panel.contigs, csv, Settings()), 600, 150,
                          seed=seed, profile="real")
    got = gen_block(PortMapper(panel.contigs, csv, PortSettings()), 600, 150, seed=seed)
    for side in ("left", "right"):
        g, e = getattr(got, side), getattr(exp, side)
        for field in ("seq", "qual", "lens"):
            a, b = getattr(g, field), getattr(e, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), (side, field)
        r, q = g.read_obj(5), e.read_obj(5)
        assert (r.name, r.seq, r.strand, r.quality) == (q.name, q.seq, q.strand, q.quality)
    assert len(got) == len(exp) == 600
