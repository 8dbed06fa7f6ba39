"""Nothing a run imports has a top-level name of jax, jaxlib, flax, the JAX
package (genefuserust_tpu), bench or tools, compared whole (so
genefuserust_tpu_torch passes), and the reference imports nothing of the
program."""

import ast
import os
import subprocess
import sys

from gfbench import registry
from gfbench.run import FORBIDDEN

HERE = registry.HERE


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_a_forbidden_name():
    for path in _sources():
        bad = set(_imports(path)) & set(FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = set(_imports(path))
        assert "genefuserust_tpu_torch" not in names and "torch" not in names, path


_RUN = """
import sys, time
from gfbench.cell import run_cell
from gfbench.run import forbidden_modules
sizes = {"config": {"genes": 30, "panel_bp": 360000, "batch_pairs": 1024},
         "traffic": {"pairs_per_sample": 2048, "chimera": 0.01}}
out = run_cell("cancer15-pe-targeted", 5, 0.1, True, time.perf_counter(), device="cpu",
               sizes=sizes, say=lambda o: None)
assert out["correct"], out
print(sorted({m.split(".")[0] for m in sys.modules}))
print(forbidden_modules())
"""


def test_a_run_loads_no_forbidden_module():
    r = subprocess.run([sys.executable, "-c", _RUN], cwd=registry.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    top, bad = r.stdout.strip().splitlines()[-2:]
    assert bad == "[]", top
    assert not set(eval(top)) & set(FORBIDDEN)
    assert "genefuserust_tpu_torch" in eval(top)


def test_the_reference_alone_loads_nothing_of_the_program():
    code = ("import sys, gfbench.reference, gfbench.checks, gfbench.control; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    top = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "genefuserust_tpu_torch" not in top and not top & set(FORBIDDEN)
