"""The import check: nothing the benchmark loads is JAX or the JAX
package, compared by whole top-level names."""
import ast
import os
import subprocess
import sys

from portbench import catalog

FORBIDDEN = {"jax", "jaxlib", "flax", "hifimeth_tpu"}


def test_sources_import_no_jax():
    for d, _, files in os.walk(catalog.ROOT):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                else:
                    continue
                for n in names:
                    assert n.split(".")[0] not in FORBIDDEN, (f, n)


def test_a_run_loads_no_jax(tmp_path):
    """A small run of a cell on the CPU, in a fresh process, leaves no
    module of jax, jaxlib, flax or hifimeth_tpu in sys.modules."""
    code = f"""
import sys, time
sys.path.insert(0, {catalog.REPO!r})
from portbench import catalog, harness
cell = harness.Cell(catalog.load_benchmark(), "3ctx-plant-hifi")
tr = dict(cell.traffic, n_reads=2, length={{"median": 1200, "sigma": 0.1,
                                           "min": 1000, "max": 1500}})
r, _ = harness.run_cell(cell, 5, 60.0, False, time.perf_counter(),
                        device="cpu", overrides={{"site_batch": 256}},
                        traffic=tr, limit=2, log=lambda s: None)
assert r["correct"], r
assert "hifimeth_tpu_torch" in sys.modules
print("FORBIDDEN", harness.forbidden_modules())
"""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stdout
