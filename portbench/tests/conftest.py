"""Tests of the port's benchmark.  CPU tests run anywhere at small sizes;
tests marked `chip` need a CUDA card and skip without one (the card is
looked for inside the test, through the `cuda` fixture).  On the card:
    python3 -m pytest portbench/tests -q -m chip
"""
import json
import os
import shutil
import sys
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def cpu_call():
    """CallConfig fields that keep CPU runs short (the engine pads every
    batch to site_batch)."""
    return {"site_batch": 256}


@pytest.fixture
def shrink():
    """A traffic dict cut to a small pool of its own kind."""
    def f(traffic: dict, n_reads: int = 4, **kw) -> dict:
        t = dict(traffic)
        t.update(n_reads=n_reads, length={"median": 1500, "sigma": 0.3,
                                          "min": 1000, "max": 3000})
        t.update(kw)
        return t
    return f


#: the fused route's configuration and cell, which a later change adds:
#: the nets of hifimeth-3ctx through `call --gather-impl fused`
FUSED_CONFIG = "hifimeth-3ctx-fused"
FUSED_CELL = "3ctx-plant-hifi-fused"


@pytest.fixture
def fused_copy(tmp_path):
    """A copy of portbench/ and BENCHMARK.json to which the fused route's
    configuration and cell are added as new files and entries only: the
    configuration file, its entry, the cell on plant-hifi on one card, and
    the cell in the `workloads` of every end-to-end metric that lists its
    cells and of every per-layer metric that applies to it.  `before`
    holds the copy's files as they were, {path: bytes}.  Where the tree
    holds them already, the copy starts without them."""
    from portbench import catalog
    root = tmp_path / "portbench"
    shutil.copytree(catalog.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    (root / "configs" / f"{FUSED_CONFIG}.json").unlink(missing_ok=True)
    bench = catalog.load_benchmark()
    bench["configs"] = [c for c in bench["configs"]
                        if c["name"] != FUSED_CONFIG]
    bench["workloads"] = [w for w in bench["workloads"]
                          if w["name"] != FUSED_CELL]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != FUSED_CELL]
    bench_path = tmp_path / "BENCHMARK.json"
    bench_path.write_text(json.dumps(bench, indent=1))
    before = {os.path.join(d, f): open(os.path.join(d, f), "rb").read()
              for d, _, fs in os.walk(tmp_path) for f in fs}
    cfg = catalog.config("hifimeth-3ctx") | {
        "name": FUSED_CONFIG,
        "deployment": "one call process on one card, all three context "
                      "nets, the gather and the whole net per site in one "
                      "kernel (call --gather-impl fused)",
        "call": {"gather_impl": "fused"}, "check": {"ml_gap_u8": 0.02}}
    (root / "configs" / f"{FUSED_CONFIG}.json").write_text(
        json.dumps(cfg, indent=1))
    bench["configs"].append({
        "name": FUSED_CONFIG,
        "source": "https://github.com/xiaochuanle/hifimeth",
        "file": f"portbench/configs/{FUSED_CONFIG}.json", "reduced": [],
        "why": "the published nets, full width and depth, float32, "
               "through the fused kernel"})
    bench["workloads"].append({
        "name": FUSED_CELL, "config": FUSED_CONFIG, "traffic": "plant-hifi",
        "chips": 1, "why": "plant-hifi's reads through the fused kernel"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(FUSED_CELL)
    listed = catalog.applies(bench, FUSED_CELL, str(root))
    for m in bench["per_layer"]:
        if m["name"] in listed:
            m["workloads"].append(FUSED_CELL)
    bench_path.write_text(json.dumps(bench, indent=1))
    return SimpleNamespace(root=str(root), bench_path=str(bench_path),
                           bench=bench, before=before, config=FUSED_CONFIG,
                           cell=FUSED_CELL)
