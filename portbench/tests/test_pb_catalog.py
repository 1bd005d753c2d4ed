"""BENCHMARK.json against the contract's shape, and discovery by name."""
import json
import os
import re
import shutil

import pytest

from portbench import catalog, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_names_its_parts():
    bench = catalog.load_benchmark()
    found = catalog.discover()
    assert bench["paths"] == ["portbench"]
    cfgs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and c["name"] in found["configs"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert catalog.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in cfgs
        assert w["traffic"] in found["traffic"]
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"sites_per_s", "peak_device_mib", "setup_s"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["name"] in found["metrics"]
        assert m["moves"] == "sites_per_s"
        assert catalog.metric(m["name"]).MOVES == m["moves"]
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_its_metrics():
    bench = catalog.load_benchmark()
    for w in bench["workloads"]:
        names = {m["name"] for m in catalog.per_layer(bench, w["name"])}
        assert names == {m["name"] for m in bench["per_layer"]}


def test_discovery_finds_added_files(tmp_path):
    """A later change adds a traffic mix and a metric as new files: a copy
    of portbench/ with one of each finds and runs them, and no file that
    was there changes."""
    root = tmp_path / "portbench"
    shutil.copytree(catalog.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: open(p, "rb").read() for p in _files(root)}
    tr = catalog.traffic("plant-hifi") | {"name": "plant-dummy",
                                         "n_reads": 2}
    (root / "traffic" / "plant-dummy.json").write_text(json.dumps(tr))
    (root / "metrics" / "dummy_share.py").write_text(
        'MOVES = "sites_per_s"\n\n\ndef read(run):\n'
        '    return run["n_sites"] / 2 if run["n_sites"] else None\n')
    found = catalog.discover(str(root))
    assert "plant-dummy" in found["traffic"]
    assert "dummy_share" in found["metrics"]
    bench = catalog.load_benchmark()
    bench["workloads"].append({"name": "3ctx-plant-dummy",
                               "config": "hifimeth-3ctx",
                               "traffic": "plant-dummy", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_share", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "sites_per_s",
                               "workloads": ["3ctx-plant-dummy"]})
    cell = harness.Cell(bench, "3ctx-plant-dummy", root=str(root))
    assert cell.traffic["n_reads"] == 2
    assert [m["name"] for m in catalog.per_layer(bench, cell.name)] == \
        ["dummy_share"]
    got = harness.window_metrics(cell, {"n_sites": 10}, 1.0, 0, True)
    assert got == {"dummy_share": {"value": 5.0, "unit": "%"}}
    after = {p: open(p, "rb").read() for p in _files(root)
             if p in before}
    assert after == before


def _files(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]


def test_unknown_names_fail():
    with pytest.raises(KeyError):
        catalog.workload(catalog.load_benchmark(), "no-such-cell")
    with pytest.raises(FileNotFoundError):
        catalog.traffic("no-such-mix")
    with pytest.raises(FileNotFoundError):
        catalog.metric("no_such_metric")
