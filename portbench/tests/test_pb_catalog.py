"""BENCHMARK.json against the contract's shape, and discovery by name."""
import json
import os
import re
import shutil

import pytest

from portbench import catalog, harness, roofline
from portbench.devtrace import DeviceTrace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def names_its_parts(bench: dict, root: str = catalog.ROOT):
    """BENCHMARK.json's shape, each name found under `root`, and no
    per-layer metric listing a cell it does not apply to."""
    found = catalog.discover(root)
    assert bench["paths"] == ["portbench"]
    cfgs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and c["name"] in found["configs"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert catalog.config(c["name"], root)["name"] == c["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in cfgs
        assert w["traffic"] in found["traffic"]
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    config_of = {w["name"]: w["config"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"sites_per_s", "peak_device_mib", "setup_s"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m.get("workloads", config_of)) <= set(config_of)
    for w in bench["workloads"]:
        reported = [m["name"] for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
    for m in bench["per_layer"]:
        assert m["name"] in found["metrics"]
        assert m["moves"] in e2e - {"setup_s"}
        assert catalog.metric(m["name"], root).MOVES == m["moves"]
        assert set(m["workloads"]) <= set(config_of)
        for cell in m["workloads"]:
            assert m["name"] in catalog.applies(bench, cell, root), \
                (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def reports_its_metrics(bench: dict, root: str = catalog.ROOT):
    """Each cell lists exactly the per-layer metrics that apply to it:
    those of its configuration's route that move its leading end-to-end
    metric."""
    for w in bench["workloads"]:
        names = {m["name"] for m in catalog.per_layer(bench, w["name"])}
        assert names == set(catalog.applies(bench, w["name"], root)), \
            w["name"]
        assert names, w["name"]


def test_benchmark_names_its_parts():
    names_its_parts(catalog.load_benchmark())


def test_every_cell_reports_its_metrics():
    reports_its_metrics(catalog.load_benchmark())


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
    for m in bench["end_to_end"]:
        m.get("workloads", []).append("3ctx-plant-dummy")
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


@pytest.mark.parametrize("call,want", [
    ({}, "pallas"), ({"gather_impl": "auto"}, "pallas"),
    ({"gather_impl": "pallas"}, "pallas"), ({"gather_impl": "fused"}, "fused"),
    ({"gather_impl": "slice", "data_parallel": True}, "slice"),
    ({"gather_impl": "folded"}, "folded")])
def test_route_of_a_configuration(call, want):
    assert catalog.route({"name": "c", "call": call}) == want
    if not call:
        assert catalog.route({"name": "c"}) == "pallas"


def test_unknown_route_fails():
    with pytest.raises(ValueError, match="gather_impl"):
        catalog.route({"name": "c", "call": {"gather_impl": "tpu"}})


@pytest.mark.parametrize("routes", ['("tpu",)', '"pallas"', "()"])
def test_reader_routes_are_checked(routes, tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "odd.py").write_text(
        f'MOVES = "sites_per_s"\nROUTES = {routes}\n\n\n'
        'def read(run):\n    return None\n')
    with pytest.raises(TypeError, match="ROUTES"):
        catalog.metric("odd", str(tmp_path))


#: a traced run's engine timers and counts on one card (2 M sites)
TIMERS = {"decode": 3.0, "sites": 2.0, "pack": 1.0, "flush": 20.0,
          "dispatch": 4.0, "resolve": 30.0, "mmbuild": 5.0, "capture": 0.1,
          "decode_wait": 0.5, "flush_wait": 18.0, "resolve_wait": 28.0,
          "write": 1.0, "slots": 2_200_000, "batches": 270,
          "pinned_new": 12, "decode_cpu": 2.0, "sites_cpu": 1.0,
          "pack_cpu": 0.5, "dispatch_cpu": 2.0, "resolve_cpu": 1.25,
          "resolve_wait_cpu": 0.25, "mmbuild_cpu": 4.0, "write_cpu": 0.25}
#: device events of a traced fused-route window (10 s) on one card: the
#: fused kernel's three parts, the featurize, the copies (names as the
#: profiler gives them on the card)
FUSED_EVENTS = [
    (0.0, 2.5, "(anonymous namespace)::fused_head_kernel(float const*, long, "
               "int const*, int const*, int, int, int, float const*, "
               "(anonymous namespace)::Net, float*, float*)"),
    (2.5, 4.0, "(anonymous namespace)::fused_mid_kernel(float const*, int, "
               "float const*, (anonymous namespace)::Net, float*, float*)"),
    (4.0, 4.5, "(anonymous namespace)::fused_tail_kernel(float const*, int, "
               "float const*, (anonymous namespace)::Net, float*)"),
    (4.5, 4.75, "void at::native::reduce_kernel<512, 1, at::native::ReduceOp"
                "<float, at::native::MaxOps<float>, unsigned int, float, 4, "
                "4> >"),
    (4.75, 5.0, "Memcpy HtoD (Pinned -> Device)"),
    (5.0, 5.25, "Memcpy DtoD (Device -> Device)")]


def fused_run() -> dict:
    sites = {"CpG": 400_000, "CHG": 300_000, "CHH": 1_300_000}
    n_sites, bases = sum(sites.values()), 6_600_000
    return {"sites": sites, "n_sites": n_sites, "bases": bases,
            "window_s": 10.0, "cards": 1, "timers": TIMERS,
            "trace": DeviceTrace({0: FUSED_EVENTS}, 0.0, 10.0),
            "flops": roofline.model_flops(
                sites, catalog.config("hifimeth-3ctx")["flops_per_site"]),
            "gather_bytes": roofline.gather_bytes(n_sites, bases)}


def test_fused_route_added_as_files_and_entries(fused_copy):
    """The fused route's configuration and cell, added to a copy as new
    files and entries only, pass the catalog's checks; the cell lists
    neither more nor less than the metrics of its route (no
    gather_roofline: the route launches no gather kernel), and each of them
    reads a number on a traced fused-route run."""
    root, cell_name = fused_copy.root, fused_copy.cell
    bench = catalog.load_benchmark(fused_copy.bench_path)
    names_its_parts(bench, root)
    reports_its_metrics(bench, root)
    assert catalog.route(catalog.config(fused_copy.config, root)) == "fused"
    listed = [m["name"] for m in catalog.per_layer(bench, cell_name)]
    assert "gather_roofline" not in listed
    assert {"cnn_roofline", "model_mfu", "device_idle_share",
            "batch_fill", "dispatch_s_per_msite",
            "peer_copy_share"} <= set(listed)

    cell = harness.Cell(bench, cell_name, root=root)
    run = fused_run()
    got = harness.window_metrics(cell, run, 9.0, 2**30, True)
    assert list(got) == listed
    for name, v in got.items():
        assert isinstance(v["value"], float) and v["value"] >= 0, name
        if name.endswith("_roofline") or "mfu" in name:
            assert 0 < v["value"] <= 100, name
    # the fused kernel and the featurize, 5 s of the window, are the CNN's
    assert got["cnn_roofline"]["value"] == pytest.approx(
        100.0 * run["flops"] / roofline.PEAK_FLOPS / 4.75)
    assert got["device_idle_share"]["value"] == pytest.approx(47.5)
    assert catalog.metric("gather_roofline", root).read(run) is None

    before = dict(fused_copy.before)
    old = json.loads(before.pop(fused_copy.bench_path))
    assert {p: open(p, "rb").read() for p in before} == before
    assert set(_files(root)) - set(before) == {
        os.path.join(root, "configs", f"{fused_copy.config}.json")}
    assert _without(bench, fused_copy.config, cell_name) == old


def test_fused_cell_listed_wrong_fails(fused_copy):
    """The rule bites both ways on the copy: the fused cell listed under
    gather_roofline, or left out of cnn_roofline, fails the checks."""
    bench = catalog.load_benchmark(fused_copy.bench_path)
    by_name = {m["name"]: m for m in bench["per_layer"]}
    by_name["gather_roofline"]["workloads"].append(fused_copy.cell)
    with pytest.raises(AssertionError):
        names_its_parts(bench, fused_copy.root)
    with pytest.raises(AssertionError):
        reports_its_metrics(bench, fused_copy.root)
    by_name["gather_roofline"]["workloads"].remove(fused_copy.cell)
    by_name["cnn_roofline"]["workloads"].remove(fused_copy.cell)
    with pytest.raises(AssertionError):
        reports_its_metrics(bench, fused_copy.root)


def _without(bench: dict, config: str, cell: str) -> dict:
    """`bench` without one configuration and one cell, wherever listed."""
    out = json.loads(json.dumps(bench))
    out["configs"] = [c for c in out["configs"] if c["name"] != config]
    out["workloads"] = [w for w in out["workloads"] if w["name"] != cell]
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != cell]
    return out


def test_unknown_names_fail():
    with pytest.raises(KeyError):
        catalog.workload(catalog.load_benchmark(), "no-such-cell")
    with pytest.raises(FileNotFoundError):
        catalog.traffic("no-such-mix")
    with pytest.raises(FileNotFoundError):
        catalog.metric("no_such_metric")


def test_leading_metric_of_each_cell():
    """The one-card cell's per-layer metrics move sites_per_s; the
    four-card cell reports no sites_per_s, and its move peak_device_mib."""
    bench = catalog.load_benchmark()
    assert catalog.leading(bench, "3ctx-plant-hifi") == "sites_per_s"
    assert catalog.leading(bench, "3ctx-plant-hifi-dp4") == "peak_device_mib"


@pytest.mark.parametrize("name", [
    m["name"] for m in catalog.load_benchmark()["per_layer"]
    if "3ctx-plant-hifi-dp4" in m["workloads"]])
def test_four_card_metric_reads_as_its_base(name):
    """Each per-layer metric of the four-card cell reads what the metric
    of its base name reads (sites_per_s.dp4: the window's rate), on a
    traced run (of the fused route: gather_roofline reads nothing there)."""
    run = fused_run()
    got = catalog.metric(name).read(run)
    base = name.removesuffix(".dp4")
    want = (run["n_sites"] / run["window_s"] if base == "sites_per_s"
            else catalog.metric(base).read(run))
    assert got == want
    assert (got is None) == (base == "gather_roofline")
