"""The rest of a run on the CPU at a small size (the look for a card
skipped): sound runs come out correct, and runs with the timed path broken
underneath come out not correct."""
import time

import pytest

from portbench import catalog, harness


#: cells that PERF.md keeps for later (their configuration and traffic
#: files are here; BENCHMARK.json does not name them yet)
LATER = [{"name": "cpg-human-hifi", "config": "hifimeth-cpg",
          "traffic": "human-hifi", "chips": 1, "why": "later"},
         {"name": "3ctx-plant-noamp", "config": "hifimeth-3ctx",
          "traffic": "plant-noamp", "chips": 1, "why": "later"},
         {"name": "3ctx-plant-hifi-dp4", "config": "hifimeth-3ctx-dp4",
          "traffic": "plant-hifi", "chips": 4, "why": "later"}]


def bench():
    """BENCHMARK.json with the LATER cells, each in the `workloads` of
    every end-to-end metric that lists its cells, as a change that adds
    one puts it."""
    b = catalog.load_benchmark()
    names = {w["name"] for w in b["workloads"]}
    later = [w for w in LATER if w["name"] not in names]
    b["workloads"] = b["workloads"] + later
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [w["name"] for w in later]
    return b


def run(name, shrink, cpu_call, trace=False, devices=None, n_reads=3,
        limit=6, seed=2**31 + 99, copy=None):
    """One small CPU run of cell `name`, from this BENCHMARK.json and its
    LATER cells, or from `copy` (a `fused_copy`)."""
    cell = (harness.Cell(bench(), name) if copy is None else
            harness.Cell(copy.bench, name, root=copy.root))
    result, numbers = harness.run_cell(
        cell, seed, 60.0, trace, time.perf_counter(), device="cpu",
        devices=devices, overrides=cpu_call,
        traffic=shrink(cell.traffic, n_reads=n_reads), limit=limit,
        log=lambda s: None)
    return result, dict((k, v) for k, v, _ in numbers)


#: the fused route's cell, which a later change adds (`fused_copy`)
FUSED = "3ctx-plant-hifi-fused"


def copy_for(name, request):
    """The `fused_copy` for the fused route's cell, else None."""
    return request.getfixturevalue("fused_copy") if name == FUSED else None


@pytest.mark.parametrize("name", ["3ctx-plant-hifi", "3ctx-plant-noamp",
                                  "cpg-human-hifi", FUSED])
def test_sound_run_is_correct(name, shrink, cpu_call, request):
    """Sound runs come out correct; on the fused route too, whose records
    the check and the reference take as they are."""
    result, numbers = run(name, shrink, cpu_call,
                          copy=copy_for(name, request))
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == 6
    assert numbers == {"missing": 0, "site_mismatch": 0, "ml_gap_u8": 0.0}
    assert set(result["metrics"]) == {"sites_per_s", "peak_device_mib",
                                      "setup_s"}
    assert list(result)[-1] == "check"


def test_traced_run_reads_the_engine_timers(shrink, cpu_call):
    """On the CPU the device readers find nothing to read and leave their
    metrics out; the timers' metrics are there."""
    result, _ = run("3ctx-plant-hifi", shrink, cpu_call, trace=True,
                    limit=4)
    assert result["correct"]
    assert set(result["metrics"]) == {"decode_s_per_msite",
                                      "pack_s_per_msite",
                                      "dispatch_s_per_msite",
                                      "emit_s_per_msite"}


def test_data_parallel_run_is_correct(shrink, cpu_call):
    result, _ = run("3ctx-plant-hifi-dp4", shrink, cpu_call,
                    devices=["cpu"] * 4)
    assert result["correct"]


def _alter_answers(monkeypatch):
    """An answer altered where it is produced: every u8 probability the
    CNN's conversion gives moves by one bin."""
    from hifimeth_tpu_torch.features import windows
    real = windows.logits_to_scaled_probs

    def altered(logits):
        p = real(logits)
        return p ^ 1
    monkeypatch.setattr(windows, "logits_to_scaled_probs", altered)


def _alter_fused_answers(monkeypatch):
    """An answer altered where the fused route produces it: every u8
    probability of the fused kernel's conversion moves by one bin."""
    from hifimeth_tpu_torch.ops import fused
    real = fused.logits_to_scaled_probs
    monkeypatch.setattr(fused, "logits_to_scaled_probs",
                        lambda logits: real(logits) ^ 1)


def _drop_a_site(monkeypatch):
    """A site lost in the scan: the last candidate of every read."""
    from hifimeth_tpu_torch.features import sites
    real = sites.scan_all

    def dropped(seq):
        out = real(seq)
        offs, strands = out["CpG"]
        out["CpG"] = (offs[:-1], strands[:-1])
        return out
    monkeypatch.setattr(sites, "scan_all", dropped)


def _no_exchange(monkeypatch):
    """The exchange between cards left out: every replica's results are
    replaced by the first replica's."""
    from hifimeth_tpu_torch.engine.call import CallEngine

    def first_only(self, per_dev):
        return [per_dev[0]] * len(per_dev) if len(per_dev) > 1 else per_dev
    monkeypatch.setattr(CallEngine, "_to_primary", first_only)


@pytest.mark.parametrize("name,fault,devices", [
    ("3ctx-plant-hifi", _alter_answers, None),
    ("cpg-human-hifi", _alter_answers, None),
    ("3ctx-plant-noamp", _drop_a_site, None),
    ("3ctx-plant-hifi-dp4", _no_exchange, ["cpu"] * 4),
    (FUSED, _alter_fused_answers, None),
])
def test_broken_path_is_not_correct(name, fault, devices, monkeypatch,
                                    shrink, cpu_call, request):
    fault(monkeypatch)
    result, numbers = run(name, shrink, cpu_call, devices=devices,
                          copy=copy_for(name, request))
    assert not result["correct"]
    assert result["failed"] > 0


def test_forbidden_modules():
    mods = {"hifimeth_tpu_torch": 1, "hifimeth_tpu_torch.engine": 1,
            "numpy": 1, "jaxlib.xla": 1, "hifimeth_tpu.io": 1,
            "flaxen": 1, "jax_like": 1}
    assert harness.forbidden_modules(mods) == ["hifimeth_tpu", "jaxlib"]
    assert harness.forbidden_modules({"flax": 1, "jax": 1}) == ["flax",
                                                                "jax"]


def test_weights_are_checked(tmp_path, monkeypatch):
    cell = harness.Cell(bench(), "cpg-human-hifi")
    harness.check_weights(cell.config)
    (tmp_path / "CpG.npz").write_bytes(b"not the model")
    monkeypatch.setattr(harness, "models_dir", lambda: str(tmp_path))
    with pytest.raises(RuntimeError, match="sha256"):
        harness.check_weights(cell.config)
