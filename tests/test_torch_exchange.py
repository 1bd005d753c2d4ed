"""`call --data-parallel`'s exchange between devices on the CPU: the plane
ship to every device, each device's share of a batch, and the results
brought back to the primary device (engine/call.py `_ship`,
`_run_programs`, `_to_primary`).

What is held:
 - over ["cpu"] * 4, on seeded random nets (train/model.py init_params,
   folded and written as the shipped npz files are), every record's MM tag
   and ML bytes agree with the benchmark's plain reference
   (portbench/reference/hifimeth.py) on the same nets, by the benchmark's
   own check (portbench/check.py: no record missing or with other sites,
   every ML byte in the bin of the reference's probability within the
   configuration's 0.02), on pallas and slice;
 - over a device list the timers hold the exchange's span `to_primary`,
   whose records open inside `dispatch`, `peer_bytes` 0 (one device type,
   so no copy crosses cards) and `ship_bytes`, the plane bytes shipped
   summed over the devices: the device count times one device's;
 - on one device, given or the one local device of `--data-parallel`,
   none of them.
"""
import json

import pytest

from hifimeth_tpu_torch.engine.call import CallConfig, CallEngine, run_call
from hifimeth_tpu_torch.model.cnn import save_params_npz
from hifimeth_tpu_torch.train.model import fold_to_inference, init_params
from portbench import check, inputs
from portbench.reference import hifimeth as reference

CONTEXTS = ("CpG", "CHH")
#: conv1's kernel per context, as the shipped nets have it
CONV1 = {"CpG": 11, "CHH": 13}
#: four plant reads of 1-3 kb (the benchmark's plant-hifi mix, shortened)
TRAFFIC = {"n_reads": 4, "composition": [0.32, 0.18, 0.18, 0.32],
           "length": {"median": 1500, "sigma": 0.3, "min": 1000,
                      "max": 3000}}
#: several fill-through flushes of small batches
SMALL = dict(site_batch=128, buffer_bases=1 << 15, flush_bases=3000,
             contexts=CONTEXTS, device="cpu")
KEYS = ("to_primary", "peer_bytes", "ship_bytes")


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """A model directory of seeded random nets at the shipped widths."""
    d = tmp_path_factory.mktemp("nets")
    for i, ctx in enumerate(CONTEXTS):
        params, state = init_params(seed=7 + i,
                                    kernels=(CONV1[ctx],) + (3,) * 7)
        save_params_npz(str(d / f"{ctx}.npz"),
                        fold_to_inference(params, state))
    return str(d)


def _pool_bam(tmp_path, seed):
    pool = inputs.make_pool(TRAFFIC, seed)
    stream = inputs.PoolStream(inputs.encode_pool(pool),
                               limit=pool.n_reads)
    path = tmp_path / "in.bam"
    path.write_bytes(stream.read())
    return pool, str(path)


def _tags(path):
    return [(name, mm, None if ml is None else bytes(ml))
            for name, mm, ml in check.read_records(path)]


def _call(tmp_path, name, in_bam, nets, devices=None, **kw):
    stats = str(tmp_path / f"{name}.json")
    out = str(tmp_path / f"{name}.bam")
    if devices is not None:
        kw["data_parallel"] = True
    run_call(in_bam, out, CallConfig(**{**SMALL, **kw}, model_dir=nets,
                                     stats_json=stats), devices=devices)
    with open(stats) as f:
        return out, json.load(f)


@pytest.mark.parametrize("seed", [3141590001, 2**31 + 5])
@pytest.mark.parametrize("impl", ["pallas", "slice"])
def test_four_devices_against_the_reference(tmp_path, nets, impl, seed):
    pool, in_bam = _pool_bam(tmp_path, seed)
    out, js = _call(tmp_path, "four", in_bam, nets, ["cpu"] * 4,
                    gather_impl=impl)
    assert js["config"]["devices"] == ["cpu"] * 4
    expected = reference.call_pool(pool.seq, pool.kin, pool.offsets,
                                   CONTEXTS, nets)
    assert sum(len(p1) for _, p1, _ in expected) > 500
    verdict = check.compare(check.read_records(out), pool.n_reads,
                            pool.name, expected, {"ml_gap_u8": 0.02})
    assert verdict["correct"], verdict
    assert verdict["numbers"]["missing"][0] == 0
    assert verdict["numbers"]["site_mismatch"][0] == 0


@pytest.mark.parametrize("impl", ["pallas", "slice"])
def test_exchange_spans_and_counts(tmp_path, nets, monkeypatch, impl):
    _, in_bam = _pool_bam(tmp_path, 11)
    shipped = []
    real_ship = CallEngine._ship

    def ship(self, piece):
        shipped.append(piece.nbytes)
        return real_ship(self, piece)
    monkeypatch.setattr(CallEngine, "_ship", ship)

    four, js = _call(tmp_path, "four", in_bam, nets, ["cpu"] * 4,
                     gather_impl=impl, trace=True)
    t = js["timers"]
    assert t["to_primary"] > 0 and t["peer_bytes"] == 0
    assert sum(shipped) > 0 and t["ship_bytes"] == 4 * sum(shipped)
    parents = {r["parent"] for r in js["spans"] if r["name"] == "to_primary"}
    assert parents == {"dispatch"}

    for name, kw in (("one", {}), ("local", {"data_parallel": True})):
        one, js = _call(tmp_path, name, in_bam, nets, gather_impl=impl,
                        trace=True, **kw)
        assert js["config"]["devices"] == ["cpu"]
        assert not set(KEYS) & set(js["timers"]), name
        assert "to_primary" not in {r["name"] for r in js["spans"]}
    if impl == "pallas":
        assert _tags(four) == _tags(one)
