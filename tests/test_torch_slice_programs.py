"""The port's slice and folded paths through their per-batch programs
(engine/programs.py, CallEngine._run_programs) on the CPU.

On the CPU a BatchProgram runs its body directly over the same static plan
and output buffers and the same copies as on the card, and the engine
featurizes every flush into the same persistent (cap, 8) table, so these
tests hold all of it but the capture (chip_smoke.py phase 8 holds graph
runs against eager runs on the card).  What is held:
 - the program path byte-equal to the functions it replaces, over the
   same padded site arrays: call_sites_batched chunk by chunk on one
   device (a flush whose sites pad to two bucket chunks), call_sites_grid
   share by share over ["cpu"] * 3 (uneven shares of the batch), slice and
   folded, float32 and bf16, a replay per batch and device;
 - the engine end to end against the JAX engine's same path on the same
   BAM: MM/MN byte-equal and ML within the parity contract (+-1, at most
   5% of bytes off; docs/PARITY.md) in float32, inside the JAX package's
   bf16 band in bf16 (the frameworks sum float32 in another order); the
   device list against the JAX engine's data-parallel run over its eight
   host devices; graphs on and off and sync byte-equal;
 - one program per (device entry, context), one warm-up per layer
   geometry and entry, and the persistent table over two flushes.
Models are built by hand at small widths (SMALL_CONVS) and written as npz
files both packages load; inputs come from numpy seeds.
"""
import json
import os

import numpy as np
import pytest
import torch

from hifimeth_tpu.engine.call import CallConfig as JaxCallConfig
from hifimeth_tpu.engine.call import run_call as jax_run_call
from hifimeth_tpu_torch.engine import programs
from hifimeth_tpu_torch.engine.call import CallConfig, CallEngine, run_call
from hifimeth_tpu_torch.features.windows import (call_sites_batched,
                                                 call_sites_grid, fold_table,
                                                 featurize_planes_seg)
from hifimeth_tpu_torch.io.bam import BamReader
from hifimeth_tpu_torch.model.cnn import save_params_npz

from util import make_kinetics_read, write_bam

KMER = 401
#: per context: conv (K, Cin, Cout, stride, (lo, hi)) layers of a narrow
#: model; conv1 Cin*K is 88 (CpG, CHG) or 104 (CHH), conv3's 288 (over
#: "auto"'s 256), conv4 pads asymmetrically
SMALL_CONVS = {
    "CpG": [(11, 8, 16, 2, (1, 1)), (3, 16, 96, 2, (1, 1)),
            (3, 96, 8, 2, (1, 1)), (5, 8, 8, 2, (2, 1))],
    "CHH": [(13, 8, 16, 2, (1, 1)), (3, 16, 96, 2, (1, 1)),
            (3, 96, 8, 2, (1, 1)), (5, 8, 8, 2, (2, 1))],
}
SMALL_CONVS["CHG"] = SMALL_CONVS["CpG"]
#: 16 Ki buffer (2 Ki segments), 64-site batches, reads from 250 bases
SMALL = dict(buffer_bases=1 << 14, site_batch=64, min_read_size=250,
             contexts=("CpG", "CHH"))
#: the JAX package's bf16 band against its float32 (BENCH_r05.json)
BAND_MAX, BAND_MEAN = 10, 0.62


def small_params(ctx: str, seed: int) -> dict:
    """A narrow DNAModNet's params pytree (the JAX package's layout) with
    weights drawn from `seed`, scaled so the probabilities spread."""
    rng = np.random.default_rng(seed)
    convs, length = [], KMER
    for k, cin, cout, stride, (lo, hi) in SMALL_CONVS[ctx]:
        convs.append({
            "w": (rng.standard_normal((k, cin, cout))
                  * np.sqrt(2.0 / (k * cin))).astype(np.float32),
            "b": (0.1 * rng.standard_normal(cout)).astype(np.float32),
            "stride": stride, "pad": (lo, hi)})
        length = (length + lo + hi - k) // stride + 1
    fc_in = SMALL_CONVS[ctx][-1][2] * length
    return {
        "bn0": {"scale": (1 + 0.1 * rng.standard_normal(8)).astype(np.float32),
                "shift": (0.1 * rng.standard_normal(8)).astype(np.float32)},
        "convs": convs,
        "fc1": {"w": (rng.standard_normal((fc_in, 16))
                      * np.sqrt(2.0 / fc_in)).astype(np.float32),
                "b": np.zeros(16, np.float32)},
        "fc2": {"w": rng.standard_normal((16, 2)).astype(np.float32),
                "b": np.zeros(2, np.float32)}}


def small_model_dir(path) -> str:
    """A model directory of the three contexts' narrow models, kmer 401."""
    os.makedirs(path, exist_ok=True)
    for i, ctx in enumerate(("CpG", "CHG", "CHH")):
        save_params_npz(os.path.join(path, f"{ctx}.npz"),
                        small_params(ctx, 100 + i))
    with open(os.path.join(path, "kmer.txt"), "w") as f:
        f.write(f"{KMER}\n")
    return str(path)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread per test: the test workers share the
    cores, and an oversubscribed thread pool stalls on every small op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return small_model_dir(tmp_path_factory.mktemp("small_models"))


def reads_bam(path, seed, n=16):
    """Called reads of 400-2500 bases, every third reverse-flagged, and a
    short passthrough."""
    rng = np.random.default_rng(seed)
    recs = [make_kinetics_read(rng, f"r{i}", int(rng.integers(400, 2500)),
                               flag=16 if i % 3 == 1 else 4)
            for i in range(n)]
    recs.insert(2, make_kinetics_read(rng, "short", 200))
    write_bam(path, recs)
    return str(path)


def records(path):
    return [r.to_bytes() for r in BamReader(path)]


def tags(path):
    out = []
    for r in BamReader(path):
        ml = r.get_tag("ML")
        out.append((r.qname, r.get_tag("MM"), r.get_tag("MN"),
                    None if ml is None else ml[1][1].astype(int)))
    return out


def ml_diff(got, want):
    """MM/MN byte-equal and records in order; (max, mean, share off) of
    the ML u8 differences."""
    assert [g[:3] for g in got] == [w[:3] for w in want]
    d = np.concatenate([np.abs(g[3] - w[3]) for g, w in zip(got, want)
                        if g[3] is not None])
    assert len(d) > 0
    return int(d.max()), float(d.mean()), float((d > 0).mean())


def assert_against_jax(got_path, jax_path, dtype):
    mx, mean, share = ml_diff(tags(got_path), tags(jax_path))
    if dtype == "float32":
        assert mx <= 1 and share <= 0.05, (mx, share)
    else:
        assert mx <= BAND_MAX and mean <= BAND_MEAN, (mx, mean)


def _jax_cfg(models, **kw):
    return JaxCallConfig(model_dir=models, **{
        k: v for k, v in {**SMALL, **kw}.items() if k != "device"})


# -- the programs against the functions they replace ------------------------

def _sites(rng, n, cap):
    """n sites inside the packed region, mixed strands, some read bounds
    cutting the window, as the engine's flush lists hold them."""
    centers = np.sort(rng.integers(KMER, cap - KMER, n)).astype(np.int32)
    strands = rng.integers(0, 2, n).astype(np.uint8)
    rstart = np.full(n, KMER, np.int32)
    rend = np.full(n, cap - KMER, np.int32)
    rstart[::3] = centers[::3] - 37
    rend[::4] = centers[::4] + 11
    return {"centers": [centers], "strands": [strands], "rstart": [rstart],
            "rend": [rend]}


@pytest.mark.parametrize("devices", [None, ["cpu"] * 3],
                         ids=["one", "three"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["slice", "folded"])
def test_programs_byte_equal_to_batched_and_grid(models, monkeypatch, impl,
                                                 dtype, devices):
    replays = []
    replay = programs.BatchProgram.replay

    def spy(prog):
        replays.append(prog)
        replay(prog)

    monkeypatch.setattr(programs.BatchProgram, "replay", spy)
    cfg = CallConfig(model_dir=models, gather_impl=impl, compute_dtype=dtype,
                     device="cpu", data_parallel=devices is not None,
                     **SMALL)
    eng = CallEngine(cfg, devices=devices)
    rng = np.random.default_rng(11)
    cap, bs = cfg.buffer_bases, cfg.site_batch
    planes = np.zeros((5, cap - KMER), np.uint8)
    planes[0] = rng.choice([0, 1, 2, 3, 255], cap - KMER)
    planes[1:] = rng.integers(0, 256, (4, cap - KMER))
    with torch.inference_mode():
        for table in eng._tables:
            featurize_planes_seg([torch.from_numpy(planes)], cap,
                                 out=table)
    # 50 batches: two bucket chunks (48 + 2) on one device, one bucket of
    # 64 over the device list
    n = 49 * bs + 23
    s = _sites(rng, n, cap)
    ctx = "CHH"
    with torch.inference_mode():
        got_n, streams, order = eng._call_context(ctx, s, [])
    assert got_n == n and order is None and len(streams) == 1
    (_, got), idx, sel, m = streams[0]
    assert idx is None and sel is None and m == n

    ndev = len(eng.devices)
    nb = 64 if ndev > 1 else 50
    pad = nb * bs - n
    arrays = [torch.from_numpy(np.concatenate([a[0], np.zeros(pad, a[0].dtype)]))
              for a in (s["centers"], s["strands"], s["rstart"], s["rend"])]
    model = eng.models.models[ctx]
    table = eng._tables[0]
    with torch.inference_mode():
        if ndev == 1:
            feats = fold_table(table) if impl == "folded" else table
            parts, o = [], 0
            for k in eng._decompose_batches(50):
                assert k < 50                 # several chunks
                sl = slice(o * bs, (o + k) * bs)
                parts.append(call_sites_batched(
                    model, feats, *(a[sl] for a in arrays), site_batch=bs,
                    kmer=KMER, gather_impl=impl))
                o += k
            want = torch.cat(parts)
        else:
            bounds = np.linspace(0, bs, ndev + 1).astype(int)
            shares = np.diff(bounds)
            assert len(set(shares.tolist())) > 1          # uneven
            grids = [a.view(nb, bs) for a in arrays]
            want = torch.cat([call_sites_grid(
                eng.replicas[d].models[ctx], eng._tables[d],
                *(g[:, bounds[d]:bounds[d + 1]] for g in grids), kmer=KMER)
                for d in range(ndev)], dim=1).reshape(-1)
    assert got.dtype == torch.uint8 and got.shape == (nb * bs,)
    assert torch.equal(got, want)
    assert len(set(want[:n].tolist())) > 10       # the probabilities spread
    assert len(replays) == nb * ndev
    assert {id(p) for p in replays} == {id(eng._programs[d][ctx])
                                        for d in range(ndev)}


# -- the engine against the JAX engine ---------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["slice", "folded"])
def test_engine_matches_jax_engine(models, tmp_path, impl, dtype):
    """Async with three decode workers, graphs on and off and sync
    byte-equal; two buffers, both strands; against the JAX engine's same
    path and dtype."""
    bam = reads_bam(tmp_path / "in.bam", 21)
    kw = dict(SMALL, model_dir=models, gather_impl=impl, compute_dtype=dtype,
              device="cpu")
    out = {}
    for name, extra in (("graphs", dict(decode_workers=3)),
                        ("eager", dict(graphs=False, decode_workers=3)),
                        ("sync", dict(async_emit=False))):
        out[name] = str(tmp_path / f"{name}.bam")
        stats_json = str(tmp_path / f"{name}.json")
        run_call(bam, out[name], CallConfig(**kw, **extra,
                                            stats_json=stats_json))
    with open(stats_json) as f:
        assert json.load(f)["schedule"]["buffers"] > 1
    assert records(out["graphs"]) == records(out["eager"]) == \
        records(out["sync"])
    jax_out = str(tmp_path / "jax.bam")
    jax_run_call(bam, jax_out, _jax_cfg(models, gather_impl=impl,
                                        compute_dtype=dtype))
    assert_against_jax(out["graphs"], jax_out, dtype)


@pytest.mark.parametrize("impl", ["slice", "folded"])
def test_device_list_matches_jax_data_parallel(models, tmp_path, impl):
    """The grid over ["cpu"] * 3 against one device (contract: the shares
    run the CNN at other batch sizes) and against the JAX engine's
    data-parallel run over its eight host devices (call_sites_grid on a
    mesh)."""
    bam = reads_bam(tmp_path / "in.bam", 23)
    kw = dict(SMALL, model_dir=models, gather_impl=impl, device="cpu")
    three, one = str(tmp_path / "three.bam"), str(tmp_path / "one.bam")
    run_call(bam, three, CallConfig(**kw, data_parallel=True),
             devices=["cpu"] * 3)
    run_call(bam, one, CallConfig(**kw))
    assert_against_jax(three, one, "float32")
    jax_out = str(tmp_path / "jax.bam")
    jax_run_call(bam, jax_out, _jax_cfg(models, gather_impl=impl,
                                        data_parallel=True))
    assert_against_jax(three, jax_out, "float32")


# -- programs, warm-ups, the persistent table --------------------------------

def test_one_program_per_entry_and_context(models, monkeypatch):
    """Per device entry a (cap, 8) table and a program per context sized
    to the entry's share of a batch; one warm-up per layer geometry and
    entry (CpG and CHG share theirs, CHH has its own)."""
    warms = []
    build = programs.BatchProgram
    from hifimeth_tpu_torch.engine import call

    def spy(body, n_plan, n_out, device, **kw):
        warms.append((n_plan, n_out, kw["warm"]))
        return build(body, n_plan, n_out, device, **kw)

    monkeypatch.setattr(call, "BatchProgram", spy)
    ctxs = ("CpG", "CHG", "CHH")
    eng = CallEngine(CallConfig(**{**SMALL, "contexts": ctxs},
                                model_dir=models, gather_impl="folded",
                                device="cpu", data_parallel=True),
                     devices=["cpu"] * 3)
    shares = [21, 21, 22]
    assert warms == [(4 * sh, sh, w) for sh in shares
                     for w in (True, False, True)]
    for d, progs in enumerate(eng._programs):
        assert set(progs) == set(ctxs)
        assert tuple(eng._tables[d].shape) == (SMALL["buffer_bases"], 8)
        for p in progs.values():
            assert p.graph is None and not p.launches
            assert tuple(p.out.shape) == (shares[d],)


def test_site_views_are_the_plan_rows():
    n = 5
    plan = torch.arange(4 * n, dtype=torch.int32)
    views = programs.site_views(plan, n)
    assert len(views) == 4
    for i, v in enumerate(views):
        assert v.is_contiguous() and v.tolist() == list(range(i * n,
                                                              (i + 1) * n))
        assert v.data_ptr() == plan.data_ptr() + 4 * i * n


def test_reverse_permutation_is_made_once():
    """The strand turn indexes channels with one index tensor per (device,
    channels), made once: a capture refuses the host-to-device copy a
    list index makes on every call."""
    from hifimeth_tpu.features.windows import REV_CHANNEL_PERM as JAX_PERM
    from hifimeth_tpu_torch.features.windows import _rev_perm
    cpu = torch.device("cpu")
    for channels in (8, 11):
        perm = _rev_perm(cpu, channels)
        assert perm is _rev_perm(cpu, channels)
        assert perm.dtype == torch.int64
        assert perm.tolist() == JAX_PERM.tolist() + list(range(8, channels))


def test_featurize_into_a_position_major_table():
    rng = np.random.default_rng(3)
    cap = 4096
    planes = torch.from_numpy(rng.integers(0, 256, (5, 3000)).astype(np.uint8))
    table = torch.full((cap, 8), 7.0)
    assert featurize_planes_seg([planes], cap, out=table) is table
    assert torch.equal(table, featurize_planes_seg([planes], cap))
    assert not table[3000:].any()
    for bad in (torch.empty(cap, 9), torch.empty(8, cap).T,
                torch.empty(cap, 8, dtype=torch.float64)):
        with pytest.raises(ValueError, match="out must be"):
            featurize_planes_seg([planes], cap, out=bad)


@pytest.mark.parametrize("impl", ["slice", "folded"])
def test_two_flushes_share_the_table(models, tmp_path, impl):
    """Reads A, a flush, reads B, the last flush: the persistent table
    serves both (same storage), and each read's record equals a fresh
    engine's over its own read set."""
    rng = np.random.default_rng(9)
    sets = {name: [make_kinetics_read(rng, f"{name}{i}", 1500,
                                      flag=16 if i else 4) for i in range(2)]
            for name in ("a", "b")}
    paths = {}
    for name, recs in sets.items():
        paths[name] = str(tmp_path / f"{name}.bam")
        write_bam(paths[name], recs)
    cfg = CallConfig(**SMALL, model_dir=models, gather_impl=impl,
                     device="cpu")
    eng = CallEngine(cfg)
    ptr = eng._tables[0].data_ptr()
    done: list = []
    for rec in BamReader(paths["a"]):
        eng.add_read(rec, done)
    eng.flush(done)
    first = eng._tables[0].clone()
    for rec in BamReader(paths["b"]):
        eng.add_read(rec, done)
    eng.finalize(done)
    assert eng.flushes == 2 and eng._tables[0].data_ptr() == ptr
    assert not torch.equal(first, eng._tables[0])
    got = {r.qname: r.to_bytes() for r in done}
    for name in sets:
        out = str(tmp_path / f"{name}.out.bam")
        run_call(paths[name], out, cfg)
        for r in BamReader(out):
            assert got[r.qname] == r.to_bytes(), r.qname
