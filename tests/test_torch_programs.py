"""The port's captured per-batch call programs (engine/programs.py) on the
CPU: the plumbing the card's CUDA graphs replay through.

On the CPU a BatchProgram runs its body directly over the same static plan
and output buffers and the same copies as on the card, and the engine
featurizes every flush into the same persistent table, so these tests hold
all of it except the capture itself (chip_smoke.py phase 8 holds graph runs
against eager runs on the card).  What is held:
 - CallConfig(graphs=True) against graphs=False (on the card, each
   program's body run eagerly, every op launched; on the CPU both run the
   body): records byte-equal on pallas
   in float32 and bf16 and on fused, both strands, flushes whose last
   bucket chunk is padded, the forced schedule (small buffer, cut flushes,
   carried reads) and the device list ["cpu", "cpu"];
 - against the JAX engine on the same inputs: MM/MN byte-equal and ML
   within the parity contract (+-1, at most 5% of bytes off;
   docs/PARITY.md) in float32, inside the JAX package's bf16 band in bf16
   (the two frameworks sum float32 in another order);
 - launch accounting: a capture adds nothing to the kernels' counts and a
   replay adds what the captured body launched (a counting stub body and a
   stand-in for the capture); the engine warms each geometry up once;
 - the persistent table: two flushes with different payloads give their
   own results, written into the same table.
Inputs are small (reads of 0.3-1.5 kb, an 8 Ki buffer, 64-site batches).
"""
import numpy as np
import pytest
import torch

from hifimeth_tpu.engine.call import CallConfig as JaxCallConfig
from hifimeth_tpu.engine.call import run_call as jax_run_call
from hifimeth_tpu_torch.engine import programs
from hifimeth_tpu_torch.engine.call import CallConfig, CallEngine, run_call
from hifimeth_tpu_torch.features.windows import (call_sites_group,
                                                 featurize_planes_seg,
                                                 featurize_planes_t_seg)
from hifimeth_tpu_torch.io.bam import BamReader
from hifimeth_tpu_torch.ops.gather import GROUP

from util import make_kinetics_read, write_bam

#: the forced schedule of tests/test_torch_pipeline.py: 8 Ki buffer (1 Ki
#: segments), 1 Ki flushes, 64-site batches, reads from 250 bases called
FORCED = dict(buffer_bases=1 << 13, flush_bases=1024, site_batch=64,
              min_read_size=250, contexts=("CpG", "CHH"), device="cpu")
#: the JAX package's bf16 band against its float32 (BENCH_r05.json)
BAND_MAX, BAND_MEAN = 10, 0.62


def _reads(seed, n=12):
    """Called reads of 300-1500 bases, every third reverse-flagged, and a
    short passthrough."""
    rng = np.random.default_rng(seed)
    recs = [make_kinetics_read(rng, f"r{i}", int(rng.integers(300, 1500)),
                               flag=16 if i % 3 == 1 else 4)
            for i in range(n)]
    recs.insert(3, make_kinetics_read(rng, "short", 200))
    return recs


def _bam(tmp_path, recs, name="in.bam"):
    path = str(tmp_path / name)
    write_bam(path, recs)
    return path


def _records(path):
    return [r.to_bytes() for r in BamReader(path)]


def _tags(path):
    out = []
    for r in BamReader(path):
        ml = r.get_tag("ML")
        out.append((r.qname, r.get_tag("MM"), r.get_tag("MN"),
                    None if ml is None else ml[1][1].astype(int)))
    return out


def _ml_diff(got, want):
    """MM/MN byte-equal and records in order; (max, mean) |ML diff| and
    the share of ML bytes off."""
    assert [g[:3] for g in got] == [w[:3] for w in want]
    d = np.concatenate([np.abs(g[3] - w[3]) for g, w in zip(got, want)
                        if g[3] is not None])
    assert len(d) > 0
    return int(d.max()), float(d.mean()), float((d > 0).mean())


class _Spy:
    """Wraps CallEngine._run_programs: counts the strands called per
    direction and the padded groups (base 0, rels 0) of every plan."""

    def __init__(self, monkeypatch):
        self.rev = {False: 0, True: 0}
        self.padded = 0
        self.batches = 0
        launch = CallEngine._run_programs

        def spy(eng, key, plans, hold):
            self.rev[key[1]] += 1
            self.batches += len(plans[0])
            n_rels = eng.cfg.site_batch // GROUP * GROUP
            for plan in plans:
                rels = plan[:, :n_rels].reshape(len(plan), -1, GROUP)
                b128 = plan[:, n_rels:]
                self.padded += int(((b128 == 0) & (rels == 0).all(-1)).sum())
            return launch(eng, key, plans, hold)

        monkeypatch.setattr(CallEngine, "_run_programs", spy)


@pytest.mark.parametrize("gather_impl,dtype", [("pallas", "float32"),
                                               ("pallas", "bfloat16"),
                                               ("fused", "float32")])
def test_graphs_match_eager_and_jax(tmp_path, monkeypatch, gather_impl,
                                    dtype):
    """The forced schedule, async with three decode workers: the program
    path byte-equal to the eager one and to its own sync run, both
    strands, padded last chunks, carried reads; against the JAX engine's
    run of the same path and dtype (pallas in interpret mode)."""
    spy = _Spy(monkeypatch)
    recs = _reads(41)
    bam = _bam(tmp_path, recs)
    kw = dict(FORCED, gather_impl=gather_impl, compute_dtype=dtype)
    out = {}
    for name, extra in (("graphs", dict(decode_workers=3)),
                        ("graphs-sync", dict(async_emit=False)),
                        ("eager", dict(graphs=False, decode_workers=3))):
        out[name] = str(tmp_path / f"{name}.bam")
        stats_json = str(tmp_path / f"{name}.json")
        run_call(bam, out[name], CallConfig(**kw, **extra,
                                            stats_json=stats_json))
    import json
    with open(stats_json) as f:
        sched = json.load(f)["schedule"]
    assert sched["buffers"] > 1 and sched["carried_reads"] > 0
    assert spy.rev[False] > 0 and spy.rev[True] > 0 and spy.padded > 0
    graphs = _records(out["graphs"])
    assert len(graphs) == len(recs)
    assert graphs == _records(out["graphs-sync"]) == _records(out["eager"])

    jax_out = str(tmp_path / "jax.bam")
    jax_run_call(bam, jax_out, JaxCallConfig(
        gather_impl=gather_impl, compute_dtype=dtype,
        **{k: v for k, v in FORCED.items() if k != "device"}))
    mx, mean, share = _ml_diff(_tags(out["graphs"]), _tags(jax_out))
    if dtype == "float32":
        assert mx <= 1 and share <= 0.05
    else:
        assert mx <= BAND_MAX and mean <= BAND_MEAN


@pytest.mark.parametrize("async_emit", [True, False])
def test_graphs_split_over_two_cpu_replicas(tmp_path, async_emit):
    """pallas over ["cpu", "cpu"] (each replica its own programs, table and
    plan rows): byte-equal to the eager split and to one device; against
    the JAX engine within the parity contract."""
    bam = _bam(tmp_path, _reads(43))
    out = {}
    for name, kw in (("split", dict(data_parallel=True)),
                     ("split-eager", dict(data_parallel=True, graphs=False)),
                     ("one", {})):
        out[name] = str(tmp_path / f"{name}.bam")
        run_call(bam, out[name], CallConfig(**FORCED, async_emit=async_emit,
                                            **kw),
                 devices=["cpu", "cpu"] if kw else None)
    split = _records(out["split"])
    assert split == _records(out["split-eager"]) == _records(out["one"])
    jax_out = str(tmp_path / "jax.bam")
    jax_run_call(bam, jax_out, JaxCallConfig(
        gather_impl="pallas",
        **{k: v for k, v in FORCED.items() if k != "device"}))
    mx, _, share = _ml_diff(_tags(out["split"]), _tags(jax_out))
    assert mx <= 1 and share <= 0.05


def test_engine_builds_one_program_per_context_and_strand():
    """Per device entry: a persistent table and a program per (context,
    strand) with the plan and output sizes of one batch, graphs on or off;
    slice builds a (cap, 8) table and a program per context, whose plan
    holds a batch's four site arrays (tests/test_torch_slice_programs.py
    holds those programs further)."""
    eng = CallEngine(CallConfig(**FORCED, data_parallel=True),
                     devices=["cpu", "cpu"])
    ngrp = FORCED["site_batch"] // GROUP
    assert len(eng._programs) == len(eng._tables) == 2
    assert eng._tables[0] is not eng._tables[1]
    for progs, table in zip(eng._programs, eng._tables):
        assert tuple(table.shape) == (8, FORCED["buffer_bases"])
        assert set(progs) == {(c, r) for c in FORCED["contexts"]
                              for r in (False, True)}
        for p in progs.values():
            assert p.graph is None and not p.launches
            assert tuple(p.plan.shape) == (ngrp * (GROUP + 1),)
            assert tuple(p.out.shape) == (FORCED["site_batch"],)
    sl = CallEngine(CallConfig(**FORCED, gather_impl="slice"))
    assert len(sl._programs) == len(sl._tables) == 1
    assert tuple(sl._tables[0].shape) == (FORCED["buffer_bases"], 8)
    assert set(sl._programs[0]) == set(FORCED["contexts"])
    for p in sl._programs[0].values():
        assert p.graph is None
        assert tuple(p.plan.shape) == (4 * FORCED["site_batch"],)
        assert tuple(p.out.shape) == (FORCED["site_batch"],)
    eager = CallEngine(CallConfig(**FORCED, graphs=False))
    assert len(eager._programs) == len(eager._tables) == 1
    assert set(eager._programs[0]) == set(eng._programs[0])
    assert all(p.graph is None for p in eager._programs[0].values())


@pytest.mark.parametrize("gather_impl", ["pallas", "fused"])
def test_engine_warms_each_geometry_once(monkeypatch, gather_impl):
    """A warm-up per device entry, layer shapes and strand: CpG and CHG
    (conv1 K=11) share theirs, CHH (K=13) has its own; each entry of a
    device list warms its own."""
    from hifimeth_tpu_torch.engine import call
    warms = []
    build = call.BatchProgram

    def spy(body, n_plan, n_out, device, **kw):
        warms.append(kw["warm"])
        return build(body, n_plan, n_out, device, **kw)

    monkeypatch.setattr(call, "BatchProgram", spy)
    ctxs = ("CpG", "CHG", "CHH")
    kw = dict(FORCED, contexts=ctxs, gather_impl=gather_impl)
    devices = None
    if gather_impl == "pallas":
        kw["data_parallel"], devices = True, ["cpu", "cpu"]
    eng = CallEngine(CallConfig(**kw), devices=devices)
    shapes = {c: [tuple(p.shape) for p in eng.models.models[c].parameters()]
              for c in ctxs}
    assert shapes["CpG"] == shapes["CHG"] != shapes["CHH"]
    one = [True, True, False, False, True, True]   # CpG, CHG, CHH x strands
    assert warms == one * len(eng.devices)


# -- launch accounting ------------------------------------------------------

def _stub(per_run):
    """A counting stub kernel wrapper and a body that launches it
    `per_run` times a run, writing plan + 1 into out."""
    def kernel():
        kernel.launches += 1
    kernel.launches = 0
    runs = []

    def body(plan, out):
        runs.append(1)
        for _ in range(per_run):
            kernel()
        out.copy_((plan[:out.shape[0]] + 1).to(torch.uint8))
    return kernel, body, runs


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


#: stands in for a GraphPool (the stand-in capture does not read it)
_POOL = object()


def _fake_record(body, plan, out, pool, counters, warm):
    """Stands in for the card's warm-up and capture: the body runs once
    with its launches taken back out (the warm-up, when `warm`) and once
    more as a capture records it (its wrappers count), nothing runs at
    replay."""
    if warm:
        with programs.held_launches(counters):
            body(plan, out)
    body(plan, out)
    return _FakeGraph()


@pytest.mark.parametrize("per_run", [1, 3])
def test_capture_adds_nothing_and_replay_adds_the_body(monkeypatch,
                                                       per_run):
    monkeypatch.setattr(programs, "_record", _fake_record)
    kernel, body, runs = _stub(per_run)
    kernel.launches = 5                      # counts made before the build
    prog = programs.BatchProgram(body, 8, 4, "cpu", pool=_POOL,
                                 counters=(kernel,))
    assert kernel.launches == 5 and len(runs) == 2
    assert prog.launches == {kernel: per_run}
    out = torch.empty(4, dtype=torch.uint8)
    for i in range(3):
        prog(torch.full((8,), i, dtype=torch.int32), out)
    assert kernel.launches == 5 + 3 * per_run
    assert prog.graph.replays == 3 and len(runs) == 2   # the body never ran


@pytest.mark.parametrize("per_run", [1, 3])
def test_uncaptured_program_runs_its_body(per_run):
    """On the CPU (capture off) the build runs nothing and each call runs
    the body over the static buffers: it counts its own launches."""
    kernel, body, runs = _stub(per_run)
    prog = programs.BatchProgram(body, 8, 4, "cpu", counters=(kernel,))
    assert kernel.launches == 0 and not runs and prog.graph is None
    out = torch.empty(4, dtype=torch.uint8)
    for i in range(3):
        plan = torch.arange(8, dtype=torch.int32) + i
        prog(plan, out)
        assert torch.equal(prog.plan, plan)
        assert out.tolist() == [i + 1, i + 2, i + 3, i + 4]
    assert kernel.launches == 3 * per_run and len(runs) == 3


def test_failed_capture_raises(monkeypatch):
    """No fallback: a capture that fails raises out of the build."""
    def failing(*args):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(programs, "_record", failing)
    kernel, body, _ = _stub(1)
    with pytest.raises(RuntimeError, match="capture failed"):
        programs.BatchProgram(body, 8, 4, "cpu", pool=_POOL,
                              counters=(kernel,))
    assert kernel.launches == 0


def test_held_launches_takes_back_only_the_block():
    kernel, _, _ = _stub(1)
    other, _, _ = _stub(1)
    kernel.launches = 7
    with programs.held_launches((kernel, other)) as made:
        kernel()
        kernel()
    assert kernel.launches == 7 and other.launches == 0
    assert made == {kernel: 2}


def test_plan_views_are_contiguous_and_aligned():
    ngrp = 4
    plan = torch.arange(ngrp * (GROUP + 1), dtype=torch.int32)
    bases, rels = programs.plan_views(plan, ngrp)
    assert bases.is_contiguous() and rels.is_contiguous()
    assert tuple(rels.shape) == (ngrp, GROUP)
    assert rels[1, 0].item() == GROUP and bases[0].item() == ngrp * GROUP
    assert (bases.data_ptr() - plan.data_ptr()) % 128 == 0


# -- the persistent table ---------------------------------------------------

def _planes(rng, m):
    p = np.zeros((5, m), np.uint8)
    p[0] = rng.integers(0, 6, m)
    p[1:] = rng.integers(0, 256, (4, m))
    return torch.from_numpy(p)


def test_featurize_into_a_table():
    """out= gives the allocating call's table, written in place; the tail
    past the segments is zeroed over what an earlier flush left there."""
    rng = np.random.default_rng(3)
    cap = 4096
    table = torch.full((8, cap), 7.0)
    segs = [_planes(rng, 1024), _planes(rng, 1024)]
    got = featurize_planes_t_seg(segs, cap, out=table)
    assert got is table
    assert torch.equal(table, featurize_planes_t_seg(segs, cap))
    assert not table[:, 2048:].any()
    assert torch.equal(featurize_planes_seg([torch.cat(segs, 1)], cap),
                       table.T)
    for bad in (torch.empty(8, cap + 1), torch.empty(8, cap,
                                                     dtype=torch.float64),
                torch.empty(cap, 8).T):
        with pytest.raises(ValueError, match="out must be"):
            featurize_planes_t_seg(segs, cap, out=bad)


def test_call_sites_group_into_out():
    rng = np.random.default_rng(4)
    eng = CallEngine(CallConfig(**FORCED))
    model = eng.models.models["CpG"]
    table = featurize_planes_t_seg([_planes(rng, 4096)], 8192)
    bases = torch.tensor([0, 1024], dtype=torch.int32)
    rels = torch.from_numpy(rng.integers(0, 1024, (2, GROUP)).astype(np.int32))
    out = torch.empty(2 * GROUP, dtype=torch.uint8)
    for rev in (False, True):
        got = call_sites_group(model, table, bases, rels, rev, eng.kmer,
                               out=out)
        assert got is out
        assert torch.equal(out, call_sites_group(model, table, bases, rels,
                                                 rev, eng.kmer))


def test_two_flushes_give_their_own_results(tmp_path):
    """Reads A, a flush, reads B, the last flush: one engine's persistent
    table serves both flushes (same storage), and each read's record
    equals a fresh engine's over its own read set."""
    rng = np.random.default_rng(9)
    set_a = [make_kinetics_read(rng, f"a{i}", 900, flag=16 if i else 4)
             for i in range(2)]
    set_b = [make_kinetics_read(rng, f"b{i}", 1100, flag=4 if i else 16)
             for i in range(2)]
    cfg = CallConfig(**{**FORCED, "flush_bases": 0, "flush_ramp": ()})
    eng = CallEngine(cfg)
    ptr = eng._tables[0].data_ptr()
    done: list = []
    for rec in BamReader(_bam(tmp_path, set_a, "a.bam")):
        eng.add_read(rec, done)
    eng.flush(done)
    first = eng._tables[0].clone()
    for rec in BamReader(_bam(tmp_path, set_b, "b.bam")):
        eng.add_read(rec, done)
    eng.finalize(done)
    assert eng.flushes == 2 and eng._tables[0].data_ptr() == ptr
    assert not torch.equal(first, eng._tables[0])
    got = {r.qname: _tag_bytes(r) for r in done}
    assert len(got) == 4
    for name, recs in (("a", set_a), ("b", set_b)):
        path = str(tmp_path / f"{name}.out.bam")
        run_call(_bam(tmp_path, recs, f"{name}2.bam"), path, cfg)
        for r in BamReader(path):
            assert got[r.qname] == _tag_bytes(r), r.qname


def _tag_bytes(rec):
    mm, ml, mn = (rec.get_tag(t) for t in ("MM", "ML", "MN"))
    assert mm is not None
    return mm, bytes(np.asarray(ml[1][1], np.uint8)), mn


def test_run_call_releases_its_engine(tmp_path, monkeypatch):
    """run_call releases its engine once the run is done (on the card the
    graphs, tables and cached blocks go; on the CPU release is a no-op and
    the programs stay)."""
    released = []
    release = CallEngine.release

    def spy(eng):
        release(eng)
        released.append(eng._programs is not None)

    monkeypatch.setattr(CallEngine, "release", spy)
    run_call(_bam(tmp_path, _reads(5, n=3)), str(tmp_path / "out.bam"),
             CallConfig(**FORCED))
    assert released == [True]
