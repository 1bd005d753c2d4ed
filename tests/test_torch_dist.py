"""The port's scale-out on the CPU: read shards and their merge, the
data-parallel device split, --feat-channels, torch.distributed set-up and
its collectives, against the JAX package's same functions.

Tolerances: sharded + merged output is byte-equal to the unsharded port
run (every record, `BamRecord.to_bytes`); against the JAX package's
sharded + merged run, records in the same order with MM/MN byte-equal and
ML within the parity contract (+-1 u8, at most 5% of ML bytes off,
docs/PARITY.md), as PyTorch and XLA sum float32 in another order.  The
data-parallel pallas path is bit-equal to one device, as
tests/test_dist.py:91 holds the JAX engine; slice and folded are held to
MM equal and ML within +-1, as tests/test_dist.py:65 holds it.
`call --feat-channels` 32 and 128 warn and give records byte-equal to 8
channels (the port keeps the 8-channel table on every path).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from hifimeth_tpu.engine.call import CallConfig as JaxCallConfig
from hifimeth_tpu.engine.call import run_call as jax_run_call
from hifimeth_tpu.parallel import dist as jax_dist
from hifimeth_tpu_torch.engine.call import CallConfig, CallEngine, run_call
from hifimeth_tpu_torch.io.bam import BamReader
from hifimeth_tpu_torch.parallel import dist

from util import make_kinetics_read, write_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "models")
#: seconds a spawned rank may take (imports + a tiny run take ~5-10 s)
RANK_TIMEOUT = 120


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(args, world: int, tmp_path, extra_env=None):
    """`python ARGS` as ranks 0..world-1 of one torch.distributed group
    (torchrun's variables, a free port), each with its own timeout;
    returns their outputs, failing on a non-zero exit."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE=str(world),
               **(extra_env or {}))
    procs = [subprocess.Popen(
        [sys.executable, *args],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    return outs


def _records(path):
    return [r.to_bytes() for r in BamReader(str(path))]


def _tags(path):
    out = []
    for r in BamReader(str(path)):
        mm, ml, mn = (r.get_tag(t) for t in ("MM", "ML", "MN"))
        out.append((r.qname, mm[1] if mm else None,
                    ml[1][1].astype(int) if ml else None,
                    mn[1] if mn else None))
    return out


def _assert_contract(got, want, max_diff=1):
    assert [g[0] for g in got] == [w[0] for w in want]
    n_off = n_tot = 0
    for (name, mm, ml, mn), (_, wmm, wml, wmn) in zip(got, want):
        assert mm == wmm and mn == wmn, name
        assert (ml is None) == (wml is None), name
        if ml is not None:
            assert np.abs(ml - wml).max() <= max_diff, name
            n_off += int((ml != wml).sum())
            n_tot += len(ml)
    assert n_tot > 0
    assert n_off <= 0.05 * n_tot, f"{n_off}/{n_tot} ML bytes off"


def _input(tmp_path, seed, n, lo=1100, hi=1400):
    rng = np.random.default_rng(seed)
    recs = [make_kinetics_read(rng, f"r{i}", int(rng.integers(lo, hi)))
            for i in range(n)]
    recs.insert(3, make_kinetics_read(rng, "short", 400))
    path = tmp_path / "in.bam"
    write_bam(path, recs)
    return str(path), len(recs)


# -- ShardSpec, chromosome_ranges, init_distributed -------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shard_spec_and_chromosome_ranges_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(1, 9))
        pid = int(rng.integers(0, n))
        bs = int(rng.integers(1, 50))
        ours, theirs = dist.ShardSpec(pid, n, bs), jax_dist.ShardSpec(pid, n, bs)
        ids = rng.integers(0, 5000, 200)
        assert ([ours.owns_read(int(i)) for i in ids]
                == [theirs.owns_read(int(i)) for i in ids])
        n_chr = int(rng.integers(0, 40))
        assert (dist.chromosome_ranges(n_chr, ours)
                == jax_dist.chromosome_ranges(n_chr, theirs))
        assert (dist.shard_path("o.bam", ours)
                == jax_dist.shard_path("o.bam", theirs))
    # every read owned by exactly one process
    n = 3
    for r in range(200):
        assert sum(dist.ShardSpec(p, n, 7).owns_read(r) for p in range(n)) == 1


def test_init_distributed_without_variables(monkeypatch):
    import torch.distributed as tdist
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert dist.init_distributed("cpu") == dist.ShardSpec()
    assert not tdist.is_initialized()
    assert dist.backend_for("cuda") == "nccl"
    assert dist.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError):
        dist.backend_for("tpu")


# -- --shard and merge-shards ---------------------------------------------

def test_sharded_call_merges_to_unsharded_and_to_jax(tmp_path):
    """--shard 0/3..2/3 + merge_shard_bams: byte-equal to the unsharded port
    run; the same records, MM/MN and ML contract as the JAX package's
    sharded + merged run."""
    in_bam, n = _input(tmp_path, 0, 13)
    cfg = CallConfig(contexts=("CpG",), site_batch=128, device="cpu")
    single = tmp_path / "single.bam"
    run_call(in_bam, str(single), cfg, cmdline="t")
    base = str(tmp_path / "out.bam")
    specs = [dist.ShardSpec(p, 3, batch_size=2) for p in range(3)]
    for spec in specs:
        stats = run_call(in_bam, base, cfg, cmdline="t", shard=spec)
        assert stats["reads"] == sum(spec.owns_read(i) for i in range(n))
    merged = tmp_path / "merged.bam"
    assert dist.merge_shard_bams(
        str(merged), [dist.shard_path(base, s) for s in specs],
        batch_size=2) == n
    assert _records(merged) == _records(single)

    jcfg = JaxCallConfig(contexts=("CpG",), site_batch=128,
                         gather_impl="folded")
    jbase = str(tmp_path / "jax.bam")
    jspecs = [jax_dist.ShardSpec(p, 3, batch_size=2) for p in range(3)]
    for spec in jspecs:
        jax_run_call(in_bam, jbase, jcfg, cmdline="t", shard=spec)
    jmerged = tmp_path / "jax_merged.bam"
    jax_dist.merge_shard_bams(
        str(jmerged), [jax_dist.shard_path(jbase, s) for s in jspecs],
        batch_size=2)
    _assert_contract(_tags(merged), _tags(jmerged))


def test_merge_shard_bams_byte_equal_to_jax_merge(tmp_path):
    """The port's merge of the port's shards equals the JAX package's merge
    of the same shard files, byte for byte (whole files)."""
    in_bam, n = _input(tmp_path, 4, 9)
    cfg = CallConfig(contexts=("CpG",), site_batch=64, device="cpu")
    base = str(tmp_path / "o.bam")
    paths = []
    for p in range(2):
        spec = dist.ShardSpec(p, 2, batch_size=3)
        run_call(in_bam, base, cfg, cmdline="t", shard=spec)
        paths.append(dist.shard_path(base, spec))
    a, b = tmp_path / "a.bam", tmp_path / "b.bam"
    assert dist.merge_shard_bams(str(a), paths, batch_size=3) == n
    assert jax_dist.merge_shard_bams(str(b), paths, batch_size=3) == n
    assert a.read_bytes() == b.read_bytes()


def test_cli_shard_and_merge_shards(tmp_path):
    from hifimeth_tpu_torch.cli import main
    in_bam, n = _input(tmp_path, 2, 7)
    out = str(tmp_path / "o.bam")
    common = ["call", "--device", "cpu", "-s", "64", "-c", "cpg"]
    assert main(common + [in_bam, out]) == 0
    for p in range(2):
        assert main(common + ["-b", "2", "--shard", f"{p}/2", in_bam,
                              out]) == 0
    # blocks of 10,000 reads whatever -b says, as the JAX CLI's: shard 0
    # holds every read, and a plain merge-shards restores the order
    counts = [len(_records(f"{out}.shard000{p}")) for p in range(2)]
    assert counts == [n, 0]
    merged = str(tmp_path / "m.bam")
    assert main(["merge-shards", merged, out + ".shard0000",
                 out + ".shard0001"]) == 0
    assert _records(merged) == _records(out)
    for bad in ("2/2", "x", "1/0"):
        with pytest.raises(SystemExit):
            main(common + ["--shard", bad, in_bam, out])


#: one rank of a sharded call: the shard from torchrun's variables, in
#: blocks of 3 reads so that both ranks hold reads
RANK_CALL = """
import dataclasses, sys
from hifimeth_tpu_torch.engine.call import CallConfig, run_call
from hifimeth_tpu_torch.parallel.dist import (init_distributed,
                                              shutdown_distributed)
spec = init_distributed("cpu")
try:
    run_call(sys.argv[1], sys.argv[2],
             CallConfig(device="cpu", site_batch=128,
                        contexts=("CpG", "CHH"), decode_workers=0),
             shard=dataclasses.replace(spec, batch_size=3))
finally:
    shutdown_distributed()
"""


def test_two_process_sharded_call(tmp_path):
    """Two processes of one gloo group (torchrun's variables) each call
    their read blocks; the merged shards are byte-equal to one process."""
    in_bam, n = _input(tmp_path, 61, 10, 1200, 2200)
    single = str(tmp_path / "single.bam")
    run_call(in_bam, single, CallConfig(device="cpu", site_batch=128,
                                        contexts=("CpG", "CHH"),
                                        decode_workers=0))
    out = str(tmp_path / "sharded.bam")
    outs = run_ranks(["-c", RANK_CALL, in_bam, out], 2, tmp_path)
    assert all("torch.distributed initialized (gloo)" in o for o in outs)
    merged = str(tmp_path / "merged.bam")
    assert min(len(_records(f"{out}.shard000{r}")) for r in range(2)) > 0
    assert dist.merge_shard_bams(merged, [out + ".shard0000",
                                          out + ".shard0001"],
                                 batch_size=3) == n
    assert _records(merged) == _records(single)


# -- --data-parallel --------------------------------------------------------

def _dp_input(tmp_path):
    rng = np.random.default_rng(5)
    recs = [make_kinetics_read(rng, f"r{i}", 1200 + 111 * i,
                               flag=16 if i % 2 else 4) for i in range(7)]
    path = tmp_path / "in.bam"
    write_bam(path, recs)
    return str(path)


@pytest.mark.parametrize("impl", ["pallas", "slice", "folded"])
def test_data_parallel_over_four_cpu_replicas(tmp_path, impl):
    """pallas bit-equal to one device (several fill-through flushes, so the
    segment cut runs against the replicated segments); slice and folded MM
    equal and ML within +-1."""
    in_bam = _dp_input(tmp_path)
    kw = dict(site_batch=128, gather_impl=impl, buffer_bases=1 << 15,
              flush_bases=3000, device="cpu")
    one, four = tmp_path / "one.bam", tmp_path / "four.bam"
    run_call(in_bam, str(one), CallConfig(**kw))
    stats_json = str(tmp_path / "stats.json")
    run_call(in_bam, str(four), CallConfig(data_parallel=True,
                                           stats_json=stats_json, **kw),
             devices=["cpu"] * 4)
    import json
    with open(stats_json) as f:
        assert json.load(f)["config"]["devices"] == ["cpu"] * 4
    if impl == "pallas":
        assert _records(four) == _records(one)
    else:
        _assert_contract(_tags(four), _tags(one))


def test_data_parallel_engine_rules(tmp_path, capsys):
    """fused warns and runs on one device; one local device is the
    single-device path; replicas of one device share one read-only model
    set (ModelSet.cached) and have their own plane segments; a device list
    needs data_parallel."""
    eng = CallEngine(CallConfig(gather_impl="fused", data_parallel=True,
                                contexts=("CpG",), device="cpu"),
                     devices=["cpu"] * 2)
    assert eng.devices == [eng.device] and not eng.cfg.data_parallel
    assert "not supported with gather_impl=fused" in capsys.readouterr().err
    eng = CallEngine(CallConfig(data_parallel=True, contexts=("CpG",),
                                device="cpu"))
    assert len(eng.devices) == 1
    assert "single-device path" in capsys.readouterr().err
    eng = CallEngine(CallConfig(data_parallel=True, contexts=("CpG",),
                                device="cpu"), devices=["cpu"] * 3)
    w = [r.models["CpG"].convs[0].weight for r in eng.replicas]
    assert len({t.data_ptr() for t in w}) == 1
    segs = eng._ship(np.zeros((5, 64), np.uint8))
    assert len({t.data_ptr() for t, _ in segs}) == 3
    with pytest.raises(ValueError, match="data_parallel"):
        CallEngine(CallConfig(device="cpu", contexts=("CpG",)),
                   devices=["cpu"])


def test_cli_data_parallel(tmp_path):
    from hifimeth_tpu_torch.cli import main
    in_bam = _dp_input(tmp_path)
    a, b = str(tmp_path / "a.bam"), str(tmp_path / "b.bam")
    common = ["call", "--device", "cpu", "-s", "128", "-c", "cpg"]
    assert main(common + [in_bam, a]) == 0
    assert main(common + ["--data-parallel", in_bam, b]) == 0
    assert _records(a) == _records(b)


# -- --feat-channels --------------------------------------------------------

@pytest.mark.parametrize("channels", [32, 128])
def test_feat_channels_tags_equal_eight(tmp_path, capsys, channels):
    from hifimeth_tpu_torch.cli import main
    rng = np.random.default_rng(77)
    recs = [make_kinetics_read(rng, f"r{i}", 1300, flag=16 if i % 2 else 4)
            for i in range(4)]
    in_bam = tmp_path / "in.bam"
    write_bam(in_bam, recs)
    common = ["call", "--device", "cpu", "-s", "256", "-c", "cpg,chh",
              "--gather-impl", "slice"]
    a, b = str(tmp_path / "a.bam"), str(tmp_path / "b.bam")
    assert main(common + [str(in_bam), a]) == 0
    assert "--feat-channels is ignored" not in capsys.readouterr().err
    assert main(common + ["--feat-channels", str(channels), str(in_bam),
                          b]) == 0
    assert "--feat-channels is ignored" in capsys.readouterr().err
    assert _records(a) == _records(b)


def test_feat_channels_ignored_off_slice(capsys):
    """Every path takes --feat-channels {8,32,128} into
    CallConfig.feat_channels (the parsed configuration equals the one
    without the flag but for that field), and its engine warns when it is
    not 8 and keeps 8 channels."""
    import dataclasses

    from hifimeth_tpu_torch.cli import _parse_call
    for impl in ("slice", "pallas", "folded", "fused"):
        plain, pos, shard = _parse_call(["--gather-impl", impl, "-c", "cpg",
                                         "--device", "cpu", "a.bam", "b.bam"])
        assert plain.feat_channels == 8
        for channels in ("8", "32", "128"):
            got = _parse_call(["--gather-impl", impl, "-c", "cpg",
                               "--device", "cpu", "--feat-channels",
                               channels, "a.bam", "b.bam"])
            assert got == (dataclasses.replace(
                plain, feat_channels=int(channels)), pos, shard)
            assert "--feat-channels" not in capsys.readouterr().err
            eng = CallEngine(got[0])
            assert eng.cfg.feat_channels == 8
            assert got[0].feat_channels == int(channels)   # not mutated
            err = capsys.readouterr().err
            assert ("--feat-channels is ignored" in err) == (channels != "8")
    from hifimeth_tpu_torch.cli import main
    with pytest.raises(SystemExit):
        main(["call", "--feat-channels", "16", "a.bam", "b.bam"])


# -- collectives ------------------------------------------------------------

def test_collectives_in_a_one_rank_gloo_group():
    """The three cross-process reductions in a one-process group: the
    identity, with int64 sums and int32 SUM/MAX."""
    import torch.distributed as tdist
    from hifimeth_tpu_torch.parallel import collectives as col
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                             world_size=1, rank=0)
    try:
        rng = np.random.default_rng(8)
        bins = rng.integers(0, 1 << 40, (3, 256))
        np.testing.assert_array_equal(col.psum_histograms_multihost(bins), bins)
        flags = rng.integers(0, 2, 7)
        np.testing.assert_array_equal(col.psum_i64_multihost(flags), flags)
        p, n, m = (rng.integers(0, 1 << 20, 1000).astype(np.int32)
                   for _ in range(3))
        gp, gn, gm = col.psum_site_partials_multihost(p, n, m)
        for got, want in ((gp, p), (gn, n), (gm, m)):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    finally:
        tdist.destroy_process_group()
