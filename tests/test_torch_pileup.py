"""The port's `pileup` (one process, the spawned worker pool, and one
process per rank of a gloo group) and its host support (FASTA, MM/ML
parsing, BED rows) against the golden corpus and the JAX package.

Every comparison here is exact: BED files byte-equal, histograms,
thresholds and parsed arrays equal.  The mapped mod-BAMs come from a numpy
seed through tests/test_pileup.py's make_mapped_mod_bam.
"""
import os

import numpy as np
import pytest

from hifimeth_tpu.io.fasta import FastaDatabase as JaxFasta
from hifimeth_tpu.io.mmtags import parse_mod_tags_flat as jax_parse_flat
from hifimeth_tpu.quant.pileup import PileupConfig as JaxPileupConfig
from hifimeth_tpu.quant.pileup import run_pileup as jax_run_pileup
from hifimeth_tpu.quant.pileup import \
    run_pileup_parallel as jax_run_pileup_parallel
from hifimeth_tpu_torch.features.read_decode import native_fwd_seq
from hifimeth_tpu_torch.io import native
from hifimeth_tpu_torch.io.bam import BamReader
from hifimeth_tpu_torch.io.fasta import FastaDatabase
from hifimeth_tpu_torch.io.mmtags import ModTagError, parse_mod_tags_flat
from hifimeth_tpu_torch.quant import pileup
from hifimeth_tpu_torch.quant.pileup import (PileupConfig,
                                             merge_pileup_shards, run_pileup,
                                             run_pileup_parallel)

from test_pileup import make_mapped_mod_bam
from test_torch_dist import run_ranks

DATA = os.path.join(os.path.dirname(__file__), "data")
CTXS = ("CpG", "CHG", "CHH")


def _beds(prefix):
    return {c: open(f"{prefix}.{c}.cov.bed", "rb").read() for c in CTXS}


@pytest.fixture
def no_native(monkeypatch):
    """Every native entry point reports the library unavailable: the numpy
    fallbacks run."""
    monkeypatch.setattr(native, "_LIB", False)


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_pileup_golden_beds(tmp_path, request, impl):
    if impl == "numpy":
        request.getfixturevalue("no_native")
    prefix = str(tmp_path / "p")
    run_pileup(os.path.join(DATA, "golden_ref.fa"),
               os.path.join(DATA, "golden_mapped.bam"), prefix,
               spill_dir=str(tmp_path))
    for ctx, got in _beds(prefix).items():
        want = open(os.path.join(DATA, f"golden_pileup.{ctx}.cov.bed"),
                    "rb").read()
        assert got == want, f"{ctx} pileup BED differs from the golden"


@pytest.mark.parametrize("seed,cfg", [
    (9, {}), (17, {}), (23, {"min_mapq": 30}), (29, {"min_identity": 95.0})])
def test_pileup_equals_jax(tmp_path, seed, cfg):
    rng = np.random.default_rng(seed)
    fasta, bam, _, _ = make_mapped_mod_bam(tmp_path, rng, n_reads=30)
    ours = run_pileup(str(fasta), str(bam), str(tmp_path / "t"),
                      PileupConfig(**cfg), spill_dir=str(tmp_path))
    theirs = jax_run_pileup(str(fasta), str(bam), str(tmp_path / "j"),
                            JaxPileupConfig(**cfg), spill_dir=str(tmp_path))
    np.testing.assert_array_equal(ours["bins"], theirs["bins"])
    assert ours["thresholds"] == theirs["thresholds"]
    assert ours["reads"] == theirs["reads"]
    assert ours["bed_rows"] == theirs["bed_rows"]
    assert _beds(tmp_path / "t") == _beds(tmp_path / "j")
    # no spill file is left behind
    assert not [f for f in os.listdir(tmp_path)
                if f.startswith("read_base_mods_")]


def test_pileup_parallel_equals_one_process(tmp_path):
    """Spawned pool: pass 1 over 3 read shards, pass 2 over position spans
    (the genome is split into one span per worker when it is large enough:
    a 1 Mb chromosome here); byte-equal to one process and to the JAX
    package's run_pileup_parallel."""
    rng = np.random.default_rng(17)
    fasta, bam, chroms, _ = make_mapped_mod_bam(tmp_path, rng, n_reads=30)
    one = run_pileup(str(fasta), str(bam), str(tmp_path / "one"),
                     spill_dir=str(tmp_path))
    par = run_pileup_parallel(str(fasta), str(bam), str(tmp_path / "par"),
                              workers=3, spill_dir=str(tmp_path))
    assert _beds(tmp_path / "one") == _beds(tmp_path / "par")
    np.testing.assert_array_equal(one["bins"], par["bins"])
    theirs = jax_run_pileup_parallel(str(fasta), str(bam), str(tmp_path / "j"),
                                     workers=3, spill_dir=str(tmp_path))
    assert _beds(tmp_path / "j") == _beds(tmp_path / "par")
    assert theirs["thresholds"] == par["thresholds"]
    # the spans path of pass 2: chrA grown past the serial cut-off (the
    # reads map into its first 2.5 kb, as before)
    tail = "".join(np.random.default_rng(1).choice(list("ACGT"), 1 << 20))
    big = tmp_path / "big.fa"
    big.write_text(f">chrA\n{chroms['chrA']}{tail}\n>chrB\n{chroms['chrB']}\n")
    one = run_pileup(str(big), str(bam), str(tmp_path / "bone"),
                     spill_dir=str(tmp_path))
    par = run_pileup_parallel(str(big), str(bam), str(tmp_path / "bpar"),
                              workers=3, spill_dir=str(tmp_path))
    assert one["bed_rows"] > 0
    assert _beds(tmp_path / "bone") == _beds(tmp_path / "bpar")


def _shared_fs_shards(run, merge, shard_spec, fasta, bam, tmp_path, name):
    """Two processes over a shared filesystem, simulated in turn (the JAX
    package's tests/test_dist.py recipe): each shard's pass 1 with its
    spill kept, the histograms summed, then each shard's pass 2 over its
    own spill and the other's, and the shard BEDs merged."""
    harvest = [run(str(fasta), str(bam), str(tmp_path / f"{name}h{pid}"),
                   spill_dir=str(tmp_path), shard=shard_spec(pid, 2, 3),
                   keep_spill=True) for pid in range(2)]
    bins = harvest[0]["bins"] + harvest[1]["bins"]
    prefix = str(tmp_path / name)
    for pid in range(2):
        run(str(fasta), str(bam), prefix, spill_dir=str(tmp_path),
            shard=shard_spec(pid, 2, 3), bins_reduce=lambda local: bins,
            extra_spill_paths=[harvest[1 - pid]["spill_path"]])
    merge(prefix, 2)
    return harvest, bins, prefix


def test_shared_filesystem_shards_equal_one_process_and_jax(tmp_path):
    from hifimeth_tpu.parallel.dist import ShardSpec as JaxShardSpec
    from hifimeth_tpu.quant.pileup import \
        merge_pileup_shards as jax_merge_pileup_shards
    from hifimeth_tpu_torch.parallel.dist import ShardSpec

    rng = np.random.default_rng(9)
    fasta, bam, _, _ = make_mapped_mod_bam(tmp_path, rng, n_reads=30)
    one = run_pileup(str(fasta), str(bam), str(tmp_path / "one"),
                     spill_dir=str(tmp_path))
    assert one["spill_path"] is None and one["bed_rows"] > 0
    harvest, bins, prefix = _shared_fs_shards(
        run_pileup, merge_pileup_shards, ShardSpec, fasta, bam, tmp_path,
        "sh")
    assert all(os.path.exists(h["spill_path"]) for h in harvest)
    assert all(h["reads"] > 0 for h in harvest)
    np.testing.assert_array_equal(bins, one["bins"])
    assert _beds(prefix) == _beds(tmp_path / "one")
    _, jbins, jprefix = _shared_fs_shards(
        jax_run_pileup, jax_merge_pileup_shards, JaxShardSpec, fasta, bam,
        tmp_path, "jsh")
    np.testing.assert_array_equal(bins, jbins)
    assert _beds(prefix) == _beds(jprefix)
    # only the four kept spills (two per package) are left behind
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("read_base_mods_")]) == 4


def test_spawned_workers_never_touch_cuda(tmp_path):
    """The pool is spawned with the cards hidden, and a worker's pileup
    imports no torch at all."""
    rng = np.random.default_rng(5)
    fasta, bam, _, _ = make_mapped_mod_bam(tmp_path, rng, n_reads=10)
    run_pileup_parallel(str(fasta), str(bam), str(tmp_path / "p"),
                        workers=2, spill_dir=str(tmp_path))
    pool = pileup._get_worker_pool(2)
    state = pool.apply_async(eval, ("(__import__('os').environ.get("
                                    "'CUDA_VISIBLE_DEVICES'), 'torch' in "
                                    "__import__('sys').modules)",)).get(60)
    assert state == ("", False)


def test_two_process_gloo_pileup_and_merge(tmp_path):
    """`pileup --device cpu` as two ranks of a gloo group: the histogram
    all-reduce and the collective pass 2, then `merge-pileup-shards`:
    byte-equal to the one-process run."""
    from hifimeth_tpu_torch.cli import main
    rng = np.random.default_rng(31)
    fasta, bam, _, _ = make_mapped_mod_bam(tmp_path, rng, n_reads=30)
    run_pileup(str(fasta), str(bam), str(tmp_path / "single"),
               spill_dir=str(tmp_path))
    prefix = str(tmp_path / "mh")
    outs = run_ranks(["-m", "hifimeth_tpu_torch", "pileup", "--device",
                      "cpu", "-t", "1", str(fasta), str(bam), prefix], 2,
                     tmp_path)
    assert all("torch.distributed initialized (gloo)" in o for o in outs)
    assert open(prefix + ".chroms").read() == "chrA\nchrB\n"
    assert main(["merge-pileup-shards", prefix, "2"]) == 0
    assert _beds(prefix) == _beds(tmp_path / "single")


def test_pileup_rejects_unsorted_like_jax(tmp_path, capsys):
    from hifimeth_tpu_torch.io.bam import BamHeader, BamWriter
    rng = np.random.default_rng(3)
    fasta, bam, _, recs = make_mapped_mod_bam(tmp_path, rng, n_reads=5)
    hdr = BamReader(str(bam)).header
    unsorted = tmp_path / "u.bam"
    with BamWriter(str(unsorted), BamHeader("@HD\tVN:1.6\tSO:unsorted\n",
                                            hdr.refs)) as w:
        for r in BamReader(str(bam)):
            w.write(r)
    for fn in (run_pileup, run_pileup_parallel, jax_run_pileup):
        with pytest.raises(SystemExit):
            fn(str(fasta), str(unsorted), str(tmp_path / "x"))
        assert "BAM is not sorted" in capsys.readouterr().err


def test_cli_pileup_one_process(tmp_path):
    from hifimeth_tpu_torch.cli import main
    prefix = str(tmp_path / "c")
    assert main(["pileup", "-q", "0", "-f", "0", "-t", "2",
                 os.path.join(DATA, "golden_ref.fa"),
                 os.path.join(DATA, "golden_mapped.bam"), prefix]) == 0
    for ctx, got in _beds(prefix).items():
        assert got == open(os.path.join(
            DATA, f"golden_pileup.{ctx}.cov.bed"), "rb").read()
    assert main(["pileup", "ref.fa"]) == 1
    with pytest.raises(SystemExit):
        main(["pileup", "--device", "tpu", "a", "b", "c"])


def test_merge_pileup_shards_interleaves_like_jax(tmp_path):
    from hifimeth_tpu.quant.pileup import \
        merge_pileup_shards as jax_merge_pileup_shards
    rng = np.random.default_rng(12)
    names = [f"c{i}" for i in range(5)]
    for ctx in CTXS:
        for s in range(3):
            with open(tmp_path / f"x.{ctx}.cov.bed.shard{s:04d}", "w") as f:
                for c in names[s::3]:
                    for k in sorted(rng.integers(0, 100, 4).tolist()):
                        f.write(f"{c}\t{k}\t{k + 1}\t50\t1\t1\n")
    (tmp_path / "x.chroms").write_text("\n".join(names) + "\n")
    merge_pileup_shards(str(tmp_path / "x"), 3)
    ours = _beds(tmp_path / "x")
    jax_merge_pileup_shards(str(tmp_path / "x"), 3)
    assert ours == _beds(tmp_path / "x")
    assert ours["CpG"].decode().split("\t", 1)[0] == "c0"


# -- host support copies ------------------------------------------------------

def test_fasta_database_equals_jax(tmp_path):
    fa = tmp_path / "r.fa.gz"
    import gzip
    with gzip.open(fa, "wt") as f:
        f.write("# comment\n>chr1 desc\nacgtNNac\nGT\n;x\nchr|2\nAC\n"
                ">3\n\n>empty\n")
    ours, theirs = FastaDatabase(str(fa)), JaxFasta(str(fa))
    assert ours.names == theirs.names == ["chr1", "chr|2", "3", "empty"]
    for sid in range(ours.num_seqs):
        np.testing.assert_array_equal(ours.seq_bases(sid),
                                      theirs.seq_bases(sid))
    assert ours.seq_name2id("3") == 2
    with pytest.raises(KeyError):
        ours.seq_name2id("nope")
    (tmp_path / "d.fa").write_text(">a\nAC\n>a\nGT\n")
    with pytest.raises(ValueError, match="Duplicate"):
        FastaDatabase(str(tmp_path / "d.fa"))


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_parse_mod_tags_flat_equals_jax(tmp_path, request, impl):
    if impl == "numpy":
        request.getfixturevalue("no_native")
    rng = np.random.default_rng(41)
    fasta, bam, _, _ = make_mapped_mod_bam(tmp_path, rng, n_reads=20)
    from hifimeth_tpu.io.bam import BamReader as JaxReader
    n = 0
    for ours, theirs in zip(BamReader(str(bam)), JaxReader(str(bam))):
        a = parse_mod_tags_flat(ours, native_fwd_seq(ours))
        from hifimeth_tpu.features.read_decode import \
            native_fwd_seq as jax_fwd
        b = jax_parse_flat(theirs, jax_fwd(theirs))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        n += len(a[0])
    assert n > 0
    # general SAM syntax: ChEBI code, '.'/'?' flags, a two-code series
    rec = next(iter(BamReader(str(bam))))
    seq = native_fwd_seq(rec)
    nc = int((seq == ord("C")).sum())
    rec.set_tag("MM", "Z", "C+27551,0,1;C+mh.,0;")
    rec.set_tag("ML", "B", ("C", np.arange(4, dtype=np.uint8)))
    q, s, c, p = parse_mod_tags_flat(rec, seq)
    assert bytes(c).decode() == "mmmh" and p.tolist() == [0, 1, 2, 3]
    assert nc > 2
    for mm in ("C+m,0,x;", "C+m,0", "X+m,0;", "C+g,0;", f"C+m,{nc};"):
        rec.set_tag("MM", "Z", mm)
        with pytest.raises(ModTagError):
            parse_mod_tags_flat(rec, seq)


def test_bed_rows_native_equals_fallback(tmp_path):
    rng = np.random.default_rng(2)
    size = 5000
    pcov = rng.integers(0, 30, size).astype(np.int32)
    ncov = rng.integers(0, 30, size).astype(np.int32)
    motif_map = rng.integers(0, 4, size).astype(np.uint8)
    motif_map[rng.random(size) < 0.2] = 255

    def rows(path, native_ok):
        saved = native._LIB
        if not native_ok:
            native._LIB = False
        try:
            with open(path, "wb") as f:
                for m in range(3):
                    pileup.write_bed_rows(f, "chr1", pcov, ncov, motif_map, m,
                                          span=(100, 4000) if m == 1 else None)
        finally:
            native._LIB = saved
        return open(path, "rb").read()

    assert rows(tmp_path / "a", True) == rows(tmp_path / "b", False)
