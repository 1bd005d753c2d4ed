"""The port's host tools (`cov2bed`, `corr`, `sample`, `eval`,
`read-level-eval`) against the golden corpus and the JAX package's tools.

Every comparison here is exact: output files byte-equal, returned numbers
equal.  Seeded inputs come from numpy (tests/test_pileup.py's
make_mapped_mod_bam, tests/util.py's make_kinetics_read).
"""
import glob
import os

import numpy as np
import pytest

from hifimeth_tpu.tools.corr import run_corr as jax_run_corr
from hifimeth_tpu.tools.cov2bed import run_cov2bed as jax_run_cov2bed
from hifimeth_tpu.tools.evaltool import run_eval as jax_run_eval
from hifimeth_tpu.tools.read_level_metrics import \
    run_read_level_eval as jax_run_read_level_eval
from hifimeth_tpu.tools.sample import run_sample as jax_run_sample
from hifimeth_tpu_torch.cli import main
from hifimeth_tpu_torch.io import native
from hifimeth_tpu_torch.tools.corr import run_corr
from hifimeth_tpu_torch.tools.cov2bed import run_cov2bed
from hifimeth_tpu_torch.tools.evaltool import run_eval
from hifimeth_tpu_torch.tools.read_level_metrics import run_read_level_eval
from hifimeth_tpu_torch.tools.sample import run_sample

from test_pileup import make_mapped_mod_bam
from util import make_kinetics_read, write_bam

DATA = os.path.join(os.path.dirname(__file__), "data")


def _p(name):
    return os.path.join(DATA, name)


@pytest.mark.parametrize("impl", ["native", "numpy"])
@pytest.mark.parametrize("ctx", ["CpG", "CHG", "CHH"])
def test_cov2bed_golden(tmp_path, monkeypatch, impl, ctx):
    if impl == "numpy":
        monkeypatch.setattr(native, "_LIB", False)
    out = tmp_path / f"c.{ctx}.bed"
    run_cov2bed(_p("golden_ref.fa"), ctx, _p("golden_bismark.cov"), str(out))
    assert out.read_bytes() == open(_p(f"golden_cov2bed.{ctx}.bed"),
                                    "rb").read()


def test_cov2bed_unsorted_rows_equal_jax(tmp_path):
    """Rows out of position order take the row loop in both packages."""
    lines = open(_p("golden_bismark.cov")).read().splitlines(True)
    rng = np.random.default_rng(4)
    cov = tmp_path / "shuffled.cov"
    cov.write_text("".join(lines[i] for i in rng.permutation(len(lines))
                           if lines[i].split("\t")[0] == lines[0].split("\t")[0]))
    for ctx in ("CpG", "CHG", "CHH"):
        run_cov2bed(_p("golden_ref.fa"), ctx, str(cov), str(tmp_path / "a"))
        jax_run_cov2bed(_p("golden_ref.fa"), ctx, str(cov), str(tmp_path / "b"))
        assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


def test_corr_golden_and_jax(capsys):
    bed1, bed2 = _p("golden_pileup.CpG.cov.bed"), _p("golden_cov2bed.CpG.bed")
    r = run_corr(bed1, bed2, min_cov=1)
    ours = capsys.readouterr()
    # golden_corr.txt is the value written as f"{r:.10f}\n"
    assert f"{r:.10f}\n" == open(_p("golden_corr.txt")).read()
    assert r == jax_run_corr(bed1, bed2, min_cov=1)
    theirs = capsys.readouterr()
    assert ours.out == theirs.out
    assert main(["corr", "-c", "1", bed1, bed2]) == 0
    assert f"correlation: {r:g}" in capsys.readouterr().err


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_corr_min_cov_equals_jax(tmp_path, monkeypatch, impl):
    if impl == "numpy":
        monkeypatch.setattr(native, "_LIB", False)
    rng = np.random.default_rng(6)
    rows = [[], []]
    for k in range(400):
        for f in range(2):
            p, n = (int(x) for x in rng.integers(0, 9, 2))
            rows[f].append(f"c{k % 3}\t{k}\t{k + 1}\t0\t{p}\t{n}\n")
    paths = []
    for f in range(2):
        paths.append(str(tmp_path / f"b{f}.bed"))
        open(paths[-1], "w").write("".join(rows[f]))
    for min_cov in (1, 5, 12):
        assert run_corr(*paths, min_cov) == jax_run_corr(*paths, min_cov)


def test_sample_equals_jax(tmp_path):
    rng = np.random.default_rng(5)
    fasta = tmp_path / "r.fa"
    fasta.write_text(">c1\n" + "ACGT" * 2500 + "\n")   # 10 kb genome
    recs = [make_kinetics_read(rng, f"r{i}", 6000) for i in range(30)]
    recs.append(make_kinetics_read(rng, "short", 1000))   # < 5 kb
    nok = make_kinetics_read(rng, "nokin", 6000)
    for t in ("fi", "ri", "fp", "rp"):
        nok.del_tag(t)
    recs.append(nok)
    in_bam = tmp_path / "in.bam"
    write_bam(in_bam, recs)
    for seed in (1, 2):
        a, b = tmp_path / f"a{seed}.bam", tmp_path / f"b{seed}.bam"
        ours = run_sample(str(fasta), str(in_bam), 3, str(a), seed=seed)
        theirs = jax_run_sample(str(fasta), str(in_bam), 3, str(b), seed=seed)
        assert ours == theirs and ours["reads"] == 5
        assert a.read_bytes() == b.read_bytes()
    assert main(["sample", str(fasta), str(in_bam), "1",
                 str(tmp_path / "c.bam")]) == 0


def _eval_input(tmp_path, seed, n_reads):
    rng = np.random.default_rng(seed)
    fasta, bam, chroms, _ = make_mapped_mod_bam(tmp_path, rng,
                                                n_reads=n_reads)
    bed = tmp_path / "labels.bed"
    rows = []
    for name, seq in chroms.items():
        for i, ch in enumerate(seq):
            if ch in "CG" and i % 3 != 2:
                rows.append(f"{name}\t{i}\t{i + 1}\t"
                            + ("100\t12\t0" if i % 2 else "0\t0\t12"))
    bed.write_text("\n".join(rows) + "\n")
    return str(fasta), str(bed), str(bam)


def _files(pattern):
    return {os.path.basename(f).split(".", 1)[1]: open(f, "rb").read()
            for f in sorted(glob.glob(pattern))}


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_eval_equals_jax(tmp_path, monkeypatch, impl):
    if impl == "numpy":
        monkeypatch.setattr(native, "_LIB", False)
    fasta, bed, bam = _eval_input(tmp_path, 21, 40)
    ours = run_eval(fasta, bed, bam, str(tmp_path / "t"), seed=0,
                    replicates=2)
    theirs = jax_run_eval(fasta, bed, bam, str(tmp_path / "j"), seed=0,
                          replicates=2)
    assert ours == theirs
    got = _files(str(tmp_path / "t.*"))
    assert got and got == _files(str(tmp_path / "j.*"))


def test_eval_workers_equal_jax_workers(tmp_path):
    """workers > 1 (a spawned pool over read shards) in both packages:
    equal thresholds and pool sizes (the seeds per shard match)."""
    fasta, bed, bam = _eval_input(tmp_path, 41, 30)
    ours = run_eval(fasta, bed, bam, str(tmp_path / "t"), seed=3,
                    replicates=1, workers=2)
    theirs = jax_run_eval(fasta, bed, bam, str(tmp_path / "j"), seed=3,
                          replicates=1, workers=2)
    assert ours == theirs
    assert _files(str(tmp_path / "t.*")) == _files(str(tmp_path / "j.*"))
    assert main(["eval", "-t", "1", fasta, bed, bam,
                 str(tmp_path / "c")]) == 0


def test_read_level_eval_equals_jax(tmp_path, capsys):
    rng = np.random.default_rng(3)
    for i in range(3):
        rows = []
        for _ in range(300):
            label = int(rng.integers(0, 2))
            prob = np.clip(label * 0.6 + rng.random() * 0.5, 0, 1)
            rows.append(f"{label}\t{1 if prob >= 0.5 else 0}\t{prob:g}")
        (tmp_path / f"ev.{i}").write_text("\n".join(rows) + "\n")
    ours = run_read_level_eval(str(tmp_path / "ev"), 3)
    out = capsys.readouterr().out
    assert ours == jax_run_read_level_eval(str(tmp_path / "ev"), 3)
    assert out == capsys.readouterr().out
    assert main(["read-level-eval", str(tmp_path / "ev"), "3"]) == 0
    assert out == capsys.readouterr().out


def test_cli_host_commands_usage(capsys):
    for cmd in ("corr", "cov2bed", "sample", "eval", "read-level-eval",
                "merge-shards", "merge-pileup-shards"):
        assert main([cmd]) == 1, cmd
        assert "USAGE" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["corr", "--bogus", "a", "b"])
