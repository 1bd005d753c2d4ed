"""The port's `extract-features` and host window extractor against the JAX
package's.

Tolerances: none.  On a seeded mapped kinetics BAM (forward and reverse
reads with mismatches, indels and soft clips, a read on a second
chromosome, an unmapped, a secondary and a short read, and a read without
kinetics) the .features, .samples and .offsets files of CpG, CHG and CHH
are byte-equal to the JAX run_extract_features', and extract_site_features
is bit-equal to the JAX one.
"""
import os

import numpy as np
import pytest

from hifimeth_tpu.features.extract import \
    extract_site_features as jax_extract_site_features
from hifimeth_tpu.tools.extract_features import \
    run_extract_features as jax_run_extract_features
from hifimeth_tpu_torch.cli import main
from hifimeth_tpu_torch.features.extract import extract_site_features
from hifimeth_tpu_torch.features.read_decode import decode_read
from hifimeth_tpu_torch.io.bam import (BamHeader, BamReader, BamRecord,
                                       BamWriter)
from hifimeth_tpu_torch.tools.extract_features import run_extract_features

KINETICS = ("fi", "fp", "ri", "rp")
SUFFIXES = ("features", "samples", "offsets")


def _aligned(rng, genome: str, length: int):
    """(stored sequence, CIGAR, position) of a read of about `length` bases
    aligned to `genome` with mismatches, insertions, deletions and soft
    clips."""
    pos = int(rng.integers(0, len(genome) - length - 100))
    stored, cig = [], []

    def op(n, c):
        if cig and cig[-1][1] == c:
            cig[-1] = (cig[-1][0] + n, c)
        else:
            cig.append((n, c))

    if rng.random() < 0.5:
        n = int(rng.integers(1, 10))
        stored.append("".join(rng.choice(list("ACGT"), n)))
        op(n, "S")
    gi = pos
    while sum(len(s) for s in stored) < length:
        r = rng.random()
        if r < 0.8:
            n = int(rng.integers(10, 60))
            stored.append(genome[gi:gi + n])
            op(n, "M")
            gi += n
        elif r < 0.9:
            stored.append(rng.choice([c for c in "ACGT" if c != genome[gi]]))
            op(1, "M")
            gi += 1
        elif r < 0.95:
            n = int(rng.integers(1, 4))
            stored.append("".join(rng.choice(list("ACGT"), n)))
            op(n, "I")
        else:
            n = int(rng.integers(1, 4))
            op(n, "D")
            gi += n
    if rng.random() < 0.5:
        n = int(rng.integers(1, 10))
        stored.append("".join(rng.choice(list("ACGT"), n)))
        op(n, "S")
    return "".join(stored), "".join(f"{n}{c}" for n, c in cig), pos


def _record(rng, name, seq, cigar, pos, refid, flag, kinetics=True):
    rec = BamRecord(qname=name, flag=flag, refid=refid, pos=pos, mapq=60)
    rec.set_seq(seq.encode())
    rec.set_cigar_str(cigar)
    if kinetics:
        for t in KINETICS:
            rec.set_tag(t, "B", ("C", rng.integers(0, 256, rec.l_seq)
                                 .astype(np.uint8)))
        rec.set_tag("fn", "C", int(rng.integers(1, 20)))
        rec.set_tag("rn", "C", int(rng.integers(1, 20)))
    return rec


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two chromosomes, 14 mapped reads of 1.1-1.6 kb (flags 0 and 16) and
    the odd ones out, labels on every C/G (0%, 100% or partial)."""
    tmp = tmp_path_factory.mktemp("extract")
    rng = np.random.default_rng(11)
    genomes = {"c1": "".join(rng.choice(list("ACGT"), 9000)),
               "c2": "".join(rng.choice(list("ACGT"), 5000))}
    fasta = tmp / "ref.fa"
    fasta.write_text("".join(f">{n}\n{g}\n" for n, g in genomes.items()))
    recs = []
    for i in range(14):
        chrom = "c2" if i == 5 else "c1"
        seq, cigar, pos = _aligned(rng, genomes[chrom],
                                   int(rng.integers(1100, 1600)))
        recs.append(_record(rng, f"rd{i}", seq, cigar, pos,
                            1 if chrom == "c2" else 0,
                            16 if i % 3 == 1 else 0))
    seq, cigar, pos = _aligned(rng, genomes["c1"], 1200)
    recs.append(_record(rng, "secondary", seq, cigar, pos, 0, 256))
    recs.append(_record(rng, "bare", seq, cigar, pos, 0, 0, kinetics=False))
    seq, cigar, pos = _aligned(rng, genomes["c1"], 300)
    recs.append(_record(rng, "short", seq, cigar, pos, 0, 0))
    unmapped = BamRecord(qname="unmapped", flag=4)
    unmapped.set_seq(b"ACGT" * 300)
    recs.sort(key=lambda r: (r.refid, r.pos))
    recs.append(unmapped)
    bam = tmp / "k.bam"
    hdr = BamHeader("@HD\tVN:1.6\tSO:coordinate\n",
                    [(n, len(g)) for n, g in genomes.items()])
    with BamWriter(str(bam), hdr) as w:
        for r in recs:
            w.write(r)
    rows = []
    for n, g in genomes.items():
        for i, ch in enumerate(g):
            if ch in "CG":
                kind = i % 5
                pc, nc = ((12, 0), (0, 12), (6, 6), (3, 2), (30, 0))[kind]
                rows.append(f"{n}\t{i}\t{i + 1}\t{100 * pc // (pc + nc)}\t"
                            f"{pc}\t{nc}")
    bed = tmp / "labels.bed"
    bed.write_text("\n".join(rows) + "\n")
    return str(fasta), str(bed), str(bam), tmp


def _read_files(prefix):
    out = []
    for s in SUFFIXES:
        with open(f"{prefix}.{s}", "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("ctx", ["CpG", "CHG", "CHH"])
def test_extract_features_files_equal_jax(world, ctx):
    fasta, bed, bam, tmp = world
    mine, theirs = str(tmp / f"port.{ctx}"), str(tmp / f"jax.{ctx}")
    res = run_extract_features(fasta, ctx, bed, bam, mine, min_read_size=1000)
    want = jax_run_extract_features(fasta, ctx, bed, bam, theirs,
                                    min_read_size=1000)
    assert res == want
    assert res["reads"] == 14 and res["positives"] and res["negatives"]
    assert _read_files(mine) == _read_files(theirs)


def test_extract_site_features_bit_equal(world):
    """Every read of the BAM, sites at random offsets on both strands,
    near and over both read edges."""
    _, _, bam, _ = world
    rng = np.random.default_rng(5)
    n = 0
    for rec in BamReader(bam):
        if (read := decode_read(rec)) is None:
            continue
        last = read
        offs = np.concatenate([[0, 1, read.size - 1],
                               rng.integers(0, read.size, 40)])
        strands = rng.integers(0, 2, len(offs)).astype(np.uint8)
        for kmer in (401, 41):
            got = extract_site_features(read, offs, strands, kmer)
            want = jax_extract_site_features(read, offs, strands, kmer)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
        n += 1
    assert n == 16          # every record with kinetics
    assert extract_site_features(last, [], []).shape == (0, 401, 8)


def test_cli_extract_features(world, capsys):
    fasta, bed, bam, tmp = world
    prefix = str(tmp / "cli")
    assert main(["extract-features", fasta, "cpg", bed, bam, prefix]) == 0
    jax_run_extract_features(fasta, "CpG", bed, bam, str(tmp / "jax.cli"))
    assert _read_files(prefix) == _read_files(str(tmp / "jax.cli"))
    capsys.readouterr()
    assert main(["extract-features", fasta, "CpG", bed, bam]) == 1
    assert "USAGE" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="Illegal 5mc context"):
        main(["extract-features", fasta, "CpA", bed, bam, prefix])
