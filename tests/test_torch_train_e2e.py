"""End-to-end proof that the port's training pipeline learns: a copy of
tests/test_train_e2e.py on hifimeth_tpu_torch, on the CPU.

Synthesizes a world with a learnable kinetics signal - IPD/PW saturated in a
+-3 bp window around methylated genomic CpG sites - then runs the full
production loop the reference ran to produce its shipped models
(the reference's training/train.py:29-101, sample_dataset.py:122-136):

    extract-features (aligned kinetics BAM + BS-seq labels -> blob)
    -> train (SGD recipe, small kmer)
    -> fold to inference params
    -> `call` on HELD-OUT reads through the port's engine
    -> read-level eval (midrank AUC)

and asserts the held-out AUC above 0.9, with every step the port's own
(no module of the JAX package runs).  kmer 81 keeps the train steps small.
"""
import numpy as np
import pytest

from hifimeth_tpu_torch.engine.call import CallConfig, run_call
from hifimeth_tpu_torch.features.read_decode import native_fwd_seq
from hifimeth_tpu_torch.io.bam import (BamHeader, BamRecord, BamReader,
                                       BamWriter)
from hifimeth_tpu_torch.io.mmtags import parse_mod_tags_flat
from hifimeth_tpu_torch.tools.extract_features import run_extract_features
from hifimeth_tpu_torch.tools.read_level_metrics import roc_auc
from hifimeth_tpu_torch.train.data import load_feature_blob
from hifimeth_tpu_torch.train.trainer import TrainConfig, train_context

pytestmark = pytest.mark.slow

GLEN = 40000
RLEN = 1500
KMER = 81


def _kinetics_for(rng, meth, pos, L):
    """Native-forward kinetics with IPD/PW elevated around methylated Cs."""
    ks = [rng.integers(20, 90, L).astype(np.uint8) for _ in range(4)]
    for q in np.flatnonzero(meth[pos:pos + L]):
        lo, hi = max(0, q - 3), min(L, q + 4)
        for a in ks:
            a[lo:hi] = np.minimum(a[lo:hi].astype(np.int32) + 120, 255)
    return ks


def _write_reads(rng, genome, meth, path, n, mapped, tag):
    hdr = (BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", GLEN)])
           if mapped else BamHeader("@HD\tVN:1.6\tSO:unknown\n", []))
    poss = np.sort(rng.integers(0, GLEN - RLEN, n))
    with BamWriter(path, hdr, threads=4, level=1) as w:
        for i, pos in enumerate(poss):
            if mapped:
                rec = BamRecord(qname=f"{tag}{i}", flag=0, refid=0,
                                pos=int(pos), mapq=60)
                rec.set_cigar_str(f"{RLEN}M")
            else:
                rec = BamRecord(qname=f"{tag}{i}", flag=4)
            rec.set_seq(genome[pos:pos + RLEN].tobytes())
            fi, fp, ri, rp = _kinetics_for(rng, meth, int(pos), RLEN)
            for t, arr in (("fi", fi), ("fp", fp), ("ri", ri), ("rp", rp)):
                rec.set_tag(t, "B", ("C", arr))
            rec.set_tag("fn", "C", 5)
            rec.set_tag("rn", "C", 5)
            w.write(rec)
    return poss


def test_port_trainer_learns_end_to_end(tmp_path):
    rng = np.random.default_rng(5)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), GLEN)
    cpg = np.flatnonzero((genome[:-1] == ord("C")) & (genome[1:] == ord("G")))
    meth = np.zeros(GLEN, bool)
    meth[cpg[rng.random(len(cpg)) < 0.5]] = True

    fasta = tmp_path / "ref.fa"
    with open(fasta, "w") as f:
        f.write(">chr1\n")
        g = genome.tobytes().decode()
        for i in range(0, GLEN, 70):
            f.write(g[i:i + 70] + "\n")
    # BS-seq ground truth in the converted-BED format eval consumes
    # (cov >= 10, 0%/100% only -> labeled; eval.cpp:104-111 semantics)
    bed = tmp_path / "labels.bed"
    with open(bed, "w") as f:
        for p in cpg:
            if meth[p]:
                f.write(f"chr1\t{p}\t{p + 1}\t100\t12\t0\tCG\n")
            else:
                f.write(f"chr1\t{p}\t{p + 1}\t0\t0\t12\tCG\n")

    train_bam = tmp_path / "train.bam"
    held_bam = tmp_path / "held.bam"
    _write_reads(rng, genome, meth, str(train_bam), 40, mapped=True, tag="t")
    held_pos = _write_reads(rng, genome, meth, str(held_bam), 10,
                            mapped=False, tag="h")

    # 1) extract-features: aligned BAM + labels -> reference blob triplet
    run_extract_features(str(fasta), "CpG", str(bed), str(train_bam),
                         str(tmp_path / "blob"), min_read_size=500)
    blob = load_feature_blob(str(tmp_path / "blob.features"),
                             str(tmp_path / "blob.samples"),
                             str(tmp_path / "blob.offsets"))
    assert blob.n_samples > 1000
    assert 0.3 < blob.labels.mean() < 0.7      # both classes present

    # 2) train with the reference SGD recipe (small kmer), fold to inference
    model_dir = tmp_path / "models"
    model_dir.mkdir()
    cfg = TrainConfig(kmer=KMER, batch_size=128, epochs=4, log_every=50,
                      ckpt_every=10 ** 9, device="cpu")
    res = train_context(blob, cfg, str(model_dir / "CpG.npz"))
    (model_dir / "kmer.txt").write_text(str(KMER))
    assert res["final_acc"] is not None and res["final_acc"] > 0.9

    # 3) call HELD-OUT reads through the production engine
    out_bam = tmp_path / "held_out.bam"
    run_call(str(held_bam), str(out_bam),
             CallConfig(model_dir=str(model_dir), contexts=("CpG",),
                        min_read_size=500, buffer_bases=1 << 16,
                        site_batch=512, device="cpu"))

    # 4) read-level eval: midrank AUC of called probs vs genomic truth
    y, p = [], []
    for i, rec in enumerate(BamReader(str(out_bam))):
        fwd = native_fwd_seq(rec)
        qoffs, _strands, _codes, probs = parse_mod_tags_flat(rec, fwd)
        pos = held_pos[i]
        for q, pr in zip(qoffs, probs):
            y.append(bool(meth[pos + q]))
            p.append(pr / 255.0)
    y, p = np.asarray(y), np.asarray(p)
    assert len(y) > 500
    auc = roc_auc(y, p)
    assert auc > 0.9, f"held-out AUC {auc:.4f}: the trainer did not learn"
