"""`eval`: read-level benchmark sample extraction.

Replicates eval.cpp:
 1. adaptive thresholds from a full mod-BAM histogram pass (same algorithm
    as pileup, eval.cpp:118-305)
 2. ground-truth labels from a converted BS-seq BED: cov >= 10 and freq 0%
    (label 0, pcov==0) or 100% (label 1, ncov==0) (eval.cpp:42-114)
 3. pass over the mod-BAM matching aligned sites to labeled loci per context
   (eval.cpp:469-578; CHH negatives downsampled to 10%)
 4. oversample any class below 100k by replication (eval.cpp:349-442)
 5. write 5 shuffled eval files of 100k positives + 100k negatives, rows
    `label predict prob` (eval.cpp:580-611)
"""
from __future__ import annotations

import sys

import numpy as np

from ..features.read_decode import native_fwd_seq
from ..io.bam import BamReader
from ..io.fasta import FastaDatabase
from ..io.mmtags import parse_mod_tags_flat
from ..quant.alignment import expand_alignment
from ..quant.mapping import map_chg_sites, map_chh_sites, map_cpg_sites
from ..quant.pileup import classify_read_mods
from ..quant.threshold import resolve_threshold
from ..utils.logging import log

TARGET_SAMPLES = 100_000
_C, _G = ord("C"), ord("G")


def load_bismark_labels(db_sizes: dict[str, int], bed_path: str):
    """Per-chromosome int8 label arrays: -1 unlabeled, 0 unmethylated,
    1 methylated (eval.cpp:42-114)."""
    labels = {name: np.full(size, -1, np.int8) for name, size in db_sizes.items()}
    np_, nn = 0, 0
    from ..io import native
    if native.available():
        from ..utils.lines import read_bytes
        names, chrid, start, end, pcov, ncov = native.scan_bed6(
            read_bytes(bed_path), skip_short=False)
        if np.any(end - start != 1):
            i = int(np.flatnonzero(end - start != 1)[0])
            raise ValueError(
                f"label BED must have end-start==1: "
                f"{names[chrid[i]]}:{start[i]}-{end[i]}")
        # label only fully un/methylated loci (0%/100%) with cov >= 10;
        # partial rows stay -1 (eval.cpp:42-114)
        keep = (pcov + ncov >= 10) & ((pcov == 0) | (ncov == 0))
        for i, nm in enumerate(names):
            arr = labels.get(nm)
            if arr is None:
                continue
            m = keep & (chrid == i)
            s, p = start[m], pcov[m]
            # row order preserved: duplicate positions resolve last-wins,
            # as in the sequential loop below
            arr[s] = (p != 0).astype(np.int8)
            np_ += int((p != 0).sum())
            nn += int((p == 0).sum())
        log("Load %d methylated sites and %d unmethylated sites from %s",
            np_, nn, bed_path)
        return labels
    from ..utils.lines import open_text
    with open_text(bed_path) as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 6:
                raise ValueError(f"corrupted bismark record {line!r}")
            soff = int(cols[1])
            if int(cols[2]) - soff != 1:
                raise ValueError(f"label BED must have end-start==1: {line!r}")
            pcov = int(cols[4])
            ncov = int(cols[5])
            if pcov + ncov < 10:
                continue
            arr = labels.get(cols[0])
            if arr is None:
                continue
            if pcov == 0:
                arr[soff] = 0
                nn += 1
            elif ncov == 0:
                arr[soff] = 1
                np_ += 1
    log("Load %d methylated sites and %d unmethylated sites from %s",
        np_, nn, bed_path)
    return labels


def compute_histogram_thresholds(mod_bam_path: str, io_threads: int = 8,
                                 shard=None):
    """Full-BAM histogram pass (eval.cpp:153-211): primary reads only."""
    bins = compute_histogram_bins(mod_bam_path, io_threads, shard)
    return (resolve_threshold(bins[0], "CpG"),
            resolve_threshold(bins[1], "CHG"),
            resolve_threshold(bins[2], "CHH"))


def compute_histogram_bins(mod_bam_path: str, io_threads: int = 8,
                           shard=None) -> np.ndarray:
    from ..parallel.dist import ShardSpec
    shard = shard or ShardSpec()
    bins = np.zeros((3, 256), np.int64)
    reader = BamReader(mod_bam_path, threads=io_threads)
    read_id = -1
    for rec in reader:
        read_id += 1
        if not shard.owns_read(read_id):
            continue
        if rec.is_secondary_or_supplementary:
            continue
        fwd_seq = native_fwd_seq(rec)
        qoffs, strands, codes, probs = parse_mod_tags_flat(rec, fwd_seq)
        if len(qoffs) == 0:
            continue
        keep = (fwd_seq[qoffs] == _C) | (fwd_seq[qoffs] == _G)
        cls = classify_read_mods(fwd_seq, qoffs[keep])
        pr = probs[keep]
        for m in range(3):
            sel = cls == m
            if sel.any():
                bins[m] += np.bincount(pr[sel], minlength=256)
    reader.close()
    return bins


def oversample(arr: np.ndarray, ctx: str, label: str,
               target: int = TARGET_SAMPLES) -> np.ndarray:
    """Replicate a class below target (eval.cpp:349-442): x = 2*(2*target//n)
    copies."""
    n = len(arr)
    if n == 0 or n >= target:
        return arr
    print(f"Original {ctx} {label} samples: {n}", file=sys.stderr)
    x = (2 * target // n) * 2
    out = np.tile(arr, x)
    print(f"Over-sampled {ctx} {label} samples: {len(out)}", file=sys.stderr)
    return out


def dump_samples(rng, pos: np.ndarray, neg: np.ndarray, threshold: int,
                 output_prefix: str, ctx: str, replicates: int = 5) -> None:
    # probs are u8: precompute all 256 row strings per label and join
    # (a per-row f-string + write() was ~70% of eval wall)
    tabs = {
        lab: np.array([f"{lab}\t{1 if v >= threshold else 0}\t{v / 255:g}\n"
                       for v in range(256)], dtype=object)
        for lab in (0, 1)
    }
    for i in range(replicates):
        path = f"{output_prefix}.{ctx}.{i}"
        with open(path, "w") as out:
            p = rng.permutation(pos)[:TARGET_SAMPLES]
            out.write("".join(tabs[1][np.asarray(p, np.uint8)]))
            n = rng.permutation(neg)[:TARGET_SAMPLES]
            out.write("".join(tabs[0][np.asarray(n, np.uint8)]))


def _sample_pass(reference_path, bismark_bed_path, mod_bam_path,
                 io_threads, seed, shard=None):
    """Label-matching pass over a read shard; returns the per-context
    positive/negative prob pools."""
    from ..parallel.dist import ShardSpec
    shard = shard or ShardSpec()
    db = FastaDatabase(reference_path, quiet=True)
    reader = BamReader(mod_bam_path, threads=io_threads)
    hdr = reader.header
    sizes = {name: length for name, length in hdr.refs}
    labels = load_bismark_labels(sizes, bismark_bed_path)

    rng = np.random.default_rng(seed)
    pools = {m: {0: [], 1: []} for m in range(3)}   # motif -> label -> probs

    read_id = -1
    for rec in reader:
        read_id += 1
        if not shard.owns_read(read_id):
            continue
        fwd_seq = native_fwd_seq(rec)
        qoffs, strands, codes, probs = parse_mod_tags_flat(rec, fwd_seq)
        if len(qoffs) == 0:
            continue
        aln = expand_alignment(rec, db, hdr.tid2name(rec.refid)) \
            if not rec.is_unmapped else None
        if aln is None:
            continue
        has_prob = np.zeros(rec.l_seq, bool)
        prob_at = np.zeros(rec.l_seq, np.uint8)
        m_mask = codes == ord("m")
        has_prob[qoffs[m_mask]] = True
        prob_at[qoffs[m_mask]] = probs[m_mask]
        chr_labels = labels[hdr.tid2name(rec.refid)]

        for motif, (mq, ms) in enumerate((
                map_cpg_sites(aln), map_chg_sites(aln), map_chh_sites(aln))):
            if len(mq) == 0:
                continue
            sel = has_prob[mq]
            mq, ms = mq[sel], ms[sel]
            lab = chr_labels[ms]
            keep = lab != -1
            mq, lab = mq[keep], lab[keep]
            pr = prob_at[mq]
            pos_sel = lab == 1
            pools[motif][1].append(pr[pos_sel])
            neg = pr[~pos_sel]
            if motif == 2 and len(neg):
                # CHH negatives downsampled to 10% (eval.cpp:562)
                neg = neg[rng.random(len(neg)) <= 0.1]
            pools[motif][0].append(neg)
    reader.close()
    return pools


def _eval_worker(args):
    kind, params = args
    if kind == "bins":
        return compute_histogram_bins(params[0], 2, params[1])
    return _sample_pass(*params)


def run_eval(reference_path: str, bismark_bed_path: str, mod_bam_path: str,
             output_prefix: str, io_threads: int = 8, seed: int | None = None,
             replicates: int = 5, workers: int = 1) -> dict:
    """Read-level benchmark extraction; workers > 1 fans both BAM passes out
    over local processes (the analog of the reference's 16-thread pool,
    eval.cpp:633-640)."""
    from ..parallel.dist import ShardSpec

    if workers > 1:
        import multiprocessing as mp

        from ..utils.system import worker_spawn_env
        ctx = mp.get_context("spawn")
        with worker_spawn_env():
            pool = ctx.Pool(workers)
        with pool:
            bin_parts = pool.map(_eval_worker, [
                ("bins", (mod_bam_path, ShardSpec(i, workers, 100)))
                for i in range(workers)])
            bins = np.sum(bin_parts, axis=0)
            thr = (resolve_threshold(bins[0], "CpG"),
                   resolve_threshold(bins[1], "CHG"),
                   resolve_threshold(bins[2], "CHH"))
            pool_parts = pool.map(_eval_worker, [
                ("samples", (reference_path, bismark_bed_path, mod_bam_path,
                             2, None if seed is None else seed + i,
                             ShardSpec(i, workers, 100)))
                for i in range(workers)])
        pools = {m: {0: [], 1: []} for m in range(3)}
        for part in pool_parts:
            for m in range(3):
                pools[m][0].extend(part[m][0])
                pools[m][1].extend(part[m][1])
    else:
        thr = compute_histogram_thresholds(mod_bam_path, io_threads)
        pools = _sample_pass(reference_path, bismark_bed_path, mod_bam_path,
                             io_threads, seed)

    rng = np.random.default_rng(seed)
    result = {}
    for motif, ctx in enumerate(("CpG", "CHG", "CHH")):
        pos = np.concatenate(pools[motif][1]) if pools[motif][1] else np.empty(0, np.uint8)
        neg = np.concatenate(pools[motif][0]) if pools[motif][0] else np.empty(0, np.uint8)
        pos = oversample(pos, ctx, "positive")
        neg = oversample(neg, ctx, "negative")
        result[ctx] = (len(pos), len(neg))
        if len(pos) and len(neg):
            print(f"{ctx} positive samples: {len(pos)}, negative samples: "
                  f"{len(neg)}", file=sys.stderr)
            dump_samples(rng, pos, neg, thr[motif], output_prefix, ctx,
                         replicates)
    result["thresholds"] = thr
    return result
