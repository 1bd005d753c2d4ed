"""`extract-features`: build training feature blobs from an aligned kinetics
BAM and BS-seq ground-truth labels.

The reference trains from pre-assembled binary blobs (sample_dataset.py:55-75)
whose producer it does not ship; this tool closes that gap.  For each
primary aligned read with kinetics it packs the 5 per-base planes (2-bit
codes, fi, fp, ri, rp; the reverse tracks re-indexed to forward coordinates,
the blob's convention and features/read_decode.py's), maps the candidate
sites of the context to the genome by alignment-exact motif matching
(quant/mapping.py), labels them from a converted BS-seq BED (cov >= 10, 0%
-> 0 / 100% -> 1, as eval.cpp:104-111), and writes the
features/samples/offsets triplet that `train` reads (train/data.py): the
same bytes as the JAX package's extract-features.
"""
from __future__ import annotations

from ..features.read_decode import decode_read
from ..io.bam import BamReader
from ..io.fasta import FastaDatabase
from ..quant.alignment import expand_alignment
from ..quant.mapping import map_chg_sites, map_chh_sites, map_cpg_sites
from ..tools.evaltool import load_bismark_labels
from ..utils.logging import log

_MAPPERS = {"CPG": map_cpg_sites, "CHG": map_chg_sites, "CHH": map_chh_sites}


def run_extract_features(reference_path: str, context: str,
                         bismark_bed_path: str, bam_path: str,
                         output_prefix: str, min_read_size: int = 1000,
                         io_threads: int = 8) -> dict:
    ctx = context.upper()
    if ctx not in _MAPPERS:
        raise SystemExit(f"Illegal 5mc context: {context}")
    mapper = _MAPPERS[ctx]

    db = FastaDatabase(reference_path)
    reader = BamReader(bam_path, threads=io_threads)
    hdr = reader.header
    labels = load_bismark_labels(dict(hdr.refs), bismark_bed_path)

    qid = 0
    base_off = 0
    n_pos = n_neg = 0
    with open(f"{output_prefix}.features", "wb") as feat_f, \
            open(f"{output_prefix}.samples", "w") as samp_f, \
            open(f"{output_prefix}.offsets", "w") as offs_f:
        for rec in reader:
            if rec.is_unmapped or rec.is_secondary_or_supplementary:
                continue
            if rec.l_seq < min_read_size:
                continue
            read = decode_read(rec)
            if read is None:
                continue
            aln = expand_alignment(rec, db, hdr.tid2name(rec.refid))
            if aln is None:
                continue
            mq, ms = mapper(aln)
            if len(mq) == 0:
                continue
            lab = labels[hdr.tid2name(rec.refid)][ms]
            keep = lab != -1
            mq, lab = mq[keep], lab[keep]
            if len(mq) == 0:
                continue

            # blob layout: 5 planes of qsize bytes (codes, fi, fp, ri, rp),
            # all forward-coordinate (sample_dataset.py:89-95 with ri/rp
            # forward-indexed)
            for plane in (read.codes, read.fi, read.fp, read.ri, read.rp):
                feat_f.write(plane.tobytes())
            for qoff, l in zip(mq, lab):
                samp_f.write(f"{qid}\t{qoff}\t{int(l)}\n")
            n_pos += int((lab == 1).sum())
            n_neg += int((lab == 0).sum())
            offs_f.write(f"{base_off}\t{qid}\t{read.size}\t{read.fn}\t"
                         f"{read.rn}\n")
            base_off += read.size
            qid += 1
            if qid % 10000 == 0:
                log("%10d reads, %d samples", qid, n_pos + n_neg)
    reader.close()
    log("wrote %d reads, %d positive / %d negative samples", qid, n_pos, n_neg)
    return {"reads": qid, "positives": n_pos, "negatives": n_neg}
