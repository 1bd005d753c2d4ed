"""`sample`: random subsampling of an unmapped kinetics BAM to a target
genome coverage.

Replicates subsample_bam.cpp: pass 1 indexes valid reads (>= 5 kb with all
four kinetics arrays), shuffles, marks reads until genome_size * coverage
bases are selected; pass 2 re-reads the BAM and writes the selected records.
"""
from __future__ import annotations

import numpy as np

from ..features.read_decode import decode_read
from ..io.bam import BamReader, BamWriter
from ..io.fasta import FastaDatabase
from ..utils.logging import bytes_to_datasize, log

MIN_READ_LEN = 5000


def run_sample(reference_path: str, input_bam: str, coverage: int,
               output_bam: str, io_threads: int = 8,
               seed: int | None = None) -> dict:
    db = FastaDatabase(reference_path)
    target = db.num_bases * coverage

    reader = BamReader(input_bam, threads=io_threads)
    valid = []
    lengths = []
    n = 0
    for rec in reader:
        ok = rec.l_seq >= MIN_READ_LEN and decode_read(rec) is not None
        valid.append(ok)
        lengths.append(rec.l_seq)
        n += 1
        if n % 100000 == 0:
            log("%10d reads processed", n)
    reader.close()
    valid = np.asarray(valid, bool)
    lengths = np.asarray(lengths, np.int64)
    total_bases = int(lengths[valid].sum())
    log("DB size: %s", bytes_to_datasize(db.num_bases))
    log("coverage: %d, target size: %s", coverage, bytes_to_datasize(target))
    log("BAM size: %s", bytes_to_datasize(total_bases))

    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    selected = np.zeros(n, bool)
    acc = 0
    for idx in order:
        if not valid[idx]:
            continue
        acc += int(lengths[idx])
        selected[idx] = True
        if acc >= target:
            break

    reader = BamReader(input_bam, threads=io_threads)
    writer = BamWriter(output_bam, reader.header, threads=io_threads)
    extracted_reads = 0
    extracted_bases = 0
    for i, rec in enumerate(reader):
        if selected[i]:
            writer.write(rec)
            extracted_reads += 1
            extracted_bases += rec.l_seq
    writer.close()
    reader.close()

    log("Target: %s", bytes_to_datasize(target))
    log("Extracted reads: %d (%s)", extracted_reads,
        bytes_to_datasize(extracted_bases))
    return {"reads": extracted_reads, "bases": extracted_bases}
