"""Training dataset over the reference feature-blob format.

Format (sample_dataset.py:55-75): a flat u8 `features` file holding, per
read, 5 planes of qsize bytes each in order [2-bit base codes, fi, fp, ri,
rp] (ri/rp already re-indexed to forward coordinates); a TSV `offsets` file
with rows (offset, id, size, fn, rn) where `offset` is the cumulative base
count; a `samples` file with rows (qid, qoff, label).

A copy of the JAX package's train/data.py (numpy only): one seed gives the
same synthetic blob in both packages, and both read and write the same
files.  Batches are cut from the blob on the trainer's device by
features/windows.gather_and_featurize.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import FWD, REV

INPUT_PLANES = 5


@dataclass
class FeatureBlob:
    planes_t: np.ndarray     # (total_bases, 5) u8, read-major
    read_start: np.ndarray   # (n_reads,) i64 base offset of each read
    read_size: np.ndarray    # (n_reads,) i64
    qids: np.ndarray         # (n_samples,) i64
    qoffs: np.ndarray        # (n_samples,) i64
    labels: np.ndarray       # (n_samples,) i32 in {0, 1}

    @property
    def n_samples(self) -> int:
        return len(self.qids)

    def site_arrays(self, idx: np.ndarray):
        """(centers, strands, rstart, rend, labels) for sample indices."""
        qid = self.qids[idx]
        start = self.read_start[qid]
        centers = (start + self.qoffs[idx]).astype(np.int32)
        codes = self.planes_t[centers, 0]
        # center base decides strand: C (code 1) -> FWD, G (code 2) -> REV
        # (sample_dataset.py:97-99,122-134)
        bad = ~np.isin(codes, (1, 2))
        if bad.any():
            raise ValueError(
                f"{int(bad.sum())} samples whose center base is not C/G")
        strands = np.where(codes == 1, FWD, REV).astype(np.uint8)
        rstart = start.astype(np.int32)
        rend = (start + self.read_size[qid]).astype(np.int32)
        return centers, strands, rstart, rend, self.labels[idx]


def load_feature_blob(features_path: str, samples_path: str,
                      offsets_path: str) -> FeatureBlob:
    raw = np.fromfile(features_path, dtype=np.uint8)
    if raw.size % INPUT_PLANES:
        raise ValueError("features file size not a multiple of 5")
    offsets = np.loadtxt(offsets_path, dtype=np.int64, delimiter="\t", ndmin=2)
    read_off = offsets[:, 0]
    read_size = offsets[:, 2]
    total = int((read_off[-1] + read_size[-1]))
    if total * INPUT_PLANES != raw.size:
        raise ValueError("offsets table inconsistent with features file size")
    # file layout is per-read plane-major; re-pack to read-major (pos, plane)
    planes_t = np.empty((total, INPUT_PLANES), np.uint8)
    for off, size in zip(read_off, read_size):
        blk = raw[off * INPUT_PLANES:(off + size) * INPUT_PLANES]
        planes_t[off:off + size] = blk.reshape(INPUT_PLANES, size).T
    samples = np.loadtxt(samples_path, dtype=np.int64, ndmin=2)
    labels = (samples[:, 2] > 0).astype(np.int32)
    return FeatureBlob(planes_t, read_off, read_size,
                       samples[:, 0], samples[:, 1], labels)


def save_feature_blob(blob: FeatureBlob, features_path: str,
                      samples_path: str, offsets_path: str) -> None:
    """Write the reference on-disk format (for interop and tests)."""
    with open(features_path, "wb") as f:
        for off, size in zip(blob.read_start, blob.read_size):
            f.write(blob.planes_t[off:off + size].T.tobytes())
    with open(offsets_path, "w") as f:
        for off, i, size in zip(blob.read_start, range(len(blob.read_start)),
                                blob.read_size):
            f.write(f"{off}\t{i}\t{size}\t-1\t-1\n")
    with open(samples_path, "w") as f:
        for qid, qoff, lab in zip(blob.qids, blob.qoffs, blob.labels):
            f.write(f"{qid}\t{qoff}\t{lab}\n")


def synthetic_blob(rng, n_reads: int = 20, read_len: int = 600,
                   n_samples: int = 512) -> FeatureBlob:
    """Random blob with a learnable signal: methylated sites get higher IPD."""
    total = n_reads * read_len
    planes_t = np.empty((total, 5), np.uint8)
    planes_t[:, 0] = rng.integers(0, 4, total)
    planes_t[:, 1:] = rng.integers(0, 128, (total, 4))
    read_start = np.arange(n_reads, dtype=np.int64) * read_len
    read_size = np.full(n_reads, read_len, np.int64)
    qids = rng.integers(0, n_reads, n_samples).astype(np.int64)
    qoffs = rng.integers(0, read_len, n_samples).astype(np.int64)
    labels = rng.integers(0, 2, n_samples).astype(np.int32)
    centers = read_start[qids] + qoffs
    planes_t[centers, 0] = np.where(rng.random(n_samples) < 0.5, 1, 2)
    # plant signal: labeled-positive sites get saturated kinetics around them
    for c, lab in zip(centers, labels):
        if lab:
            lo = max(0, c - 3)
            planes_t[lo:c + 4, 1:] = np.minimum(
                planes_t[lo:c + 4, 1:].astype(np.int32) + 120, 255)
    return FeatureBlob(planes_t, read_start, read_size, qids, qoffs, labels)
