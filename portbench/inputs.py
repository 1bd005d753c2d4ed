"""Seeded HiFi read pools, their BGZF/BAM encoding, and the streamed input
that feeds `call` for a fixed number of seconds.

A traffic file (traffic/<name>.json) gives the parameters one generator
reads:

- ``n_reads`` and ``length``: the read lengths are the quantiles of a
  log-normal of median ``median`` and shape ``sigma`` at (i + 0.5) / n,
  clipped to [``min``, ``max``], so every seed draws the same set of
  lengths and only their order differs;
- ``composition``: A, C, G, T probabilities of an i.i.d. sequence, and
  optionally ``cg_keep``: the share of C->G steps kept, which turns it into
  a first-order Markov chain whose C row has P(G|C) = cg_keep * P(G) and
  the rest of the row in proportion (CpG depletion);
- kinetics: fi, ri, fp and rp uniform u8 codeV1 bytes, fn = rn = 5.

The pool is encoded once into BGZF with zlib: a header block, then each
record's bytes compressed into blocks of its own, so the stream can stop
at any record boundary.  `PoolStream` serves the header once, then the
pool's records round after round until its deadline has passed, then the
BGZF EOF block; `served` counts the records it handed out, so output
record k came from pool read k % n_reads.

Nothing here imports the program: the pool is this benchmark's input.
"""
from __future__ import annotations

import statistics
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
#: payload bytes per BGZF block (htslib's limit, 64 KiB minus headroom)
BLOCK_PAYLOAD = 65280
BAM_MAGIC = b"BAM\x01"
HEADER_TEXT = "@HD\tVN:1.6\tSO:unknown\n"
KINETICS_TAGS = ("fi", "ri", "fp", "rp")
#: BAM 4-bit sequence codes of A, C, G, T
_NIBBLE = np.zeros(256, np.uint8)
for _b, _n in zip(b"ACGT", (1, 2, 4, 8)):
    _NIBBLE[_b] = _n


@dataclass
class Pool:
    """A seeded read pool: read i is seq[offsets[i]:offsets[i + 1]] (ASCII)
    with kinetics kin[:, offsets[i]:offsets[i + 1]] in the order fi, ri,
    fp, rp, all in the read's own (forward) orientation."""
    seq: np.ndarray          # (total,) u8 ASCII
    kin: np.ndarray          # (4, total) u8 codeV1
    offsets: np.ndarray      # (n + 1,) int64

    @property
    def n_reads(self) -> int:
        return len(self.offsets) - 1

    def read(self, i: int):
        a, b = self.offsets[i], self.offsets[i + 1]
        return self.seq[a:b], self.kin[:, a:b]

    def name(self, i: int) -> str:
        return f"pb/{i}/ccs"


def read_lengths(length: dict, n_reads: int) -> np.ndarray:
    """The log-normal quantile grid of `length` (median, sigma, min, max):
    the same n_reads lengths for every seed."""
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n_reads) for i in range(n_reads)])
    lens = np.rint(length["median"] * np.exp(length["sigma"] * z))
    return np.clip(lens, length["min"], length["max"]).astype(np.int64)


def draw_sequence(rng: np.random.Generator, n: int, composition,
                  cg_keep: float = 1.0) -> np.ndarray:
    """n ASCII bases: i.i.d. from `composition` (A, C, G, T), then every
    G that follows a C kept with probability cg_keep and otherwise redrawn
    from A, C, T in proportion.  A redrawn C exposes the next base to the
    same rule, so the loop runs until no C->G step is left undecided;
    every base's law depends only on the base before it (a first-order
    Markov chain)."""
    p = np.asarray(composition, np.float64)
    p = p / p.sum()
    seq = BASES[rng.choice(4, n, p=p)]
    if cg_keep >= 1.0:
        return seq
    q = p[[0, 1, 3]] / (1.0 - p[2])            # A, C, T without G
    todo = np.flatnonzero((seq[:-1] == ord("C")) & (seq[1:] == ord("G"))) + 1
    while len(todo):
        drop = todo[rng.random(len(todo)) >= cg_keep]
        seq[drop] = np.frombuffer(b"ACT", np.uint8)[
            rng.choice(3, len(drop), p=q)]
        # a G redrawn as C: the base after it now follows a C
        nxt = drop[seq[drop] == ord("C")] + 1
        nxt = nxt[nxt < n]
        todo = nxt[seq[nxt] == ord("G")]
    return seq


def make_pool(traffic: dict, seed: int) -> Pool:
    """The traffic file's read pool for `seed` (see the module notes)."""
    rng = np.random.default_rng(seed % 2**64)
    lens = rng.permutation(read_lengths(traffic["length"],
                                        traffic["n_reads"]))
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    seq = draw_sequence(rng, total, traffic["composition"],
                        traffic.get("cg_keep", 1.0))
    kin = rng.integers(0, 256, (4, total), dtype=np.uint8)
    return Pool(seq, kin, offsets)


# ---------------------------------------------------------------------------
# BAM and BGZF encoding


def header_bytes() -> bytes:
    text = HEADER_TEXT.encode()
    return (BAM_MAGIC + struct.pack("<i", len(text)) + text
            + struct.pack("<i", 0))


def record_bytes(name: str, seq: np.ndarray, kin: np.ndarray,
                 fn: int = 5, rn: int = 5) -> bytes:
    """One unmapped (flag 4) BAM record with qualities 40, the four
    kinetics arrays as B:C tags and fn/rn as C tags."""
    l_seq = len(seq)
    qname = name.encode() + b"\x00"
    nib = _NIBBLE[seq]
    if l_seq % 2:
        nib = np.append(nib, 0)
    packed = ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8)
    parts = [struct.pack("<iiBBHHHIiii", -1, -1, len(qname), 0, 4680, 0, 4,
                         l_seq, -1, -1, 0),
             qname, packed.tobytes(), np.full(l_seq, 40, np.uint8).tobytes()]
    for tag, arr in zip(KINETICS_TAGS, kin):
        parts.append(tag.encode() + b"BC" + struct.pack("<I", l_seq))
        parts.append(np.ascontiguousarray(arr, np.uint8).tobytes())
    parts.append(b"fnC" + bytes([fn]) + b"rnC" + bytes([rn]))
    body = b"".join(parts)
    return struct.pack("<I", len(body)) + body


def bgzf_block(payload: bytes, level: int = 1) -> bytes:
    """One BGZF block (a gzip member with the BC extra field)."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    data = co.compress(payload) + co.flush()
    bsize = len(data) + 25
    head = struct.pack("<4BI2BH2BHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                       ord("B"), ord("C"), 2, bsize)
    return head + data + struct.pack("<II", zlib.crc32(payload),
                                     len(payload) & 0xFFFFFFFF)


def bgzf_compress(data: bytes, level: int = 1) -> bytes:
    """`data` as consecutive BGZF blocks (no EOF block)."""
    return b"".join(bgzf_block(data[o:o + BLOCK_PAYLOAD], level)
                    for o in range(0, len(data), BLOCK_PAYLOAD))


def encode_pool(pool: Pool, threads: int = 4) -> list[bytes]:
    """Each read's record as BGZF blocks of its own (zlib releases the
    interpreter lock, so the reads compress on `threads` threads)."""
    def one(i):
        s, k = pool.read(i)
        return bgzf_compress(record_bytes(pool.name(i), s, k))
    with ThreadPoolExecutor(max_workers=threads) as ex:
        return list(ex.map(one, range(pool.n_reads)))


class PoolStream:
    """A readable BGZF BAM stream over an encoded pool: the header, then
    the records round after round, then the EOF block.

    The records stop at the first record boundary after `deadline`
    (`start(seconds)` sets it from now) or after `limit` records,
    whichever comes first.  `read` is what BgzfReader calls, from one
    thread."""

    def __init__(self, blocks: list[bytes], limit: int | None = None):
        self._head = bgzf_compress(header_bytes())
        self._blocks = blocks
        self._limit = limit
        self._deadline = float("inf")
        self._buf = memoryview(self._head)
        self._next = 0            # index of the next record to queue
        self.served = 0           # records handed out whole
        self._ended = False

    def start(self, seconds: float) -> None:
        self._deadline = time.perf_counter() + seconds

    def _refill(self) -> bool:
        """Queue the next record, or the EOF block once the stream is
        over; False when nothing is left."""
        if self._ended:
            return False
        if self._next > 0:
            self.served += 1
        done = (self._limit is not None and self._next >= self._limit) or \
            time.perf_counter() >= self._deadline
        if done:
            self._ended = True
            self._buf = memoryview(BGZF_EOF)
            return True
        self._buf = memoryview(self._blocks[self._next % len(self._blocks)])
        self._next += 1
        return True

    def read(self, n: int = -1) -> bytes:
        out = []
        want = n if n is not None and n >= 0 else float("inf")
        while want > 0:
            if not len(self._buf):
                if not self._refill():
                    break
                continue
            take = int(min(want, len(self._buf)))
            out.append(self._buf[:take].tobytes())
            self._buf = self._buf[take:]
            want -= take
        return b"".join(out)

    def readable(self) -> bool:
        return True
