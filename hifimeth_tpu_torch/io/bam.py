"""hts-free BAM reader/writer.

Replaces the htslib dependency of the reference (corelib/sam_batch.hpp,
bam_info.cpp) with a self-contained implementation: BGZF framing via
io/bgzf.py, BAM record (de)serialization here.  Records are parsed into a
mutable structure so the call pipeline can strip kinetics tags and attach
MM/ML/MN before re-serializing (reference: build_mod_bam.cpp:87-248).

Numpy is used for the per-base payloads (SEQ nibbles, QUAL, kinetics arrays)
so decode cost stays O(bytes) in C, not O(bases) in Python.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .bgzf import BgzfReader, BgzfWriter
from ..constants import BAM_NIBBLE_TO_BASE

BAM_MAGIC = b"BAM\x01"
CIGAR_OPS = "MIDNSHP=X"
_CIGAR_OP_TO_CODE = {c: i for i, c in enumerate(CIGAR_OPS)}

# 256-entry nibble-pair -> 2 ASCII bases table for fast SEQ decode.
_SEQ_BYTE_TO_2BASES = np.empty((256, 2), dtype=np.uint8)
for _b in range(256):
    _SEQ_BYTE_TO_2BASES[_b, 0] = BAM_NIBBLE_TO_BASE[_b >> 4]
    _SEQ_BYTE_TO_2BASES[_b, 1] = BAM_NIBBLE_TO_BASE[_b & 0xF]

_BASE_TO_NIBBLE = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _BASE_TO_NIBBLE[_c] = _i
    _BASE_TO_NIBBLE[_c | 0x20] = _i  # lowercase

_AUX_SCALAR = {
    "c": struct.Struct("<b"), "C": struct.Struct("<B"),
    "s": struct.Struct("<h"), "S": struct.Struct("<H"),
    "i": struct.Struct("<i"), "I": struct.Struct("<I"),
    "f": struct.Struct("<f"), "A": None,
}
_B_DTYPES = {
    "c": np.int8, "C": np.uint8, "s": np.int16, "S": np.uint16,
    "i": np.int32, "I": np.uint32, "f": np.float32,
}


class BamFormatError(ValueError):
    pass


@dataclass
class BamHeader:
    text: str = ""
    refs: list[tuple[str, int]] = field(default_factory=list)
    _name2tid: dict[str, int] | None = None

    def name2tid(self, name: str) -> int:
        if self._name2tid is None:
            self._name2tid = {n: i for i, (n, _) in enumerate(self.refs)}
        return self._name2tid.get(name, -1)

    def tid2name(self, tid: int) -> str:
        return self.refs[tid][0]

    def tid2len(self, tid: int) -> int:
        return self.refs[tid][1]

    @property
    def n_refs(self) -> int:
        return len(self.refs)

    def sort_order(self) -> str | None:
        """SO tag of the @HD line, if present (pileup.cpp:438-459)."""
        for line in self.text.splitlines():
            if line.startswith("@HD"):
                for col in line.split("\t")[1:]:
                    if col.startswith("SO:"):
                        return col[3:]
        return None

    def with_pg_line(self, name: str, version: str, cmdline: str) -> "BamHeader":
        pg = f"@PG\tID:{name}\tPN:{name}\tVN:{version}\tCL:{cmdline}\n"
        text = self.text
        if text and not text.endswith("\n"):
            text += "\n"
        return BamHeader(text + pg, list(self.refs))

    def to_bytes(self) -> bytes:
        text_b = self.text.encode()
        out = [BAM_MAGIC, struct.pack("<i", len(text_b)), text_b,
               struct.pack("<i", len(self.refs))]
        for name, length in self.refs:
            nb = name.encode() + b"\x00"
            out.append(struct.pack("<i", len(nb)))
            out.append(nb)
            out.append(struct.pack("<i", length))
        return b"".join(out)

    @classmethod
    def from_stream(cls, read) -> "BamHeader":
        magic = read(4)
        if magic != BAM_MAGIC:
            raise BamFormatError(f"bad BAM magic {magic!r}")
        (l_text,) = struct.unpack("<i", read(4))
        text = read(l_text).decode(errors="replace").rstrip("\x00")
        (n_ref,) = struct.unpack("<i", read(4))
        refs = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", read(4))
            name = read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", read(4))
            refs.append((name, l_ref))
        return cls(text, refs)


@dataclass
class BamRecord:
    qname: str = "*"
    flag: int = 4
    refid: int = -1
    pos: int = -1
    mapq: int = 0
    bin: int = 0
    next_refid: int = -1
    next_pos: int = -1
    tlen: int = 0
    cigar: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint32))
    seq_nibbles: bytes = b""
    l_seq: int = 0
    qual: np.ndarray | None = None
    # tags: ordered list of (tag, type_char, value); value is int/float/str for
    # scalars and (subtype_char, ndarray) for 'B' arrays.
    tags: list[tuple[str, str, object]] = field(default_factory=list)

    # -- SEQ ------------------------------------------------------------
    def seq_ascii(self) -> np.ndarray:
        """Stored-orientation sequence as uint8 ASCII array."""
        arr = np.frombuffer(self.seq_nibbles, dtype=np.uint8)
        out = _SEQ_BYTE_TO_2BASES[arr].reshape(-1)
        return out[: self.l_seq]

    def set_seq(self, seq_ascii: np.ndarray | bytes, qual: np.ndarray | None = None) -> None:
        s = np.frombuffer(seq_ascii, np.uint8) if isinstance(seq_ascii, (bytes, bytearray)) else np.asarray(seq_ascii, np.uint8)
        self.l_seq = len(s)
        nib = _BASE_TO_NIBBLE[s]
        if len(nib) % 2:
            nib = np.concatenate([nib, np.zeros(1, np.uint8)])
        self.seq_nibbles = ((nib[0::2] << 4) | nib[1::2]).tobytes()
        self.qual = None if qual is None else np.asarray(qual, np.uint8)

    # -- CIGAR ----------------------------------------------------------
    def set_cigar_str(self, cig: str) -> None:
        if cig in ("*", ""):
            self.cigar = np.empty(0, np.uint32)
            return
        ops = []
        num = 0
        for ch in cig:
            if ch.isdigit():
                num = num * 10 + int(ch)
            else:
                ops.append((num << 4) | _CIGAR_OP_TO_CODE[ch])
                num = 0
        self.cigar = np.asarray(ops, np.uint32)

    def cigar_ops(self) -> tuple[np.ndarray, np.ndarray]:
        """(op_codes, op_lengths) arrays."""
        return ((self.cigar & 0xF).astype(np.int64),
                (self.cigar >> 4).astype(np.int64))

    # -- aux tags --------------------------------------------------------
    def get_tag(self, tag: str):
        for t, ty, v in self.tags:
            if t == tag:
                return ty, v
        return None

    def set_tag(self, tag: str, type_char: str, value) -> None:
        for i, (t, _, _) in enumerate(self.tags):
            if t == tag:
                self.tags[i] = (tag, type_char, value)
                return
        self.tags.append((tag, type_char, value))

    def del_tag(self, tag: str) -> bool:
        for i, (t, _, _) in enumerate(self.tags):
            if t == tag:
                del self.tags[i]
                return True
        return False

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 0x10)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 0x4)

    @property
    def is_secondary_or_supplementary(self) -> bool:
        return bool(self.flag & 0x900)

    # -- (de)serialization ----------------------------------------------
    @classmethod
    def from_bytes(cls, buf: memoryview) -> "BamRecord":
        (refid, pos, l_qname, mapq, bin_, n_cigar, flag, l_seq,
         next_refid, next_pos, tlen) = struct.unpack_from("<iiBBHHHIiii", buf, 0)
        off = 32
        qname = bytes(buf[off:off + l_qname - 1]).decode()
        off += l_qname
        cigar = np.frombuffer(buf[off:off + 4 * n_cigar], np.uint32).copy()
        off += 4 * n_cigar
        nseq = (l_seq + 1) // 2
        seq_nibbles = bytes(buf[off:off + nseq])
        off += nseq
        qual = np.frombuffer(buf[off:off + l_seq], np.uint8).copy()
        if l_seq and qual[0] == 0xFF:
            qual = None
        off += l_seq
        tags = _parse_aux(buf, off)
        return cls(qname, flag, refid, pos, mapq, bin_, next_refid, next_pos,
                   tlen, cigar, seq_nibbles, l_seq, qual, tags)

    def to_bytes(self) -> bytes:
        qname_b = self.qname.encode() + b"\x00"
        parts = [
            struct.pack("<iiBBHHHIiii", self.refid, self.pos, len(qname_b),
                        self.mapq, self.bin, len(self.cigar), self.flag,
                        self.l_seq, self.next_refid, self.next_pos, self.tlen),
            qname_b,
            np.ascontiguousarray(self.cigar, np.uint32).tobytes(),
            self.seq_nibbles,
        ]
        if self.qual is None:
            parts.append(b"\xff" * self.l_seq)
        else:
            parts.append(self.qual.tobytes())
        parts.append(_serialize_aux(self.tags))
        body = b"".join(parts)
        return struct.pack("<I", len(body)) + body


def _parse_aux(buf: memoryview, off: int) -> list[tuple[str, str, object]]:
    # one bytes copy up front: C-speed find()/unpack_from beat per-byte
    # memoryview indexing (the NUL scan over multi-KB MM:Z strings was the
    # pileup pass-1 hot spot)
    buf = bytes(buf)
    tags = []
    end = len(buf)
    while off < end:
        tag = buf[off:off + 2].decode()
        ty = chr(buf[off + 2])
        off += 3
        if ty == "A":
            tags.append((tag, ty, chr(buf[off])))
            off += 1
        elif ty in "cCsSiIf":
            st = _AUX_SCALAR[ty]
            tags.append((tag, ty, st.unpack_from(buf, off)[0]))
            off += st.size
        elif ty in "ZH":
            e = buf.find(0, off)
            if e < 0:
                raise BamFormatError(f"unterminated {ty} tag {tag}")
            tags.append((tag, ty, buf[off:e].decode(errors="replace")))
            off = e + 1
        elif ty == "B":
            sub = chr(buf[off])
            (count,) = struct.unpack_from("<I", buf, off + 1)
            off += 5
            dt = _B_DTYPES[sub]
            nbytes = count * np.dtype(dt).itemsize
            arr = np.frombuffer(buf[off:off + nbytes], dt).copy()
            tags.append((tag, ty, (sub, arr)))
            off += nbytes
        else:
            raise BamFormatError(f"unknown aux type {ty!r} for tag {tag}")
    return tags


def _serialize_aux(tags) -> bytes:
    parts = []
    for tag, ty, val in tags:
        head = tag.encode() + ty.encode()
        if ty == "A":
            parts.append(head + val.encode())
        elif ty in "cCsSiI":
            parts.append(head + _AUX_SCALAR[ty].pack(int(val)))
        elif ty == "f":
            parts.append(head + _AUX_SCALAR["f"].pack(float(val)))
        elif ty in "ZH":
            parts.append(head + val.encode() + b"\x00")
        elif ty == "B":
            sub, arr = val
            arr = np.ascontiguousarray(arr, _B_DTYPES[sub])
            parts.append(head + sub.encode() + struct.pack("<I", len(arr)) + arr.tobytes())
        else:
            raise BamFormatError(f"unknown aux type {ty!r} for tag {tag}")
    return b"".join(parts)


def choose_int_type(v: int) -> str:
    """Smallest BAM integer type for a value, htslib-style (C before S/I)."""
    if 0 <= v <= 0xFF:
        return "C"
    if -128 <= v < 0:
        return "c"
    if 0 <= v <= 0xFFFF:
        return "S"
    if -32768 <= v < 0:
        return "s"
    if v < 0:
        return "i"
    return "I"


class SamTextReader:
    """Plain-text SAM reader producing BamRecords (gzip-transparent).

    The reference opens inputs through htslib's sam_open, which auto-detects
    SAM/BAM/CRAM (sam_batch.hpp:12-23), so `hifimeth call reads.sam` works
    there; BamReader delegates here when the input is not BGZF/BAM."""

    def __init__(self, path):
        import gzip
        with open(path, "rb") as probe:
            is_gz = probe.read(2) == b"\x1f\x8b"
        self._f = (gzip.open(path, "rt") if is_gz
                   else open(path, "r", encoding="utf-8"))
        self._pending: str | None = None
        text = []
        refs = []
        for line in self._f:
            if line.startswith("@"):
                text.append(line)
                if line.startswith("@SQ"):
                    name, ln = None, 0
                    for col in line.rstrip("\n").split("\t")[1:]:
                        if col.startswith("SN:"):
                            name = col[3:]
                        elif col.startswith("LN:"):
                            ln = int(col[3:])
                    if name is not None:
                        refs.append((name, ln))
            else:
                self._pending = line
                break
        self.header = BamHeader("".join(text), refs)

    def __iter__(self):
        return self

    def __next__(self) -> BamRecord:
        if self._pending is not None:
            line, self._pending = self._pending, None
        else:
            line = self._f.readline()
        while line and not line.strip():
            line = self._f.readline()
        if not line:
            raise StopIteration
        return self._parse_record(line)

    def _parse_record(self, line: str) -> BamRecord:
        cols = line.rstrip("\n").split("\t")
        if len(cols) < 11:
            raise BamFormatError(f"SAM record with {len(cols)} < 11 fields: "
                                 f"{line[:80]!r}")
        rec = BamRecord()
        rec.qname = cols[0]
        rec.flag = int(cols[1])
        rec.refid = -1 if cols[2] == "*" else self.header.name2tid(cols[2])
        rec.pos = int(cols[3]) - 1
        rec.mapq = int(cols[4])
        rec.set_cigar_str(cols[5])
        if cols[6] == "=":
            rec.next_refid = rec.refid
        elif cols[6] == "*":
            rec.next_refid = -1
        else:
            rec.next_refid = self.header.name2tid(cols[6])
        rec.next_pos = int(cols[7]) - 1
        rec.tlen = int(cols[8])
        if cols[9] == "*":
            rec.set_seq(b"")
        else:
            qual = None
            if cols[10] != "*":
                qual = (np.frombuffer(cols[10].encode(), np.uint8)
                        - 33).astype(np.uint8)
            rec.set_seq(cols[9].encode(), qual=qual)
        for tok in cols[11:]:
            tag, ty, val = tok.split(":", 2)
            if ty == "i":
                rec.set_tag(tag, choose_int_type(int(val)), int(val))
            elif ty == "f":
                rec.set_tag(tag, "f", float(val))
            elif ty in ("A", "Z", "H"):
                rec.set_tag(tag, ty, val)
            elif ty == "B":
                sub = val[0]
                body = val[2:] if len(val) > 1 else ""
                if not body:
                    arr = np.empty(0, _B_DTYPES[sub])
                elif sub == "f":
                    arr = np.array(body.split(","), np.float32)
                else:
                    arr = np.array([int(x) for x in body.split(",")],
                                   _B_DTYPES[sub])
                rec.set_tag(tag, "B", (sub, arr))
            else:
                raise BamFormatError(
                    f"unknown SAM tag type {ty!r} in {tok!r}")
        return rec

    def close(self) -> None:
        self._f.close()


class BamReader:
    """Sequential streaming BAM reader over BGZF.

    Keeps a rolling decoded buffer (~chunk bytes) so memory stays bounded for
    arbitrarily large inputs; the BGZF layer inflates ahead in a thread pool
    (the analog of htslib's 8-thread pool, sam_batch.hpp:19).

    SAM/BAM auto-detection (the reference gets this from htslib's sam_open,
    sam_batch.hpp:12-23): a path whose content is not BGZF-framed BAM -
    plain-text SAM, gzipped SAM, or BGZF SAM - is transparently routed
    through SamTextReader."""

    def __init__(self, path, threads: int = 4, chunk: int = 4 << 20):
        import os as _os
        self._sam: SamTextReader | None = None
        if isinstance(path, (str, _os.PathLike)):
            with open(path, "rb") as f:
                head = f.read(4)
            if head[:2] != b"\x1f\x8b":
                if head == BAM_MAGIC:
                    raise BamFormatError(
                        "uncompressed BAM input is not supported; "
                        "compress with bgzip")
                if head == b"CRAM":
                    # htslib-surface parity (sam_batch.hpp:12-23): the
                    # reference reads CRAM through htslib; we detect the
                    # magic and say so instead of failing with a confusing
                    # SAM parse error
                    raise BamFormatError(
                        f"{path}: CRAM input is not supported; convert "
                        f"with `samtools view -b in.cram -o in.bam`")
                # ASCII content: plain-text SAM
                self._sam = SamTextReader(path)
                self.header = self._sam.header
                return
            try:
                self._init_bam(path, threads, chunk)
                return
            except (BamFormatError, ValueError):
                # gzip/BGZF stream whose payload is not BAM: gzipped SAM.
                # Close the half-constructed BAM layer first or its open fd
                # + inflate thread pool leak (round-4 ADVICE).
                bgzf = getattr(self, "_bgzf", None)
                if bgzf is not None:
                    bgzf.close()
                    self._bgzf = None
                self._sam = SamTextReader(path)
                self.header = self._sam.header
                return
        self._init_bam(path, threads, chunk)

    def _init_bam(self, path, threads: int, chunk: int) -> None:
        self._bgzf = BgzfReader(path, threads=threads)
        self._chunk = chunk
        self._buf = bytearray()
        self._pos = 0
        self.header = BamHeader.from_stream(self._read_exact)

    def _read_exact(self, n: int) -> bytes:
        self._ensure(n)
        b = bytes(self._buf[self._pos:self._pos + n])
        self._pos += n
        return b

    def _ensure(self, n: int) -> bool:
        """Make >= n bytes available at the cursor; False on clean EOF."""
        avail = len(self._buf) - self._pos
        if avail >= n:
            return True
        if self._pos:
            del self._buf[:self._pos]
            self._pos = 0
        while len(self._buf) < n:
            more = self._bgzf.read(max(self._chunk, n - len(self._buf)))
            if not more:
                return False
            self._buf.extend(more)
        return True

    def __iter__(self):
        return self

    def __next__(self) -> BamRecord:
        if self._sam is not None:
            return next(self._sam)
        raw = self.next_raw()
        if raw is None:
            raise StopIteration
        return BamRecord.from_bytes(raw)

    @property
    def is_sam_text(self) -> bool:
        """True when the input is SAM text: its records are born parsed, so
        callers that would parse raw views take records with next()."""
        return self._sam is not None

    def next_raw(self) -> memoryview | None:
        """Next record body (without the leading block_size) or None at EOF.

        The returned memoryview is only valid until the next call.
        """
        if self._sam is not None:
            try:
                rec = next(self._sam)
            except StopIteration:
                return None
            return memoryview(rec.to_bytes())[4:]
        if not self._ensure(4):
            return None
        (block_size,) = struct.unpack_from("<I", self._buf, self._pos)
        if not self._ensure(4 + block_size):
            raise BamFormatError("truncated BAM record")
        start = self._pos + 4
        self._pos = start + block_size
        return memoryview(self._buf)[start:self._pos]

    def close(self) -> None:
        if self._sam is not None:
            self._sam.close()
            return
        self._bgzf.close()


class BamWriter:
    def __init__(self, path, header: BamHeader, threads: int = 4, level: int = 6):
        self._bgzf = BgzfWriter(path, threads=threads, level=level)
        self._bgzf.write(header.to_bytes())
        self.header = header

    def write(self, rec: BamRecord) -> None:
        self._bgzf.write(rec.to_bytes())

    def write_raw(self, body: bytes | memoryview) -> None:
        """Write one record body as BamReader.next_raw returns it."""
        self._bgzf.write(struct.pack("<I", len(body)))
        self._bgzf.write(body)

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
