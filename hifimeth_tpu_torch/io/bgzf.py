"""BGZF (blocked gzip) reader/writer.

hts-free replacement for the compression layer htslib provides in the
reference (sam_batch.hpp uses htslib's 8-thread BGZF pool).  BGZF is a series
of gzip members, each carrying a BC extra subfield with the compressed block
size; blocks hold <= 64 KiB of uncompressed payload so the stream is
random-accessible and parallelizable.

Decompression/compression run through zlib's C core; a thread pool exploits
the fact that zlib releases the GIL, mirroring the reference's use of an
8-thread htslib pool.  An optional native path (src/native/bamcore.cpp) is
used when the compiled library is available.
"""
from __future__ import annotations

import io
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
# gzip header: magic, CM, FLG | MTIME | XFL, OS | XLEN | SI1, SI2 | SLEN | BSIZE
_HEADER = struct.Struct("<4BI2BH2BHH")
MAX_BLOCK_UNCOMPRESSED = 65280  # htslib uses 64KiB minus headroom


def _compress_block(payload: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    data = co.compress(payload) + co.flush()
    # total block length = 18 (header+extra) + data + 8 (crc+isize); BSIZE is
    # total-1 per the BGZF spec.
    bsize = len(data) + 18 + 8 - 1
    header = _HEADER.pack(
        0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, ord("B"), ord("C"), 2, bsize
    )
    return b"".join(
        (header, data, struct.pack("<II", zlib.crc32(payload), len(payload) & 0xFFFFFFFF))
    )


class BgzfWriter(io.RawIOBase):
    """Streaming BGZF writer.

    Uses the native core (src/native/bamcore.cpp) to compress many blocks per
    call with C threads when available; otherwise falls back to per-block
    zlib in a Python thread pool."""

    def __init__(self, path_or_fh, level: int = 6, threads: int = 4):
        if hasattr(path_or_fh, "write"):
            self._fh = path_or_fh
            self._owns = False
        else:
            self._fh = open(path_or_fh, "wb")
            self._owns = True
        self._level = level
        self._threads = max(1, threads)
        self._buf = bytearray()
        from . import native
        self._native = native if native.available() else None
        self._native_chunk = MAX_BLOCK_UNCOMPRESSED * max(8, threads * 4)
        self._pool = ThreadPoolExecutor(max_workers=max(1, threads)) if threads > 1 else None
        self._pending: list = []
        self._max_pending = max(2, threads * 4)

    def write(self, data) -> int:
        self._buf.extend(data)
        if self._native is not None:
            while len(self._buf) >= self._native_chunk:
                chunk = bytes(self._buf[:self._native_chunk])
                del self._buf[:self._native_chunk]
                self._submit_native(chunk)
            return len(data)
        while len(self._buf) >= MAX_BLOCK_UNCOMPRESSED:
            chunk = bytes(self._buf[:MAX_BLOCK_UNCOMPRESSED])
            del self._buf[:MAX_BLOCK_UNCOMPRESSED]
            self._submit(chunk)
        return len(data)

    def _submit_native(self, chunk: bytes) -> None:
        """Run the (GIL-releasing, internally threaded) native compress off
        the caller thread so writes never stall the pipeline; ordered FIFO
        drain preserves the output stream.  Chunks are large, so at most one
        compress is kept in flight beyond the current one."""
        if self._pool is None:
            self._fh.write(self._native.bgzf_compress_buffer(
                chunk, self._level, self._threads))
            return
        self._pending.append(self._pool.submit(
            self._native.bgzf_compress_buffer, chunk, self._level,
            self._threads))
        if len(self._pending) >= 2:
            self._drain(1)

    def _submit(self, chunk: bytes) -> None:
        if self._pool is None:
            self._fh.write(_compress_block(chunk, self._level))
            return
        self._pending.append(self._pool.submit(_compress_block, chunk, self._level))
        if len(self._pending) >= self._max_pending:
            self._drain(self._max_pending // 2)

    def _drain(self, keep: int = 0) -> None:
        while len(self._pending) > keep:
            self._fh.write(self._pending.pop(0).result())

    def flush_block(self) -> None:
        if self._buf:
            chunk = bytes(self._buf)
            self._buf.clear()
            if self._native is not None:
                self._submit_native(chunk)
            else:
                self._submit(chunk)

    def close(self) -> None:
        if self.closed:
            return
        self.flush_block()
        self._drain()
        if self._pool is not None:
            self._pool.shutdown()
        self._fh.write(BGZF_EOF)
        self._fh.flush()
        if self._owns:
            self._fh.close()
        super().close()

    def writable(self) -> bool:
        return True


def _inflate_member(comp: bytes, xlen: int) -> bytes:
    return zlib.decompress(comp[12 + xlen:len(comp) - 8], -15)


class BgzfReader(io.RawIOBase):
    """Streaming BGZF reader.

    Compressed blocks are read sequentially from the file (cheap) and inflated
    in a thread pool ahead of the read cursor, bounding memory to
    ~prefetch_blocks * 64 KiB while keeping all cores busy.
    """

    def __init__(self, path_or_fh, threads: int = 4, prefetch_blocks: int = 128):
        if hasattr(path_or_fh, "read"):
            self._fh = path_or_fh
            self._owns = False
        else:
            self._fh = open(path_or_fh, "rb")
            self._owns = True
        self._threads = max(1, threads)
        from . import native
        self._native = native if native.available() else None
        self._comp_rem = b""
        self._pool = ThreadPoolExecutor(max_workers=max(1, threads)) if threads > 1 else None
        self._prefetch = prefetch_blocks
        self._futures: list = []
        self._eof = False
        self._cur = b""
        self._cur_off = 0

    def _native_payload(self) -> bytes | None:
        """Read a large compressed chunk and inflate it with C threads."""
        import numpy as np

        while True:
            chunk = self._fh.read(8 << 20)
            if not chunk and not self._comp_rem:
                return None
            comp = self._comp_rem + chunk
            payload, consumed = self._native.bgzf_inflate_buffer(
                np.frombuffer(comp, np.uint8), self._threads)
            self._comp_rem = comp[consumed:]
            if not chunk and payload == b"" and self._comp_rem:
                raise ValueError("truncated BGZF stream")
            if payload or not chunk:
                return payload if payload else None

    def _read_compressed_block(self) -> tuple[bytes, int] | None:
        head = self._fh.read(12)
        if not head:
            return None
        if len(head) < 12 or head[0] != 0x1F or head[1] != 0x8B:
            raise ValueError("bad BGZF magic (truncated or not BGZF)")
        xlen = struct.unpack_from("<H", head, 10)[0]
        extra = self._fh.read(xlen)
        bsize = None
        sub = 0
        while sub < xlen:
            si1, si2, slen = extra[sub], extra[sub + 1], struct.unpack_from("<H", extra, sub + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, sub + 4)[0] + 1
            sub += 4 + slen
        if bsize is None:
            raise ValueError("gzip member without BC subfield (not BGZF)")
        rest = self._fh.read(bsize - 12 - xlen)
        return head + extra + rest, xlen

    def _fill_pipeline(self) -> None:
        while not self._eof and len(self._futures) < self._prefetch:
            blk = self._read_compressed_block()
            if blk is None:
                self._eof = True
                break
            comp, xlen = blk
            if self._pool is None:
                self._futures.append(_inflate_member(comp, xlen))
            else:
                self._futures.append(self._pool.submit(_inflate_member, comp, xlen))

    def _next_payload(self) -> bytes | None:
        if self._native is not None:
            return self._native_payload()
        self._fill_pipeline()
        if not self._futures:
            return None
        f = self._futures.pop(0)
        return f if self._pool is None else f.result()

    def read(self, n: int = -1) -> bytes:
        out = []
        remaining = n if n >= 0 else None
        while remaining is None or remaining > 0:
            if self._cur_off >= len(self._cur):
                nxt = self._next_payload()
                if nxt is None:
                    break
                self._cur = nxt
                self._cur_off = 0
                continue
            avail = len(self._cur) - self._cur_off
            take = avail if remaining is None else min(avail, remaining)
            out.append(self._cur[self._cur_off:self._cur_off + take])
            self._cur_off += take
            if remaining is not None:
                remaining -= take
        return b"".join(out)

    def read_all(self) -> bytes:
        """Inflate the rest of the file and return its payload."""
        return self.read(-1)

    def close(self) -> None:
        if self.closed:
            return
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
        if self._owns:
            self._fh.close()
        super().close()

    def readable(self) -> bool:
        return True
