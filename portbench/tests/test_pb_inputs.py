"""The seeded read generator, its BGZF/BAM encoding and the stream."""
import struct
import zlib

import numpy as np
import pytest

from portbench import catalog, check, inputs


@pytest.mark.parametrize("name", ["plant-hifi", "human-hifi", "plant-noamp"])
def test_pool_reads_back(name, tmp_path):
    """A generated pool, written through the stream and read back by the
    benchmark's own BAM reader: the record count, every name, length and
    base, and the composition and CG frequency the traffic file asks for."""
    tr = catalog.traffic(name)
    tr = dict(tr, n_reads=40)
    pool = inputs.make_pool(tr, 2**31 + 5)
    stream = inputs.PoolStream(inputs.encode_pool(pool), limit=pool.n_reads)
    path = tmp_path / "pool.bam"
    path.write_bytes(stream.read())
    assert stream.served == pool.n_reads
    recs = check.read_records(str(path))
    assert [r[0] for r in recs] == [pool.name(i) for i in range(pool.n_reads)]
    lens = np.diff(pool.offsets)
    assert sorted(lens) == sorted(inputs.read_lengths(tr["length"], 40))
    assert lens.min() >= tr["length"]["min"]
    assert lens.max() <= tr["length"]["max"]
    # composition: i.i.d. draws (plant), or with C->G steps thinned (human)
    seq = pool.seq
    freq = np.array([np.mean(seq == b) for b in b"ACGT"])
    cg = np.mean((seq[:-1] == ord("C")) & (seq[1:] == ord("G")))
    p = np.asarray(tr["composition"])
    keep = tr.get("cg_keep", 1.0)
    assert abs(cg - keep * p[1] * p[2]) < 0.1 * keep * p[1] * p[2]
    # thinning moves some G to A, C and T: G drops by the removed share
    removed = (1 - keep) * p[1] * p[2]
    want = p + removed * np.array([p[0], p[1], -(1 - p[2]), p[3]]) \
        / (1 - p[2])
    np.testing.assert_allclose(freq, want, atol=0.004)
    if "cg_keep" in tr:
        # CpG depletion: about a fifth of chance, ~1% of dinucleotides
        assert 0.008 < cg < 0.012


def test_pool_bytes_parse_as_bam(tmp_path):
    """The record bytes: unmapped, quality 40, four B:C kinetics arrays of
    the read's length holding the pool's bytes, fn and rn 5."""
    pool = inputs.make_pool(catalog.traffic("plant-hifi") | {"n_reads": 2},
                            7)
    body = inputs.record_bytes(pool.name(0), *pool.read(0))
    seq, kin = pool.read(0)
    size, refid, pos, l_name = struct.unpack_from("<IiiB", body)
    assert size == len(body) - 4 and refid == -1 and pos == -1
    flag, l_seq = struct.unpack_from("<HI", body, 18)
    assert flag == 4 and l_seq == len(seq)
    o = 36 + l_name + (l_seq + 1) // 2
    assert body[o:o + l_seq] == bytes([40]) * l_seq
    o += l_seq
    for tag, arr in zip(inputs.KINETICS_TAGS, kin):
        assert body[o:o + 4] == tag.encode() + b"BC"
        assert struct.unpack_from("<I", body, o + 4)[0] == l_seq
        assert body[o + 8:o + 8 + l_seq] == arr.tobytes()
        o += 8 + l_seq
    assert body[o:] == b"fnC\x05rnC\x05"


def test_stream_ends_in_bgzf_eof():
    """Header, whole records, then the 28-byte BGZF EOF block and nothing
    more; each block a valid BGZF member whose CRC matches."""
    pool = inputs.make_pool(catalog.traffic("plant-noamp") | {"n_reads": 3},
                            1)
    stream = inputs.PoolStream(inputs.encode_pool(pool), limit=5)
    data = b""
    while True:
        chunk = stream.read(1000)     # small reads cross record boundaries
        if not chunk:
            break
        data += chunk
    assert data.endswith(inputs.BGZF_EOF)
    assert stream.served == 5
    assert stream.read(10) == b""
    payload = check.bgzf_payload(data)
    assert payload.startswith(b"BAM\x01")
    # every member's CRC and size
    o = 0
    while o < len(data):
        bsize = int.from_bytes(data[o + 16:o + 18], "little") + 1
        block = data[o:o + bsize]
        raw = zlib.decompress(block[18:-8], -15)
        assert int.from_bytes(block[-8:-4], "little") == zlib.crc32(raw)
        assert int.from_bytes(block[-4:], "little") == len(raw)
        o += bsize
    assert o == len(data)


def test_stream_stops_at_its_deadline():
    """A stream started with 0 seconds serves the header and the EOF block
    and no record; records wrap around the pool."""
    pool = inputs.make_pool(catalog.traffic("plant-noamp") | {"n_reads": 2},
                            1)
    blocks = inputs.encode_pool(pool)
    s = inputs.PoolStream(blocks)
    s.start(0.0)
    assert check.bgzf_payload(s.read()) == inputs.header_bytes()
    assert s.served == 0
    s = inputs.PoolStream(blocks, limit=5)
    check.bgzf_payload(s.read())
    assert s.served == 5


def test_seeds_share_lengths_not_order():
    tr = catalog.traffic("plant-hifi") | {"n_reads": 30}
    a = inputs.make_pool(tr, 11)
    b = inputs.make_pool(tr, 2**32 + 11)
    la, lb = np.diff(a.offsets), np.diff(b.offsets)
    assert sorted(la) == sorted(lb) and list(la) != list(lb)
    assert not np.array_equal(a.seq[:1000], b.seq[:1000])
    c = inputs.make_pool(tr, 11)
    assert np.array_equal(a.seq, c.seq) and np.array_equal(a.kin, c.kin)
