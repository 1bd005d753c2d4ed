"""The flush-wide MM/ML builder (ops/csrc/mmbuild.cpp, through
`CallEngine._flush_tags`) against the per-read path it replaces
(`CallEngine._read_tags`, io/mmtags.py `build_mod_tags`): every record's
`to_bytes()` equal after the engine's emit step, on

 - a seeded `plant-hifi` pool (portbench/inputs.py `make_pool`),
 - the golden corpus (tests/data/golden_call_in.bam),
 - hand-made edge reads: no site, sites on one strand only, a call at the
   first and at the last base, MM/ML/MN tags already present,

each with uncalled reads (too short or without kinetics) between the
called ones, over CpG alone and all three contexts, with keep_kinetics off
and on, and u8 probabilities drawn from a seed.  A context whose calls are
out of offset order is sorted as the per-read path sorts it, and a call
off its series base raises on both paths.
"""
import os

import numpy as np
import pytest

from hifimeth_tpu_torch.constants import CONTEXTS
from hifimeth_tpu_torch.engine.call import CallConfig, CallEngine, _PendingRead
from hifimeth_tpu_torch.engine.spans import SpanRecorder
from hifimeth_tpu_torch.features import sites
from hifimeth_tpu_torch.features.read_decode import decode_read
from hifimeth_tpu_torch.io import native
from hifimeth_tpu_torch.io.bam import BamReader, BamRecord
from portbench import catalog, inputs

DATA = os.path.join(os.path.dirname(__file__), "data")
SEED = 3141592653
KINETICS = ("fi", "ri", "fp", "rp")


def _emitter(keep_kinetics: bool) -> CallEngine:
    """An engine with only what `_build_emit` reads: its config and span
    recorder (no models, programs or device)."""
    eng = object.__new__(CallEngine)
    eng.cfg = CallConfig(device="cpu", keep_kinetics=keep_kinetics)
    eng.spans = SpanRecorder()
    return eng


def _copy(rec: BamRecord) -> BamRecord:
    return BamRecord.from_bytes(memoryview(rec.to_bytes())[4:])


def _record(name: str, seq: bytes, rng, tags=()) -> BamRecord:
    rec = BamRecord(qname=name, flag=4)
    rec.set_seq(np.frombuffer(seq, np.uint8),
                qual=np.full(len(seq), 30, np.uint8))
    for t in KINETICS:
        rec.set_tag(t, "B", ("C", rng.integers(0, 256, len(seq), np.uint8)))
    for tag in tags:
        rec.set_tag(*tag)
    return rec


def _pool_reads(rng):
    """(record, called) pairs of the seeded plant-hifi pool; every seventh
    read is left uncalled."""
    pool = inputs.make_pool(catalog.traffic("plant-hifi"), SEED)
    out = []
    for i in range(pool.n_reads):
        seq, kin = pool.read(i)
        body = inputs.record_bytes(pool.name(i), seq, kin)
        rec = BamRecord.from_bytes(memoryview(body)[4:])
        out.append((rec, i % 7 != 3))
    return out


def _golden_reads(rng):
    """The golden corpus as the engine sees it: reads under the default
    min_read_size or without kinetics stay uncalled."""
    recs = list(BamReader(os.path.join(DATA, "golden_call_in.bam")))
    min_size = CallConfig().min_read_size
    return [(r, r.l_seq >= min_size and decode_read(r) is not None)
            for r in recs]


def _edge_reads(rng):
    mn = ("MN", "S", 7)
    old_mm = ("MM", "Z", "C+m,0;")
    old_ml = ("ML", "B", ("C", np.array([9], np.uint8)))
    cases = [
        ("no-sites", b"AT" * 700, ()),
        ("fwd-only", b"CAT" * 500, ()),
        ("short", b"CGA" * 100, ()),
        ("rev-only", b"ATG" * 500, (mn,)),
        ("ends", b"C" + b"A" * 700 + b"CG" + b"T" * 700 + b"G",
         (old_mm, old_ml)),
        ("mixed", rng.choice(np.frombuffer(b"ACGTN", np.uint8), 4000,
                             p=[.3, .2, .2, .28, .02]).tobytes(),
         (mn, old_ml)),
    ]
    out = [(_record(name, seq, rng, tags), name != "short")
           for name, seq, tags in cases]
    bare = _record("bare", b"ACG" * 600, rng)
    for t in KINETICS:
        bare.del_tag(t)
    out.insert(3, (bare, False))
    return out


READS = {"pool": _pool_reads, "golden": _golden_reads, "edges": _edge_reads}


def _flush(reads, contexts, rng):
    """A flush as add_read leaves it: a pend per record (fwd_seq only on
    called reads), each called read's site slices into the flush's
    per-context arrays, and one seeded u8 probability per site."""
    pending = []
    n = dict.fromkeys(contexts, 0)
    for rec, called in reads:
        if not called:
            pending.append(_PendingRead(_copy(rec)))
            continue
        seq = decode_read(rec).seq
        found = sites.scan_all(seq)
        pend = _PendingRead(_copy(rec), fwd_seq=seq)
        for ctx in contexts:
            offs, strands = found[ctx]
            pend.site_slices[ctx] = (n[ctx], n[ctx] + len(offs), offs,
                                     strands)
            n[ctx] += len(offs)
        pending.append(pend)
    probs = {ctx: rng.integers(0, 256, n[ctx], np.uint8) for ctx in contexts}
    return pending, probs


def _emit(pending, probs, keep_kinetics):
    eng = _emitter(keep_kinetics)
    out: list = []
    eng._build_emit(pending, probs, out, 0)
    return [r.to_bytes() for r in out], eng.spans.totals()


@pytest.mark.parametrize("source,contexts,keep_kinetics", [
    ("pool", CONTEXTS, False),
    ("pool", ("CpG",), True),
    ("golden", CONTEXTS, False),
    ("golden", ("CpG",), True),
    ("edges", CONTEXTS, False),
    ("edges", CONTEXTS, True),
    ("edges", ("CpG",), False),
])
def test_flush_builder_matches_per_read_path(monkeypatch, source, contexts,
                                             keep_kinetics):
    rng = np.random.default_rng(SEED)
    reads = READS[source](rng)
    pending, probs = _flush(reads, contexts, rng)
    n_called = sum(p.fwd_seq is not None for p in pending)
    assert 0 < n_called < len(pending)
    fwd_seqs = [p.fwd_seq for p in pending]
    # the same pends twice: the records are copied, the sites shared
    again = [_PendingRead(_copy(p.rec), p.fwd_seq, p.site_slices)
             for p in pending]

    got, counts = _emit(pending, probs, keep_kinetics)
    assert counts == {"mmbuild_native": n_called, "mmbuild_calls": 1,
                      "mmbuild": counts["mmbuild"]}
    monkeypatch.setattr(native, "_load_mmbuild", lambda: False)
    want, counts = _emit(again, probs, keep_kinetics)
    assert set(counts) == {"mmbuild"}

    assert len(got) == len(want) == len(reads)
    for (rec, called), g, w in zip(reads, got, want):
        assert g == w, rec.qname
        if not called:
            assert g == rec.to_bytes(), rec.qname     # passed through
    assert [p.fwd_seq for p in pending] == fwd_seqs
    tagged = [BamRecord.from_bytes(memoryview(g)[4:]) for g in got]
    n_ml = sum(len(r.get_tag("ML")[1][1]) for r in tagged
               if r.get_tag("MM") is not None)
    assert n_ml == sum(len(p) for p in probs.values())
    if source == "edges":
        by_name = {r.qname: r for r in tagged}
        assert by_name["no-sites"].get_tag("MM") is None
        assert by_name["no-sites"].get_tag("ML") is None
        # CHH calls on the first base and on the last, a CpG between
        assert by_name["ends"].get_tag("MM")[1] == (
            "C+m,0,0;G-m,1;" if "CHH" in contexts else "C+m,1;G-m;")


def test_off_base_call_raises(monkeypatch):
    """A call whose offset is not on its series base is refused by both
    builders (the per-read one through bamcore's hm_mm_deltas)."""
    rng = np.random.default_rng(SEED)
    rec = _record("r", b"ACGT" * 400, rng)
    pend = _PendingRead(rec, fwd_seq=decode_read(rec).seq)
    pend.site_slices["CpG"] = (0, 1, np.array([0]), np.zeros(1, np.uint8))
    probs = {"CpG": np.array([200], np.uint8)}
    with pytest.raises(ValueError, match="not on"):
        _emit([pend], probs, False)
    monkeypatch.setattr(native, "_load_mmbuild", lambda: False)
    with pytest.raises(ValueError, match="not on"):
        _emit([pend], probs, False)


def test_unsorted_context_runs_match_per_read_path(monkeypatch):
    """A context whose calls come out of offset order (the site scans
    never give one) is stable-sorted as the per-read path's argsort does,
    not merged as it stands."""
    rng = np.random.default_rng(SEED)
    pending, probs = _flush(_edge_reads(rng), CONTEXTS, rng)
    for p in pending:
        if p.fwd_seq is not None:
            lo, hi, offs, strands = p.site_slices["CHH"]
            p.site_slices["CHH"] = (lo, hi, offs[::-1], strands[::-1])
            probs["CHH"][lo:hi] = probs["CHH"][lo:hi][::-1]
    again = [_PendingRead(_copy(p.rec), p.fwd_seq, p.site_slices)
             for p in pending]
    got, counts = _emit(pending, probs, False)
    assert counts["mmbuild_calls"] == 1
    monkeypatch.setattr(native, "_load_mmbuild", lambda: False)
    want, _ = _emit(again, probs, False)
    assert got == want
