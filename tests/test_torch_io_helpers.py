"""The structured MM/ML parser and the small I/O helpers of the port
against the JAX package's, with the native core and with its numpy
fallbacks.

parse_mod_tags runs over every record of the golden corpus's mapped
mod-BAM and over every hand-derived vector of
tests/test_mmtags_spec_vectors.py (read from that file with ast): both
packages raise ModTagError on the same vectors and give equal series on
the rest.  seq_unpack, revcomp and encode_codev1 equal the JAX package's
native entries; read_all, tid2len, seq_str, site_strands_for_c_or_g and die
behave as the JAX ones.
"""
import ast
import os

import numpy as np
import pytest

from hifimeth_tpu.features import sites as jax_sites
from hifimeth_tpu.features.read_decode import native_fwd_seq as jax_fwd
from hifimeth_tpu.io import bam as jax_bam
from hifimeth_tpu.io import bgzf as jax_bgzf
from hifimeth_tpu.io import fasta as jax_fasta
from hifimeth_tpu.io import mmtags as jax_mmtags
from hifimeth_tpu.io import native as jax_native
from hifimeth_tpu.utils import logging as jax_logging
from hifimeth_tpu_torch.features import sites
from hifimeth_tpu_torch.features.read_decode import native_fwd_seq
from hifimeth_tpu_torch.io import bam, bgzf, fasta, mmtags, native
from hifimeth_tpu_torch.utils import logging

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")


@pytest.fixture(params=["native", "numpy"])
def impl(request, monkeypatch):
    """Both routes of the port's native entries: the library, and the
    numpy fallbacks (the library reported unavailable)."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "_LIB", False)
    return request.param


def _spec_vectors():
    """(seq, flag, MM, ML) of every _rec(...) call in the spec-vector
    tests, a for-loop's literal values expanded."""
    tree = ast.parse(open(os.path.join(HERE,
                                       "test_mmtags_spec_vectors.py")).read())
    loops = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            loops[node.target.id] = ast.literal_eval(node.iter)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "_rec":
            choices = [loops[a.id] if isinstance(a, ast.Name)
                       else [ast.literal_eval(a)] for a in node.args]
            for mm in choices[2]:
                out.append((choices[0][0], choices[1][0], mm, choices[3][0]))
    return out


SPEC_VECTORS = _spec_vectors()


def _series(s):
    return (s.unmod_base, s.strand, s.codes, s.qoffs.dtype, s.qoffs.tolist(),
            s.probs.dtype, s.probs.shape, s.probs.tolist())


def _parse_both(ours, theirs):
    """Both parsers on one record: ("error",) each, or their series."""
    out = []
    for parse, rec, fwd in ((mmtags.parse_mod_tags, ours, native_fwd_seq),
                            (jax_mmtags.parse_mod_tags, theirs, jax_fwd)):
        try:
            out.append([_series(s) for s in parse(rec, fwd(rec))])
        except (mmtags.ModTagError, jax_mmtags.ModTagError) as e:
            out.append(("error", type(e).__name__))
    return out


def test_spec_vectors_found():
    assert len(SPEC_VECTORS) >= 13


@pytest.mark.parametrize("vector", SPEC_VECTORS,
                         ids=[f"{v[0]}-{v[2]}" for v in SPEC_VECTORS])
def test_parse_mod_tags_spec_vector_equals_jax(vector, impl):
    seq, flag, mm, ml = vector
    recs = []
    for mod in (bam, jax_bam):
        rec = mod.BamRecord(qname="v", flag=flag)
        rec.set_seq(seq.encode())
        rec.set_tag("MM", "Z", mm)
        rec.set_tag("ML", "B", ("C", np.asarray(ml, np.uint8)))
        recs.append(rec)
    ours, theirs = _parse_both(*recs)
    assert ours == theirs


def test_parse_mod_tags_golden_equals_jax(impl):
    path = os.path.join(DATA, "golden_mapped.bam")
    n = 0
    for ours, theirs in zip(bam.BamReader(path), jax_bam.BamReader(path)):
        a, b = _parse_both(ours, theirs)
        assert a == b, ours.qname
        n += sum(len(s[4]) for s in a)
        # the flat view is the structured one flattened
        flat = mmtags.parse_mod_tags_flat(ours, native_fwd_seq(ours))
        jflat = jax_mmtags.parse_mod_tags_flat(theirs, jax_fwd(theirs))
        for x, y in zip(flat, jflat):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert n > 1000


def test_seq_unpack_revcomp_encode_equal_jax(impl):
    rng = np.random.default_rng(19)
    for length in (0, 1, 2, 7, 100, 1001):
        seq = rng.choice(list(b"ACGTN=MRSV"), length).astype(np.uint8)
        rec = bam.BamRecord()
        rec.set_seq(seq)
        got = native.seq_unpack(rec.seq_nibbles, length)
        np.testing.assert_array_equal(
            got, jax_native.seq_unpack(rec.seq_nibbles, length))
        np.testing.assert_array_equal(got, rec.seq_ascii())
    seq = rng.choice(list(b"ACGTNacgtnRY-"), 999).astype(np.uint8)
    np.testing.assert_array_equal(native.revcomp(seq),
                                  jax_native.revcomp(seq))
    frames = np.concatenate([np.arange(0, 1500), [65535, 952, 953]])
    np.testing.assert_array_equal(
        native.encode_codev1(frames.astype(np.uint16)),
        jax_native.encode_codev1(frames.astype(np.uint16)))
    assert native.available() == (impl == "native")


def test_read_all_tid2len_seq_str(tmp_path):
    path = os.path.join(DATA, "golden_mapped.bam")
    with bgzf.BgzfReader(path) as f, jax_bgzf.BgzfReader(path) as g:
        head = f.read(100)
        assert head == g.read(100)
        assert f.read_all() == g.read_all() and len(head) == 100
    hdr = bam.BamReader(path).header
    jhdr = jax_bam.BamReader(path).header
    assert hdr.n_refs > 0
    assert ([hdr.tid2len(t) for t in range(hdr.n_refs)]
            == [jhdr.tid2len(t) for t in range(jhdr.n_refs)])
    ref = os.path.join(DATA, "golden_ref.fa")
    ours, theirs = fasta.FastaDatabase(ref), jax_fasta.FastaDatabase(ref)
    assert [ours.seq_str(s) for s in range(ours.num_seqs)] == \
        [theirs.seq_str(s) for s in range(theirs.num_seqs)]


def test_site_strands_for_c_or_g_and_die(capsys):
    rng = np.random.default_rng(23)
    seq = rng.choice(list(b"ACGTN"), 500).astype(np.uint8)
    offs = np.flatnonzero((seq == ord("C")) | (seq == ord("G")))
    got = sites.site_strands_for_c_or_g(seq, offs)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, jax_sites.site_strands_for_c_or_g(seq, offs))
    for mod in (logging, jax_logging):
        with pytest.raises(SystemExit) as e:
            mod.die("bad %s of %d", "input", 3)
        assert e.value.code == 1
        assert capsys.readouterr().err.rstrip().endswith(
            "ERROR: bad input of 3")
