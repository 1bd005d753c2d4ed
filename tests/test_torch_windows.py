"""The slice and folded paths: the port's featurize_planes(_folded),
gather_windows_slice/_folded and call_sites_batched against the JAX
package's XLA versions on the CPU, and `call --gather-impl slice|folded`
against the JAX engine's same paths.

Tables and windows are copies of the same values, so bit-equal (the JAX
package decodes codeV1 through the same table on the CPU,
hifimeth_tpu/features/windows.py:55-57).  Logits: within 2e-3 of JAX's
dnamodnet_apply on the same windows, u8 probabilities within +-1 with at
most 5% off, because the convolutions sum in another order.  Engine
outputs meet the parity contract (docs/PARITY.md)."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hifimeth_tpu.engine.call import CallConfig as JaxCallConfig
from hifimeth_tpu.engine.call import run_call as jax_run_call
from hifimeth_tpu.features import windows as jw
from hifimeth_tpu.model.cnn import conv_spec, dnamodnet_apply
from hifimeth_tpu.model.cnn import load_params_npz as jax_load
from hifimeth_tpu.model.cnn import logits_to_scaled_probs as jax_probs
from hifimeth_tpu_torch.engine.call import CallConfig, CallEngine, run_call
from hifimeth_tpu_torch.features.windows import (call_sites_batched,
                                                 featurize_planes,
                                                 featurize_planes_folded,
                                                 featurize_planes_seg,
                                                 fold_table,
                                                 gather_windows_folded,
                                                 gather_windows_slice)
from hifimeth_tpu_torch.io.bam import BamReader
from hifimeth_tpu_torch.model.cnn import DNAModNet, params_from_jax

from test_torch_call import _assert_contract, _tags
from util import make_kinetics_read, write_bam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models")
DATA = os.path.join(ROOT, "tests", "data")
KMER = 401
CAP = 4096


def _planes(rng, cap=CAP, margin=KMER):
    """Packed planes as the engine fills them: 255/0 margins, codes 0..3
    with a few IUPAC codes (> 3), random codeV1 kinetics."""
    p = np.zeros((5, cap), np.uint8)
    p[0].fill(255)
    p[0, margin:cap - margin] = rng.choice([0, 1, 2, 3, 4, 9], cap - 2 * margin,
                                           p=[.24, .24, .24, .24, .02, .02])
    p[1:, margin:cap - margin] = rng.integers(0, 256, (4, cap - 2 * margin))
    return p


def _sites(rng, n, cap=CAP, pad=0):
    """Site descriptors inside the margins, some read bounds cutting the
    window, mixed strands; `pad` center-0 slots with empty read bounds as
    the engine pads a batch."""
    centers = rng.integers(KMER, cap - KMER, n).astype(np.int32)
    strands = rng.integers(0, 2, n).astype(np.uint8)
    rstart = np.full(n, KMER, np.int32)
    rend = np.full(n, cap - KMER, np.int32)
    rstart[::3] = centers[::3] - 37
    rend[::4] = centers[::4] + 11
    z = np.zeros(pad, np.int32)
    return (np.concatenate([centers, z]),
            np.concatenate([strands, np.zeros(pad, np.uint8)]),
            np.concatenate([rstart, z]), np.concatenate([rend, z]))


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.from_numpy(x) for x in a]


def test_featurize_planes_bit_equal_to_jax():
    planes = _planes(np.random.default_rng(1))
    got = featurize_planes(torch.from_numpy(planes))
    want = np.asarray(jw.featurize_planes(jnp.asarray(planes)))
    assert got.shape == (CAP, 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    folded = featurize_planes_folded(torch.from_numpy(planes))
    np.testing.assert_array_equal(
        folded.numpy(),
        np.asarray(jw.featurize_planes_folded(jnp.asarray(planes))))
    assert folded.shape == (CAP // 16, 128)


def test_featurize_prefix_with_zero_tail_equals_whole_buffer():
    planes = _planes(np.random.default_rng(2), margin=KMER)
    m = CAP - KMER                     # the filled prefix; the rest is fill
    got = featurize_planes_seg([torch.from_numpy(planes[:, :m].copy())], CAP)
    np.testing.assert_array_equal(got.numpy(),
                                  featurize_planes(torch.from_numpy(planes)))
    with pytest.raises(ValueError):
        featurize_planes_seg([torch.from_numpy(planes)], CAP - 128)
    with pytest.raises(ValueError):
        fold_table(got[:CAP - 8])


@pytest.mark.parametrize("strands", ["fwd", "rev", "mixed"])
@pytest.mark.parametrize("gather", ["slice", "folded"])
def test_gather_bit_equal_to_jax(gather, strands):
    """Read bounds that cut windows, and 8 padded center-0 slots (start
    -200: clamped by the slice gather, phase bits of a negative start in
    the folded one), which must come out all zero."""
    rng = np.random.default_rng(3)
    planes = _planes(rng)
    c, s, rs, re = _sites(rng, 56, pad=8)
    s[:56] = {"fwd": 0, "rev": 1, "mixed": s[:56]}[strands]
    if gather == "slice":
        table = jw.featurize_planes(jnp.asarray(planes))
        want = np.asarray(jw.gather_windows_slice(table, *_j(c, s, rs, re)))
        got = gather_windows_slice(featurize_planes(torch.from_numpy(planes)),
                                   *_t(c, s, rs, re))
    else:
        table = jw.featurize_planes_folded(jnp.asarray(planes))
        want = np.asarray(jw.gather_windows_folded(table, *_j(c, s, rs, re)))
        got = gather_windows_folded(
            featurize_planes_folded(torch.from_numpy(planes)),
            *_t(c, s, rs, re))
    assert got.shape == (64, KMER, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[56:].any()
    assert got[:56].any(dim=(1, 2)).all()


def test_slice_and_folded_agree_at_every_phase():
    """Every start phase mod 16 and the first and last in-table windows:
    the folded gather's phase shift equals the plain slice."""
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.standard_normal((CAP, 8)).astype(np.float32))
    hk = KMER // 2
    c = np.concatenate([np.arange(1000, 1016), [hk, CAP - 1 - hk]])
    c = c.astype(np.int32)
    s = (np.arange(len(c)) % 2).astype(np.uint8)
    rs = np.zeros(len(c), np.int32)
    re = np.full(len(c), CAP, np.int32)
    a = gather_windows_slice(feats, *_t(c, s, rs, re))
    b = gather_windows_folded(fold_table(feats), *_t(c, s, rs, re))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.fixture(scope="module", params=["CpG", "CHH"])
def model(request):
    params = jax_load(os.path.join(MODELS, f"{request.param}.npz"))
    return params, DNAModNet.from_state_dict(params_from_jax(params))


@pytest.mark.parametrize("gather", ["slice", "folded"])
def test_call_sites_batched_matches_jax(model, gather):
    params, module = model
    rng = np.random.default_rng(5)
    planes = _planes(rng)
    c, s, rs, re = _sites(rng, 120, pad=8)
    jtab = (jw.featurize_planes_folded if gather == "folded"
            else jw.featurize_planes)(jnp.asarray(planes))
    want = np.asarray(jw.call_sites_batched(
        params, jtab, *_j(c, s, rs, re), site_batch=64,
        spec=conv_spec(params), gather_impl=gather))
    ttab = (featurize_planes_folded if gather == "folded"
            else featurize_planes)(torch.from_numpy(planes))
    with torch.inference_mode():
        got = call_sites_batched(module, ttab, *_t(c, s, rs, re),
                                 site_batch=64, gather_impl=gather)
        # the CNN on the same windows
        w = (gather_windows_folded if gather == "folded"
             else gather_windows_slice)(ttab, *_t(c, s, rs, re))
        logits = module(w.transpose(1, 2).contiguous()).numpy()
    assert got.dtype == torch.uint8 and got.shape == (128,)
    d = np.abs(got.numpy().astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).sum() <= 0.05 * len(d)
    jlogits = np.asarray(dnamodnet_apply(params, jnp.asarray(w.numpy()),
                                         spec=conv_spec(params)))
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=2e-3)
    du8 = (logits_u8(logits) - np.asarray(jax_probs(jnp.asarray(jlogits)))
           .astype(int))
    assert np.abs(du8).max() <= 1
    with pytest.raises(ValueError):
        call_sites_batched(module, ttab, *_t(c[:100], s[:100], rs[:100],
                                             re[:100]), site_batch=64)
    with pytest.raises(ValueError):
        call_sites_batched(module, ttab, *_t(c, s, rs, re), site_batch=64,
                           gather_impl="pallas")


def logits_u8(logits):
    from hifimeth_tpu_torch.model.cnn import logits_to_scaled_probs
    return logits_to_scaled_probs(torch.from_numpy(logits)).numpy().astype(int)


def _flush_input(tmp_path):
    """tests/test_torch_call.py's flush-forcing reads (7 reads, a third on
    the reverse strand, plus a short and a kinetics-less read): against a
    16 Ki buffer they force buffer rollovers and padded batches."""
    rng = np.random.default_rng(7)
    recs = [make_kinetics_read(rng, f"r{i}", int(rng.integers(1500, 3000)),
                               flag=16 if i % 3 == 1 else 4)
            for i in range(7)]
    recs.insert(2, make_kinetics_read(rng, "short", 300))
    bam = str(tmp_path / "in.bam")
    write_bam(bam, recs)
    return bam


def _read(path):
    return [(r.qname, *_tags(r)) for r in BamReader(path)]


@pytest.mark.parametrize("impl", ["slice", "folded"])
def test_call_matches_jax_engine(tmp_path, impl):
    """The port's slice/folded paths against the JAX engine's same paths
    (flush_bases is ignored by both: they flush when the buffer is full)."""
    bam = _flush_input(tmp_path)
    jax_out = str(tmp_path / "jax.bam")
    jax_run_call(bam, jax_out, JaxCallConfig(
        site_batch=128, gather_impl=impl, buffer_bases=1 << 14))
    out = str(tmp_path / "torch.bam")
    stats = run_call(bam, out, CallConfig(
        site_batch=128, buffer_bases=1 << 14, flush_bases=4096,
        device="cpu", gather_impl=impl))
    assert stats["called_reads"] == 7
    _assert_contract(_read(out), _read(jax_out))


def test_call_slice_equals_folded_and_meets_pallas(tmp_path):
    """The port's two indexing paths give the same windows, so the same
    bytes; against its pallas path they meet the parity contract."""
    bam = _flush_input(tmp_path)
    outs = {}
    for impl in ("slice", "folded", "pallas"):
        outs[impl] = str(tmp_path / f"{impl}.bam")
        run_call(bam, outs[impl], CallConfig(
            site_batch=128, buffer_bases=1 << 14, flush_bases=4096,
            device="cpu", gather_impl=impl))
    got = {k: _read(v) for k, v in outs.items()}
    for (q, mm, ml, mn), (q2, mm2, ml2, mn2) in zip(got["slice"],
                                                    got["folded"]):
        assert (q, mm, mn) == (q2, mm2, mn2)
        assert (ml is None and ml2 is None) or np.array_equal(ml, ml2)
    _assert_contract(got["slice"], got["pallas"])


@pytest.mark.parametrize("impl", ["slice", "folded"])
def test_cli_gather_impl_on_cpu(tmp_path, capsys, impl):
    from hifimeth_tpu_torch.cli import main

    out = str(tmp_path / "cli.bam")
    assert main(["call", "--device", "cpu", "--gather-impl", impl, "-s",
                 "512", "-c", "cpg,chh",
                 os.path.join(DATA, "golden_call_in.bam"), out]) == 0
    assert impl in capsys.readouterr().err
    recs = list(BamReader(out))
    assert len(recs) == 12
    assert any(r.get_tag("MM") is not None for r in recs)


def test_engine_keeps_slice_and_folded():
    for impl in ("slice", "folded"):
        engine = CallEngine(CallConfig(device="cpu", gather_impl=impl,
                                       buffer_bases=1000))
        assert engine.cfg.gather_impl == impl
        assert engine.cfg.buffer_bases == 1024 and not engine.models.fused
