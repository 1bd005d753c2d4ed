"""The reference per-site path, gather_windows and call_sites, against the
JAX package's on the CPU.

Windows are copies of the same table values, so bit-equal, on both strands
and for sites at their read's edges (first and last base, one base inside,
read bounds at the table's ends, where the gather clamps its positions).
The model on them: logits within 1e-4 of JAX's dnamodnet_apply (the
tolerance of tests/test_torch_model.py), u8 probabilities within +-1 of
JAX's call_sites with at most 5% off.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hifimeth_tpu.features import windows as jw
from hifimeth_tpu.model.cnn import conv_spec, dnamodnet_apply
from hifimeth_tpu.model.cnn import load_params_npz as jax_load
from hifimeth_tpu_torch.features.windows import (call_sites,
                                                 featurize_planes,
                                                 gather_windows)
from hifimeth_tpu_torch.model.cnn import DNAModNet, params_from_jax

from test_torch_windows import CAP, KMER, MODELS, _j, _planes, _sites, _t


def _edge_sites(rng, n=96):
    """Random sites plus sites on their read's first and last bases, one
    base inside each, and reads that start at row 0 or end at the table's
    last row."""
    c, s, rs, re = _sites(rng, n)
    lo = rng.integers(KMER, CAP // 2, 8).astype(np.int32)
    hi = lo + rng.integers(50, 900, 8).astype(np.int32)
    ec = np.concatenate([lo, lo + 1, hi - 1, hi - 2])
    ers = np.tile(lo, 4)
    ere = np.tile(hi, 4)
    # reads at the table's ends: windows reach past row 0 and row CAP - 1
    ec = np.concatenate([ec, [0, 5, CAP - 1, CAP - 6]]).astype(np.int32)
    ers = np.concatenate([ers, [0, 0, CAP - 300, CAP - 300]]).astype(np.int32)
    ere = np.concatenate([ere, [300, 300, CAP, CAP]]).astype(np.int32)
    es = rng.integers(0, 2, len(ec)).astype(np.uint8)
    return (np.concatenate([c, ec]), np.concatenate([s, es]),
            np.concatenate([rs, ers]), np.concatenate([re, ere]))


@pytest.mark.parametrize("strands", ["fwd", "rev", "mixed"])
def test_gather_windows_bit_equal_to_jax(strands):
    rng = np.random.default_rng(31)
    planes = _planes(rng, margin=0)
    c, s, rs, re = _edge_sites(rng)
    s[:] = {"fwd": 0, "rev": 1, "mixed": s}[strands]
    want = np.asarray(jw.gather_windows(jw.featurize_planes(
        jnp.asarray(planes)), *_j(c, s, rs, re)))
    got = gather_windows(featurize_planes(torch.from_numpy(planes)),
                         *_t(c, s, rs, re))
    assert got.shape == (len(c), KMER, 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # a site on its read's first base sees nothing before it
    first = 96 + 0
    hk = KMER // 2
    side = slice(0, hk) if s[first] == 0 else slice(hk + 1, KMER)
    assert not got[first, side].any() and got[first, hk].any()


@pytest.fixture(scope="module", params=["CpG", "CHH"])
def model(request):
    params = jax_load(os.path.join(MODELS, f"{request.param}.npz"))
    return params, DNAModNet.from_state_dict(params_from_jax(params))


def test_call_sites_matches_jax(model):
    params, module = model
    rng = np.random.default_rng(37)
    planes = _planes(rng, margin=0)
    c, s, rs, re = _edge_sites(rng)
    jtab = jw.featurize_planes(jnp.asarray(planes))
    want = np.asarray(jw.call_sites(params, jtab, *_j(c, s, rs, re),
                                    spec=conv_spec(params)))
    ttab = featurize_planes(torch.from_numpy(planes))
    with torch.inference_mode():
        got = call_sites(module, ttab, *_t(c, s, rs, re))
        w = gather_windows(ttab, *_t(c, s, rs, re))
        logits = module(w.transpose(1, 2).contiguous()).numpy()
    assert got.dtype == torch.uint8 and got.shape == (len(c),)
    d = np.abs(got.numpy().astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).sum() <= 0.05 * len(d)
    jlogits = np.asarray(dnamodnet_apply(params, jw.gather_windows(
        jtab, *_j(c, s, rs, re)), spec=conv_spec(params)))
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=1e-4)
