"""DNAModNet in PyTorch against the JAX package's dnamodnet_apply, for each
shipped model.  Tolerances: logits within 1e-4 absolute (float32 sums taken
in another order by the two frameworks' convolutions), u8 probabilities
within +-1 (docs/PARITY.md)."""
import os

import numpy as np
import pytest
import torch

from hifimeth_tpu.model.cnn import dnamodnet_apply
from hifimeth_tpu.model.cnn import load_params_npz as jax_load
from hifimeth_tpu.model.cnn import logits_to_scaled_probs as jax_probs
from hifimeth_tpu_torch.model.cnn import (DNAModNet, load_params_npz,
                                          logits_to_scaled_probs,
                                          params_from_jax)

MODELS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models")


def _windows(rng, b, kmer=401):
    x = np.zeros((b, kmer, 8), np.float32)
    codes = rng.integers(0, 4, (b, kmer))
    x[np.arange(b)[:, None], np.arange(kmer)[None, :], codes] = 1.0
    x[..., 4:] = rng.random((b, kmer, 4), dtype=np.float32)
    return x


@pytest.mark.parametrize("ctx", ["CpG", "CHG", "CHH"])
def test_logits_match_jax(ctx):
    params = jax_load(os.path.join(MODELS, f"{ctx}.npz"))
    x = _windows(np.random.default_rng(1), 24)
    want = np.asarray(dnamodnet_apply(params, x))
    model = DNAModNet.from_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 2, 1).contiguous())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    d = (logits_to_scaled_probs(got).numpy().astype(int)
         - np.asarray(jax_probs(want)).astype(int))
    assert np.abs(d).max() <= 1


@pytest.mark.parametrize("ctx", ["CpG", "CHG", "CHH"])
def test_npz_loader_equals_params_from_jax(ctx):
    path = os.path.join(MODELS, f"{ctx}.npz")
    a = params_from_jax(load_params_npz(path))
    b = params_from_jax(jax_load(path))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    model = DNAModNet.from_state_dict(a)
    k1 = 13 if ctx == "CHH" else 11
    assert tuple(model.convs[0].weight.shape) == (128, 8, k1)
    assert len(model.convs) == 8 and model.fc1.in_features == 128


def test_scaled_probs_edges():
    logits = torch.tensor([[0.0, 0.0], [-50.0, 50.0], [50.0, -50.0],
                           [1.0, 2.0]], dtype=torch.float32)
    got = logits_to_scaled_probs(logits).numpy()
    want = np.asarray(jax_probs(logits.numpy()))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and got[1] == 255 and got[2] == 0
