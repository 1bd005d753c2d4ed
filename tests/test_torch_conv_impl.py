"""CallConfig.conv_impl and DNAModNet.set_conv_impl (direct | im2col |
auto) against the JAX package's dnamodnet_apply(conv_impl=) and its engine,
on the CPU.

im2col runs a conv as one (B*Lo, Cin*K) @ (Cin*K, Cout) product over the
padded input's K strided columns (the JAX package's _conv1d_im2col);
"auto" takes it where Cin * K <= 256 (conv1 of every shipped model).
Tolerances: float32 logits within rtol 1e-5, atol 1e-5 of JAX's
dnamodnet_apply with the same conv_impl on the same weights and windows,
and of the port's own direct route (the products sum in another order);
bf16 logits within 0.1 absolute and 2e-3 on average of JAX's compiled
bf16 forward (tests/test_torch_dtype.py's band: a sum that lands on the
other side of a bf16 rounding moves later layers) and of the port's own
direct bf16 route.  Engine runs with conv_impl im2col and auto on
pallas, slice and folded against the JAX engine with the same setting:
MM/MN byte-equal, ML within +-1 and at most 5% of bytes off
(docs/PARITY.md).
"""
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hifimeth_tpu.engine.call import CallConfig as JaxCallConfig
from hifimeth_tpu.engine.call import run_call as jax_run_call
from hifimeth_tpu.model.cnn import conv_spec, dnamodnet_apply
from hifimeth_tpu.model.cnn import load_params_npz as jax_load
from hifimeth_tpu_torch.engine.call import (CallConfig, CallEngine, ModelSet,
                                            run_call)
from hifimeth_tpu_torch.model.cnn import (DNAModNet, load_model_npz,
                                          params_from_jax, uses_im2col)
from hifimeth_tpu_torch.ops.conv import pack_weight

from test_torch_dtype import _windows
from test_torch_slice_programs import (SMALL, assert_against_jax, reads_bam,
                                       small_model_dir, small_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models")
RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread per test: the test workers share the
    cores, and an oversubscribed thread pool stalls on every small op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module(params, conv_impl, dtype=torch.float32):
    return DNAModNet.from_state_dict(params_from_jax(params)) \
        .set_compute_dtype(dtype).set_conv_impl(conv_impl)


def _forward(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x).permute(0, 2, 1).contiguous()).numpy()


def _params(source):
    if source == "small":
        return small_params("CHH", 7)
    return jax_load(os.path.join(MODELS, f"{source}.npz"))


@pytest.mark.parametrize("conv_impl", ["im2col", "auto"])
@pytest.mark.parametrize("source", ["CpG", "CHH", "small"])
def test_logits_match_jax_and_direct(source, conv_impl):
    params = _params(source)
    x = _windows(np.random.default_rng(2), 48)
    want = np.asarray(dnamodnet_apply(params, jnp.asarray(x),
                                      spec=conv_spec(params),
                                      conv_impl=conv_impl))
    model = _module(params, conv_impl)
    routes = [c.im2col for c in model.convs]
    want_routes = [conv_impl == "im2col" or c["w"].shape[0]
                   * c["w"].shape[1] <= 256 for c in params["convs"]]
    assert routes == want_routes
    if conv_impl == "auto":
        # conv1 only on the shipped models; the small one's conv3 (Cin*K
        # 288) stays direct
        assert routes[0] and not all(routes)
    got = _forward(model, x)
    assert got.dtype == np.float32 and got.shape == (48, 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    direct = _forward(_module(params, "direct"), x)
    np.testing.assert_allclose(got, direct, rtol=RTOL, atol=ATOL)
    assert np.abs(got - direct).max() > 0 or source == "small"


@pytest.mark.parametrize("conv_impl", ["im2col", "auto"])
@pytest.mark.parametrize("ctx", ["CpG", "CHH"])
def test_bf16_logits_match_jax(ctx, conv_impl):
    """bf16 operands, float32 sums, one rounding a layer, with the im2col
    matrices rounded from the same weights: within the bf16 band of JAX's
    compiled forward, and of the port's direct bf16 route."""
    params = _params(ctx)
    x = _windows(np.random.default_rng(3), 48)
    jax_bf16 = jax.jit(partial(dnamodnet_apply, compute_dtype=jnp.bfloat16,
                               spec=conv_spec(params), conv_impl=conv_impl))
    want = np.asarray(jax_bf16(params, x))
    model = _module(params, conv_impl, torch.bfloat16)
    got = _forward(model, x)
    for other in (want, _forward(_module(params, "direct", torch.bfloat16),
                                 x)):
        d = np.abs(got - other)
        assert d.max() <= 0.1 and d.mean() <= 2e-3, (d.max(), d.mean())
    f32 = _forward(_module(params, conv_impl), x)
    assert np.abs(got - f32).mean() > 1e-3       # not a float32 run
    # the route and the bf16 weights follow each other in either order
    again = _forward(DNAModNet.from_state_dict(params_from_jax(params))
                     .set_conv_impl(conv_impl)
                     .set_compute_dtype(torch.bfloat16), x)
    np.testing.assert_array_equal(got, again)


def test_route_rule_and_unknown_names(tmp_path):
    assert uses_im2col("im2col", 128, 3)
    assert uses_im2col("auto", 8, 11) and uses_im2col("auto", 8, 32)
    assert not uses_im2col("auto", 8, 33) and not uses_im2col("direct", 8, 3)
    model = _module(_params("small"), "direct")
    for bad in ("fft", "", "Direct"):
        with pytest.raises(ValueError, match="unknown conv_impl"):
            uses_im2col(bad, 8, 3)
        with pytest.raises(ValueError, match="unknown conv_impl"):
            model.set_conv_impl(bad)
        with pytest.raises(ValueError, match="unknown conv_impl"):
            CallEngine(CallConfig(device="cpu", contexts=("CpG",),
                                  conv_impl=bad))
    # switching back restores direct
    model.set_conv_impl("im2col").set_conv_impl("direct")
    assert not any(c.im2col for c in model.convs)
    assert all(torch.equal(c._mat, pack_weight(c.weight))
               for c in model.convs)


def test_model_sets_keyed_by_route():
    """Engines of one route share one set; another route loads its own;
    the fused path ignores the route (it runs no DNAModNet) and warns
    nothing about it."""
    kw = dict(device="cpu", contexts=("CpG",))
    sets = {impl: CallEngine(CallConfig(**kw, conv_impl=impl)).models
            for impl in ("direct", "im2col", "auto")}
    assert len({id(s) for s in sets.values()}) == 3
    assert CallEngine(CallConfig(**kw, conv_impl="auto")).models is \
        sets["auto"]
    assert sets["auto"].models["CpG"].conv_impl == "auto"
    fused = CallEngine(CallConfig(**kw, gather_impl="fused",
                                  conv_impl="im2col"))
    assert fused.models.models["CpG"].conv_impl == "direct"
    assert ModelSet.cached(MODELS, ("CpG",), "cpu", conv_impl="auto",
                           feat_channels=32) is sets["auto"]
    model = load_model_npz(os.path.join(MODELS, "CHH.npz"), "cpu",
                           conv_impl="im2col")
    assert all(c.im2col for c in model.convs)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return small_model_dir(tmp_path_factory.mktemp("conv_models"))


@pytest.mark.parametrize("conv_impl", ["im2col", "auto"])
@pytest.mark.parametrize("impl", ["pallas", "slice", "folded"])
def test_engine_matches_jax_engine(models, tmp_path, impl, conv_impl):
    """The engine with conv_impl on each path that runs DNAModNet against
    the JAX engine with the same setting (pallas in interpret mode), and
    against its own direct run."""
    bam = reads_bam(tmp_path / "in.bam", 31, n=8)
    kw = dict(SMALL, model_dir=models, gather_impl=impl)
    out = {}
    for name in (conv_impl, "direct"):
        out[name] = str(tmp_path / f"{name}.bam")
        run_call(bam, out[name], CallConfig(**kw, conv_impl=name,
                                            device="cpu"))
    jax_out = str(tmp_path / "jax.bam")
    jax_run_call(bam, jax_out, JaxCallConfig(**kw, conv_impl=conv_impl))
    assert_against_jax(out[conv_impl], jax_out, "float32")
    assert_against_jax(out[conv_impl], out["direct"], "float32")
