"""The direct route's convolution wrapper (ops/conv.py conv1d_relu) on the
CPU, where it runs its plain version, and the weight layout it takes.

The wrapper takes the weight packed (pack_weight): the (Cin*K, Cout)
matrix, row c*K + k, which the model makes once when it is loaded
(set_conv_impl, and set_compute_dtype for bf16).  For each of the seven
shipped layer shapes the packed matrix holds w[:, c, k] in row c*K + k,
unpacks to the weight bit for bit, and the plain version run from it
equals F.conv1d bit for bit, in float32 and on bf16-valued inputs and
weights; a weight in another layout (unpacked, transposed, of other rows,
off 16-byte alignment) is refused.

The plain version must be the arithmetic DNAModNet's direct route ran
before the kernel, bit for bit: F.conv1d with the bias then F.relu, for
every layer of the shipped nets, on float32 and on bf16-valued inputs and
weights (the bf16 mode's convs); with bn0 folded into the first layer, bn0
as its own multiply and add first, the padding padding bn0's output with
0.  The wrapper's checks run before its device branch, so the CPU holds
them too: a wrong dtype, a non-contiguous tensor or a layer shape the
kernel is not built for raises ValueError.  DNAModNet's logits on the CPU
stay those of the module's former forward under every conv_impl.  The
kernel itself runs only on the card (chip_smoke.py compares it with the
plain version there).
"""
import glob
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hifimeth_tpu_torch.model.cnn import CONV_IMPLS, load_model_npz
from hifimeth_tpu_torch.ops import build
from hifimeth_tpu_torch.ops.conv import (PAD, SHAPES, STRIDE, conv1d_relu,
                                         conv1d_relu_plain, out_length,
                                         pack_weight, unpack_weight)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, "models")
CONTEXTS = ("CpG", "CHG", "CHH")
KMER = 401
N_LAYERS = 8
GEOMETRIES = [(ctx, i) for ctx in CONTEXTS for i in range(N_LAYERS)]


def _model(ctx, conv_impl="direct", dtype=torch.float32):
    return load_model_npz(os.path.join(MODELS, f"{ctx}.npz"), "cpu", dtype,
                          conv_impl).requires_grad_(False)


def _input_length(model, layer):
    n = KMER
    for conv in model.convs[:layer]:
        n = out_length(n, conv.weight.shape[2])
    return n


def _x(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("bf16_valued", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("ctx,layer", GEOMETRIES,
                         ids=[f"{c}-conv{i}" for c, i in GEOMETRIES])
def test_plain_is_the_former_arithmetic(ctx, layer, bf16_valued):
    model = _model(ctx)
    conv = model.convs[layer]
    cout, cin, k = conv.weight.shape
    assert (cin, k, cout) in SHAPES
    assert (conv.stride, (conv.lo, conv.hi)) == (STRIDE, PAD)
    x = _x(np.random.default_rng(layer), 3, cin, _input_length(model, layer))
    w = conv.weight
    if bf16_valued:
        x = x.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    want = F.relu(F.conv1d(x, w, conv.bias, stride=STRIDE, padding=PAD[0]))
    got = conv1d_relu(x, pack_weight(w), conv.bias, STRIDE, PAD)
    assert got.shape == (3, cout, out_length(x.shape[2], k))
    assert torch.equal(got, want)
    assert torch.equal(conv(x, None if not bf16_valued else pack_weight(w)),
                       want)


@pytest.mark.parametrize("ctx", CONTEXTS)
def test_bn0_folds_into_the_first_layer(ctx):
    model = _model(ctx)
    conv, bn0 = model.convs[0], model.bn0
    x = _x(np.random.default_rng(7), 4, 8, KMER)
    want = F.relu(F.conv1d(bn0(x), conv.weight, conv.bias, stride=STRIDE,
                           padding=PAD[0]))
    got = conv1d_relu(x, conv._mat, conv.bias, STRIDE, PAD, bn0.scale,
                      bn0.shift)
    assert torch.equal(got, want)
    assert torch.equal(conv(x, bn0=bn0), want)
    # the padding pads bn0's output with 0: padding the input instead
    # (so that a padded position reads `shift`) moves both edge outputs
    shift = bn0.shift + 1.0
    got = conv1d_relu(x, conv._mat, conv.bias, STRIDE, PAD, bn0.scale,
                      shift)
    padded_in = F.pad(x, PAD) * bn0.scale[:, None] + shift[:, None]
    wrong = F.relu(F.conv1d(padded_in, conv.weight, conv.bias, stride=STRIDE))
    torch.testing.assert_close(got[..., 1:-1], wrong[..., 1:-1], rtol=1e-5,
                               atol=1e-5)
    for edge in (0, -1):
        assert (got[..., edge] - wrong[..., edge]).abs().max() > 1e-2


SHAPE_IDS = [f"{cin}x{k}-{cout}" for cin, k, cout in sorted(SHAPES)]


@pytest.mark.parametrize("bf16_valued", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(SHAPES), ids=SHAPE_IDS)
def test_packed_weight_layout(shape, bf16_valued):
    cin, k, cout = shape
    rng = np.random.default_rng(cin * k + cout)
    w, x = _x(rng, cout, cin, k), _x(rng, 2, cin, 2 * k + 9)
    if bf16_valued:
        w, x = w.to(torch.bfloat16).float(), x.to(torch.bfloat16).float()
    packed = pack_weight(w)
    assert packed.shape == (cin * k, cout) and packed.is_contiguous()
    for c in (0, cin // 2, cin - 1):
        for t in range(k):
            assert torch.equal(packed[c * k + t], w[:, c, t])
    assert torch.equal(unpack_weight(packed, cin), w)
    bias = _x(rng, cout)
    want = F.relu(F.conv1d(x, w, bias, stride=STRIDE, padding=PAD[0]))
    assert torch.equal(conv1d_relu(x, packed, bias, STRIDE, PAD), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_model_packs_its_weights_once(dtype):
    model = _model("CHH", dtype=dtype)
    for i, conv in enumerate(model.convs):
        assert torch.equal(conv._mat, pack_weight(conv.weight))
        if dtype == torch.bfloat16:
            assert torch.equal(model._low[0][i], pack_weight(
                conv.weight.to(dtype).float()))


def _args(rng, cin=128, k=3, cout=96, length=25):
    return dict(x=_x(rng, 2, cin, length),
                weight=pack_weight(_x(rng, cout, cin, k)),
                bias=_x(rng, cout), stride=STRIDE, pad=PAD)


def _bad_args(case):
    rng = np.random.default_rng(3)
    a = _args(rng)
    if case == "x float64":
        a["x"] = a["x"].double()
    elif case == "x bfloat16":
        a["x"] = a["x"].to(torch.bfloat16)
    elif case == "weight float16":
        a["weight"] = a["weight"].half()
    elif case == "x not contiguous":
        a["x"] = a["x"].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "weight not contiguous":
        a["weight"] = a["weight"].t().contiguous().t()
    elif case == "weight (Cout, Cin, K)":
        a["weight"] = unpack_weight(a["weight"], 128).contiguous()
    elif case == "weight transposed":
        a["weight"] = a["weight"].t().contiguous()
    elif case == "weight rows not Cin * K":
        a["weight"] = a["weight"][:-1].contiguous()
    elif case == "weight off 16 bytes":
        flat = torch.zeros(a["weight"].numel() + 1)
        a["weight"] = flat[1:].view(a["weight"].shape)
    elif case == "shape not shipped":
        a = _args(rng, cin=16, k=5, cout=32)
    elif case == "cout not shipped":
        a = _args(rng, cin=128, k=3, cout=32)
    elif case == "stride 1":
        a["stride"] = 1
    elif case == "pad (2, 1)":
        a["pad"] = (2, 1)
    elif case == "bias of another width":
        a["bias"] = a["bias"][:64].contiguous()
    elif case == "x of another width":
        a["x"] = _x(rng, 2, 64, 25)
    elif case == "bn0 on a later layer":
        a.update(scale=torch.ones(128), shift=torch.zeros(128))
    elif case == "scale without shift":
        a = _args(rng, cin=8, k=11, cout=128, length=KMER)
        a["scale"] = torch.ones(8)
    elif case == "scale of another width":
        a = _args(rng, cin=8, k=11, cout=128, length=KMER)
        a.update(scale=torch.ones(4), shift=torch.zeros(8))
    elif case == "input too short":
        a = _args(rng, cin=8, k=11, cout=128, length=4)
    else:
        raise KeyError(case)
    return a


BAD = ["x float64", "x bfloat16", "weight float16", "x not contiguous",
       "weight not contiguous", "weight (Cout, Cin, K)", "weight transposed",
       "weight rows not Cin * K", "weight off 16 bytes",
       "shape not shipped", "cout not shipped",
       "stride 1", "pad (2, 1)", "bias of another width",
       "x of another width", "bn0 on a later layer", "scale without shift",
       "scale of another width", "input too short"]


@pytest.mark.parametrize("case", BAD)
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    a = _bad_args(case)
    with pytest.raises(ValueError):
        conv1d_relu(**a)


def test_no_launch_on_the_cpu():
    conv1d_relu.launches = 0
    rng = np.random.default_rng(4)
    a = _args(rng)
    want = conv1d_relu_plain(**{**a, "weight": unpack_weight(a["weight"],
                                                             128)})
    assert torch.equal(conv1d_relu(**a), want)
    model = _model("CHH")
    with torch.inference_mode():
        model(_x(rng, 2, 8, KMER))
    assert conv1d_relu.launches == 0


def test_build_lists_the_library():
    sources = {os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(build.CSRC_DIR, "*.cu"))}
    assert "conv1d_relu" in build.KERNELS
    assert set(build.KERNELS) == sources


def _former_forward(model, x):
    """DNAModNet.forward as it was before the kernel: bn0 its own pass,
    each direct conv F.conv1d with the bias then F.relu."""
    cd = model.compute_dtype
    low = cd != torch.float32
    w_convs = ([unpack_weight(w, c.weight.shape[1]) if not c.im2col else w
                for c, w in zip(model.convs, model._low[0])] if low
               else [None] * len(model.convs))

    def rnd(h):
        return h.to(cd).float() if low else h

    h = rnd(model.bn0(x.float()))
    for conv, w in zip(model.convs, w_convs):
        if conv.im2col:
            h = conv._im2col(h, conv._mat if w is None else w)
        else:
            h = F.relu(F.conv1d(h, conv.weight if w is None else w,
                                conv.bias, stride=conv.stride,
                                padding=conv.lo))
        h = rnd(h)
    w1 = model._low[1] if low else model.fc1.weight
    w2 = model._low[2] if low else model.fc2.weight
    h = F.relu(F.linear(h.flatten(1), w1, model.fc1.bias))
    return F.linear(rnd(h), w2, model.fc2.bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("conv_impl", CONV_IMPLS)
@pytest.mark.parametrize("ctx", CONTEXTS)
def test_dnamodnet_logits_unchanged(ctx, conv_impl, dtype):
    model = _model(ctx, conv_impl, dtype)
    x = _x(np.random.default_rng(11), 6, 8, KMER)
    with torch.inference_mode():
        got = model(x)
        want = _former_forward(model, x)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
