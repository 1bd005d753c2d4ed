"""DNAModNet's convolution + bias + ReLU, one kernel per layer on the card.

`conv1d_relu` computes relu(conv1d(x, weight, stride 2, zero pad (lo, hi))
+ bias) for a contiguous (B, Cin, L) float32 input, as (B, Cout, Lo): the
layer of model/cnn.py's direct route.  The weight arrives packed
(`pack_weight`): the (Cin*K, Cout) matrix, row c*K + k for channel c and
tap k, which is also the im2col route's matrix.  Packing is done once, when
the model is loaded (DNAModNet.set_conv_impl, and set_compute_dtype for the
bf16 mode's bf16-valued weights), so that each chunk of the kernel's ring
is whole rows of it, copied 16 bytes at a time, and no CTA transposes
anything.  Given bn0's `scale` and `shift` (the first layer only) it
applies x * scale + shift to the input first, and the padding pads that
result with 0.

On a CUDA tensor the wrapper launches the hand-written kernel in
ops/csrc/conv1d_relu.cu; on a CPU tensor it runs `conv1d_relu_plain` on the
unpacked weight, the arithmetic the module ran before the kernel (F.conv1d
with the bias, then F.relu, bn0 as its own multiply and add).  The kernel
is built for the layer shapes of the shipped nets (`SHAPES`); the wrapper
raises on any other, and on a weight not in the packed layout, on either
device, and nothing falls back: a failed build or launch raises.

The kernel (the source note gives the rest): an implicit GEMM on the FFMA
units in full float32, every product one fmaf in the plain version's order
(channel, then tap, into one float32 accumulator), so its outputs are
bit-equal to the plain version's.  No tensor cores: the configuration runs
float32 with TF32 off, and TF32 or 3xTF32 products would change both the
precision and the order of the sums.  Each CTA computes 128 (site,
position) rows by the whole of Cout from a four-stage cp.async ring: the
input as im2col columns, the weight chunk as whole packed rows in 16-byte
copies.  Its bound is the FFMA rate, 67 TFLOP/s; a batch of 8,192 sites
needs, layer by layer (CpG / CHH): conv0 0.543 / 0.638 ms, conv1 1.190 /
1.178, conv2 0.601 / 0.589, conv3 0.225, conv4 0.088, conv5 0.047, conv6
0.018, conv7 0.006; 2.718 / 2.790 ms the eight.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

#: (Cin, K, Cout) of every layer of models/{CpG,CHG,CHH}.npz, the shapes
#: the kernel is compiled for (HM_CONV in ops/csrc/conv1d_relu.cu)
SHAPES = frozenset({(8, 11, 128), (8, 13, 128), (128, 3, 128), (128, 3, 96),
                    (96, 3, 96), (96, 3, 64), (64, 3, 64)})
#: stride and zero padding of every shipped layer
STRIDE = 2
PAD = (1, 1)
#: input channels of the layer that takes bn0 (the first)
BN0_CHANNELS = 8


def out_length(length: int, k: int, stride: int = STRIDE,
               pad: tuple[int, int] = PAD) -> int:
    return (length + pad[0] + pad[1] - k) // stride + 1


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """A (Cout, Cin, K) weight as the kernel's packed (Cin*K, Cout) matrix,
    row c*K + k for channel c and tap k (a new contiguous tensor)."""
    return weight.detach().reshape(weight.shape[0], -1).t().contiguous()


def unpack_weight(packed: torch.Tensor, cin: int) -> torch.Tensor:
    """The packed (Cin*K, Cout) matrix back as the (Cout, Cin, K) weight."""
    rows, cout = packed.shape
    return packed.t().reshape(cout, cin, rows // cin)


def conv1d_relu_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, stride: int,
                      pad: tuple[int, int], scale: torch.Tensor | None = None,
                      shift: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, for any geometry; `weight` is
    (Cout, Cin, K), as F.conv1d takes it."""
    if scale is not None:
        x = x * scale[:, None] + shift[:, None]
    lo, hi = pad
    if lo == hi:
        h = F.conv1d(x, weight, bias, stride=stride, padding=lo)
    else:
        h = F.conv1d(F.pad(x, (lo, hi)), weight, bias, stride=stride)
    return F.relu(h)


_KERNEL_LIB = None


def _kernel_lib():
    global _KERNEL_LIB
    if _KERNEL_LIB is None:
        from .build import kernel_library
        lib = ctypes.CDLL(kernel_library("conv1d_relu"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hm_conv1d_relu.restype = ci
        lib.hm_conv1d_relu.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                       ci, ci, ci, vp]
        _KERNEL_LIB = lib
    return _KERNEL_LIB


def _check(x, weight, bias, stride, pad, scale, shift) -> None:
    """ValueError unless the kernel takes these arguments (`weight` packed)."""
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if x.dim() != 3 or bias.dim() != 1:
        raise ValueError(f"x must be (B, Cin, L) and bias (Cout,), got "
                         f"{tuple(x.shape)} and {tuple(bias.shape)}")
    cin = x.shape[1]
    if weight.dim() != 2 or cin < 1 or weight.shape[0] % cin:
        raise ValueError(f"weight must be packed (pack_weight): the (Cin*K, "
                         f"Cout) matrix for Cin {cin}, got "
                         f"{tuple(weight.shape)}")
    k, cout = weight.shape[0] // cin, weight.shape[1]
    if bias.shape[0] != cout:
        raise ValueError(f"x {tuple(x.shape)}, packed weight "
                         f"{tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} do not match")
    if ((cin, k, cout) not in SHAPES or stride != STRIDE
            or tuple(pad) != PAD):
        raise ValueError(f"no kernel for Cin {cin}, K {k}, Cout {cout}, "
                         f"stride {stride}, pad {tuple(pad)}: the shipped "
                         f"layers are {sorted(SHAPES)}, stride {STRIDE}, pad "
                         f"{PAD}")
    if (scale is None) != (shift is None):
        raise ValueError("bn0 needs both scale and shift")
    if scale is not None:
        if cin != BN0_CHANNELS:
            raise ValueError(f"bn0 folds into the first layer only (Cin "
                             f"{BN0_CHANNELS}), got Cin {cin}")
        for name, t in (("scale", scale), ("shift", shift)):
            if t.dtype != torch.float32 or tuple(t.shape) != (cin,):
                raise ValueError(f"{name} must be ({cin},) float32")
    tensors = [x, weight, bias] + ([scale, shift] if scale is not None
                                   else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, weight, bias, scale and shift must be "
                         "contiguous")
    if weight.data_ptr() % 16:
        raise ValueError("the packed weight must start on 16 bytes: the "
                         "kernel copies its rows in 16-byte units")
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, weight, bias, scale and shift must share one "
                         "device")
    if x.shape[2] < 1 or out_length(x.shape[2], k) < 1:
        raise ValueError(f"input length {x.shape[2]} gives no output")
    if max(x.numel(), x.shape[0] * cout * out_length(x.shape[2], k)) >= 2**31:
        raise ValueError("x or the output holds 2**31 values or more")


def conv1d_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                stride: int, pad: tuple[int, int],
                scale: torch.Tensor | None = None,
                shift: torch.Tensor | None = None) -> torch.Tensor:
    """(B, Cin, L) float32 -> (B, Cout, Lo) float32: relu(conv1d(x', w) + b)
    with x' = x, or x * scale + shift per channel when bn0's `scale` and
    `shift` are given; stride and zero pad (lo, hi) of a shipped layer.
    `weight` is w packed (`pack_weight`), the (Cin*K, Cout) matrix.

    CUDA tensors launch the kernel (counted in `conv1d_relu.launches`); CPU
    tensors run the plain version.  Raises ValueError on what the kernel
    does not take, on either device."""
    _check(x, weight, bias, stride, pad, scale, shift)
    if x.device.type == "cpu":
        return conv1d_relu_plain(x, unpack_weight(weight, x.shape[1]), bias,
                                 stride, pad, scale, shift)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, cin, length = x.shape
    k, cout = weight.shape[0] // cin, weight.shape[1]
    lo_len = out_length(length, k, stride, pad)
    out = torch.empty((b, cout, lo_len), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hm_conv1d_relu(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), out.data_ptr(),
            b, cin, length, cout, k, pad[0], lo_len, stream)
    if err != 0:
        raise RuntimeError(f"conv1d_relu launch failed: CUDA error {err}")
    conv1d_relu.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads it to show the
#: main path went through the kernel); a replay of a captured program adds
#: the launches its body made (engine/programs.py), its capture none
conv1d_relu.launches = 0
