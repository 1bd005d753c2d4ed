"""Window gather + the whole DNAModNet forward per site, in one kernel.

`call --gather-impl fused` sends every planned site through `fused_forward`:
the site's (8, kmer) window is cut out of the (8, N) feature table (flipped
and channel-permuted for the reverse strand, as in ops/gather.py), and bn0,
conv1..conv8, fc1 and fc2 run on it; only the 2 logits per site come back.

On a CUDA tensor the wrapper launches the hand-written kernels in
ops/csrc/fused_forward.cu (which replace the Pallas kernel
hifimeth_tpu/ops/fused.py:_fused_kernel; the source note there gives their
bound and design: 3xTF32 tensor-core GEMMs; conv1 and conv2 per site and
conv3 and conv4 per two sites on wgmma, then conv5..fc2 over 8 sites at a
time on mma.sync, the kernels handing activations over in a device
scratch buffer the wrapper allocates); one call counts one launch.
On a CPU tensor it runs `fused_forward_plain`, the same function in
PyTorch, computed from the same packed weights.  There is no fallback
between the two: a failed build or launch raises.

`prepare_fused_params` packs a DNAModNet into one contiguous float32 buffer
(bn0, the biases, the conv and fc1 weights as they are, fc2 as (in, out),
and the conv and fc1 weights once more split into TF32 halves in the
chunks the kernels stream into shared memory, see `pack_split`; each
tensor at an offset the kernel reads from `meta`) and checks the geometry the
kernel supports: the shipped 8-conv models, conv1 (11 | 13, 8, 128),
stride 2 and zero pad (1, 1) everywhere, convs 2-8 of kernel size 3 with
the shipped widths (`WIDTHS`), fc1 128 -> 256, fc2 256 -> 2.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..model.cnn import (DNAModNet, logits_to_scaled_probs, params_from_jax)
from .gather import GROUP, group_windows_t_plain

#: window size the fused path supports (the shipped models')
KMER = 401
N_CONVS = 8
IN_CHANNELS = 8
#: output channels of conv1..conv8 the kernel's tiles are built for
WIDTHS = (128, 128, 128, 96, 96, 96, 64, 64)
#: weight offsets are multiples of this many floats (16-byte bulk copies)
_ALIGN = 4
#: K-rows per weight chunk of conv1..conv8 and fc1, the depths the kernel's
#: tiles are built for (kTiling in ops/csrc/fused_forward.cu, which checks
#: them in `meta`)
CHUNK_K = (32, 32, 32, 32, 32, 32, 32, 32, 8)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as cvt.rna.tf32.f32 rounds: add half a TF32 ulp to the magnitude
    bits and clear the 13 dropped bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_split(w: torch.Tensor, kc: int) -> torch.Tensor:
    """(K, N) weight (K = taps x Cin, tap-major, N a multiple of 8) -> flat
    chunks of kc K-rows, K zero-padded to whole chunks; each chunk is its
    TF32 hi = rna(w) and then lo = rna(w - hi), each in the order wgmma
    reads an unswizzled K-major B tile: core matrices of 8 N-rows x 4
    K-values (128 contiguous bytes), index [k // 4][n // 8][n % 8][k % 4]."""
    k, n = w.shape
    w = F.pad(w, (0, 0, 0, -k % kc))
    hi = tf32_rna(w)
    lo = tf32_rna(w - hi)

    def core(t):
        return t.reshape(-1, kc // 4, 4, n // 8, 8).permute(0, 1, 3, 4, 2)

    return torch.stack([core(hi), core(lo)], 1).reshape(-1)


@dataclass(frozen=True)
class FusedWeights:
    """A DNAModNet packed for the fused kernel.

    buf: (n,) float32 on the model's device; layout: name -> (offset,
    shape, kc) of each tensor in `buf`: kc 0 for a tensor stored as it is
    (conv weights as (K, Cin, Cout), fc1 and fc2 as (in, out)), else the
    chunk depth of the copy "convs.{i}.split" or "fc1.split" of a GEMM
    weight, packed by `pack_split` as (K * Cin, Cout) or (in, out), which
    the kernel reads;
    lengths: per-conv output lengths for a `kmer` window; meta: the int32
    geometry the kernel reads."""
    buf: torch.Tensor
    layout: dict
    kmer: int
    lengths: tuple
    meta: np.ndarray

    def tensor(self, name: str) -> torch.Tensor:
        """A tensor stored as it is (not a split copy), as a view."""
        off, shape, kc = self.layout[name]
        if kc:
            raise ValueError(f"{name} is a split copy, not a tensor")
        return self.buf[off:off + int(np.prod(shape))].view(shape)

    def flops_per_window(self) -> int:
        """Multiply-adds x 2 of the convolutions and FC layers per site."""
        n = 0
        for i, lo in enumerate(self.lengths):
            k, cin, cout = self.layout[f"convs.{i}.w"][1]
            n += 2 * k * cin * cout * lo
        for name in ("fc1.w", "fc2.w"):
            fin, fout = self.layout[name][1]
            n += 2 * fin * fout
        return n


def _state_dict(model_or_state_dict) -> dict:
    if isinstance(model_or_state_dict, DNAModNet):
        return model_or_state_dict.state_dict()
    return dict(model_or_state_dict)


def prepare_fused_params(model_or_state_dict, device=None,
                         kmer: int = KMER) -> FusedWeights:
    """DNAModNet (or its state dict, model/cnn.py layout) -> FusedWeights on
    `device` (default: where the weights lie).  Raises ValueError for any
    geometry the kernel does not take."""
    sd = _state_dict(model_or_state_dict)
    n_convs = 0
    while f"convs.{n_convs}.weight" in sd:
        n_convs += 1
    if n_convs != N_CONVS:
        raise ValueError(f"the fused kernel takes the {N_CONVS}-conv "
                         f"DNAModNet only, got {n_convs} convs")
    if device is None:
        device = sd["convs.0.weight"].device
    arrays = {}

    def put(name, t, kc=0):
        arrays[name] = (t.detach().to("cpu", torch.float32).contiguous(), kc)

    scale, shift = sd["bn0.scale"], sd["bn0.shift"]
    if tuple(scale.shape) != (IN_CHANNELS,) or tuple(shift.shape) != (IN_CHANNELS,):
        raise ValueError(f"bn0 must have {IN_CHANNELS} channels")
    put("bn0.scale", scale)
    put("bn0.shift", shift)
    lengths = []
    lin, cin = kmer, IN_CHANNELS
    for i in range(N_CONVS):
        w = sd[f"convs.{i}.weight"]                      # (Cout, Cin, K)
        geom = tuple(int(v) for v in sd[f"convs.{i}.geometry"])
        cout, wcin, k = w.shape
        if i == 0 and (tuple(w.shape) not in ((128, 8, 11), (128, 8, 13))):
            raise ValueError(f"unexpected conv1 geometry {tuple(w.shape)} "
                             f"(Cout, Cin, K); want (128, 8, 11 | 13)")
        if i > 0 and k != 3:
            raise ValueError(f"conv{i + 1} kernel size {k}, want 3")
        if geom != (2, 1, 1):
            raise ValueError(f"conv{i + 1} (stride, pad) {geom}, want "
                             f"(2, 1, 1)")
        if wcin != cin or cout != WIDTHS[i]:
            raise ValueError(f"conv{i + 1} shape {tuple(w.shape)} does not "
                             f"chain (Cin {cin}, Cout {WIDTHS[i]})")
        lo = (lin + 2 - k) // 2 + 1
        if lo < 1:
            raise ValueError(f"window of {kmer} too short for conv{i + 1}")
        w = w.permute(2, 1, 0)                             # (K, Cin, Cout)
        put(f"convs.{i}.w", w)   # the kernel reads .split, the CPU .w
        put(f"convs.{i}.split", w, CHUNK_K[i])
        put(f"convs.{i}.b", sd[f"convs.{i}.bias"])
        lengths.append(lo)
        lin, cin = lo, cout
    fc1, fc2 = sd["fc1.weight"], sd["fc2.weight"]        # (out, in)
    if tuple(fc1.shape) != (256, cin * lin) or cin * lin != 128:
        raise ValueError(f"fc1 {tuple(fc1.shape[::-1])} (in, out), want "
                         f"(128, 256) over conv8's {cin} x {lin}")
    if tuple(fc2.shape) != (2, 256):
        raise ValueError(f"fc2 {tuple(fc2.shape[::-1])} (in, out), want "
                         f"(256, 2)")
    put("fc1.w", fc1.t())
    put("fc1.split", fc1.t(), CHUNK_K[N_CONVS])
    put("fc1.b", sd["fc1.bias"])
    put("fc2.w", fc2.t())
    put("fc2.b", sd["fc2.bias"])

    layout, parts, off = {}, [], 0
    for name, (t, kc) in arrays.items():
        layout[name] = (off, tuple(t.shape), kc)
        if kc:
            t = pack_split(t.reshape(-1, t.shape[-1]), kc)
        n = t.numel()
        pad = -n % _ALIGN
        parts += [t.reshape(-1), torch.zeros(pad)]
        off += n + pad
    buf = torch.cat(parts).to(device)
    return FusedWeights(buf, layout, kmer, tuple(lengths),
                        _meta(layout, kmer, lengths))


def _meta(layout: dict, kmer: int, lengths) -> np.ndarray:
    """The geometry the kernel reads, in the field order of struct Net in
    ops/csrc/fused_forward.cu."""
    fc1_off, (fc1_in, fc1_out), fc1_kc = layout["fc1.split"]
    m = [kmer, layout["bn0.scale"][0], layout["bn0.shift"][0],
         fc1_off, layout["fc1.b"][0], fc1_in, fc1_out, fc1_kc,
         layout["fc2.w"][0], layout["fc2.b"][0], layout["fc2.w"][1][1]]
    lin = kmer
    for i, lo in enumerate(lengths):
        w_off, (k, cin, cout), kc = layout[f"convs.{i}.split"]
        m += [k, cin, cout, lin, lo, w_off, layout[f"convs.{i}.b"][0], kc]
        lin = lo
    return np.asarray(m, np.int32)


def fused_params_from_jax(params: dict, device="cpu",
                          kmer: int = KMER) -> FusedWeights:
    """JAX params pytree (numpy arrays) -> FusedWeights, through the port's
    state-dict import (model/cnn.py params_from_jax)."""
    return prepare_fused_params(params_from_jax(params), device, kmer)


def _forward_packed(weights: FusedWeights, x: torch.Tensor) -> torch.Tensor:
    """DNAModNet on (B, 8, kmer) windows, every weight read back out of the
    packed buffer (so a packing error shows here as well as on the card)."""
    t = weights.tensor
    h = x * t("bn0.scale")[:, None] + t("bn0.shift")[:, None]
    for i in range(N_CONVS):
        w = t(f"convs.{i}.w").permute(2, 1, 0)            # (Cout, Cin, K)
        h = F.relu(F.conv1d(h, w, t(f"convs.{i}.b"), stride=2, padding=1))
    h = F.relu(h.flatten(1) @ t("fc1.w") + t("fc1.b"))
    return h @ t("fc2.w") + t("fc2.b")


def fused_forward_plain(weights: FusedWeights, table: torch.Tensor,
                        bases: torch.Tensor, rels: torch.Tensor,
                        rev: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (ng*G, 2) float32 logits.  On a
    GPU it runs cuDNN convolutions, which need TF32 off
    (model/cnn.exact_float32) to be a float32 reference."""
    x = group_windows_t_plain(table, bases, rels, rev, weights.kmer,
                              torch.float32)
    return _forward_packed(weights, x)


_KERNEL_LIB = None


def bind_kernel(path: str) -> ctypes.CDLL:
    """Load a build of ops/csrc/fused_forward.cu and declare its entries."""
    lib = ctypes.CDLL(path)
    vp = ctypes.c_void_p
    lib.hm_fused_forward.restype = ctypes.c_int
    lib.hm_fused_forward.argtypes = [
        vp, ctypes.c_int64, vp, vp, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, vp, vp, ctypes.c_int, vp, vp, vp]
    lib.hm_fused_scratch_floats.restype = ctypes.c_int64
    lib.hm_fused_scratch_floats.argtypes = [vp, ctypes.c_int]
    return lib


def _kernel_lib():
    global _KERNEL_LIB
    if _KERNEL_LIB is None:
        from .build import kernel_library
        _KERNEL_LIB = bind_kernel(kernel_library("fused_forward"))
    return _KERNEL_LIB


def launch_kernel(lib: ctypes.CDLL, weights: FusedWeights,
                  table: torch.Tensor, bases: torch.Tensor,
                  rels: torch.Tensor, rev: bool, out: torch.Tensor) -> None:
    """Launch `lib`'s kernels on the current stream into `out` (ng*G, 2);
    the arguments must already have passed fused_forward's checks.  The
    device scratch between the kernels (conv2's and conv4's outputs per
    site) is allocated here, from the graph's pool while a captured
    program records the call (engine/programs.py).  Besides the launches,
    hm_fused_forward makes only host-side calls (cudaGetDevice,
    cudaDeviceGetAttribute, cudaFuncSetAttribute), which a stream capture
    allows."""
    ng, g = rels.shape
    meta = weights.meta
    per_site = lib.hm_fused_scratch_floats(meta.ctypes.data, len(meta))
    if per_site < 0:
        raise ValueError("fused_forward: the kernel rejects this geometry")
    scratch = torch.empty(ng * g * per_site, dtype=torch.float32,
                          device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.hm_fused_forward(
            table.data_ptr(), table.shape[1], bases.data_ptr(),
            rels.data_ptr(), ng, g, int(rev), weights.buf.data_ptr(),
            meta.ctypes.data, len(meta), scratch.data_ptr(), out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"fused_forward launch failed: CUDA error {err}")


def fused_forward(weights: FusedWeights, table: torch.Tensor,
                  bases: torch.Tensor, rels: torch.Tensor,
                  rev: bool = False) -> torch.Tensor:
    """(8, N) float32 table, bases (ng,) int32, rels (ng, G) int32 ->
    (ng*G, 2) float32 logits of each planned site's window.

    Window t of group g starts at lane bases[g] + rels[g, t]; the plan must
    meet ops/gather.check_plan's contract.  CUDA tensors launch the kernel
    (counted in `fused_forward.launches`); CPU tensors run the plain
    version."""
    if table.dim() != 2 or table.shape[0] != 8 or table.dtype != torch.float32:
        raise ValueError(f"table must be (8, N) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if bases.dim() != 1 or bases.dtype != torch.int32:
        raise ValueError("bases must be (ng,) int32")
    if (rels.dim() != 2 or rels.dtype != torch.int32
            or rels.shape[0] != bases.shape[0]
            or not 1 <= rels.shape[1] <= GROUP):
        raise ValueError(f"rels must be (ng, G<={GROUP}) int32 matching bases")
    if not (bases.device == rels.device == table.device == weights.buf.device):
        raise ValueError("weights, table, bases and rels must share one device")
    if not (table.is_contiguous() and bases.is_contiguous()
            and rels.is_contiguous()):
        raise ValueError("table, bases and rels must be contiguous")
    if table.device.type == "cpu":
        return fused_forward_plain(weights, table, bases, rels, rev)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    ng, g = rels.shape
    n_out = weights.layout["fc2.b"][1][0]
    out = torch.empty((ng * g, n_out), dtype=torch.float32,
                      device=table.device)
    if ng == 0:
        return out
    launch_kernel(_kernel_lib(), weights, table, bases, rels, rev, out)
    fused_forward.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads it to show the
#: fused path went through the kernel); a replay of a captured program adds
#: the launches its body made (engine/programs.py), its capture none
fused_forward.launches = 0


def call_sites_fused(weights: FusedWeights, table: torch.Tensor,
                     bases: torch.Tensor, rels: torch.Tensor, rev: bool,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """One batch of planned groups -> (ng*G,) u8 scaled probs in slot order
    (the fused counterpart of features/windows.call_sites_group, `out` as
    there)."""
    probs = logits_to_scaled_probs(fused_forward(weights, table, bases, rels,
                                                 rev))
    return probs if out is None else out.copy_(probs)
