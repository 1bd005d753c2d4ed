"""DNAModNet in PyTorch, with every BatchNorm folded for inference.

Architecture of the reference training code (training/model_cnn.py:8-85):
input (B, 8, kmer) -> channelwise BatchNorm (folded to scale/shift) ->
8x [Conv1d stride 2, BN folded into the conv, ReLU] -> flatten channel-major
-> FC 256 -> ReLU -> FC 2.  Layer geometry (kernel sizes, widths, strides,
pads) comes from the weights, not from constants: the shipped models use a
first kernel of 11 (CpG, CHG) and 13 (CHH).

Parameters arrive as the params pytree of the JAX package's model/cnn.py
(numpy arrays): `bn0.{scale,shift}`, `convs[i].{w (K, Cin, Cout), b,
stride, pad (lo, hi)}`, `fc{1,2}.{w (in, out), b}`.  `params_from_jax`
turns that pytree into this module's state dict; `load_params_npz` reads the
same pytree from the repository's `models/*.npz` files and `save_params_npz`
writes it; `load_reference_onnx` reads it from a reference ONNX file.

Numerics: on a GPU the float32 path must not run in TF32, which keeps only
about three decimal digits and would move the u8 probabilities by more than
the +-1 the parity contract allows (docs/PARITY.md).  `exact_float32()`
turns TF32 off for cuDNN convolutions and cuBLAS matrix products; the call
engine applies it before it runs a model on the GPU.

bfloat16 (`set_compute_dtype`, CLI --dtype bf16) follows the JAX package's
dnamodnet_apply: bn0 in float32 and the result rounded to bf16; each conv
and FC takes bf16 operands and accumulates in float32; bias and ReLU run in
float32 and the result is rounded to bf16; the logits come out in float32.
A bf16 conv1d in PyTorch returns a bf16 sum, which the bias and ReLU after
it would round a second time.  So the convs and FCs take float32 tensors
that hold bf16 values (activations and weights rounded to bf16) and return
the float32 sum, on the same float32 ops as the float32 path (no TF32):
the product of two bf16 values is exact in float32 (8 + 8 significand
bits), so every product is exact and the sums accumulate in float32.
Each layer rounds once, after its ReLU.  The FC outputs stay float32 up to
their bias, as in the JAX engine's compiled programs; JAX's eager
dnamodnet_apply rounds them to bf16 first.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .onnx_import import load_onnx_graph


def exact_float32() -> None:
    """Run float32 convolutions and matmuls in full float32 (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# Parameter import


def params_from_numpy(flat: dict[str, np.ndarray]) -> dict:
    """{path: array} npz dict -> params pytree (the JAX package's layout)."""
    params = {
        "bn0": {"scale": flat["bn0.scale"], "shift": flat["bn0.shift"]},
        "convs": [],
        "fc1": {"w": flat["fc1.w"], "b": flat["fc1.b"]},
        "fc2": {"w": flat["fc2.w"], "b": flat["fc2.b"]},
    }
    i = 0
    while f"convs.{i}.w" in flat:
        params["convs"].append({
            "w": flat[f"convs.{i}.w"],
            "b": flat[f"convs.{i}.b"],
            "stride": int(flat[f"convs.{i}.stride"]),
            "pad": tuple(int(x) for x in flat[f"convs.{i}.pad"]),
        })
        i += 1
    return params


def load_params_npz(path: str) -> dict:
    with np.load(path) as z:
        return params_from_numpy({k: z[k] for k in z.files})


def params_to_numpy(params: dict) -> dict[str, np.ndarray]:
    """Params pytree -> the {path: array} dict an npz file stores."""
    flat = {"bn0.scale": np.asarray(params["bn0"]["scale"]),
            "bn0.shift": np.asarray(params["bn0"]["shift"])}
    for i, c in enumerate(params["convs"]):
        flat[f"convs.{i}.w"] = np.asarray(c["w"])
        flat[f"convs.{i}.b"] = np.asarray(c["b"])
        flat[f"convs.{i}.stride"] = np.asarray(c["stride"])
        flat[f"convs.{i}.pad"] = np.asarray(c["pad"])
    for k in ("fc1", "fc2"):
        flat[f"{k}.w"] = np.asarray(params[k]["w"])
        flat[f"{k}.b"] = np.asarray(params[k]["b"])
    return flat


def save_params_npz(path: str, params: dict) -> None:
    np.savez_compressed(path, **params_to_numpy(params))


def fold_batchnorm(gamma, beta, mean, var, eps):
    """Return (scale, shift) such that BN(x) == x * scale + shift."""
    scale = gamma / np.sqrt(var + eps)
    return scale.astype(np.float32), (beta - mean * scale).astype(np.float32)


def load_reference_onnx(path: str) -> dict:
    """Import an inference params pytree from a reference ONNX file.

    Handles both exporter layouts of the shipped models: initializer
    weights with Gemm FCs (CpG, CHG) and Constant-node weights with
    MatMul/Add FCs (CHH).  Conv weights come out WIO = (K, Cin, Cout), FC
    weights (in, out), as the JAX package's importer stores them."""
    inits, nodes = load_onnx_graph(path)
    # tensor names -> arrays: the initializers and the Constant nodes
    env = dict(inits)
    for n in nodes:
        if n["op"] == "Constant" and isinstance(n["attrs"].get("value"),
                                                np.ndarray):
            env[n["outputs"][0]] = n["attrs"]["value"]

    params: dict = {"convs": []}
    pending_matmul: np.ndarray | None = None
    for n in nodes:
        op = n["op"]
        if op == "BatchNormalization":
            gamma, beta, mean, var = (env[i] for i in n["inputs"][1:5])
            eps = float(n["attrs"].get("epsilon", 1e-5))
            scale, shift = fold_batchnorm(gamma, beta, mean, var, eps)
            params["bn0"] = {"scale": scale, "shift": shift}
        elif op == "Conv":
            w = env[n["inputs"][1]]                      # (Cout, Cin, K)
            b = (env[n["inputs"][2]] if len(n["inputs"]) > 2
                 else np.zeros(w.shape[0], np.float32))
            strides = n["attrs"].get("strides", [1])
            pads = n["attrs"].get("pads", [0, 0])
            params["convs"].append({
                "w": np.ascontiguousarray(w.transpose(2, 1, 0)),  # WIO
                "b": b.astype(np.float32),
                "stride": int(strides[0]),
                "pad": (int(pads[0]), int(pads[1])),
            })
        elif op == "Gemm":
            w = env[n["inputs"][1]]                      # (out, in), transB=1
            if not n["attrs"].get("transB", 0):
                w = w.T
            b = env[n["inputs"][2]]
            key = "fc1" if "fc1" not in params else "fc2"
            params[key] = {"w": np.ascontiguousarray(w.T), "b": b}
        elif op == "MatMul":
            pending_matmul = env[n["inputs"][1]]          # (in, out) already
        elif op == "Add" and pending_matmul is not None:
            b = env[n["inputs"][1]]
            key = "fc1" if "fc1" not in params else "fc2"
            params[key] = {"w": np.ascontiguousarray(pending_matmul), "b": b}
            pending_matmul = None

    if "fc1" not in params or "fc2" not in params or not params["convs"]:
        raise ValueError(f"could not reconstruct DNAModNet layers from {path}")
    return params


def conv_spec(params: dict) -> tuple[tuple[int, int, int], ...]:
    """Conv geometry (stride, pad_lo, pad_hi) per layer."""
    return tuple((int(c["stride"]), int(c["pad"][0]), int(c["pad"][1]))
                 for c in params["convs"])


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX params pytree (numpy arrays) -> DNAModNet state dict.

    Conv weights go from WIO (K, Cin, Cout) to PyTorch's (Cout, Cin, K); FC
    weights from (in, out) to (out, in).  Each conv's (stride, lo, hi)
    rides along as an int64 `geometry` buffer, so a state dict alone
    rebuilds the module (DNAModNet.from_state_dict).  fc1 needs no
    reordering: the JAX forward flattens its NWC activations channel-major
    (model/cnn.py:204-206 there), which is how (B, C, L) flattens here."""
    sd = {"bn0.scale": _f32(params["bn0"]["scale"]),
          "bn0.shift": _f32(params["bn0"]["shift"])}
    for i, (c, geom) in enumerate(zip(params["convs"], conv_spec(params))):
        w = np.asarray(c["w"], np.float32)
        sd[f"convs.{i}.weight"] = _f32(w.transpose(2, 1, 0))
        sd[f"convs.{i}.bias"] = _f32(c["b"])
        sd[f"convs.{i}.geometry"] = torch.tensor(geom, dtype=torch.int64)
    for k in ("fc1", "fc2"):
        sd[f"{k}.weight"] = _f32(np.asarray(params[k]["w"], np.float32).T)
        sd[f"{k}.bias"] = _f32(params[k]["b"])
    return sd


# ---------------------------------------------------------------------------
# Forward


class _ChannelAffine(nn.Module):
    """Folded input BatchNorm: x * scale + shift per channel of (B, C, L)."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(channels))
        self.register_buffer("shift", torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale[:, None] + self.shift[:, None]


class _Conv(nn.Module):
    """Conv1d with BN folded in, possibly asymmetric zero padding, ReLU."""

    def __init__(self, cin: int, cout: int, k: int, geometry):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("geometry", torch.tensor(geometry, dtype=torch.int64))
        # python ints for the forward: reading the buffer there would sync
        # with the device on every call
        self.stride, self.lo, self.hi = (int(v) for v in geometry)

    def forward(self, h: torch.Tensor,
                weight: torch.Tensor | None = None) -> torch.Tensor:
        w = self.weight if weight is None else weight
        if self.lo == self.hi:
            h = F.conv1d(h, w, self.bias, stride=self.stride,
                         padding=self.lo)
        else:
            h = F.conv1d(F.pad(h, (self.lo, self.hi)), w, self.bias,
                         stride=self.stride)
        return F.relu(h)


class DNAModNet(nn.Module):
    """(B, 8, kmer) windows (NCW, float32 or the compute dtype) -> (B, 2)
    float32 logits."""

    def __init__(self, conv_shapes, geometries, fc1_in: int, fc1_out: int,
                 n_out: int = 2):
        super().__init__()
        self.bn0 = _ChannelAffine(conv_shapes[0][1])
        self.convs = nn.ModuleList(
            _Conv(cin, cout, k, geom)
            for (cout, cin, k), geom in zip(conv_shapes, geometries))
        self.fc1 = nn.Linear(fc1_in, fc1_out)
        self.fc2 = nn.Linear(fc1_out, n_out)
        self.compute_dtype = torch.float32
        self._low: tuple = ()            # bf16 mode's weights, see below

    def set_compute_dtype(self, dtype: torch.dtype) -> "DNAModNet":
        """float32 or bfloat16 (see the module notes).  bf16 keeps, beside
        the float32 parameters, every conv and FC weight rounded to bf16
        (stored as float32), so call it after moving the module to its
        device."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, "
                             f"got {dtype}")
        self.compute_dtype = dtype
        self._low = () if dtype == torch.float32 else (
            [c.weight.detach().to(dtype).float() for c in self.convs],
            self.fc1.weight.detach().to(dtype).float(),
            self.fc2.weight.detach().to(dtype).float())
        return self

    @classmethod
    def from_state_dict(cls, sd: dict[str, torch.Tensor]) -> "DNAModNet":
        n = 0
        while f"convs.{n}.weight" in sd:
            n += 1
        shapes = [tuple(sd[f"convs.{i}.weight"].shape) for i in range(n)]
        geoms = [tuple(sd[f"convs.{i}.geometry"].tolist()) for i in range(n)]
        fc1_out, fc1_in = sd["fc1.weight"].shape
        model = cls(shapes, geoms, fc1_in, fc1_out, sd["fc2.weight"].shape[0])
        model.load_state_dict(sd)
        return model.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            h = self.bn0(x)
            for conv in self.convs:
                h = conv(h)
            h = F.relu(self.fc1(h.flatten(1)))
            return self.fc2(h)
        cd = self.compute_dtype
        w_convs, w_fc1, w_fc2 = self._low
        h = self.bn0(x.float()).to(cd).float()
        for conv, w in zip(self.convs, w_convs):
            h = conv(h, w).to(cd).float()
        h = F.relu(F.linear(h.flatten(1), w_fc1, self.fc1.bias))
        return F.linear(h.to(cd).float(), w_fc2, self.fc2.bias)


def load_model_npz(path: str, device: torch.device,
                   compute_dtype: torch.dtype = torch.float32) -> DNAModNet:
    """Shipped `models/<ctx>.npz` -> DNAModNet on `device`."""
    return DNAModNet.from_state_dict(
        params_from_jax(load_params_npz(path))).to(device).set_compute_dtype(
            compute_dtype)


def logits_to_scaled_probs(logits: torch.Tensor) -> torch.Tensor:
    """2-logit -> u8 scaled probability, the reference conversion
    scaled = min(255, int(255 * softmax_p1)) (mod_batch.cpp:46-64)."""
    m = logits.max(dim=-1, keepdim=True).values
    e = torch.exp(logits - m)
    p1 = e[..., 1] / (e[..., 0] + e[..., 1])
    v = torch.floor(255.0 * p1).to(torch.int32)
    return v.clamp(0, 255).to(torch.uint8)
