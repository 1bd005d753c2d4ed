"""Trainable DNAModNet (training-mode BatchNorm) as an nn.Module.

The reference training architecture (model_cnn.py:8-85): input BN -> 8x
[Conv1d stride 2, pad 1, no bias, BN, ReLU] -> channel-major flatten -> FC
256 -> ReLU -> FC 2; the JAX package's train/model.py in PyTorch.

Weights travel as the JAX trainer's numpy pytrees (`params`: bn0.{gamma,
beta}, convs[i].{w (K, Cin, Cout), gamma, beta}, fc{1,2}.{w (in, out), b};
`state`: bn0 and convs[i] {mean, var}): `init_params` draws them,
`train_params_from_jax` turns them into this module's state dict and
`train_params_to_jax` back, so checkpoints and initial weights cross between
the packages.  `fold_to_inference` folds every BN into the inference layout
of model/cnn.py, which `call` and both packages' load_params_npz read.

Batch norm is torch's BatchNorm1d: eps 1e-5, momentum 0.1, the biased
variance to normalise and the unbiased one (n = B*L) in the running
variance, as the JAX trainer's apply_train.  Under a process group
(parallel/mesh.TrainLayout) the statistics are those of the whole batch:
sums over the data group, as the JAX trainer's jit over its mesh has them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import (TrainLayout, all_reduce_sum, copy_to_model,
                             gather_state_dict, reduce_from_model,
                             shard_state_dict)

BN_EPS = 1e-5
BN_MOMENTUM = 0.1          # torch BatchNorm1d default
HIDDEN = 256

# channel widths / kernel sizes of the in-repo training recipe
# (model_cnn.py:12-29); the shipped CpG/CHG models use a first kernel of 11
DEFAULT_CHANNELS = (128, 128, 128, 96, 96, 96, 64, 64)
DEFAULT_KERNELS = (13, 3, 3, 3, 3, 3, 3, 3)


def conv_lengths(kmer: int, kernels) -> list[int]:
    """Output length of each stride-2, pad-1 conv."""
    out, L = [], kmer
    for k in kernels:
        L = (L + 2 - k) // 2 + 1
        out.append(L)
    return out


def init_params(seed: int = 42, kmer: int = 401, in_features: int = 8,
                channels=DEFAULT_CHANNELS, kernels=DEFAULT_KERNELS):
    """(params, state) numpy pytrees in the JAX trainer's layout, drawn from
    torch.Generator(seed) as the JAX package's init_params draws them
    (another generator, so other numbers): every conv and FC weight and FC
    bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fc1.b with fc1's fan-in, as
    torch's Conv1d/Linear default init; BN gamma 1, beta 0, running mean 0,
    variance 1."""
    gen = torch.Generator().manual_seed(seed)

    def uniform(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return torch.empty(shape).uniform_(-bound, bound,
                                           generator=gen).numpy()

    def ones(n):
        return np.ones(n, np.float32)

    def zeros(n):
        return np.zeros(n, np.float32)

    params = {"bn0": {"gamma": ones(in_features), "beta": zeros(in_features)},
              "convs": []}
    state = {"bn0": {"mean": zeros(in_features), "var": ones(in_features)},
             "convs": []}
    cin = in_features
    for cout, k in zip(channels, kernels):
        params["convs"].append({"w": uniform((k, cin, cout), cin * k),
                                "gamma": ones(cout), "beta": zeros(cout)})
        state["convs"].append({"mean": zeros(cout), "var": ones(cout)})
        cin = cout
    flat = cin * conv_lengths(kmer, kernels)[-1]
    params["fc1"] = {"w": uniform((flat, HIDDEN), flat),
                     "b": uniform((HIDDEN,), flat)}
    params["fc2"] = {"w": uniform((HIDDEN, 2), HIDDEN),
                     "b": uniform((2,), HIDDEN)}
    return params, state


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def train_params_from_jax(params, state) -> dict[str, torch.Tensor]:
    """JAX trainer pytrees (numpy) -> the full TrainNet state dict: conv
    weights WIO (K, Cin, Cout) -> (Cout, Cin, K), FC weights (in, out) ->
    (out, in), BN gamma/beta -> weight/bias, mean/var -> running stats."""
    def bn(prefix, p, s):
        return {f"{prefix}.weight": _t(p["gamma"]),
                f"{prefix}.bias": _t(p["beta"]),
                f"{prefix}.running_mean": _t(s["mean"]),
                f"{prefix}.running_var": _t(s["var"]),
                f"{prefix}.num_batches_tracked": torch.tensor(0)}

    sd = bn("bn0", params["bn0"], state["bn0"])
    for i, (c, cs) in enumerate(zip(params["convs"], state["convs"])):
        sd[f"convs.{i}.weight"] = _t(np.asarray(c["w"]).transpose(2, 1, 0))
        sd.update(bn(f"bns.{i}", c, cs))
    for k in ("fc1", "fc2"):
        sd[f"{k}.weight"] = _t(np.asarray(params[k]["w"]).T)
        sd[f"{k}.bias"] = _t(params[k]["b"])
    return sd


def train_params_to_jax(net: "TrainNet"):
    """TrainNet -> (params, state) numpy pytrees in the JAX trainer's
    layout, FC shards gathered over the model group (every process of it
    must call)."""
    sd = net.state_dict()
    if net.layout is not None:
        sd = gather_state_dict(sd, net.layout)
    # copies: on the CPU .numpy() would share the module's memory
    sd = {k: v.detach().to("cpu", copy=True).numpy() for k, v in sd.items()}

    def bn(prefix):
        return ({"gamma": sd[f"{prefix}.weight"], "beta": sd[f"{prefix}.bias"]},
                {"mean": sd[f"{prefix}.running_mean"],
                 "var": sd[f"{prefix}.running_var"]})

    p0, s0 = bn("bn0")
    params = {"bn0": p0, "convs": []}
    state = {"bn0": s0, "convs": []}
    for i in range(len(net.convs)):
        p, s = bn(f"bns.{i}")
        params["convs"].append({
            "w": np.ascontiguousarray(sd[f"convs.{i}.weight"].transpose(2, 1, 0)),
            **p})
        state["convs"].append(s)
    for k in ("fc1", "fc2"):
        params[k] = {"w": np.ascontiguousarray(sd[f"{k}.weight"].T),
                     "b": sd[f"{k}.bias"]}
    return params, state


class TrainNet(nn.Module):
    """(B, kmer, 8) float32 windows -> (B, 2) float32 logits, in training or
    eval mode.  With a sharded `layout` this process holds FC1's output
    features and FC2's input features of its model rank."""

    def __init__(self, kmer: int = 401, in_features: int = 8,
                 channels=DEFAULT_CHANNELS, kernels=DEFAULT_KERNELS,
                 layout: TrainLayout | None = None):
        super().__init__()
        self.layout = layout
        shards = layout.n_model if layout is not None else 1
        if HIDDEN % shards:
            raise ValueError(f"FC width {HIDDEN} does not split over "
                             f"{shards} model shards")

        def batch_norm(c):
            return nn.BatchNorm1d(c, eps=BN_EPS, momentum=BN_MOMENTUM)

        self.bn0 = batch_norm(in_features)
        cins = (in_features, *channels[:-1])
        self.convs = nn.ModuleList(
            nn.Conv1d(cin, cout, k, stride=2, padding=1, bias=False)
            for cin, cout, k in zip(cins, channels, kernels))
        self.bns = nn.ModuleList(batch_norm(c) for c in channels)
        flat = channels[-1] * conv_lengths(kmer, kernels)[-1]
        self.fc1 = nn.Linear(flat, HIDDEN // shards)
        self.fc2 = nn.Linear(HIDDEN // shards, 2)

    @classmethod
    def from_jax(cls, params, state, kmer: int,
                 layout: TrainLayout | None = None) -> "TrainNet":
        """A TrainNet holding the JAX-layout pytrees (this process's model
        shard of them under a sharded layout), in training mode."""
        channels = tuple(np.shape(c["w"])[2] for c in params["convs"])
        kernels = tuple(np.shape(c["w"])[0] for c in params["convs"])
        net = cls(kmer, np.shape(params["bn0"]["gamma"])[0], channels,
                  kernels, layout)
        sd = train_params_from_jax(params, state)
        if layout is not None and layout.sharded:
            sd = shard_state_dict(sd, layout)
        net.load_state_dict(sd)
        return net.train()

    def _bn(self, bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
        group = self.layout.data_group if self.layout is not None else None
        if group is None or not self.training:
            return bn(x)
        return _sync_batch_norm(bn, x, group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._bn(self.bn0, x.permute(0, 2, 1))
        for conv, bn in zip(self.convs, self.bns):
            h = F.relu(self._bn(bn, conv(h)))
        h = h.flatten(1)                    # channel-major, as the JAX layout
        group = self.layout.model_group if self.layout is not None else None
        if group is not None:
            h = copy_to_model(h, group)
        h = F.linear(F.relu(self.fc1(h)), self.fc2.weight)
        if group is not None:
            h = reduce_from_model(h, group)
        return h + self.fc2.bias


def _sync_batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor,
                     group) -> torch.Tensor:
    """Training-mode BatchNorm1d over the whole batch of a data group: the
    count and per-channel sum, then the sum of squared deviations from the
    global mean, each summed over the group (gradients flow through both
    sums).  Updates `bn`'s running statistics as BatchNorm1d does."""
    local = torch.full((1,), x.shape[0] * x.shape[2], dtype=x.dtype,
                       device=x.device)
    sums = all_reduce_sum(torch.cat([x.sum((0, 2)), local]), group)
    n = sums[-1]
    mean = sums[:-1] / n
    d = x - mean[:, None]
    var = all_reduce_sum((d * d).sum((0, 2)), group) / n
    y = d * torch.rsqrt(var + bn.eps)[:, None]
    y = y * bn.weight[:, None] + bn.bias[:, None]
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean, alpha=m)
        bn.running_var.mul_(1 - m).add_(var * n / (n - 1), alpha=m)
        bn.num_batches_tracked += 1
    return y


@torch.no_grad()
def apply_eval(net: TrainNet, x: torch.Tensor) -> torch.Tensor:
    """Inference forward with the running statistics; `net`'s mode is kept."""
    mode = net.training
    try:
        return net.eval()(x)
    finally:
        net.train(mode)


def fold_to_inference(params, state) -> dict:
    """Fold every BN of the JAX-layout pytrees into the inference params of
    model/cnn.py (the JAX package's fold, in numpy)."""
    g0 = np.asarray(params["bn0"]["gamma"])
    b0 = np.asarray(params["bn0"]["beta"])
    m0 = np.asarray(state["bn0"]["mean"])
    v0 = np.asarray(state["bn0"]["var"])
    scale0 = g0 / np.sqrt(v0 + BN_EPS)
    out = {"bn0": {"scale": scale0.astype(np.float32),
                   "shift": (b0 - m0 * scale0).astype(np.float32)},
           "convs": []}
    for conv, cstate in zip(params["convs"], state["convs"]):
        w = np.asarray(conv["w"])                  # (K, Cin, Cout)
        g = np.asarray(conv["gamma"])
        m = np.asarray(cstate["mean"])
        v = np.asarray(cstate["var"])
        s = g / np.sqrt(v + BN_EPS)
        out["convs"].append({
            "w": (w * s[None, None, :]).astype(np.float32),
            "b": (np.asarray(conv["beta"]) - m * s).astype(np.float32),
            "stride": 2,
            "pad": (1, 1),
        })
    out["fc1"] = {"w": np.asarray(params["fc1"]["w"]),
                  "b": np.asarray(params["fc1"]["b"])}
    out["fc2"] = {"w": np.asarray(params["fc2"]["w"]),
                  "b": np.asarray(params["fc2"]["b"])}
    return out
