"""Per-context DNAModNet trainer: SGD on the card, optionally over processes.

The reference recipe (train.py:29-101) as the JAX package's trainer runs
it: seed 42, SGD lr 0.1, weight decay 1e-5 on every parameter (BN gamma and
beta and the biases too, as optax.add_decayed_weights), momentum 0.9
Nesterov, the learning rate times 0.2 after each epoch, mean softmax cross
entropy, batch 512, 3 epochs, a checkpoint every 10,000 steps and at each
epoch's end.  Each epoch draws np.random.default_rng(seed).permutation(n)
and runs n // batch steps, so the batches are the JAX trainer's.

Batches are cut from the blob on the device (features/windows.
gather_and_featurize).  Under torchrun the processes form a (data, model)
grid (parallel/mesh.TrainLayout): each data rank takes a contiguous slice of
every batch, batch-norm statistics and gradients are reduced over the data
group, FC1/FC2 are split over the model group.

Precision: float32 throughout, with TF32 off for cuDNN and cuBLAS inside
the trainer only (`float32_scope`), and the flags restored afterwards.

Checkpoints are pickles of {"params", "state"}: numpy pytrees in the JAX
trainer's layout, under its file names, so each package resumes from the
other's.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..features.windows import gather_and_featurize
from ..model.cnn import save_params_npz
from ..parallel.mesh import TrainLayout, train_layout
from ..utils.logging import log
from .data import FeatureBlob, load_feature_blob
from .model import TrainNet, fold_to_inference, init_params, train_params_to_jax

#: the trainer's stages, timed per step (TrainStep.timers)
STAGES = ("gather", "forward_backward", "optimizer")


@dataclass
class TrainConfig:
    kmer: int = 401
    batch_size: int = 512
    epochs: int = 3
    lr: float = 0.1
    weight_decay: float = 1e-5
    momentum: float = 0.9
    lr_gamma: float = 0.2
    seed: int = 42
    ckpt_every: int = 10000
    n_model_shards: int = 1
    log_every: int = 100
    device: str = "cuda"


@contextlib.contextmanager
def float32_scope():
    """Full float32 (no TF32) cuDNN convolutions and cuBLAS matmuls inside
    the block; both flags as they were afterwards."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


class TrainStep:
    """One process's trainer: the network, its SGD and StepLR, the blob's
    planes on the device, and the per-stage timers.

    `params`/`state` (JAX-layout numpy pytrees, the full model) give the
    initial weights; by default init_params(cfg.seed).  Call `step` (or
    `gather`, `forward_backward` and `optimizer_step` in turn) inside
    float32_scope, and `end_epoch` after each epoch."""

    def __init__(self, cfg: TrainConfig, planes_t: np.ndarray, params=None,
                 state=None, layout: TrainLayout | None = None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.layout = layout or train_layout(cfg.n_model_shards,
                                             cfg.batch_size)
        if params is None:
            params, state = init_params(cfg.seed, kmer=cfg.kmer)
        self.net = TrainNet.from_jax(params, state, cfg.kmer,
                                     self.layout).to(self.device)
        # weight decay on every parameter, as optax.add_decayed_weights
        self.optimizer = torch.optim.SGD(
            self.net.parameters(), lr=cfg.lr, momentum=cfg.momentum,
            nesterov=True, weight_decay=cfg.weight_decay)
        self.scheduler = torch.optim.lr_scheduler.StepLR(
            self.optimizer, step_size=1, gamma=cfg.lr_gamma)
        self.planes = torch.from_numpy(planes_t).to(self.device)
        self._marks: list = []

    # -- the three stages --------------------------------------------------

    def gather(self, blob: FeatureBlob, idx: np.ndarray):
        """This process's slice of the batch `idx`: its windows (B, kmer, 8)
        and labels on the device."""
        idx = idx[self.layout.batch_slice(len(idx))]
        centers, strands, rstart, rend, labels = blob.site_arrays(idx)
        dev = self.device
        args = [torch.from_numpy(a).to(dev)
                for a in (centers, strands, rstart, rend)]
        x = gather_and_featurize(self.planes, *args, kmer_size=self.cfg.kmer)
        return x, torch.from_numpy(labels.astype(np.int64)).to(dev)

    def forward_backward(self, x: torch.Tensor, labels: torch.Tensor):
        """Loss and accuracy of the whole batch (averaged over the data
        group) as a (2,) tensor; the gradients averaged over it."""
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.net(x)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        metrics = torch.stack([loss.detach(), acc])
        group = self.layout.data_group
        if group is not None:
            import torch.distributed as dist
            grads = [p.grad for p in self.net.parameters()]
            flat = torch.cat([g.reshape(-1) for g in grads] + [metrics])
            dist.all_reduce(flat, group=group)
            flat /= self.layout.n_data
            off = 0
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
            metrics = flat[off:]
        return metrics

    def optimizer_step(self) -> None:
        self.optimizer.step()

    def step(self, blob: FeatureBlob, idx: np.ndarray) -> torch.Tensor:
        """One training step on batch `idx`; returns (loss, acc) as a
        tensor on the device (reading it waits for the step)."""
        self._mark()
        x, labels = self.gather(blob, idx)
        self._mark()
        metrics = self.forward_backward(x, labels)
        self._mark()
        self.optimizer_step()
        self._mark()
        return metrics

    def end_epoch(self) -> None:
        self.scheduler.step()

    # -- timers ------------------------------------------------------------

    def _mark(self) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)
        else:
            self._marks.append(time.perf_counter())

    def timers(self) -> dict:
        """Seconds per stage summed over the steps so far: the card's stream
        time between CUDA events (waits for the host included), host time
        on the CPU."""
        out = dict.fromkeys(STAGES, 0.0)
        m = self._marks
        if m and self.device.type == "cuda":
            m[-1].synchronize()
        for i in range(0, len(m), len(STAGES) + 1):
            for j, stage in enumerate(STAGES):
                a, b = m[i + j], m[i + j + 1]
                out[stage] += (a.elapsed_time(b) / 1e3
                               if self.device.type == "cuda" else b - a)
        return out

    # -- weights -----------------------------------------------------------

    def jax_params(self):
        """(params, state) of the whole model, JAX layout (every process of
        the model group must call)."""
        return train_params_to_jax(self.net)

    def save_checkpoint(self, path: str) -> None:
        params, state = self.jax_params()
        if _is_rank0():
            save_checkpoint(path, params, state)


def _is_rank0() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def train_context(blob: FeatureBlob, cfg: TrainConfig, model_out: str,
                  ckpt_dir: str | None = None) -> dict:
    """Train one context's model from init_params(cfg.seed) on `blob` and
    write its folded inference params to `model_out` (an npz that `call`
    reads).

    Returns {"steps", "history" [(step, loss, acc)], "final_loss",
    "final_acc"} as the JAX trainer does, plus "timers" (seconds per stage,
    STAGES) and "wall_s"."""
    n = blob.n_samples
    steps_per_epoch = n // cfg.batch_size
    with float32_scope():
        tr = TrainStep(cfg, blob.planes_t)
        rank0 = _is_rank0()
        rng = np.random.default_rng(cfg.seed)
        step = 0
        history = []
        t0 = time.perf_counter()
        for epoch in range(cfg.epochs):
            order = rng.permutation(n)
            for bi in range(steps_per_epoch):
                metrics = tr.step(
                    blob, order[bi * cfg.batch_size:(bi + 1) * cfg.batch_size])
                step += 1
                if step % cfg.log_every == 0 or bi + 1 == steps_per_epoch:
                    loss_v, acc_v = (float(v) for v in metrics.cpu())
                    history.append((step, loss_v, acc_v))
                    if rank0:
                        log("epoch %d step %d loss %.4f acc %.4f "
                            "(%.1f steps/s)", epoch + 1, step, loss_v, acc_v,
                            step / (time.perf_counter() - t0))
                if ckpt_dir and step % cfg.ckpt_every == 0:
                    tr.save_checkpoint(
                        os.path.join(ckpt_dir, f"{epoch}_{step}.ckpt"))
            tr.end_epoch()
            if ckpt_dir:
                tr.save_checkpoint(os.path.join(
                    ckpt_dir, f"kmer_{cfg.kmer}_epoch_{epoch + 1}.ckpt"))
        params, state = tr.jax_params()
        wall = time.perf_counter() - t0
    if rank0:
        save_params_npz(model_out, fold_to_inference(params, state))
        log("saved inference model to %s", model_out)
    return {"steps": step, "history": history,
            "final_loss": history[-1][1] if history else None,
            "final_acc": history[-1][2] if history else None,
            "timers": tr.timers(), "wall_s": wall}


def save_checkpoint(path, params, state):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"params": params, "state": state}, f)


def load_checkpoint(path):
    """(params, state) of a checkpoint this package or the JAX package
    wrote (a pickle: load only such files)."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    return d["params"], d["state"]


def main(argv, prog: str = "hifimeth-tpu-torch train") -> int:
    import argparse

    from ..parallel.dist import init_distributed, shutdown_distributed

    ap = argparse.ArgumentParser(
        prog,
        description="Train a per-context DNAModNet on extracted features "
                    "(reference blob format: features/samples/offsets)")
    ap.add_argument("--feature", required=True)
    ap.add_argument("--train-sample", required=True)
    ap.add_argument("--offsets", required=True)
    ap.add_argument("--model-out", required=True,
                    help="output .npz inference model path")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--kmer-size", type=int, default=401)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--epoch", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--model-shards", type=int, default=1,
                    help="processes per FC split; under torchrun the "
                         "world is data x model-shards processes")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default cuda)")
    args = ap.parse_args(argv)

    cfg = TrainConfig(kmer=args.kmer_size, batch_size=args.batch_size,
                      epochs=args.epoch, lr=args.lr, seed=args.seed,
                      n_model_shards=args.model_shards, device=args.device)
    resolve_device(cfg.device)          # no card: fail before any work
    log("loading feature blob...")
    blob = load_feature_blob(args.feature, args.train_sample, args.offsets)
    log("%d samples over %d reads", blob.n_samples, len(blob.read_start))
    # torchrun's variables make this process one cell of the grid
    init_distributed(cfg.device)
    try:
        train_context(blob, cfg, args.model_out, args.ckpt_dir)
    finally:
        shutdown_distributed()
    return 0
