"""Collectives for distributed quantification, on torch.distributed.

The reference merges per-thread histograms and per-site (pcov, ncov) counts
under a mutex (pileup.cpp:158-167, mod_main.cpp:255-261).  Here each process
accumulates local partials and one all-reduce over the process group gives
the global result.  The tensors live on the group's device: the current card
for an nccl group, the CPU for gloo.

Every process must issue the same collectives, of the same shapes, in the
same order: pileup's pass 2 walks the chromosomes and their globally touched
chunks in one deterministic order for that reason.
"""
from __future__ import annotations

import numpy as np
import torch


def _group_device() -> torch.device:
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_reduce(arr: np.ndarray, op) -> np.ndarray:
    import torch.distributed as dist
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(_group_device())
    dist.all_reduce(t, op=op)
    return t.cpu().numpy()


def psum_histograms_multihost(local_bins: np.ndarray) -> np.ndarray:
    """Cross-process histogram all-reduce: each process's (3, 256) int64
    bins -> the global bins on every process.  Doubles as the pass-1 ->
    pass-2 barrier of distributed pileup."""
    import torch.distributed as dist
    return _all_reduce(np.asarray(local_bins, np.int64), dist.ReduceOp.SUM)


def psum_i64_multihost(vec: np.ndarray) -> np.ndarray:
    """Cross-process sum of a small 1-D int64 vector (per-chunk occupancy
    flags, so pass-2 collectives run only over covered chunks)."""
    import torch.distributed as dist
    return _all_reduce(np.asarray(vec, np.int64), dist.ReduceOp.SUM)


def psum_site_partials_multihost(pcov_local: np.ndarray,
                                 ncov_local: np.ndarray,
                                 menc_local: np.ndarray):
    """Cross-process merge of one genome chunk's per-site partials: SUM of
    the (pcov, ncov) int32 counts and MAX of the motif encoding.

    The collective behind distributed pileup pass 2
    (quant/pileup._pass2_collective): each process accumulates partials from
    its own spill only; no process reads another's spill.  `menc_local`
    encodes this process's motif map as 0 = untouched, else
    process_id * 4 + motif + 1, so the MAX keeps the motif written by the
    highest-rank process that touched the site: the spill replay's
    last-write-wins in process order.  All three arrays have one fixed chunk
    length on every process."""
    import torch.distributed as dist
    counts = _all_reduce(np.stack([np.asarray(pcov_local, np.int32),
                                   np.asarray(ncov_local, np.int32)]),
                         dist.ReduceOp.SUM)
    motif = _all_reduce(np.asarray(menc_local, np.int32), dist.ReduceOp.MAX)
    return counts[0], counts[1], motif
