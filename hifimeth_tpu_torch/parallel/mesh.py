"""The device list of a data-parallel `call`, and the trainer's layout over
processes.

The model is tiny (~270k parameters), so the parallelism of `call` is pure
data parallelism over sites: every device holds its own copy of the models
and of the feature table and calls its share of each batch; no collective
runs in the hot loop.  This replaces the reference's pthread read pool
(mod_main.cpp:330-350) within one process.

`train` runs over a (data, model) grid of processes (TrainLayout): batch
slices on the data axis with batch-norm statistics and gradients reduced
over it, FC1/FC2 split on the model axis.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device


def local_devices(device: str = "cuda") -> list[torch.device]:
    """Every local device of `device`'s type: each visible card for "cuda"
    (raises when there is none), the one CPU device for "cpu"."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def resolve_devices(devices) -> list[torch.device]:
    """A device list (names or devices) resolved; one device type only.  A
    device may repeat: each entry is a replica of its own."""
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("empty device list")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"devices of one type only, got {devs}")
    return devs


# ---------------------------------------------------------------------------
# The trainer's layout over processes
#
# The JAX trainer runs one program over a (data, model) mesh of local
# devices: the batch sharded on `data`, FC1's columns and FC2's rows on
# `model` (its train_param_shardings), batch-norm statistics those of the
# whole batch.  Here every process of a torch.distributed group is one mesh
# cell: rank = data_rank * n_model + model_rank, world = n_data * n_model.


@dataclass
class TrainLayout:
    """This process's cell of the (data, model) grid and its two groups:
    the processes of its model column that hold other batch slices
    (`data_group`) and those of its data row that hold the other FC shards
    (`model_group`).  No groups at all outside a process group."""
    n_data: int = 1
    n_model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: object = None
    model_group: object = None

    @property
    def sharded(self) -> bool:
        return self.model_group is not None

    def batch_slice(self, batch: int) -> slice:
        """This process's contiguous share of a batch of `batch` samples."""
        n = batch // self.n_data
        return slice(self.data_rank * n, (self.data_rank + 1) * n)


def train_layout(model_shards: int = 1, batch_size: int | None = None
                 ) -> TrainLayout:
    """The layout of this process in the current process group (torchrun:
    parallel/dist.init_distributed), or the one-process layout with no
    group when none is initialised.  Every process of the group must call
    it, in the same order as any other group creation."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_shards < 1 or world % model_shards:
        raise ValueError(f"--model-shards {model_shards} does not divide the "
                         f"{world} process(es) (launch n_data x n_model "
                         f"processes with torchrun)")
    n_data = world // model_shards
    if batch_size is not None and batch_size % n_data:
        raise ValueError(f"batch size {batch_size} is not a multiple of the "
                         f"{n_data} data-parallel process(es)")
    if not dist.is_initialized():
        return TrainLayout()
    data_rank, model_rank = divmod(dist.get_rank(), model_shards)
    data_groups = [dist.new_group([d * model_shards + m for d in range(n_data)])
                   for m in range(model_shards)]
    model_groups = [dist.new_group([d * model_shards + m
                                    for m in range(model_shards)])
                    for d in range(n_data)]
    return TrainLayout(n_data, model_shards, data_rank, model_rank,
                       data_groups[model_rank], model_groups[data_rank])


#: state-dict entries split over the model axis -> their split dimension:
#: FC1's output features (the JAX layout's columns), FC2's input features
#: (its rows)
MODEL_SPLIT = {"fc1.weight": 0, "fc1.bias": 0, "fc2.weight": 1}


def shard_state_dict(sd: dict, layout: TrainLayout) -> dict:
    """A full trainer state dict -> this process's model shard of it."""
    out = dict(sd)
    for k, dim in MODEL_SPLIT.items():
        out[k] = sd[k].chunk(layout.n_model, dim)[layout.model_rank].clone()
    return out


def gather_state_dict(sd: dict, layout: TrainLayout) -> dict:
    """This process's model shard of a trainer state dict -> the full one
    (an all-gather over the model group; every process of it must call)."""
    import torch.distributed as dist
    if not layout.sharded:
        return dict(sd)
    out = dict(sd)
    for k, dim in MODEL_SPLIT.items():
        parts = [torch.empty_like(sd[k]) for _ in range(layout.n_model)]
        dist.all_gather(parts, sd[k].contiguous(), group=layout.model_group)
        out[k] = torch.cat(parts, dim)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the gradient is summed over it too (each process's
    copy of the sum feeds its own loss)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum FC2's partial products over the model group; every process then
    holds the same logits and loss, so the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    """FC1's input, the same on every process of the model group: each
    process's FC1 columns give only their part of its gradient, which the
    backward sums."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)
