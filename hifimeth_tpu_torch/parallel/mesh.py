"""The device list of a data-parallel `call`.

The model is tiny (~270k parameters), so the parallelism of `call` is pure
data parallelism over sites: every device holds its own copy of the models
and of the feature table and calls its share of each batch; no collective
runs in the hot loop.  This replaces the reference's pthread read pool
(mod_main.cpp:330-350) within one process.
"""
from __future__ import annotations

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
