"""Device selection: the port runs on the GPU unless the CPU is asked for."""
from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """`"cuda"` (default, optionally with an index) or `"cpu"`.

    Raises RuntimeError for `"cuda"` when no GPU is visible: a run that asked
    for the card never falls back to the CPU silently."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (CLI: --device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}; choose cuda or cpu")
    return dev
