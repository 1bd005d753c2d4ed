"""Multi-process distribution on torch.distributed.

The reference is a single-process tool; its unit of parallelism is one read
pulled from a mutex-guarded reader (sam_batch.hpp:38-54).  Scale-out keeps
that granularity and lifts it to processes:

 - `call`: every process streams the same input BAM and handles the read
   blocks assigned to it round-robin over `batch_size` reads
   (deterministic, no coordination); each writes an ordered shard BAM and
   `merge_shard_bams` interleaves the shards back into the reference's read
   order.  No collective runs during `call`.
 - `pileup`: each process histograms and maps its read shard; the 256-bin
   histograms and the per-site partial counts are summed by collectives
   (parallel/collectives.py) instead of the reference's mutex merge.

`init_distributed` is environment-driven and optional: it reads torchrun's
variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT through `env://`,
LOCAL_RANK for the card) and without them everything runs as one process.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from ..io.bam import BamReader, BamRecord, BamWriter
from ..utils.logging import log


@dataclass
class ShardSpec:
    process_id: int = 0
    num_processes: int = 1
    batch_size: int = 10000      # reads per round-robin block

    def owns_read(self, read_id: int) -> bool:
        return (read_id // self.batch_size) % self.num_processes == self.process_id


def backend_for(device: str) -> str:
    """The process group's backend for a device type: nccl for the card,
    gloo for the CPU."""
    kind = device.split(":")[0]
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; choose cuda or cpu")
    return "nccl" if kind == "cuda" else "gloo"


def init_distributed(device: str = "cuda") -> ShardSpec:
    """Join the process group that torchrun's variables describe and return
    this process's ShardSpec; the one-process spec, initialising nothing,
    when WORLD_SIZE is unset.

    The backend follows `device` (nccl for "cuda", gloo for "cpu").  On the
    card each process takes card LOCAL_RANK (modulo the visible cards) as
    its current device."""
    if "WORLD_SIZE" not in os.environ:
        return ShardSpec()
    import torch
    import torch.distributed as dist

    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    backend = backend_for(device)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no GPU is "
                               "visible; pass --device cpu for gloo")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                world_size=world, rank=rank)
    log("torch.distributed initialized (%s): process %d/%d", backend, rank,
        world)
    return ShardSpec(process_id=rank, num_processes=world)


def shutdown_distributed() -> None:
    """Leave the process group init_distributed joined, if any."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def shard_path(base: str, spec: ShardSpec) -> str:
    if spec.num_processes == 1:
        return base
    return f"{base}.shard{spec.process_id:04d}"


def merge_shard_bams(out_path: str, shard_paths: list[str],
                     batch_size: int = 10000, io_threads: int = 8) -> int:
    """Interleave ordered shard BAMs back into global read order.

    Shard i holds the round-robin blocks (block_idx % n == i) in order, so
    the merge pulls batch_size records from each shard in rotation.
    Returns the number of records written."""
    readers = [BamReader(p, threads=2) for p in shard_paths]
    writer = BamWriter(out_path, readers[0].header, threads=io_threads)
    n = 0
    active = [True] * len(readers)
    try:
        while any(active):
            for i, rd in enumerate(readers):
                if not active[i]:
                    continue
                for _ in range(batch_size):
                    raw = rd.next_raw()
                    if raw is None:
                        active[i] = False
                        break
                    writer.write_raw(raw)
                    raw.release()   # the view pins the reader's rolling buffer
                    n += 1
    finally:
        writer.close()
        for rd in readers:
            rd.close()
    return n


def sharded_read_stream(reader: BamReader, spec: ShardSpec):
    """Yield (read_id, record) for the reads this process owns.

    Records of other processes are skipped as raw views, unparsed."""
    read_id = 0
    while True:
        raw = reader.next_raw()
        if raw is None:
            return
        if spec.owns_read(read_id):
            rec = BamRecord.from_bytes(raw)
            raw.release()   # the view pins the reader's rolling buffer
            yield read_id, rec
        else:
            raw.release()
        read_id += 1


def chromosome_ranges(n_chr: int, spec: ShardSpec) -> list[int]:
    """Chromosomes this process owns for pileup pass 2 (round robin)."""
    return [c for c in range(n_chr)
            if c % spec.num_processes == spec.process_id]
