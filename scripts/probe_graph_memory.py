#!/usr/bin/env python3
"""Device memory over repeated `call` runs in one process, graphs on and
off, with no cache emptied between runs.

Builds the chip smoke's synthetic input (--reads reads x 15 kb, seed 0)
and runs it --rounds times through each path of --paths (default pallas,
fused and pallas in bf16; also slice and folded), each with
CallConfig.graphs off and then on, in one process, never calling
torch.cuda.empty_cache or the garbage collector.  After each run it prints
the allocator's allocated and reserved MiB, the reserved and allocated MiB
of segments in graph pools (private pools) and how many such pools hold
segments, and whether the run's CallEngine is still alive (a weak
reference).  A run that runs out of device memory is reported with the
same figures and ends the probe (exit code 1).

Usage (on a machine with a CUDA device):
    python3 scripts/probe_graph_memory.py [--rounds N] [--reads N]
        [--paths pallas,fused,bf16,slice,folded]
"""
import argparse
import os
import subprocess
import sys
import tempfile
import weakref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PATHS = {"pallas": dict(gather_impl="pallas"),
         "fused": dict(gather_impl="fused"),
         "bf16": dict(gather_impl="pallas", compute_dtype="bfloat16"),
         "slice": dict(gather_impl="slice"),
         "folded": dict(gather_impl="folded")}


def memory(torch) -> str:
    """Allocated and reserved MiB, and those of graph-pool segments."""
    mib = 2 ** 20
    pools: dict = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get("segment_pool_id", (0, 0)))
        if pool != (0, 0):
            tot, alloc = pools.get(pool, (0, 0))
            pools[pool] = (tot + seg["total_size"],
                           alloc + seg["allocated_size"])
    return (f"allocated {torch.cuda.memory_allocated() / mib:.0f} MiB, "
            f"reserved {torch.cuda.memory_reserved() / mib:.0f} MiB; graph "
            f"pools: {len(pools)} holding "
            f"{sum(t for t, _ in pools.values()) / mib:.0f} MiB reserved, "
            f"{sum(a for _, a in pools.values()) / mib:.0f} MiB allocated")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reads", type=int, default=200)
    ap.add_argument("--paths", default="pallas,fused,bf16")
    args = ap.parse_args()
    paths = args.paths.split(",")
    for p in paths:
        if p not in PATHS:
            ap.error(f"unknown path {p!r}; choose from {sorted(PATHS)}")
    import torch
    if not torch.cuda.is_available():
        print("probe_graph_memory: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import make_bam
    from hifimeth_tpu_torch.engine import call

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    engines = []
    build = call.CallEngine.__init__

    def init(self, *a, **kw):
        build(self, *a, **kw)
        engines.append(weakref.ref(self))

    call.CallEngine.__init__ = init
    with tempfile.TemporaryDirectory() as td:
        big = os.path.join(td, "big.bam")
        make_bam(big, args.reads, 15000, seed=0)
        out = os.path.join(td, "out.bam")
        for r in range(args.rounds):
            for p in paths:
                fields = PATHS[p]
                for graphs in (False, True):
                    label = (f"round {r} {p} "
                             f"{'graphs' if graphs else 'eager'}")
                    try:
                        call.run_call(big, out, call.CallConfig(
                            **fields, graphs=graphs))
                        torch.cuda.synchronize()
                    except torch.OutOfMemoryError as e:
                        print(f"[{label}] out of device memory: "
                              f"{memory(torch)}; {str(e)[:300]}")
                        return 1
                    alive = sum(ref() is not None for ref in engines)
                    print(f"[{label}] {memory(torch)}; engines alive "
                          f"{alive}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
