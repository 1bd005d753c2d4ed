#!/usr/bin/env python3
"""Where the device time of the PyTorch port's `call` goes, on one GPU.

Runs the port's run_call on the chip_smoke.py main-path input (200 reads x
15 kb, random seed-0 kinetics, shipped models, default batch and buffer
sizes) through one per-site path (--gather-impl: "pallas", the gather
kernel + cuDNN CNN; "fused", the fused kernel; "slice" or "folded", the
indexing gathers + cuDNN CNN), once plain to time it and once under
torch.profiler, and prints:
 - wall seconds and sites/s of the plain run;
 - device time by kernel class (the gather kernel, the fused kernel,
   convolutions, matrix products, PyTorch indexing (the slice/folded
   gathers), elementwise/other kernels, memory copies), summed over the
   profiled run, and the device's busy share of that run's wall time.

Usage (on a machine with a CUDA device):
    python3 scripts/profile_torch_call.py [--gather-impl pallas|fused|slice|folded]
        [--out DIR]
With --out, the JSON summary is also written to
DIR/profile_summary.<gather-impl>.json.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def kernel_class(name: str) -> str:
    n = name.lower()
    if "group_windows" in n:
        return "gather kernel"
    if "fused_forward" in n or "::fused_" in n:   # fused_{head,mid,tail}
        return "fused kernel"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset"
    if "conv" in n or "xmma_fprop" in n or "implicit" in n or "cudnn" in n:
        return "convolution"
    if "gemm" in n or "sgemm" in n or "cublas" in n or "ampere" in n \
            or "sm90" in n:
        return "matmul"
    if "index" in n or "gather" in n:
        return "indexing"
    return "elementwise/other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gather-impl", default="pallas",
                    choices=("pallas", "fused", "slice", "folded"))
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_call: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import make_bam
    from hifimeth_tpu_torch.engine.call import CallConfig, run_call

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    cfg = CallConfig(gather_impl=args.gather_impl)
    with tempfile.TemporaryDirectory() as td:
        small, big = os.path.join(td, "small.bam"), os.path.join(td, "big.bam")
        make_bam(small, 4, 4000, seed=1)
        make_bam(big, 200, 15000, seed=0)
        out = os.path.join(td, "out.bam")
        run_call(small, out, cfg)                          # warm-up
        t0 = time.perf_counter()
        stats = run_call(big, out, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sites = sum(stats[c] for c in ("CpG", "CHG", "CHH"))
        print(f"[plain run, {args.gather_impl}] {sites} sites in {wall:.3f} s = "
              f"{sites / wall:.1f} sites/s")

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_call(big, out, cfg)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0

    by_class: dict = {}
    by_kernel: dict = {}
    busy_us = 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        busy_us += us
        c = kernel_class(ev.name)
        by_class[c] = by_class.get(c, 0.0) + us
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + us
    print(f"[profiled run] wall {pwall:.3f} s, device busy "
          f"{busy_us / 1e6:.3f} s = {100 * busy_us / 1e6 / pwall:.1f}% "
          f"of wall (idle {100 - 100 * busy_us / 1e6 / pwall:.1f}%)")
    for c, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {c:<20} {us / 1e3:10.3f} ms  {100 * us / busy_us:5.1f}%")
    print("  top kernels:")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3:10.3f} ms  {name[:110]}")
    summary = {"card": card, "gather_impl": args.gather_impl, "sites": sites, "wall_s": wall,
               "sites_per_s": sites / wall, "profiled_wall_s": pwall,
               "device_busy_s": busy_us / 1e6,
               "device_ms_by_class": {k: v / 1e3 for k, v in by_class.items()}}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"profile_summary."
                               f"{args.gather_impl}.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
