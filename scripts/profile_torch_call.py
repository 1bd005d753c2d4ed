#!/usr/bin/env python3
"""Where the device time of the PyTorch port's `call` goes, on one GPU.

Runs the port's run_call on the chip_smoke.py main-path input (200 reads x
15 kb, random seed-0 kinetics, shipped models, default batch and buffer
sizes) through one per-site path (--gather-impl: "pallas", the gather
kernel + cuDNN CNN; "fused", the fused kernel; "slice" or "folded", the
indexing gathers + cuDNN CNN), through the asynchronous pipeline or, with
--sync-emit, on the caller's thread, in --dtype f32 or bf16, with
--decode-workers threads (default -1, the engine's auto rule), with the
CNN's convolutions on the route of --conv-impl (CallConfig.conv_impl:
direct, im2col or auto; fused ignores it), each batch replaying its
captured CUDA graph (CallConfig.graphs, the default) or, with --eager,
launching every op eagerly, --reps times plain to time it (default 1) and
once under torch.profiler (device activity only, so the host pays no
per-op tracing cost), and prints:
 - wall seconds, sites/s, the engine's timers (`capture`: the seconds the
   engine took to warm up and capture its graphs, inside the wall) and the
   peak device memory (allocated and reserved) of each plain run, and the
   median sites/s over the runs;
 - device time by kernel class (the gather kernel, the fused kernel,
   convolutions, matrix products, PyTorch indexing (the slice/folded
   gathers), elementwise/other kernels, memory copies), summed over the
   profiled run, and the device's busy share of that run's wall time (the
   union of its kernels' and copies' intervals on every stream).  CUPTI
   reports the kernels a graph launches one by one, as it does eager
   launches, so both kinds of run are read the same way;
 - each conv layer's device ms on one 8192-site batch of CpG windows
   (random one-hot bases and kinetics at kmer 401, after bn0; CUDA events
   around the layer: padding, columns, product or convolution, bias, ReLU;
   median of --layer-reps), direct and, when --conv-impl is not direct, on
   that route, measured in turns in the same process: conv1 apart from the
   sum of conv2-conv8.

Usage (on a machine with a CUDA device):
    python3 scripts/profile_torch_call.py [--gather-impl pallas|fused|slice|folded]
        [--sync-emit] [--dtype f32|bf16] [--decode-workers N] [--eager]
        [--conv-impl direct|im2col|auto] [--reps N] [--layer-reps N]
        [--out DIR]
To compare settings, run the script once per setting in one session, the
settings in turns, so that drift on the host spreads over all of them.
With --out, the JSON summary is also written to
DIR/profile_summary.<gather-impl>[.sync][.bf16][.w<N>][.eager][.<conv-impl>].json.
`device_profile` is also chip_smoke.py's reading of the idle share.
"""
import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def cfg_dtype(name: str):
    import torch
    return {"f32": torch.float32, "bf16": torch.bfloat16}[name]


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


def device_profile(fn) -> dict:
    """Run `fn()` under torch.profiler (device activity only) and
    synchronise; returns its wall seconds, the device's busy seconds (the
    union of its kernels' and copies' intervals on every stream), device
    ms by kernel class and by kernel name, and the count of each kernel
    name's device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class: dict = {}
    by_kernel: dict = {}
    n_by_kernel: dict = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        spans.append((ev.time_range.start, ev.time_range.end))
        c = kernel_class(ev.name)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + us / 1e3
        n_by_kernel[ev.name] = n_by_kernel.get(ev.name, 0) + 1
    # busy = the union of the intervals: a copy on the copy stream that
    # overlaps a kernel counts once
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return {"wall_s": wall, "busy_s": busy_us / 1e6,
            "idle_share": 1 - busy_us / 1e6 / wall,
            "ms_by_class": by_class, "ms_by_kernel": by_kernel,
            "n_by_kernel": n_by_kernel}


def conv_layer_ms(routes, dtype, reps, batch=8192, kmer=401, seed=0) -> dict:
    """Device ms of each conv layer of the shipped CpG model on one batch,
    per route of `routes`: {route: [ms of conv1, ..., conv8]}, medians of
    `reps` timings, the routes timed in turns (see the module notes)."""
    import numpy as np
    import torch
    from hifimeth_tpu_torch.model.cnn import exact_float32, load_model_npz
    exact_float32()
    rng = np.random.default_rng(seed)
    x = np.zeros((batch, 8, kmer), np.float32)
    x[np.arange(batch)[:, None], rng.integers(0, 4, (batch, kmer)),
      np.arange(kmer)[None, :]] = 1.0
    x[:, 4:] = rng.random((batch, 4, kmer), dtype=np.float32)
    x = torch.from_numpy(x).cuda()
    models = {r: load_model_npz(os.path.join(ROOT, "models", "CpG.npz"),
                                "cuda", dtype, r) for r in routes}
    times = {r: [[] for _ in models[r].convs] for r in routes}
    with torch.inference_mode():
        ins = {}
        for r, m in models.items():
            h = m.bn0(x)
            low = m._low[0] if m._low else [None] * len(m.convs)
            ins[r] = []
            for conv, w in zip(m.convs, low):
                ins[r].append(h)
                h = conv(h, w)
        for rep in range(reps + 1):                # the first is a warm-up
            for r, m in models.items():
                low = m._low[0] if m._low else [None] * len(m.convs)
                events = []
                for i, (conv, w) in enumerate(zip(m.convs, low)):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    conv(ins[r][i], w)
                    b.record()
                    events.append((a, b))
                torch.cuda.synchronize()
                if rep:
                    for i, (a, b) in enumerate(events):
                        times[r][i].append(a.elapsed_time(b))
    return {r: [statistics.median(t) for t in times[r]] for r in routes}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gather-impl", default="pallas",
                    choices=("pallas", "fused", "slice", "folded"))
    ap.add_argument("--sync-emit", action="store_true")
    ap.add_argument("--dtype", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--decode-workers", type=int, default=-1)
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--conv-impl", default="direct",
                    choices=("direct", "im2col", "auto"))
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--layer-reps", type=int, default=20)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if args.reps < 1 or args.layer_reps < 1:
        ap.error("--reps and --layer-reps must be at least 1")
    label = (args.gather_impl + (".sync" if args.sync_emit else "")
             + (".bf16" if args.dtype == "bf16" else "")
             + (f".w{args.decode_workers}" if args.decode_workers >= 0
                else "") + (".eager" if args.eager else "")
             + (f".{args.conv_impl}" if args.conv_impl != "direct" else ""))

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_call: no CUDA device", file=sys.stderr)
        return 1

    from chip_smoke import make_bam
    from hifimeth_tpu_torch.engine.call import CallConfig, run_call

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    with tempfile.TemporaryDirectory() as td:
        stats_json = os.path.join(td, "stats.json")
        cfg = CallConfig(gather_impl=args.gather_impl,
                         async_emit=not args.sync_emit,
                         compute_dtype={"f32": "float32",
                                        "bf16": "bfloat16"}[args.dtype],
                         decode_workers=args.decode_workers,
                         conv_impl=args.conv_impl,
                         graphs=not args.eager, stats_json=stats_json)
        small, big = os.path.join(td, "small.bam"), os.path.join(td, "big.bam")
        make_bam(small, 4, 4000, seed=1)
        make_bam(big, 200, 15000, seed=0)
        out = os.path.join(td, "out.bam")
        run_call(small, out, cfg)                          # warm-up
        runs = []
        for rep in range(args.reps):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            stats = run_call(big, out, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            sites = sum(stats[c] for c in ("CpG", "CHG", "CHH"))
            with open(stats_json) as f:
                timers = json.load(f)["timers"]
            peak = (torch.cuda.max_memory_allocated() / 2**20,
                    torch.cuda.max_memory_reserved() / 2**20)
            runs.append({"wall_s": wall, "sites_per_s": sites / wall,
                         "timers": timers, "peak_allocated_mib": peak[0],
                         "peak_reserved_mib": peak[1]})
            print(f"[plain run {rep}, {label}] {sites} sites in {wall:.3f} s"
                  f" = {sites / wall:.1f} sites/s; peak device memory "
                  f"{peak[0]:.1f} MiB allocated, {peak[1]:.1f} MiB reserved;"
                  f" engine timers (s): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in timers.items()))
        median = statistics.median(r["sites_per_s"] for r in runs)
        print(f"[plain runs, {label}] median of {args.reps}: {median:.1f} "
              f"sites/s")

        prof = device_profile(lambda: run_call(big, out, cfg))

    print(f"[profiled run] wall {prof['wall_s']:.3f} s, device busy "
          f"{prof['busy_s']:.3f} s = {100 - 100 * prof['idle_share']:.1f}% "
          f"of wall (idle {100 * prof['idle_share']:.1f}%)")
    by_class = prof["ms_by_class"]
    sum_ms = sum(by_class.values())
    for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {c:<20} {ms:10.3f} ms  {100 * ms / sum_ms:5.1f}%")
    print("  top kernels:")
    for name, ms in sorted(prof["ms_by_kernel"].items(),
                           key=lambda kv: -kv[1])[:12]:
        print(f"    {ms:10.3f} ms  {name[:110]}")
    routes = ("direct",) + ((args.conv_impl,) if args.conv_impl != "direct"
                            else ())
    layers = conv_layer_ms(routes, cfg_dtype(args.dtype), args.layer_reps)
    for r, ms in layers.items():
        print(f"[conv layers, {r}, {args.dtype}] one 8192-site CpG batch: "
              f"conv1 {ms[0]:.4f} ms, conv2-conv8 {sum(ms[1:]):.4f} ms ("
              + ", ".join(f"{t:.4f}" for t in ms[1:]) + f"); median of "
              f"{args.layer_reps}")
    summary = {"card": card, "gather_impl": args.gather_impl,
               "sync_emit": args.sync_emit, "dtype": args.dtype,
               "decode_workers": args.decode_workers,
               "graphs": not args.eager,
               "sites": sites, "plain_runs": runs,
               "median_sites_per_s": median,
               "profiled_wall_s": prof["wall_s"],
               "device_busy_s": prof["busy_s"],
               "device_idle_share": prof["idle_share"],
               "device_ms_by_class": by_class, "conv_impl": args.conv_impl,
               "conv_layer_ms": layers}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"profile_summary.{label}.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
