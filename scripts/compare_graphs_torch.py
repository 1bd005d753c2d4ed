#!/usr/bin/env python3
"""`call` with its batches replayed in CUDA graphs against the same runs
launched eagerly (CallConfig.graphs), in paired turns on one GPU.

Builds the chip smoke's synthetic input (--reads reads x 15 kb, seed 0,
plant composition) and runs it through every (path, mode) of --paths and
--modes --pairs times with graphs off and on, in one process.  The pairs
are interleaved over the settings (pair 0 of every setting, then pair 1,
...) and each pair's order alternates (eager first in even pairs, graphs
first in odd ones), so drift on the host spreads over settings and both
orders.  Paths: pallas, fused, bf16 (pallas in bf16), slice, folded (the
indexing gathers, one program a context).  Modes: async (the
default pipeline, decode workers by the engine's rule), sync-w0
(--sync-emit --decode-workers 0).  Prints, per run, its wall seconds,
sites/s and the engine's `capture` and `dispatch` timers; per setting, the
median sites/s of each side and the eager runs' interquartile spread, the
median, lowest and highest of the pairs' graphs/eager ratios, how many
pairs graphs won, the median capture seconds of the graph runs, and a
verdict: "gain" (or "loss") when graphs won (lost) at least nine pairs
in ten and the medians differ by more than the eager runs' interquartile
spread, else "unresolved".  Outputs of every run are byte-equal to the
first run of their path (checked).  Every run starts from an empty
allocator cache.

Usage (on a machine with a CUDA device):
    python3 scripts/compare_graphs_torch.py [--paths pallas,fused,bf16,slice,folded]
        [--modes async,sync-w0] [--pairs N] [--reads N] [--out DIR]
With --out, the JSON summary is also written to
DIR/compare_graphs.r<reads>.json.
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

PATHS = {"pallas": dict(gather_impl="pallas"),
         "fused": dict(gather_impl="fused"),
         "bf16": dict(gather_impl="pallas", compute_dtype="bfloat16"),
         "slice": dict(gather_impl="slice"),
         "folded": dict(gather_impl="folded")}
MODES = {"async": {}, "sync-w0": dict(async_emit=False, decode_workers=0)}


def iqr(xs) -> float:
    """The distance between the first and third quartiles (0 for one
    value)."""
    if len(xs) < 2:
        return 0.0
    q = statistics.quantiles(xs, n=4)
    return q[2] - q[0]


def verdict(eager, graph) -> str:
    """gain / loss / unresolved over paired runs (see the module notes)."""
    n = len(eager)
    won = sum(g > e for g, e in zip(graph, eager))
    lost = sum(g < e for g, e in zip(graph, eager))
    gap = statistics.median(graph) - statistics.median(eager)
    if abs(gap) <= iqr(eager):
        return "unresolved"
    if won >= 0.9 * n and gap > 0:
        return "gain"
    if lost >= 0.9 * n and gap < 0:
        return "loss"
    return "unresolved"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="pallas,fused,bf16")
    ap.add_argument("--modes", default="async,sync-w0")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reads", type=int, default=200)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    paths, modes = args.paths.split(","), args.modes.split(",")
    for p in paths:
        if p not in PATHS:
            ap.error(f"unknown path {p!r}; choose from {sorted(PATHS)}")
    for m in modes:
        if m not in MODES:
            ap.error(f"unknown mode {m!r}; choose from {sorted(MODES)}")
    if args.pairs < 1 or args.reads < 1:
        ap.error("--pairs and --reads must be at least 1")

    import torch
    if not torch.cuda.is_available():
        print("compare_graphs_torch: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import make_bam, record_bytes
    from hifimeth_tpu_torch.engine.call import CallConfig, run_call

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    settings = [(p, m) for p in paths for m in modes]
    runs = {s: {False: [], True: []} for s in settings}
    with tempfile.TemporaryDirectory() as td:
        small, big = os.path.join(td, "small.bam"), os.path.join(td, "big.bam")
        make_bam(small, 4, 4000, seed=1)
        t0 = time.perf_counter()
        make_bam(big, args.reads, 15000, seed=0)
        print(f"[input] {args.reads} reads x 15 kb in "
              f"{time.perf_counter() - t0:.1f} s")
        out = os.path.join(td, "out.bam")
        stats_json = os.path.join(td, "stats.json")
        for p in paths:                                  # warm-up
            run_call(small, out, CallConfig(**PATHS[p]))
        want = {}
        for i in range(args.pairs):
            for s in settings:
                p, m = s
                for graphs in ((False, True) if i % 2 == 0
                               else (True, False)):
                    cfg = CallConfig(**PATHS[p], **MODES[m], graphs=graphs,
                                     stats_json=stats_json)
                    # every run starts from an empty allocator cache
                    gc.collect()
                    torch.cuda.empty_cache()
                    t0 = time.perf_counter()
                    stats = run_call(big, out, cfg)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    sites = sum(stats[c] for c in ("CpG", "CHG", "CHH"))
                    with open(stats_json) as f:
                        timers = json.load(f)["timers"]
                    recs = record_bytes(out)
                    if want.setdefault(p, recs) != recs:
                        raise AssertionError(f"{p} {m} graphs={graphs} pair "
                                             f"{i}: records differ")
                    runs[s][graphs].append({
                        "wall_s": wall, "sites_per_s": sites / wall,
                        "capture_s": timers["capture"],
                        "dispatch_s": timers["dispatch"]})
                    print(f"[run {p} {m} {'graphs' if graphs else 'eager'} "
                          f"pair {i}] {sites} sites in {wall:.4f} s = "
                          f"{sites / wall:.1f} sites/s; capture "
                          f"{timers['capture']:.4f} s, dispatch "
                          f"{timers['dispatch']:.4f} s", flush=True)
    summary = {"card": card, "reads": args.reads, "pairs": args.pairs,
               "sites": sites, "settings": {}}
    for (p, m), r in runs.items():
        eager = [x["sites_per_s"] for x in r[False]]
        graph = [x["sites_per_s"] for x in r[True]]
        ratios = [g / e for g, e in zip(graph, eager)]
        row = {"eager_median": statistics.median(eager),
               "graphs_median": statistics.median(graph),
               "eager_iqr": iqr(eager), "verdict": verdict(eager, graph),
               "ratio_median": statistics.median(ratios),
               "ratio_min": min(ratios), "ratio_max": max(ratios),
               "graphs_won": sum(x > 1 for x in ratios),
               "capture_median_s": statistics.median(
                   x["capture_s"] for x in r[True]),
               "dispatch_median_s": {
                   "eager": statistics.median(x["dispatch_s"]
                                              for x in r[False]),
                   "graphs": statistics.median(x["dispatch_s"]
                                               for x in r[True])},
               "runs": r}
        summary["settings"][f"{p} {m}"] = row
        print(f"[summary {p} {m}] {args.reads} reads, {args.pairs} pairs: "
              f"eager {row['eager_median']:.1f} (IQR "
              f"{row['eager_iqr']:.1f}), graphs {row['graphs_median']:.1f} "
              f"sites/s (medians); {row['verdict']}; graphs/eager "
              f"median {row['ratio_median']:.4f}, range "
              f"{row['ratio_min']:.4f}-{row['ratio_max']:.4f}, graphs won "
              f"{row['graphs_won']} of {args.pairs}; capture "
              f"{row['capture_median_s']:.4f} s; dispatch eager "
              f"{row['dispatch_median_s']['eager']:.4f} s, graphs "
              f"{row['dispatch_median_s']['graphs']:.4f} s")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out,
                               f"compare_graphs.r{args.reads}.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
