#!/usr/bin/env python3
"""The port's benchmark: one cell of BENCHMARK.json on the card(s).

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout that holds the program
(hifimeth_tpu_torch) and its shipped models.  Prints, as the last line of
standard output, one JSON object: `correct`, `attempted` (records served
in the window), `failed`, `metrics` (the cell's end-to-end metrics, or
with --trace 1 its per-layer metrics), `device`, with --trace 1
`breakdown`, and last `check`, each compared number beside its limit
(also the last lines of standard error).  Exits non-zero and prints no
result without enough CUDA devices, when a module of jax, jaxlib, flax or
hifimeth_tpu was loaded, or on any error.
"""
import os
import sys
import time

T_START = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from portbench import catalog  # noqa: E402

catalog.set_cache_dirs()


def main() -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if args.seconds <= 0:
        ap.error("--seconds must be positive")

    from portbench import harness
    cell = harness.Cell(catalog.load_benchmark(), args.workload)

    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    result, numbers = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), T_START,
        log=lambda s: print(s, file=sys.stderr))
    # after the run, so that set-up holds only what the run needs
    print(f"[portbench] card: {harness.card_line()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded forbidden modules: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, value, limit in numbers:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
