#!/usr/bin/env python3
"""The control of `correct`, and readings of the check's numbers beside it.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 \
        [--paths default,fused,im2col,bf16]

For each seed, on the cell's own pool (the size a run uses):

- ``control``: the plain reference computed with TF32 operands (the
  nearest precision below the configuration's float32 with TF32 off), put
  in the program's place and held to the float32 reference by the same
  comparison as a run.  It has to come out not correct;
- each of ``--paths``: the program's run_call over one round of the pool
  (every read once) with the cell's settings and one CallConfig change
  ("default": none; "fused": gather_impl fused, 3xTF32 tensor-core
  products; "im2col": conv_impl im2col; "bf16": compute_dtype bfloat16),
  held to the same reference.  "default" is a reading of the program as
  benchmarked; the others show where other float32 routes, and a lower
  precision the program has, land against the limit.

Prints one line per seed and reading (`[control] <cell> seed <n> <what>
<number> <value> ...`) and, last, a JSON summary.  Needs the card(s) the
cell asks for; the benchmark's own runs do not run this.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from portbench import catalog  # noqa: E402

catalog.set_cache_dirs()

PATHS = {"default": {}, "fused": {"gather_impl": "fused"},
         "im2col": {"conv_impl": "im2col"},
         "bf16": {"compute_dtype": "bfloat16"}}


def readings(cell, seed: int, paths, device: str = "cuda", traffic=None,
             overrides=None, devices=None, log=print) -> dict:
    """{what: {number: value}} for the control and each program path on
    one seed's pool."""
    import shutil
    import tempfile

    from hifimeth_tpu_torch.engine.call import run_call

    from portbench import check, harness, inputs
    from portbench.reference import hifimeth as reference

    pool = inputs.make_pool(traffic or cell.traffic, seed)
    ref_dev = "cuda:0" if device == "cuda" else "cpu"
    args = (pool.seq, pool.kin, pool.offsets, cell.config["contexts"],
            harness.models_dir())
    expected = reference.call_pool(*args, device=ref_dev)
    limits = cell.config["check"]
    out = {}
    t = time.perf_counter()
    low = reference.call_pool(*args, device=ref_dev, precision="tf32")
    v = check.score_answers(expected, low, limits)
    out["control"] = {k: val for k, (val, _) in v["numbers"].items()}
    out["control"]["correct"] = v["correct"]
    log(f"[control] {cell.name} seed {seed} control "
        + " ".join(f"{k} {val!r}" for k, val in out["control"].items())
        + f" ({time.perf_counter() - t:.2f} s)")
    blocks = inputs.encode_pool(pool)
    dev_list = cell.devices(device, devices)
    work = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        for name in paths:
            kw = dict(overrides or {})
            kw.update(PATHS[name])
            stream = inputs.PoolStream(blocks, limit=pool.n_reads)
            path = os.path.join(work, f"{name}.bam")
            t = time.perf_counter()
            run_call(stream, path, cell.call_config(device, kw),
                     devices=dev_list)
            v = check.compare(check.read_records(path), stream.served,
                              pool.name, expected, limits)
            out[name] = {k: val for k, (val, _) in v["numbers"].items()}
            out[name]["correct"] = v["correct"]
            log(f"[control] {cell.name} seed {seed} program-{name} "
                + " ".join(f"{k} {val!r}" for k, val in out[name].items())
                + f" ({time.perf_counter() - t:.2f} s)")
            os.remove(path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def main() -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--paths", default="")
    args = ap.parse_args()
    paths = [p for p in args.paths.split(",") if p]
    unknown = [p for p in paths if p not in PATHS]
    if unknown:
        ap.error(f"unknown paths {unknown}; choose from {list(PATHS)}")

    import torch

    from portbench import harness
    cell = harness.Cell(catalog.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print("control: not enough CUDA devices", file=sys.stderr)
        return 2
    print(f"[control] card: {harness.card_line()}", flush=True)
    summary = {}
    for s in args.seeds.split(","):
        summary[s] = readings(cell, int(s), paths,
                              log=lambda m: print(m, flush=True))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
