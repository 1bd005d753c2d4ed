#!/usr/bin/env python3
"""Where the fused kernel's time goes, stage by stage, on one GPU.

Builds ops/csrc/fused_forward.cu ten times with -DHM_FUSED_STAGES=n (the
kernel stops after stage n: 0 = window staged with bn0, 1..8 = conv1..conv8,
9 = the whole kernel with fc1/fc2), all builds in parallel, and times each
variant with CUDA events at the main path's shape (8192 sites, the
chip_smoke.py main plan over a featurized table) for the CpG (conv1 K=11)
and CHH (K=13) models.  Each stage's time is the difference of consecutive
variants; beside it, its FLOP, its achieved FLOP/s and its share of the
kernel.  The source has three kernels (head: window, conv1, conv2; mid:
conv3, conv4; tail: conv5..fc2), handing activations over through a
scratch buffer: stage conv2 carries writing conv2's output, conv3 reading
it and the mid kernel's launch, conv5 reading conv4's output and the tail
kernel's launch.

Usage (on a machine with a CUDA device):
    python3 scripts/profile_fused_layers.py [--out DIR]
With --out, the JSON summary is also written to DIR/fused_layers.json.
"""
import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = ["window+bn0"] + [f"conv{i}" for i in range(1, 9)] + ["fc1+fc2"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_fused_layers: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import SITE_BATCH, cuda_ms, feature_table, gather_plan
    from hifimeth_tpu_torch.engine.call import default_model_dir
    from hifimeth_tpu_torch.model.cnn import load_model_npz
    from hifimeth_tpu_torch.ops import build
    from hifimeth_tpu_torch.ops.fused import (bind_kernel, launch_kernel,
                                              prepare_fused_params)
    from hifimeth_tpu_torch.ops.gather import GROUP

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    src = os.path.join(build.CSRC_DIR, "fused_forward.cu")

    def lib(n):
        # a library name of its own per variant: builds of one name
        # serialise on that name's lock
        return bind_kernel(build._build(
            src, f"fused_forward_s{n}", build.nvcc_path(),
            build.NVCC_FLAGS + [f"-DHM_FUSED_STAGES={n}"], []))

    with ThreadPoolExecutor(len(STAGES)) as pool:
        libs = list(pool.map(lib, range(len(STAGES))))

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    n_cols = 1 << 21
    table = feature_table(rng, n_cols, dev)
    b, r = gather_plan(rng, SITE_BATCH - 200, n_cols - 602 - 27000,
                       n_cols - 602, n_cols, SITE_BATCH // GROUP)
    bd, rd = torch.from_numpy(b).to(dev), torch.from_numpy(r).to(dev)
    n_sites = len(b) * GROUP
    out = torch.empty((n_sites, 2), dtype=torch.float32, device=dev)
    summary = {"card": card, "sites": n_sites, "models": {}}
    for ctx in ("CpG", "CHH"):
        w = prepare_fused_params(load_model_npz(
            os.path.join(default_model_dir(), f"{ctx}.npz"), dev), dev)
        stage_flops = [0]
        for i, lo in enumerate(w.lengths):
            k, cin, cout = w.layout[f"convs.{i}.w"][1]
            stage_flops.append(2 * k * cin * cout * lo * n_sites)
        stage_flops.append((w.flops_per_window() * n_sites)
                           - sum(stage_flops))

        cum = [cuda_ms(lambda so=so: launch_kernel(so, w, table, bd, rd,
                                                   False, out), iters=10)
               for so in libs]
        total = cum[-1]
        rows = []
        print(f"{ctx}: whole kernel {total:.4f} ms at {n_sites} sites")
        for i, name in enumerate(STAGES):
            ms = cum[i] - (cum[i - 1] if i else 0.0)
            tf = stage_flops[i] / (ms * 1e-3) / 1e12 if ms > 0 else 0.0
            rows.append({"stage": name, "ms": ms, "cumulative_ms": cum[i],
                         "flop": stage_flops[i], "tflops": tf})
            print(f"  {name:<11} {ms:9.4f} ms  {100 * ms / total:5.1f}%  "
                  f"{stage_flops[i] / 1e9:8.3f} GFLOP  {tf:6.2f} TFLOP/s")
        summary["models"][ctx] = rows
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "fused_layers.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
