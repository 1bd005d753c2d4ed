#!/usr/bin/env python3
"""Microbenchmark of the per-site window fetch in the PyTorch port.

The port of scripts/microbench_gather.py, with its variants, flags, defaults
and synthetic inputs (numpy default_rng(0), drawn in the same order): a
(rows, 8) feature table featurized from random planes, NB batches of
site_batch random window centers with random strands, and the group plans
of sorted sites ~2.5 rows apart.  Each variant runs every batch and reduces
its windows to a checksum; the line printed per variant gives ms for all
batches (best of 3 after a warm-up), ms/batch, Msites/s and batch 0's
checksum.  On the GPU the time is device time between CUDA events (a
device-side sleep first lets the host enqueue ahead, as chip_smoke.cuda_ms
does); with --device cpu it is the host clock.  Before timing, each kernel
variant's windows for batch 0 are checked bit-equal to its plain version.

Usage: python3 scripts/microbench_torch_gather.py [--variants a,b,...]
           [--nb 16] [--site-batch 16384] [--rows 4194304] [--device cuda]
Variants:
  fetch_slice    kmer consecutive rows per site by indexing (no mask/flip)
  fetch_folded   26 folded (16-position) rows per site by indexing
  folded_full    gather_windows_folded (fetch + phase + mask/flip)
  slice_full     gather_windows_slice (fetch + mask/flip)
  cnn            DNAModNet (shipped CpG model) on resident (B, 8, 401) windows
  pallas_group   ops.gather.group_windows kernel (32-site groups, 1024 rows)
  pallas_groupt  ops.gather.group_windows_t kernel (the call path's gather)
  pallas_slice   ops.gather.window_slices kernel (spp=8)
  pallas_slice64 same with spp=64
The pallas_* names are the JAX script's; here they are CUDA kernels.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

VARIANTS = ("fetch_slice", "fetch_folded", "folded_full", "slice_full", "cnn",
            "pallas_group", "pallas_groupt", "pallas_slice", "pallas_slice64")


def _timer(dev):
    """fn() -> seconds for one call of fn: CUDA events on the GPU, the host
    clock on the CPU."""
    import torch
    if dev.type != "cuda":
        def host(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        return host

    def device(fn):
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    return device


def _group_plans(rng, nb, b, k, n, block, align):
    """Per batch: b sorted starts ~2.5 rows apart packed into groups of 32
    consecutive sites, each group's base its first start (rounded down to
    `align`) clipped to n - block (the JAX script's construction)."""
    g = 32
    bases = np.empty((nb, b // g), np.int32)
    rels = np.empty((nb, b // g, g), np.int32)
    for i in range(nb):
        starts = (k + np.cumsum(rng.integers(1, 5, b))).astype(np.int32)
        sg = starts.reshape(b // g, g)
        base = np.minimum((sg[:, 0] // align) * align, n - block)
        bases[i] = base
        rels[i] = sg - base[:, None]
    return bases, rels


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants",
                    default="fetch_slice,fetch_folded,folded_full,slice_full,cnn")
    ap.add_argument("--nb", type=int, default=16)
    ap.add_argument("--site-batch", type=int, default=16384)
    ap.add_argument("--rows", type=int, default=1 << 22)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    variants = [v for v in args.variants.split(",") if v]
    unknown = sorted(set(variants) - set(VARIANTS))
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; choose from "
                         f"{','.join(VARIANTS)}")

    import torch
    from hifimeth_tpu_torch.constants import KMER_SIZE
    from hifimeth_tpu_torch.device import resolve_device
    from hifimeth_tpu_torch.features.windows import (FOLD, featurize_planes,
                                                     featurize_planes_t,
                                                     fold_table,
                                                     gather_windows_folded,
                                                     gather_windows_slice)
    from hifimeth_tpu_torch.ops import gather as G

    dev = resolve_device(args.device)
    N, B, NB, K = args.rows, args.site_batch, args.nb, KMER_SIZE
    hk = K // 2
    rng = np.random.default_rng(0)
    planes = rng.integers(0, 256, (5, N)).astype(np.uint8)
    planes[0] = rng.integers(0, 4, N)
    planes_d = torch.from_numpy(planes).to(dev)
    feats = featurize_planes(planes_d)
    folded = fold_table(feats)
    centers = rng.integers(K, N - K, (NB, B)).astype(np.int32)
    strands = rng.integers(0, 2, (NB, B)).astype(np.uint8)
    rstart = np.zeros((NB, B), np.int32) + 8
    rend = np.zeros((NB, B), np.int32) + (N - 8)
    c_d, s_d, rs_d, re_d = (torch.from_numpy(a).to(dev)
                            for a in (centers, strands, rstart, rend))
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (host clock)")
    print(f"[microbench] {name}: {N} rows, {NB} batches x {B} sites",
          flush=True)
    clock = _timer(dev)
    results = {}

    def timed(label, batch):
        """batch(i) -> windows (or logits) of batch i."""
        def run():
            return [batch(i).sum() for i in range(NB)]
        with torch.inference_mode():
            checks = run()                         # warm-up
            best = min(clock(run) for _ in range(3))
        per_batch = best / NB
        checksum = float(checks[0])
        print(f"{label:16s} {best*1e3:8.1f} ms total  {per_batch*1e3:7.2f} "
              f"ms/batch  {B/per_batch/1e6:7.2f} Msites/s  (checksum "
              f"{checksum:.3e})", flush=True)
        results[label] = {"ms_per_batch": per_batch * 1e3,
                          "msites_per_s": B / per_batch / 1e6,
                          "checksum": checksum}

    def check(label, got, want):
        with torch.inference_mode():
            if not torch.equal(got(), want()):
                raise AssertionError(f"{label}: kernel windows of batch 0 "
                                     f"differ from its plain version")

    if "fetch_slice" in variants:
        timed("fetch_slice", lambda i: G.window_slices_plain(
            feats, c_d[i] - hk, K))
    if "fetch_folded" in variants:
        frows = (K + 2 * (FOLD - 1)) // FOLD

        def fetch_folded(i):
            r0 = torch.div(c_d[i].long() - hk, FOLD, rounding_mode="floor")
            r0 = r0.clamp(0, folded.shape[0] - frows)
            return folded[r0[:, None] + torch.arange(frows, device=dev)]
        timed("fetch_folded", fetch_folded)
    if "folded_full" in variants:
        timed("folded_full", lambda i: gather_windows_folded(
            folded, c_d[i], s_d[i], rs_d[i], re_d[i]))
    if "slice_full" in variants:
        timed("slice_full", lambda i: gather_windows_slice(
            feats, c_d[i], s_d[i], rs_d[i], re_d[i]))

    if "cnn" in variants:
        from hifimeth_tpu_torch.engine.call import default_model_dir
        from hifimeth_tpu_torch.model.cnn import exact_float32, load_model_npz
        if dev.type == "cuda":
            exact_float32()
        model = load_model_npz(os.path.join(default_model_dir(), "CpG.npz"),
                               dev)
        with torch.inference_mode():
            w = gather_windows_slice(feats, c_d[0], s_d[0], rs_d[0], re_d[0])
            w_dev = w.transpose(1, 2).contiguous()
        # eager PyTorch runs every batch; nothing is hoisted out of the loop
        timed("cnn", lambda i: model(w_dev))

    if "pallas_group" in variants:
        bases, rels = _group_plans(rng, NB, B, K, N, 1024, 1)
        assert rels.max() <= 1024 - K and rels.min() >= 0
        b_d, r_d = torch.from_numpy(bases).to(dev), torch.from_numpy(rels).to(dev)
        check("pallas_group",
              lambda: G.group_windows(feats, b_d[0], r_d[0], 32, 1024, K),
              lambda: G.group_windows_plain(feats, b_d[0], r_d[0], 32, 1024,
                                            K))
        timed("pallas_group", lambda i: G.group_windows(
            feats, b_d[i], r_d[i], 32, 1024, K))

    if "pallas_groupt" in variants:
        ft = featurize_planes_t(planes_d)
        bases, rels = _group_plans(rng, NB, B, K, N, G.BLOCK_LANES, 128)
        assert rels.max() <= G.BLOCK_LANES - G.CHUNK_LANES and rels.min() >= 0
        b_d, r_d = torch.from_numpy(bases).to(dev), torch.from_numpy(rels).to(dev)
        check("pallas_groupt",
              lambda: G.group_windows_t(ft, b_d[0], r_d[0], kmer=K),
              lambda: G.group_windows_t_plain(ft, b_d[0], r_d[0], False, K,
                                              torch.float32))
        timed("pallas_groupt", lambda i: G.group_windows_t(
            ft, b_d[i], r_d[i], kmer=K))

    for label, spp in (("pallas_slice", 8), ("pallas_slice64", 64)):
        if label not in variants:
            continue
        starts = c_d - hk
        check(label, lambda: G.window_slices(feats, starts[0], K, spp=spp),
              lambda: G.window_slices_plain(feats, starts[0], K))
        timed(label, lambda i: G.window_slices(feats, starts[i], K, spp=spp))
    return results


if __name__ == "__main__":
    main()
