#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hifimeth_tpu_torch) on one GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases (any failure exits non-zero before the final line is printed):
 1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
    build of every kernel and of the host I/O core from this checkout;
 2. every kernel of the call path against its plain PyTorch version on the
    card, bit-exact, and timed at the main path's shape (8192 sites), beside
    its byte bound and one PyTorch library call computing the same function;
 3. the main path: all-context `call` through the port's run_call at the
    shipped models' full width, over ~200 reads x 15 kb (~0.9 M sites), with
    every kernel's launch count read just after it;
 4. the card's output against the port's CPU run on a small input: MM/MN
    byte-equal, ML within +-1.
The line before the last is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: base composition (A, C, G, T) of the synthetic reads: GC ~0.36, about
#: 0.30 all-context candidate sites per base, a plant genome's density
PLANT = (0.32, 0.18, 0.18, 0.32)
SITE_BATCH = 8192


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def make_bam(path, n_reads, read_len, seed):
    """Unmapped HiFi-like reads with random codeV1 kinetics (fi/ri/fp/rp)."""
    import numpy as np
    from hifimeth_tpu_torch.io.bam import BamHeader, BamRecord, BamWriter

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    with BamWriter(path, BamHeader("@HD\tVN:1.6\tSO:unknown\n", []),
                   threads=8) as w:
        for i in range(n_reads):
            rec = BamRecord(qname=f"m/{i}/ccs", flag=4)
            rec.set_seq(rng.choice(bases, read_len, p=PLANT),
                        qual=np.full(read_len, 40, np.uint8))
            for tag in ("fi", "ri", "fp", "rp"):
                rec.set_tag(tag, "B", ("C", rng.integers(
                    0, 256, read_len).astype(np.uint8)))
            rec.set_tag("fn", "C", 5)
            rec.set_tag("rn", "C", 5)
            w.write(rec)


def cuda_ms(fn, iters=50):
    """Mean device time of `fn` over back-to-back launches (CUDA events;
    a device-side sleep first lets the host enqueue all of them, so host
    launch overhead is not timed)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def gather_plan(rng, n_sites, lo, hi, n_cols, ng_multiple):
    """A real plan from the port's planner for n_sites sorted distinct
    window starts in [lo, hi), 128-aligned as the engine aligns it, padded
    with base-0 groups to a multiple of ng_multiple groups."""
    import numpy as np
    from hifimeth_tpu_torch.ops.gather import (BLOCK_LANES, GROUP,
                                               PLAN_EXTENT, check_plan,
                                               plan_groups)
    starts = np.sort(rng.choice(np.arange(lo, hi), n_sites, replace=False))
    bases, rels, _ = plan_groups(starts.astype(np.int32), GROUP, BLOCK_LANES,
                                 401, n_cols, extent=PLAN_EXTENT)
    b128 = (bases // 128) * 128
    rels = rels + (bases - b128)[:, None]
    pad = -len(b128) % ng_multiple
    b128 = np.concatenate([b128, np.zeros(pad, np.int32)]).astype(np.int32)
    rels = np.concatenate([rels, np.zeros((pad, GROUP), np.int32)])
    check_plan(b128, rels, n_cols, 401)
    return b128, rels.astype(np.int32)


def phase_kernels():
    """Kernel vs plain version (bit-exact) and timings; returns the
    kernel's JSON row without `launches`."""
    import numpy as np
    import torch
    from hifimeth_tpu_torch.ops.gather import (GROUP, group_windows_t,
                                               group_windows_t_plain)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    kmer = 401
    n_cols = 1 << 21                    # the engine's default buffer
    ng = SITE_BATCH // GROUP
    table = torch.from_numpy(
        rng.standard_normal((8, n_cols)).astype(np.float32)).to(dev)
    # main-path shape: 8192 sites at ~0.3 sites/bp ending at the buffer's
    # last window start (clipped bases), plus padded groups
    main = gather_plan(rng, SITE_BATCH - 200, n_cols - 602 - 27000,
                       n_cols - 602, n_cols, ng)
    # spans split by the greedy planner (sparse sites) and a table whose
    # width is not a multiple of 4 (unaligned, bounds-checked staging)
    sparse = gather_plan(rng, 500, 401, n_cols - 602, n_cols, 1)
    odd_cols = 5003
    odd_table = torch.from_numpy(
        rng.standard_normal((8, odd_cols)).astype(np.float32)).to(dev)
    odd = gather_plan(rng, 300, 0, odd_cols - 602, odd_cols, 1)

    max_err = 0.0
    n_checked = 0
    for tab, (b, r) in ((table, main), (table, sparse), (odd_table, odd)):
        bd = torch.from_numpy(b).to(dev)
        rd = torch.from_numpy(r).to(dev)
        for rev in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                got = group_windows_t(tab, bd, rd, rev=rev, kmer=kmer,
                                      out_dtype=dt)
                want = group_windows_t_plain(tab, bd, rd, rev, kmer, dt)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"group_windows_t != plain (rev={rev}, {dt}, "
                        f"{len(b)} groups): max |err| {err}")
                n_checked += 1
    print(f"[kernels] group_windows_t bit-exact vs plain in {n_checked} "
          f"cases (fwd/rev x f32/bf16 x main/split/unaligned plans)")

    b, r = main
    bd, rd = torch.from_numpy(b).to(dev), torch.from_numpy(r).to(dev)
    times = {}
    for rev in (False, True):
        times[rev] = cuda_ms(lambda: group_windows_t(table, bd, rd, rev=rev,
                                                     kmer=kmer))
    plain_ms = cuda_ms(lambda: group_windows_t_plain(
        table, bd, rd, False, kmer, torch.float32), iters=10)
    # library yardstick: one torch.take over precomputed flat indices
    starts = (bd.long()[:, None] + rd).reshape(-1)
    lanes = torch.arange(kmer, device=dev)
    flat = (torch.arange(8, device=dev)[None, :, None] * n_cols
            + starts[:, None, None] + lanes[None, None, :])
    lib = torch.take(table, flat)
    if not torch.equal(lib, group_windows_t_plain(table, bd, rd, False, kmer,
                                                  torch.float32)):
        raise AssertionError("torch.take yardstick disagrees with plain")
    library_ms = cuda_ms(lambda: torch.take(table, flat), iters=10)
    # bytes the function must move: each output once, each table lane the
    # windows cover once (all 8 channels), the plan arrays once
    need = np.zeros(n_cols, bool)
    s_np = (b.astype(np.int64)[:, None] + r).ravel()
    for s in np.unique(s_np):
        need[s:s + kmer] = True
    n_out = len(s_np) * 8 * kmer
    moved = n_out * 4 + int(need.sum()) * 8 * 4 + b.nbytes + r.nbytes
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"[kernels] group_windows_t at {len(s_np)} sites: fwd "
          f"{times[False]:.4f} ms, rev {times[True]:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.take {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({moved} B at 3.35 TB/s)")
    return {"name": "group_windows_t", "route": "cuda",
            "source": "hifimeth_tpu_torch/ops/csrc/group_windows.cu",
            "replaces": "hifimeth_tpu/ops/gather.py:341",
            "max_abs_err": max_err, "ms": times[False],
            "rev_ms": times[True], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def read_tags(path):
    from hifimeth_tpu_torch.io.bam import BamReader
    out = []
    for rec in BamReader(path):
        mm, ml, mn = (rec.get_tag(t) for t in ("MM", "ML", "MN"))
        out.append((rec.qname, mm[1] if mm else None,
                    ml[1][1] if ml else None, mn[1] if mn else None))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: torch.cuda.is_available() is False")
    if not os.path.isdir(os.path.join(ROOT, "hifimeth_tpu_torch")):
        return fail("hifimeth_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    import numpy as np
    from hifimeth_tpu_torch.engine.call import CallConfig, run_call
    from hifimeth_tpu_torch.ops import build, gather

    # -- phase 1: card, versions, builds ---------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    if smi.returncode != 0 or not card:
        return fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(card, flush=True)
    print(f"[versions] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        k_fut = pool.submit(build.kernel_library, "group_windows")
        b_fut = pool.submit(build.bamcore_library)
        kernel_lib, bamcore_lib = k_fut.result(), b_fut.result()
    if bamcore_lib is None:
        return fail("libbamcore did not build")
    print(f"[build] kernel + libbamcore in {time.perf_counter() - t0:.2f} s")
    print("[build] " + "\n[build] ".join(
        l for l in build.build_log(kernel_lib).splitlines() if "ptxas" in l))

    # -- phase 2: kernels against their plain versions -------------------
    row = phase_kernels()

    with tempfile.TemporaryDirectory() as td:
        small, big = os.path.join(td, "small.bam"), os.path.join(td, "big.bam")
        make_bam(small, 4, 4000, seed=1)
        make_bam(big, 200, 15000, seed=0)
        # warm-up + the card side of phase 4 (cuDNN picks its algorithms)
        run_call(small, os.path.join(td, "small.cuda.bam"),
                 CallConfig(device="cuda"))

        # -- phase 3: the main path --------------------------------------
        stats_json = os.path.join(td, "stats.json")
        gather.group_windows_t.launches = 0
        t0 = time.perf_counter()
        stats = run_call(big, os.path.join(td, "big.out.bam"),
                         CallConfig(device="cuda", stats_json=stats_json))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = gather.group_windows_t.launches
        n_sites = sum(stats[c] for c in ("CpG", "CHG", "CHH"))
        with open(stats_json) as f:
            timers = json.load(f)["timers"]
        print(f"[main] {stats['reads']} reads, {stats['bases']} bases, "
              f"{n_sites} sites ({', '.join(f'{c} {stats[c]}' for c in ('CpG', 'CHG', 'CHH'))})"
              f" in {secs:.3f} s = {n_sites / secs:.1f} sites/s; "
              f"group_windows_t launches {launches}")
        print("[main] engine timers (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in timers.items()))
        if launches <= 0:
            return fail("the main path launched group_windows_t no time")
        recs = read_tags(os.path.join(td, "big.out.bam"))
        n_ml = sum(len(ml) for _, _, ml, _ in recs if ml is not None)
        if len(recs) != 200 or any(mm is None for _, mm, _, _ in recs):
            return fail("main path output lacks records or MM tags")
        if n_ml != n_sites:
            return fail(f"ML holds {n_ml} probabilities for {n_sites} sites")

        # -- phase 4: card vs CPU ----------------------------------------
        run_call(small, os.path.join(td, "small.cpu.bam"),
                 CallConfig(device="cpu", site_batch=512))
        a = read_tags(os.path.join(td, "small.cuda.bam"))
        b = read_tags(os.path.join(td, "small.cpu.bam"))
        if [x[0] for x in a] != [x[0] for x in b]:
            return fail("card and CPU records differ in order")
        n_off = n_tot = max_d = 0
        for (q, mm, ml, mn), (_, mm2, ml2, mn2) in zip(a, b):
            if mm != mm2 or mn != mn2 or len(ml) != len(ml2):
                return fail(f"{q}: MM/MN differ between card and CPU")
            d = np.abs(ml.astype(int) - ml2.astype(int))
            max_d = max(max_d, int(d.max()))
            n_off += int((d > 0).sum())
            n_tot += len(d)
        print(f"[cuda-vs-cpu] {len(a)} reads, {n_tot} ML bytes: MM/MN equal, "
              f"{n_off} ML bytes off, max |diff| {max_d}")
        if max_d > 1:
            return fail(f"ML differs by {max_d} > 1 between card and CPU")

    row["launches"] = launches
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
