#!/usr/bin/env python3
"""What bounds window_rows' TMA route on one GPU.

Prints, with the card's name and power limit first:
 - the DRAM-granularity probe (scripts/read_rows_probe.cu): device time to
   read every 32-byte row of a 256 MB table against every other row; about
   half the time if the DRAM moves 32-byte sectors, about the same if it
   moves 64-byte bursts;
 - window_rows at the window-fetch microbenchmark's shape (16384 sites, two
   (4 Mi, 8) float32 tables, fetch_rows 802, out_rows 401, random strands)
   for three kinds of starts: random (chip_smoke.py's case), the same
   starts in position order (as a per-site caller walks a read), and
   random within the first 64 Ki rows (every window in L2).  For each, the
   whole call's device time (CUDA events, as chip_smoke.py times it) and,
   under torch.profiler, the device time of each of its two kernels: the
   site-order pass and the TMA copy.  Each kind is first checked bit-exact
   against window_rows_plain.

Usage (on a machine with a CUDA device):
    python3 scripts/probe_window_rows.py
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROBE_SRC = os.path.join(ROOT, "scripts", "read_rows_probe.cu")
#: window_rows' TMA route's two kernels, by a part of their names
TMA_KERNELS = {"order pass": "site_order_kernel",
               "TMA copy": "window_rows_tma_kernel"}


def build() -> str:
    """Build read_rows_probe.cu (once; later calls reuse the library)."""
    from hifimeth_tpu_torch.ops.build import cuda_library
    return cuda_library(PROBE_SRC, "read_rows_probe")


def dram_probe(dev) -> tuple[float, float]:
    """Print and return the device ms to read every 32-byte row of a 256 MB
    table and every other row."""
    import torch
    from chip_smoke import cuda_ms
    fn = ctypes.CDLL(build()).hm_read_rows_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = (256 << 20) // 32
    table = torch.randn((n, 8), device=dev)
    blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * 8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = {}
    for step in (1, 2):
        def run():
            err = fn(table.data_ptr(), n // step, step, blocks,
                     out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"read_rows_probe: CUDA error {err}")
        run()
        want = table[::step].double().sum().item()
        if abs(out.double().sum().item() - want) > 1.0:
            raise AssertionError(f"read_rows_probe step {step} read wrong "
                                 f"rows: {out.double().sum().item()} != "
                                 f"{want}")
        times[step] = cuda_ms(run)
    asked = n * 32
    print(f"[dram probe] 256 MB table of 32-byte rows: every row "
          f"{times[1]:.4f} ms ({asked / times[1] / 1e6:.1f} GB/s), every "
          f"other row {times[2]:.4f} ms ({asked / 2 / times[2] / 1e6:.1f} "
          f"GB/s of the bytes read); ratio {times[2] / times[1]:.3f} (0.5: "
          f"32-byte access, 1.0: 64-byte bursts)")
    return times[1], times[2]


def kernel_ms(fn, iters=20) -> dict:
    """Mean device ms per call of `fn` of each of TMA_KERNELS, from
    torch.profiler over `iters` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    got = dict.fromkeys(TMA_KERNELS, 0.0)
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for label, part in TMA_KERNELS.items():
            if part in ev.name:
                got[label] += ev.time_range.elapsed_us() / 1e3 / iters
    return got


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_window_rows: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import MICRO_ROWS, MICRO_SITES, cuda_ms
    from hifimeth_tpu_torch.ops.gather import (window_rows, window_rows_plain,
                                               window_rows_route)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    dram_probe(dev)

    kmer, fetch, n, b = 401, 802, MICRO_ROWS, MICRO_SITES
    rng = np.random.default_rng(0)
    d, dr = (torch.from_numpy(rng.standard_normal((n, 8), dtype=np.float32))
             .to(dev) for _ in range(2))
    starts = rng.integers(0, n - fetch + 1, b).astype(np.int32)
    is_rev = rng.integers(0, 2, b).astype(np.int32)
    order = np.argsort(starts, kind="stable")
    kinds = {"random": (starts, is_rev),
             "position-sorted": (starts[order], is_rev[order]),
             "in L2": (rng.integers(0, 1 << 16, b).astype(np.int32), is_rev)}
    for kind, (s, r) in kinds.items():
        s, r = torch.from_numpy(s).to(dev), torch.from_numpy(r).to(dev)
        got = window_rows(d, dr, s, r, fetch, kmer)
        if not torch.equal(got, window_rows_plain(d, dr, s, r, fetch, kmer)):
            raise AssertionError(f"window_rows ({kind}) differs from plain")
        route = window_rows_route(8, kmer, d.data_ptr(), dr.data_ptr(),
                                  got.data_ptr())
        if route != "tma":
            raise AssertionError(f"window_rows ({kind}) took the {route} "
                                 f"route, not tma")
        call = cuda_ms(lambda: window_rows(d, dr, s, r, fetch, kmer))
        parts = kernel_ms(lambda: window_rows(d, dr, s, r, fetch, kmer))
        print(f"[window_rows {kind}] {b} sites: call {call:.4f} ms; "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
