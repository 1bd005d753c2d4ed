"""HBN-style observability: timestamped stderr logging, program banner, and
wall-clock + peak-RSS reporting at exit.

Mirrors the reference UX (hbn_aux.cpp:58-115 logging macros;
program_info.cpp:16-25 RAII wall-clock/RSS report; mod_main.cpp:266-301
start-up banner) without copying its implementation.
"""
from __future__ import annotations

import os
import platform
import resource
import sys
import time
from contextlib import contextmanager


def _ts() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S")


def log(msg: str, *args) -> None:
    if args:
        msg = msg % args
    print(f"[{_ts()}] {msg}", file=sys.stderr, flush=True)


def warn(msg: str, *args) -> None:
    if args:
        msg = msg % args
    print(f"[{_ts()}] WARNING: {msg}", file=sys.stderr, flush=True)


def die(msg: str, *args) -> "SystemExit":
    """Log an error and exit 1."""
    if args:
        msg = msg % args
    print(f"[{_ts()}] ERROR: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def peak_rss_bytes() -> int:
    # ru_maxrss is KiB on Linux.
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def bytes_to_datasize(n: float) -> str:
    """Human-size formatting in the reference's style (hbn_aux.cpp:321)."""
    for unit, div in (("GB", 1 << 30), ("MB", 1 << 20), ("KB", 1 << 10)):
        if n >= div:
            return f"{n / div:.2f} {unit}"
    return f"{int(n)} B"


def format_with_commas(n: int) -> str:
    return f"{n:,}"


def program_banner(name: str, version: str, device) -> None:
    import torch

    out = sys.stderr
    print("", file=out)
    print("PROGRAM:", file=out)
    print(f"  Name:                   {name}", file=out)
    print(f"  Version:                {version}", file=out)
    print(f"  PyTorch:                {torch.__version__}", file=out)
    print(f"  CUDA:                   {torch.version.cuda or 'none'}", file=out)
    print("  Description:            5mC methylation toolkit for HiFi reads", file=out)
    print("", file=out)
    print("SYSTEM:", file=out)
    u = platform.uname()
    print(f"  Computer:                {u.node}", file=out)
    print(f"  Name:                    {u.system}", file=out)
    print(f"  Release:                 {u.release}", file=out)
    print(f"  Machine:                 {u.machine}", file=out)
    print(f"  Logical CPU threads:     {os.cpu_count()}", file=out)
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    kb = int(line.split()[1])
                    print(f"  RAM:                     {bytes_to_datasize(kb * 1024)}",
                          file=out)
                    break
    except OSError:
        pass
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"  Device:                  {device} ({kind})", file=out)
    print("", file=out, flush=True)


@contextmanager
def program_info(name: str):
    """Print wall-clock seconds and peak RSS on exit (program_info.cpp:16-25)."""
    t0 = time.time()
    try:
        yield
    finally:
        dur = time.time() - t0
        rss = bytes_to_datasize(peak_rss_bytes())
        print(f"[{name}] wall clock time: {dur:.2f} seconds", file=sys.stderr)
        print(f"[{name}] peak RSS: {rss}", file=sys.stderr, flush=True)
