"""System introspection: physical core count, parameter dump, the
environment of spawned worker processes.

Replicates the reference's thread-count default semantics
(get_core_count.cpp:21-121: count distinct (physical id, core id) pairs in
/proc/cpuinfo, i.e. real cores without SMT siblings; mod_options.cpp:120-132
defaults worker threads to that count).  Falls back to os.cpu_count() when
/proc/cpuinfo is unavailable (non-Linux) or unparsable.
"""
from __future__ import annotations

import os
import sys
from contextlib import contextmanager


def physical_core_count() -> int:
    """Distinct (physical id, core id) pairs from /proc/cpuinfo, or
    os.cpu_count() as fallback.  Always >= 1."""
    try:
        pairs = set()
        phys = core = None
        with open("/proc/cpuinfo") as f:
            for line in f:
                if ":" not in line:
                    phys = core = None
                    continue
                key, _, val = line.partition(":")
                key = key.strip()
                if key == "physical id":
                    phys = val.strip()
                elif key == "core id":
                    core = val.strip()
                if phys is not None and core is not None:
                    pairs.add((phys, core))
                    phys = core = None
        if pairs:
            return len(pairs)
    except OSError:
        pass
    return max(os.cpu_count() or 1, 1)


def dump_parameters(title: str, params: dict) -> None:
    """Reference-style startup parameter block (mod_options.cpp:185-198)."""
    print("", file=sys.stderr)
    print("######## Parameters:", file=sys.stderr)
    for k, v in params.items():
        print(f"  {k}: {v}", file=sys.stderr)
    print("", file=sys.stderr, flush=True)


@contextmanager
def worker_spawn_env():
    """The environment for spawning numpy-only worker processes (pileup's
    pool): the cards are hidden from them (CUDA_VISIBLE_DEVICES empty), so
    a worker never creates a CUDA context, whatever the parent holds.
    Spawned children snapshot os.environ at exec, so the variable is set
    around the pool's construction and the parent's value restored after."""
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        yield
    finally:
        if saved is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
