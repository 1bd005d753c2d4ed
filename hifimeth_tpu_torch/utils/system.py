"""System introspection: physical core count, parameter dump.

Replicates the reference's thread-count default semantics
(get_core_count.cpp:21-121: count distinct (physical id, core id) pairs in
/proc/cpuinfo, i.e. real cores without SMT siblings; mod_options.cpp:120-132
defaults worker threads to that count).  Falls back to os.cpu_count() when
/proc/cpuinfo is unavailable (non-Linux) or unparsable.
"""
from __future__ import annotations

import os
import sys


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
