"""Build the port's native code from the repository's sources at first use.

Two shared libraries, both compiled into `hifimeth_tpu_torch/_build/`
(git-ignored) and named by a hash of source and command, so an edited
source rebuilds and an unchanged one is reused:

- the CUDA kernels (ops/csrc/*.cu): `nvcc` for sm_90a into a library with a
  plain C interface, loaded with ctypes by the kernel wrappers.  No PyTorch
  headers are compiled, which keeps a build to seconds;
- the host I/O core (src/native/bamcore.cpp): `g++ ... -lz`, loaded by
  io/native.py, which falls back to numpy when this build is not possible.

Concurrent first uses (test workers, processes) serialise on a file lock and
publish each library with an atomic rename.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess

from ..utils.logging import log, warn

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "ops", "csrc")
BAMCORE_SRC = os.path.join(os.path.dirname(PKG_DIR), "src", "native",
                           "bamcore.cpp")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-shared"]


class BuildError(RuntimeError):
    pass


def _build(src: str, name: str, compiler: str, flags: list[str],
           libs: list[str]) -> str:
    """Compile `src` into BUILD_DIR/lib<name>-<hash>.so unless it exists;
    returns the library path.  The compiler's output (for nvcc, the ptxas
    register and shared-memory report) lands beside it as <same>.log."""
    with open(src, "rb") as f:
        key = f.read() + " ".join(flags + libs).encode()
    out = os.path.join(BUILD_DIR,
                       f"lib{name}-{hashlib.sha256(key).hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [compiler, *flags, "-o", tmp, src, *libs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        with open(out[:-3] + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + r.stdout + r.stderr)
        if r.returncode != 0:
            raise BuildError(f"{' '.join(cmd)} failed:\n{r.stderr[-4000:]}")
        os.replace(tmp, out)
    log("built %s", out)
    return out


def build_log(lib_path: str) -> str:
    """Compiler output recorded when `lib_path` was built ("" if none)."""
    try:
        with open(lib_path[:-3] + ".log") as f:
            return f.read()
    except OSError:
        return ""


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc as PyTorch resolves it."""
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found: install the CUDA toolkit or set "
                         "CUDA_HOME")
    return found


def kernel_library(name: str) -> str:
    """Build ops/csrc/<name>.cu for sm_90a; raises BuildError on failure."""
    return cuda_library(os.path.join(CSRC_DIR, f"{name}.cu"), name)


def cuda_library(src: str, name: str) -> str:
    """Build the CUDA source `src` for sm_90a into BUILD_DIR as lib<name>;
    raises BuildError on failure."""
    return _build(src, name, nvcc_path(), NVCC_FLAGS, [])


def bamcore_library() -> str | None:
    """Build the host I/O core; None (numpy fallbacks) if that fails."""
    if not os.path.exists(BAMCORE_SRC):
        return None
    gxx = shutil.which("g++")
    if gxx is None:
        warn("g++ not found; host I/O runs on numpy fallbacks")
        return None
    try:
        return _build(BAMCORE_SRC, "bamcore", gxx, GXX_FLAGS, ["-lz"])
    except BuildError as e:
        warn("%s; host I/O runs on numpy fallbacks", e)
        return None
