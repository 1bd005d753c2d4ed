"""The port stands alone: no module of hifimeth_tpu_torch, and neither
chip_smoke.py nor the port's profiling and microbenchmark scripts, imports
jax or the JAX package, and the GPU is never replaced by the CPU behind the
caller's back."""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "hifimeth_tpu_torch")

_IMPORTS_ALL = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path.insert(0, ROOT)
import hifimeth_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hifimeth_tpu_torch.__path__,
                                               "hifimeth_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import microbench_torch_gather
import probe_window_rows
leaked = sorted(m for m in sys.modules
                if m == "hifimeth_tpu" or m.startswith("hifimeth_tpu."))
assert not leaked, leaked
print(len(names))
"""


def test_every_port_module_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _IMPORTS_ALL],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 51


def test_no_jax_import_statement_anywhere():
    """Lazy imports inside functions never run in the subprocess above;
    a source scan catches them."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|hifimeth_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(ROOT, "scripts", f) for f in (
            "profile_torch_call.py", "profile_fused_layers.py",
            "microbench_torch_gather.py", "probe_window_rows.py")]
    for d, dirs, fs in os.walk(PKG):
        dirs[:] = [x for x in dirs if x != "_build"]     # build outputs
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    hits = []
    for path in files:
        with open(path) as f:
            hits += [f"{path}: {m.group(0).strip()}" for m in pat.finditer(f.read())]
    assert not hits, hits


def test_cuda_request_without_gpu_raises(monkeypatch):
    from hifimeth_tpu_torch.device import resolve_device
    from hifimeth_tpu_torch.engine.call import CallConfig, CallEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        CallEngine(CallConfig())
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
