"""Where the benchmark finds its parts, by the names in BENCHMARK.json.

- configs/<name>.json: one model configuration (the nets, their
  contexts, the `call` settings that are not the defaults, the limits of
  the check);
- traffic/<name>.json: one traffic mix (inputs.py reads it);
- metrics/<name>.py: one per-layer metric, a module with ``MOVES`` (the
  end-to-end metric it moves) and ``read(run)``, which returns the number
  or None where the run holds nothing to read.

A later cell, mix or metric is a new file and a new entry; no file here
changes for it.
"""
from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)


def set_cache_dirs() -> None:
    """Point every kernel cache of torch and the program at fixed
    directories inside the checkout (call before torch is imported).
    The program's own kernel libraries build into its fixed
    hifimeth_tpu_torch/_build/."""
    cache = os.path.join(ROOT, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"


def load_benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   + ", ".join(w["name"] for w in bench["workloads"]))


def _json(kind: str, name: str, root: str) -> dict:
    path = os.path.join(root, kind, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    with open(path) as f:
        return json.load(f)


def config(name: str, root: str = ROOT) -> dict:
    return _json("configs", name, root)


def traffic(name: str, root: str = ROOT) -> dict:
    return _json("traffic", name, root)


def metric(name: str, root: str = ROOT):
    """The reader module of per-layer metric `name`."""
    path = os.path.join(root, "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"metric {name!r}: no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)) or \
            not isinstance(getattr(mod, "MOVES", None), str):
        raise TypeError(f"{path} must define MOVES and read(run)")
    return mod


def discover(root: str = ROOT) -> dict:
    """The names of every configuration, traffic mix and metric reader
    under `root`."""
    def names(kind, ext):
        d = os.path.join(root, kind)
        return sorted(f[:-len(ext)] for f in os.listdir(d)
                      if f.endswith(ext) and not f.startswith("_"))
    return {"configs": names("configs", ".json"),
            "traffic": names("traffic", ".json"),
            "metrics": names("metrics", ".py")}


def per_layer(bench: dict, cell: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in e2e]
