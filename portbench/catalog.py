"""Where the benchmark finds its parts, by the names in BENCHMARK.json.

- configs/<name>.json: one model configuration (the nets, their
  contexts, the `call` settings that are not the defaults, the limits of
  the check);
- traffic/<name>.json: one traffic mix (inputs.py reads it);
- metrics/<name>.py: one per-layer metric, a module with ``MOVES`` (the
  end-to-end metric it moves) and ``read(run)``, which returns the number
  or None where the run holds nothing to read, and optionally ``ROUTES``,
  the `call` gather routes whose layer it reads (without it, every route):
  a cell lists exactly the metrics that apply to it (`applies`): those of
  its configuration's route that move its leading end-to-end metric.

A later cell, mix or metric is a new file and a new entry; no file here
changes for it.
"""
from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
#: the `call` gather routes (CallConfig.gather_impl, "auto" being "pallas")
ROUTES = ("pallas", "fused", "slice", "folded")


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
    routes = getattr(mod, "ROUTES", ROUTES)
    if not isinstance(routes, tuple) or not routes \
            or not set(routes) <= set(ROUTES):
        raise TypeError(f"{path}: ROUTES must be a non-empty tuple of "
                        f"{', '.join(ROUTES)}")
    return mod


def route(config: dict) -> str:
    """The gather route a configuration runs: its `call.gather_impl`,
    absent or "auto" meaning "pallas", as CallConfig documents."""
    impl = config.get("call", {}).get("gather_impl", "auto")
    impl = "pallas" if impl == "auto" else impl
    if impl not in ROUTES:
        raise ValueError(f"configuration {config.get('name')!r}: unknown "
                         f"gather_impl {impl!r}")
    return impl


def leading(bench: dict, cell: str) -> str:
    """The first end-to-end metric of `bench` that a cell reports, the one
    its per-layer metrics move: sites_per_s where the cell reports it."""
    return next(m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell]))


def applies(bench: dict, cell: str, root: str = ROOT) -> list:
    """The names of the per-layer metrics of `bench` that apply to a cell:
    those whose reader reads a layer its configuration's route runs and
    moves the cell's leading end-to-end metric."""
    r = route(config(workload(bench, cell)["config"], root))
    lead = leading(bench, cell)
    out = []
    for m in bench["per_layer"]:
        mod = metric(m["name"], root)
        if r in getattr(mod, "ROUTES", ROUTES) and mod.MOVES == lead:
            out.append(m["name"])
    return out


def twin(path: str, base: str):
    """(ROUTES, read) of the reader `base` beside the reader file `path`:
    for a metric that reads what `base` reads, in the cells whose leading
    end-to-end metric is another than the one `base` moves."""
    mod = metric(base, os.path.dirname(os.path.dirname(os.path.abspath(
        path))))
    return getattr(mod, "ROUTES", ROUTES), mod.read


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
