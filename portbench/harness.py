"""One cell of the port's benchmark: set-up, the timed window through the
program's `call`, and the check of what the window wrote.

The window drives `hifimeth_tpu_torch.engine.call.run_call` unchanged,
with the `call` defaults apart from the configuration's contexts and
`call` settings: its input is a PoolStream (inputs.py) that serves the
seeded pool's records round after round for `seconds`, then ends the BGZF
stream, so run_call drains and returns as at the end of a file.  The rate
is every site written over the time from run_call's start to its return,
the engine's build, graph capture and final drain included.

Set-up (`setup_s`, from the process's start): torch and the program
loaded, the pool made and encoded, the kernel libraries built or found in
the program's build directory, and one warm-up run_call over a few of the
pool's reads, so the shipped weights are loaded (ModelSet.cached) and the
first calls of each library are made before the window.

With trace on, the window runs under torch.profiler (device activity
only) with the engine's per-flush stamps (CallConfig.trace) and timers
(CallConfig.stats_json), and the cell's per-layer metrics are read from
them by their readers in metrics/.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from . import catalog, check, devtrace, inputs, roofline
from .reference import hifimeth as reference

#: top-level module names that may not be loaded where the result is made
FORBIDDEN = ("jax", "jaxlib", "flax", "hifimeth_tpu")
#: reads of the pool in the warm-up run_call
WARM_READS = 8


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in mods} & set(FORBIDDEN))


def models_dir() -> str:
    return os.path.join(catalog.REPO, "models")


def check_weights(config: dict) -> None:
    """The shipped model files must be the ones the configuration names."""
    for ctx, want in config["models"].items():
        path = os.path.join(models_dir(), f"{ctx}.npz")
        with open(path, "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != want:
            raise RuntimeError(f"{path}: sha256 {got}, the configuration "
                               f"{config['name']} names {want}")


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


@contextlib.contextmanager
def engine_stamps(sink: list):
    """Collect the engine's per-flush stamps ((flush, stage, host time),
    CallConfig.trace) as run_call prints them at its end."""
    from hifimeth_tpu_torch.engine import call as callmod
    orig = callmod.CallEngine.log_timers

    def log_timers(self):
        sink.extend(getattr(self, "_trace_events", ()))
        return orig(self)

    callmod.CallEngine.log_timers = log_timers
    try:
        yield
    finally:
        callmod.CallEngine.log_timers = orig


class Cell:
    """A workload of BENCHMARK.json with its configuration and traffic."""

    def __init__(self, bench: dict, name: str, root: str = catalog.ROOT):
        self.bench = bench
        self.work = catalog.workload(bench, name)
        self.name = name
        self.config = catalog.config(self.work["config"], root)
        self.traffic = catalog.traffic(self.work["traffic"], root)
        self.chips = int(self.work["chips"])
        self.root = root

    def call_config(self, device: str, overrides: dict | None = None,
                    **extra):
        from hifimeth_tpu_torch.engine.call import CallConfig
        kw = dict(self.config.get("call", {}))
        kw.update(overrides or {})
        kw.update(extra)
        return CallConfig(contexts=tuple(self.config["contexts"]),
                          device=device, **kw)

    def devices(self, device: str, devices=None):
        """The device list of a data-parallel configuration (every card the
        cell asks for), else None (the engine's one device)."""
        if not self.config.get("call", {}).get("data_parallel"):
            return None
        if devices is not None:
            return list(devices)
        return [f"cuda:{i}" for i in range(self.chips)]


def _sync(devs):
    import torch
    for d in devs:
        torch.cuda.synchronize(d)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", devices=None,
             overrides: dict | None = None, traffic: dict | None = None,
             limit: int | None = None, log=print):
    """Run one cell; returns (result dict, [(name, value, limit)]).

    `devices`, `overrides` (CallConfig fields), `traffic` (a traffic dict
    in place of the cell's) and `limit` (records the window serves at
    most) are for the CPU tests, which run the cell at a small size."""
    import torch
    from hifimeth_tpu_torch.engine.call import run_call

    check_weights(cell.config)
    traffic = traffic or cell.traffic
    dev_list = cell.devices(device, devices)
    cuda = device == "cuda"
    cards = ([torch.device(d) for d in dev_list] if dev_list and cuda
             else [torch.device("cuda:0")] if cuda else [])
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        marks = [("imports_and_cuda", time.perf_counter())]
        pool = inputs.make_pool(traffic, seed)
        marks.append(("pool", time.perf_counter()))
        blocks = inputs.encode_pool(pool)
        marks.append(("encode", time.perf_counter()))
        warm = inputs.PoolStream(blocks, limit=min(WARM_READS,
                                                   pool.n_reads))
        run_call(warm, os.path.join(work, "warm.bam"),
                 cell.call_config(device, overrides), devices=dev_list)
        if cuda:
            _sync(cards)
        marks.append(("warm_call", time.perf_counter()))
        setup_s = marks[-1][1] - t_start
        log("[portbench] setup split: " + ", ".join(
            f"{name} {t - t_prev:.4f} s" for (name, t), t_prev in
            zip(marks, [t_start] + [t for _, t in marks])))

        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            for d in cards:
                torch.cuda.reset_peak_memory_stats(d)
        stats_path = os.path.join(work, "stats.json")
        out_path = os.path.join(work, "out.bam")
        cfg = cell.call_config(device, overrides, trace=trace,
                               stats_json=stats_path if trace else "")
        stream = inputs.PoolStream(blocks, limit=limit)
        stamps: list = []
        prof = None
        with contextlib.ExitStack() as st:
            if trace:
                st.enter_context(engine_stamps(stamps))
                if cuda:
                    from torch.profiler import ProfilerActivity, profile
                    prof = st.enter_context(
                        profile(activities=[ProfilerActivity.CUDA]))
                    t_mark0 = devtrace.marker(cards)
            t0, cpu0 = time.perf_counter(), time.process_time()
            stream.start(seconds)
            stats = run_call(stream, out_path, cfg, devices=dev_list)
            if cuda:
                _sync(cards)
            t1, cpu1 = time.perf_counter(), time.process_time()
            if prof is not None:
                t_mark1 = devtrace.marker(cards)
        window_s = t1 - t0
        peak = (max(torch.cuda.max_memory_reserved(d) for d in cards)
                if cuda else 0)
        sites = {c: int(stats[c]) for c in cell.config["contexts"]}
        n_sites = sum(sites.values())
        run = {"sites": sites, "n_sites": n_sites,
               "bases": int(stats["bases"]), "window_s": window_s,
               "cards": max(1, len(cards)), "timers": None, "trace": None,
               "flops": roofline.model_flops(
                   sites, cell.config["flops_per_site"]),
               "gather_bytes": roofline.gather_bytes(n_sites,
                                                     int(stats["bases"]))}
        if trace:
            with open(stats_path) as f:
                run["timers"] = json.load(f)["timers"]
            if prof is not None:
                run["trace"] = devtrace.from_profiler(prof, t_mark0, t_mark1,
                                                      t0, t1, stamps)
        log(f"[portbench] {cell.name} seed {seed}: {stream.served} reads, "
            f"{n_sites} sites ({sites}) in {window_s:.4f} s, setup "
            f"{setup_s:.4f} s, peak reserved {peak / 2**20:.1f} MiB, "
            f"process CPU in the window {cpu1 - cpu0:.4f} s")
        metrics = window_metrics(cell, run, setup_s, peak, trace)
        prof = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        expected = reference.call_pool(
            pool.seq, pool.kin, pool.offsets, cell.config["contexts"],
            models_dir(), device=str(cards[0]) if cuda else "cpu")
        records = check.read_records(out_path)
        verdict = check.compare(records, stream.served, pool.name, expected,
                                cell.config["check"])
    finally:
        shutil.rmtree(work, ignore_errors=True)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(cards[0]) if cuda else "cpu",
           "count": len(cards), "memory_peak_bytes": int(peak)}
    result = {"correct": verdict["correct"], "attempted": stream.served,
              "failed": verdict["failed"], "metrics": metrics,
              "device": dev}
    if trace and run["trace"] is not None:
        busy = run["trace"].busy_s()
        dev["busy_s"] = sum(busy.values()) / len(busy)
        dev["window_s"] = window_s
        result["breakdown"] = devtrace.breakdown(run["trace"])
    numbers = [(k, v, lim) for k, (v, lim) in verdict["numbers"].items()]
    result["check"] = {k: {"value": v, "limit": lim} for k, v, lim in numbers}
    return result, numbers


def window_metrics(cell: Cell, run: dict, setup_s: float, peak: int,
                   trace: bool) -> dict:
    """The end-to-end metrics of a plain run, or the per-layer metrics of
    a traced one, each {"value", "unit"}; a reader that finds nothing to
    read leaves its metric out."""
    if not trace:
        values = {"sites_per_s": run["n_sites"] / run["window_s"],
                  "peak_device_mib": peak / 2**20, "setup_s": setup_s}
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in cell.bench["end_to_end"]
                if cell.name in m.get("workloads", [cell.name])}
    out = {}
    for m in catalog.per_layer(cell.bench, cell.name):
        v = catalog.metric(m["name"], cell.root).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
