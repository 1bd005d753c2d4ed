#!/usr/bin/env python3
"""One batch of the call path on one GPU: its captured program (a CUDA graph
replay) against the same body launched eagerly.

Builds a CallEngine (shipped models, default site batch of 8192 and buffer
of 2 Mi bases) for --gather-impl pallas or fused and --dtype f32 or bf16,
featurizes seeded random planes into its persistent table, plans 8192
seeded sites of one strand into a batch, and times, with CUDA events over
--iters launches after a warm-up, on the engine's compute stream:
 - graph: the program's replay (BatchProgram.replay);
 - body: the same body launched eagerly into the program's static buffers,
   what CallConfig.graphs=False runs;
 - eager: the per-batch call with fresh allocations each call
   (call_sites_group / call_sites_fused without `out`);
 - graph (own pool): the body captured anew with torch.cuda.graph's
   defaults (its own stream and pool);
 - all graphs / all eager: the engine's six programs (three contexts, two
   strands) replayed one after another, as a flush does, against their
   bodies' eager calls (one launch of each counts as one batch);
in turns (graph, body, eager, own pool, then in reverse order), each
variant's outputs byte-equal to the graph's.  Beside each time: the SM and
memory clocks and power draw nvidia-smi read while it ran (sampled every
50 ms), and the device ms by kernel class of one more round under
torch.profiler (scripts/profile_torch_call.py's device_profile).

Usage (on a machine with a CUDA device):
    python3 scripts/probe_graph_replay.py [--gather-impl pallas|fused]
        [--dtype f32|bf16] [--iters N]
"""
import argparse
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


class ClockSampler:
    """nvidia-smi's SM clock, memory clock and power draw, every 50 ms, in
    a thread, while the block runs."""

    def __enter__(self):
        self.rows = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.strip()
            try:
                self.rows.append([float(v) for v in out.split(",")])
            except ValueError:
                pass
            self._stop.wait(0.05)

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()

    def summary(self) -> str:
        if not self.rows:
            return "no clock samples"
        cols = list(zip(*self.rows))
        return (f"SM clock {min(cols[0]):.0f}-{max(cols[0]):.0f} MHz, memory "
                f"{min(cols[1]):.0f}-{max(cols[1]):.0f} MHz, power "
                f"{min(cols[2]):.1f}-{max(cols[2]):.1f} W "
                f"({len(self.rows)} samples)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gather-impl", default="pallas",
                    choices=("pallas", "fused"))
    ap.add_argument("--dtype", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_graph_replay: no CUDA device", file=sys.stderr)
        return 1
    from profile_torch_call import device_profile

    from hifimeth_tpu_torch.engine.call import CallConfig, CallEngine
    from hifimeth_tpu_torch.engine.programs import plan_views
    from hifimeth_tpu_torch.features.windows import (call_sites_group,
                                                     featurize_planes_t_seg)
    from hifimeth_tpu_torch.ops.fused import call_sites_fused
    from hifimeth_tpu_torch.ops.gather import (BLOCK_LANES, GROUP,
                                               PLAN_EXTENT, check_plan,
                                               plan_groups)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    eng = CallEngine(CallConfig(device="cuda", gather_impl=args.gather_impl,
                                compute_dtype={"f32": "float32",
                                               "bf16": "bfloat16"}[
                                                   args.dtype]))
    cap, sb = eng.cfg.buffer_bases, eng.cfg.site_batch
    ngrp = sb // GROUP
    rng = np.random.default_rng(0)
    planes = np.zeros((5, cap), np.uint8)
    planes[0] = rng.integers(0, 4, cap)
    planes[1:] = rng.integers(0, 256, (4, cap))
    dev = eng.device
    stream = eng._computes[0]
    starts = np.sort(rng.choice(np.arange(eng.kmer, cap - 2 * eng.kmer),
                                sb, replace=False)).astype(np.int32)
    bases, rels, _ = plan_groups(starts, GROUP, BLOCK_LANES, eng.kmer, cap,
                                 extent=PLAN_EXTENT)
    b128 = (bases // 128) * 128
    rels = rels + (bases - b128)[:, None]
    check_plan(b128, rels, cap, eng.kmer)
    b128, rels = b128[:ngrp], rels[:ngrp]
    plan = torch.from_numpy(np.concatenate(
        [rels.reshape(-1), b128]).astype(np.int32)).to(dev)
    prog = eng._programs[0][("CpG", False)]
    with torch.inference_mode(), torch.cuda.stream(stream):
        featurize_planes_t_seg([torch.from_numpy(planes).to(dev)], cap,
                               out=eng._tables[0])
        prog.plan.copy_(plan)
        table = eng._tables[0]
        if args.gather_impl == "fused":
            weights = eng.models.fused["CpG"]

            def eager():
                return call_sites_fused(weights, table,
                                        *plan_views(prog.plan, ngrp), False)
        else:
            model = eng.models.models["CpG"]

            def eager():
                return call_sites_group(model, table,
                                        *plan_views(prog.plan, ngrp), False,
                                        eng.kmer)
        own = torch.cuda.CUDAGraph()
        own_out = torch.empty_like(prog.out)
        prog._body(prog.plan, own_out)
        stream.synchronize()
        with torch.cuda.graph(own):
            prog._body(prog.plan, own_out)
        outs = {}
        progs = list(eng._programs[0].items())
        bodies = []
        for (ctx, rev), p in progs:
            p.plan.copy_(plan)
            if args.gather_impl == "fused":
                w = eng.models.fused[ctx]
                bodies.append(lambda w=w, rev=rev: call_sites_fused(
                    w, table, *plan_views(plan, ngrp), rev))
            else:
                m = eng.models.models[ctx]
                bodies.append(lambda m=m, rev=rev: call_sites_group(
                    m, table, *plan_views(plan, ngrp), rev, eng.kmer))

        def all_graphs():
            for _, p in progs:
                p.replay()

        def all_eager():
            outs["all"] = [b() for b in bodies]

        variants = {
            "graph": lambda: prog.replay(),
            "body": lambda: prog._body(prog.plan, prog.out),
            "eager": lambda: outs.__setitem__("eager", eager()),
            "graph (own pool)": lambda: own.replay(),
            "all graphs": all_graphs,
            "all eager": all_eager,
        }
        ref = ref_all = None
        times: dict = {}
        for name in list(variants) + list(variants)[::-1]:
            fn = variants[name]
            for _ in range(3):
                fn()
            stream.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            with ClockSampler() as clocks:
                a.record(stream)
                for _ in range(args.iters):
                    fn()
                b.record(stream)
                b.synchronize()
            n = len(progs) if name.startswith("all") else 1
            ms = a.elapsed_time(b) / args.iters / n
            if name == "all graphs":
                got = torch.cat([p.out for _, p in progs]).cpu()
                ref_all = got if ref_all is None else ref_all
            elif name == "all eager":
                got = torch.cat(outs["all"]).cpu()
            else:
                got = {"graph": prog.out, "body": prog.out,
                       "eager": outs.get("eager"),
                       "graph (own pool)": own_out}[name].cpu()
            want = ref_all if name.startswith("all") else ref
            if want is None:
                ref = got
            elif not torch.equal(got, want):
                raise AssertionError(f"{name}: output differs from the "
                                     f"graph's")
            times.setdefault(name, []).append(ms)
            print(f"[{name}] {ms:.4f} ms a batch of {sb} sites; "
                  f"{clocks.summary()}", flush=True)
        for name, fn in variants.items():
            n = args.iters * (len(progs) if name.startswith("all") else 1)
            prof = device_profile(lambda: [fn() for _ in range(args.iters)])
            print(f"[{name} profiled] device ms a batch by class: " + ", ".join(
                f"{c} {ms / n:.4f}" for c, ms in sorted(
                    prof["ms_by_class"].items(), key=lambda kv: -kv[1])))
    print("[summary] ms a batch, two turns each: " + "; ".join(
        f"{k} {v[0]:.4f}/{v[1]:.4f}" for k, v in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
