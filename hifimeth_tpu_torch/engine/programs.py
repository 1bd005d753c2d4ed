"""Captured per-batch call programs: the JAX engine's compiled dispatch unit
on the card.

The JAX engine calls the device once per bucket chunk through a compiled
program that it caches per static shape (hifimeth_tpu/engine/call.py: "one
dispatch per bucket chunk; each reuses a cached program"; call_sites_pallas,
call_sites_fused, call_sites_batched and call_sites_grid are `jax.jit` +
`lax.map` over the chunk's batches).  The port's counterpart is a CUDA
graph per batch: a `BatchProgram` holds one batch's body for one (replica,
context, strand, path, compute dtype, convolution route) with static
buffers, so that a batch costs its dispatch thread three enqueues (plan
in, replay, result out) where the body itself is some twenty-five (the
gather, eight convolution kernels with bias and ReLU inside and bn0 in the
first, two linears and the u8 conversion) on the pallas path, and some
thirty-five on slice and folded (the indexing gather, its read-bounds
mask and strand turn, then the same).

 - The plan: one int32 buffer.  On the planned paths (pallas, fused) it
   holds ngrp * GROUP + ngrp entries, the rels (ngrp, GROUP) first and
   the bases (ngrp,) after them, both contiguous views of it
   (`plan_views`); rels lead so that each view starts on a 128-byte
   boundary.  On slice and folded it holds a batch's n sites as four
   (n,) arrays, centers, strands, rstart and rend (`site_views`).  A
   batch is one copy of its plan row into it.
 - The output: (n,) u8 for the batch's n sites, allocated outside the
   capture; the body writes its probabilities into it.
 - On the card (given a `GraphPool`) the body is captured on the pool's
   stream as a `torch.cuda.CUDAGraph` into the pool's memory, after one
   eager warm-up run there (the kernels load and set their shared-memory
   attributes, cuBLAS sets up its handle) unless the caller already
   warmed a program of the same geometry (`warm=False`); replay()
   launches the graph on the current stream.  A capture or a replay that
   fails raises: nothing reruns the batch eagerly.
 - Without a pool (on the CPU, or on the card with CallConfig.graphs off)
   the same static buffers and copies are used and replay() runs the
   body: every op of the batch is launched eagerly.

Launch accounting: each kernel wrapper counts its launches in `.launches`
(ops/gather.py, ops/fused.py, ops/conv.py): the batches a run computed
(the convolution kernel: their layers).  The capture launches nothing
and its counts are taken back out; each replay of a graph
adds what the captured body launched.  The warm-ups do launch their
kernels: their launches go to `warmup_launches` instead, so that a
profile of a run holds `.launches` + `warmup_launches` kernels of each.
"""
from __future__ import annotations

import contextlib

import torch

from ..ops import conv, fused, gather
from ..ops.gather import GROUP


#: {kernel wrapper: launches} of the warm-ups before captures since the
#: last clear (chip_smoke.py clears it with the wrappers' counts)
warmup_launches: dict = {}


def kernel_wrappers() -> tuple:
    """Every kernel wrapper of the port that counts its launches."""
    return (gather.group_windows_t, fused.fused_forward, conv.conv1d_relu,
            gather.group_windows, gather.window_slices, gather.window_rows)


@contextlib.contextmanager
def held_launches(counters):
    """Take the launches counted inside the block back out of `counters`
    (functions with a `.launches` count) on exit; yields a dict filled on
    exit with {counter: launches made inside}, nonzero entries only."""
    before = {f: f.launches for f in counters}
    made: dict = {}
    try:
        yield made
    finally:
        for f in counters:
            n = f.launches - before[f]
            if n:
                f.launches -= n
                made[f] = n


def plan_views(plan: torch.Tensor, ngrp: int):
    """A batch's (ngrp * GROUP + ngrp,) int32 plan -> (bases (ngrp,), rels
    (ngrp, GROUP)), contiguous views of it."""
    return plan[ngrp * GROUP:], plan[:ngrp * GROUP].view(ngrp, GROUP)


def site_views(plan: torch.Tensor, n: int):
    """A slice/folded batch's (4 * n,) int32 plan -> its n sites' (centers,
    strands, rstart, rend), contiguous (n,) views of it."""
    return plan.view(4, n).unbind(0)


class GraphPool:
    """A graph memory pool of one device and the one side stream its graphs
    are warmed up and captured on: graphs captured into one pool share its
    memory (each takes the blocks the one before it freed) only when they
    are captured on one stream.  Graphs of one pool must not run at once,
    so each replica (device entry of an engine) has its own."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)


def _record(body, plan: torch.Tensor, out: torch.Tensor, pool: GraphPool,
            counters, warm: bool) -> torch.cuda.CUDAGraph:
    """Warm `body` up on the pool's stream when `warm` (its launches moved
    from `counters` to `warmup_launches`), then capture it there into a
    graph of the pool.  The warm-up runs on after this returns (the
    capture records new work only, so it need not wait for it)."""
    with torch.cuda.device(pool.device):
        side = pool.stream
        side.wait_stream(torch.cuda.current_stream(pool.device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            if warm:
                with held_launches(counters) as made:
                    body(plan, out)
                for f, n in made.items():
                    warmup_launches[f] = warmup_launches.get(f, 0) + n
            graph.capture_begin(pool=pool.handle)
            try:
                body(plan, out)
            except BaseException:
                # end the capture so the stream is usable; the body's
                # error is the one raised
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
    return graph


class BatchProgram:
    """One batch's body with static plan and output buffers, captured as a
    CUDA graph into `pool` when one is given (see the module notes).

    body(plan, out): computes the batch of `plan` ((n_plan,) int32) into
    `out` ((n_out,) u8), both on `device`; on the card it must launch only
    work that a graph can hold (no host synchronisation, no allocation that
    outlives it).  `pool`: the GraphPool to capture into (on the card), or
    None to run the body at each replay; the warm-up may still run on the
    pool's stream when the constructor returns, so synchronise the device
    before the first replay (CallEngine does, once for all its programs).
    `counters`: the kernel wrappers whose launches the program accounts
    for.  `warm=False` skips the warm-up: a program of the same geometry
    (layer shapes, dtypes, kernel variants) was warmed on this device."""

    def __init__(self, body, n_plan: int, n_out: int, device, *,
                 pool: GraphPool | None = None, counters=None,
                 warm: bool = True):
        self._body = body
        self.plan = torch.zeros(n_plan, dtype=torch.int32, device=device)
        self.out = torch.zeros(n_out, dtype=torch.uint8, device=device)
        self.graph = None
        #: {counter: launches} one replay adds
        self.launches: dict = {}
        if pool is not None:
            counters = kernel_wrappers() if counters is None else counters
            with held_launches(counters) as made:
                self.graph = _record(body, self.plan, self.out, pool,
                                     counters, warm)
            self.launches = made

    def replay(self) -> None:
        """Run the body over the static plan into the static output, on the
        current stream."""
        if self.graph is None:
            self._body(self.plan, self.out)
            return
        self.graph.replay()
        for f, n in self.launches.items():
            f.launches += n

    def __call__(self, plan: torch.Tensor, out: torch.Tensor) -> None:
        """One batch: `plan` into the static plan, replay, the static
        output into `out` (each on the current stream)."""
        self.plan.copy_(plan, non_blocking=True)
        self.replay()
        out.copy_(self.out, non_blocking=True)
