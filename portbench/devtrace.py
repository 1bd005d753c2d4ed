"""The device's side of a traced run, read from torch.profiler.

The traced window runs under `torch.profiler.profile` with device activity
only (the host pays no per-op tracing).  Two marker kernels, launched on an
idle card with the host clock read just before each, are the first and
last device events; they map the profiler's clock onto the host's
(`time.perf_counter`), so device intervals can be set against the
pipeline's own stamps.

Busy time is the union of a card's kernel and copy intervals (a copy that
overlaps a kernel counts once), the idle share 1 - busy / window per card;
the same arithmetic as the program's scripts/profile_torch_call.py
`device_profile`, copied here so that the yardstick does not move with
the program.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


def kernel_class(name: str) -> str:
    """A device event's class by its kernel name."""
    n = name.lower()
    if "group_windows" in n:
        return "gather kernel"
    if "fused_forward" in n or "::fused_" in n:
        return "fused kernel"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset"
    if "conv" in n or "xmma_fprop" in n or "implicit" in n or "cudnn" in n:
        return "convolution"
    if "gemm" in n or "sgemm" in n or "cublas" in n or "ampere" in n \
            or "sm90" in n:
        return "matmul"
    if "index" in n or "gather" in n:
        return "indexing"
    return "elementwise/other"


def union_seconds(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_gaps(spans, t0: float, t1: float) -> list:
    """The (start, end) gaps of [t0, t1] that no interval covers."""
    gaps, end = [], t0
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, min(a, t1)))
        end = max(end, b)
        if end >= t1:
            break
    if end < t1:
        gaps.append((end, t1))
    return [(a, b) for a, b in gaps if b > a]


@dataclass
class DeviceTrace:
    """Device events of the traced window on the host clock: per card a
    list of (start, end, name), and the window [t0, t1]."""
    events: dict
    t0: float
    t1: float
    stamps: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> dict:
        """Busy seconds inside the window, per card."""
        return {d: union_seconds([(max(a, self.t0), min(b, self.t1))
                                  for a, b, _ in evs if b > self.t0
                                  and a < self.t1])
                for d, evs in self.events.items()}

    def seconds_by(self, key) -> dict:
        """Device seconds summed over every card by key(name)."""
        out: dict = {}
        for evs in self.events.values():
            for a, b, name in evs:
                k = key(name)
                out[k] = out.get(k, 0.0) + (b - a)
        return out

    def gaps(self) -> list:
        """Every card's idle gaps in the window, (start, end, card)."""
        out = []
        for d, evs in self.events.items():
            out += [(a, b, d) for a, b in
                    idle_gaps([(a, b) for a, b, _ in evs], self.t0, self.t1)]
        return out


def stage_at(stamps, a: float, b: float) -> str:
    """What the pipeline was doing on the host during [a, b], from the
    engine's per-flush stamps ((flush, stage, time)): the stages whose
    span overlaps it (queued: handed to dispatch and waiting; dispatch;
    resolve; emit), or where the run stood."""
    if not stamps:
        return "unattributed"
    by_flush: dict = {}
    for seq, stage, t in stamps:
        by_flush.setdefault(seq, {})[stage] = t
    spans = []
    for ev in by_flush.values():
        for kind, s, e in (("queued", "flush", "dispatch0"),
                           ("dispatch", "dispatch0", "dispatch1"),
                           ("resolve", "resolve0", "resolve1"),
                           ("emit", "emit0", "emit1")):
            if s in ev and e in ev:
                spans.append((kind, ev[s], ev[e]))
    first = min(t for _, _, t in stamps)
    last = max(t for _, _, t in stamps)
    if b <= first:
        return "start: engine build, first pack"
    if a >= last:
        return "end: after the last emit"
    kinds = sorted({k for k, s, e in spans if s < b and e > a})
    return "+".join(kinds) if kinds else "pack: no flush in flight"


def marker(devices) -> float:
    """Synchronise every card, read the host clock, launch one short
    kernel on the first card and wait for it: the clock's anchor in the
    trace."""
    import torch
    for d in devices:
        torch.cuda.synchronize(d)
    t = time.perf_counter()
    with torch.cuda.device(devices[0]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return t


def from_profiler(prof, t_mark0: float, t_mark1: float, t0: float,
                  t1: float, stamps=()) -> DeviceTrace:
    """The profiler's device events as a DeviceTrace; the first and last
    device events are the markers launched at t_mark0 and t_mark1;
    `stamps` are the engine's per-flush stamps."""
    import torch
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    if len(evs) < 2:
        raise RuntimeError("the profiler recorded no device activity")
    s0 = min(e.start_ns() for e in evs)
    s1 = max(e.start_ns() for e in evs)
    scale = (t_mark1 - t_mark0) / ((s1 - s0) * 1e-9) if s1 > s0 else 1.0
    by_dev: dict = {}
    for e in evs:
        a = t_mark0 + (e.start_ns() - s0) * 1e-9 * scale
        b = a + e.duration_ns() * 1e-9 * scale
        by_dev.setdefault(e.device_index(), []).append((a, b, e.name()))
    return DeviceTrace(by_dev, t0, t1, list(stamps))


def breakdown(trace: DeviceTrace, top: int = 10) -> dict:
    """The device operations that took most time, by kernel name, and the
    longest idle gaps, each named by what the host was doing."""
    ops = sorted(trace.seconds_by(lambda n: n[:160]).items(),
                 key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:top]
    named = [[f"card{d} {stage_at(trace.stamps, a, b)}", b - a]
             for a, b, d in gaps]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
