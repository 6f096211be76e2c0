"""The device trace of a run's window: ``torch.profiler`` records every
operation the card runs; this module turns the record into intervals, the
busy time (their union), the operations that took most time, the share of
the window in which no kernel ran, and that idle time named by the
harness spans open across it. Copies between host and card (memcpy,
memset) are device operations but not kernels: the card computes nothing
while one runs alone, so they count as idle. Which kernels make a family
is each per-layer metric's own business.

Timestamps are nanoseconds on the trace's clock, which is the host's
``time.time_ns()``, the clock of the harness's spans.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[str, int, int]  # (name, start ns, end ns)


class DeviceTrace:
    """Profile the card between ``start`` and ``stop``."""

    def __init__(self):
        self._prof = None
        self.t0_ns = self.t1_ns = 0
        self.ops: List[Interval] = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self._prof.__exit__(None, None, None)
        ops = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            t0 = ev.start_ns()
            ops.append((ev.name(), t0, t0 + ev.duration_ns()))
        self._prof = None
        self.ops = ops


TRANSFERS = ("memcpy", "memset")


def is_transfer(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in TRANSFERS)


def kernels(ops: Sequence[Interval]) -> List[Interval]:
    return [op for op in ops if not is_transfer(op[0])]


def union_s(intervals: Sequence[Interval], lo: int, hi: int) -> float:
    """Seconds of [lo, hi] covered by at least one interval."""
    spans = sorted((max(a, lo), min(b, hi)) for _n, a, b in intervals if b > lo and a < hi)
    total, end = 0, lo
    for a, b in spans:
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e9


def gaps(intervals: Sequence[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle stretches of [lo, hi]: no interval covers them."""
    out, end = [], lo
    for a, b in sorted((a, b) for _n, a, b in intervals if b > lo and a < hi):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return out


def open_span(spans: Sequence[Interval], t: int, default: str) -> str:
    """The span open at ``t`` that started last, ``default`` if none is."""
    best: Optional[Interval] = None
    for s in spans:
        if s[1] <= t < s[2] and (best is None or s[1] > best[1]):
            best = s
    return best[0] if best is not None else default


def breakdown(ops: Sequence[Interval], spans: Sequence[Interval], lo: int, hi: int,
              idle_name: str, n: int = 10) -> Dict[str, list]:
    """The ``n`` device operations with the most time (transfers included),
    and the time with no kernel running by what the host was doing: each
    stretch of a gap charged to the span open across it that started last
    (``idle_name`` where none is), the ``n`` largest totals."""
    by_name: Dict[str, int] = {}
    for name, a, b in ops:
        by_name[name] = by_name.get(name, 0) + (b - a)
    idle: Dict[str, int] = {}
    for a, b in gaps(kernels(ops), lo, hi):
        cuts = sorted({a, b} | {t for _n, s0, s1 in spans for t in (s0, s1) if a < t < b})
        for c0, c1 in zip(cuts, cuts[1:]):
            name = open_span(spans, (c0 + c1) // 2, idle_name)
            idle[name] = idle.get(name, 0) + (c1 - c0)

    def top(d):
        return [[k[:120], v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]

    return {"device_ops": top(by_name), "idle_gaps": top(idle)}


def device_s(ops: Sequence[Interval], match) -> float:
    """Device seconds of the operations whose name ``match`` accepts."""
    return sum(b - a for name, a, b in ops if match(name)) / 1e9


def idle_percent(run) -> Optional[float]:
    """The share of a traced run's window in which no kernel ran on the
    card (transfers alone are idle), percent; None without a trace."""
    if run.busy_s is None or run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - union_s(kernels(run.ops), run.lo_ns, run.hi_ns) / run.window_s)
