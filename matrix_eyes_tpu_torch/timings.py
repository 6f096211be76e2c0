"""Coarse wall-clock stage timing for the CLI (the port's own copy of
``matrix_eyes_tpu/timings.py``).

Set ``MATRIX_EYES_TIMINGS=1`` and the CLI prints a per-stage wall-clock
table to stderr on exit. Spans measure what the user waits for at that
point of the program: device work enqueued inside a span is charged to
whichever later span first waits on it, except the model forward, whose
span waits for the card when timings are on (``pipeline``). The table is a
wall-clock attribution, not a device-time profile.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple


def enabled() -> bool:
    return os.environ.get("MATRIX_EYES_TIMINGS", "") not in ("", "0")


_lock = threading.Lock()
_spans: List[Tuple[str, float]] = []
_t0 = time.perf_counter()


@contextmanager
def span(name: str):
    """Record the wall time of a block under ``name``. No-op (and no
    overhead beyond one env read) when MATRIX_EYES_TIMINGS is unset."""
    if not enabled():
        yield
        return
    start = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - start
        with _lock:
            _spans.append((name, dt))


def snapshot() -> Dict[str, Tuple[int, float]]:
    """{name: (count, total_seconds)} in first-seen order."""
    agg: Dict[str, Tuple[int, float]] = {}
    with _lock:
        for name, dt in _spans:
            n, tot = agg.get(name, (0, 0.0))
            agg[name] = (n + 1, tot + dt)
    return agg


def report(file=None) -> None:
    """Print the stage table (stderr by default) and reset. The final
    line reports the process wall clock since this module was imported,
    which exceeds the span sum by whatever ran untimed (imports, CUDA
    context creation)."""
    if not enabled():
        return
    agg = snapshot()
    if not agg:
        return
    f = file if file is not None else sys.stderr
    wall = time.perf_counter() - _t0
    width = max(len(n) for n in agg)
    print("-- timings (wall clock) --", file=f)
    for name, (n, tot) in agg.items():
        times = f" x{n}" if n > 1 else ""
        print(f"  {name:<{width}}  {tot:8.3f} s{times}", file=f)
    print(f"  {'process total':<{width}}  {wall:8.3f} s", file=f)
    with _lock:
        _spans.clear()
