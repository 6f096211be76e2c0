"""The port's spans: one recorder for the CLI's stage table and for the
program's own trace.

A span is a block of host time: its name, its start and end in
``time.time_ns()`` nanoseconds (the clock of ``torch.profiler``'s events,
so a device operation or an idle stretch of the card can be put beside the
span open at its moment), its own id, the id of the span open around it in
the same context (``contextvars``), a request id, the thread and an
optional small dict of attributes. A span opened with no span open around
it starts a new request; threads do not share requests.

Spans are recorded while ``MATRIX_EYES_TIMINGS`` is set (not "" or "0") or
while a ``torch.profiler`` trace runs (PyTorch's own flag). Otherwise a span
costs two flag reads: no environment read through ``os.environ.get``, no
allocation. The recorded spans are kept in memory, the latest ``BUFFER``
of them (``recorded()``).

Two kinds share the recorder:

* ``span(name)``: a stage of the CLI's table. Set ``MATRIX_EYES_TIMINGS=1``
  and the CLI prints a per-stage wall-clock table to stderr on exit
  (``report()``); its totals count every such span, however many the
  buffer keeps. Spans measure what the user waits for at that point of the
  program: device work enqueued inside a span is charged to whichever later
  span first waits on it, except the model forward, whose span waits for
  the card when ``MATRIX_EYES_TIMINGS`` is on (``pipeline``). The table is
  a wall-clock attribution, not a device-time profile.
* ``trace(name, attrs)``: a span of the program's trace (``pipeline.decode``,
  ``output.encode``, ``dispatch.replay``, ``serve.request``...), recorded
  and not counted in the table.

Recording adds no device work and no synchronisation: the spans are host
clock readings, never ``record_function`` ranges or NVTX marks.
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import os
import sys
import threading
import time
from typing import Any, Deque, Dict, List, NamedTuple, Optional, Tuple

import torch.autograd.profiler as _profiler

BUFFER = 1 << 16  # spans kept for recorded()


class Span(NamedTuple):
    """One recorded span; times in ``time.time_ns()`` nanoseconds."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # the span open around it, None for a request's root
    request: int
    thread: int  # threading.get_ident()
    attrs: Optional[Dict[str, Any]]


# os.environ's own store, read by a dict lookup: os.environ.get encodes the
# key, decodes the value and raises KeyError inside when the variable is
# unset (~1.6 us a call); this lookup allocates nothing and still sees every
# change made through os.environ
_ENVIRON = os.environ._data
_TIMINGS_KEY = os.environ.encodekey("MATRIX_EYES_TIMINGS")
_OFF = (None, os.environ.encodevalue(""), os.environ.encodevalue("0"))


def enabled() -> bool:
    """Whether ``MATRIX_EYES_TIMINGS`` is set: the table is kept and the
    forward's span waits for the card."""
    return _ENVIRON.get(_TIMINGS_KEY) not in _OFF


_lock = threading.Lock()
_buffer: Deque[Span] = collections.deque(maxlen=BUFFER)
_totals: Dict[str, Tuple[int, float]] = {}  # the table: name -> (count, seconds)
_ids = itertools.count(1)
_requests = itertools.count(1)
_open: contextvars.ContextVar[Optional["_Open"]] = contextvars.ContextVar(
    "matrix_eyes_span", default=None)
_t0 = time.perf_counter()


class _Off:
    """The span of a block while nothing records: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF_SPAN = _Off()


class _Open:
    __slots__ = ("name", "attrs", "table", "id", "parent", "request", "start_ns", "_token")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]], table: bool):
        self.name = name
        self.attrs = attrs
        self.table = table

    def __enter__(self):
        up = _open.get()
        self.id = next(_ids)
        if up is None:
            self.parent, self.request = None, next(_requests)
        else:
            self.parent, self.request = up.id, up.request
        self._token = _open.set(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        _open.reset(self._token)
        rec = Span(self.name, self.start_ns, end, self.id, self.parent, self.request,
                   threading.get_ident(), self.attrs)
        with _lock:
            _buffer.append(rec)
            if self.table and enabled():
                n, tot = _totals.get(self.name, (0, 0.0))
                _totals[self.name] = (n + 1, tot + (end - self.start_ns) / 1e9)
        return False


def span(name: str):
    """A stage of the CLI's table under ``name``, recorded as a span too
    (see the module's docstring). Costs two flag reads while nothing
    records."""
    if not _profiler._is_profiler_enabled and _ENVIRON.get(_TIMINGS_KEY) in _OFF:
        return _OFF_SPAN
    return _Open(name, None, True)


def trace(name: str, attrs: Optional[Dict[str, Any]] = None):
    """A span of the program's trace under ``name`` with ``attrs`` (not a
    row of the table). Costs two flag reads while nothing records."""
    if not _profiler._is_profiler_enabled and _ENVIRON.get(_TIMINGS_KEY) in _OFF:
        return _OFF_SPAN
    return _Open(name, attrs, False)


def current_request() -> Optional[int]:
    """The request of the span open in this context, None if none is."""
    up = _open.get()
    return None if up is None else up.request


def recorded() -> List[Span]:
    """The recorded spans, the latest ``BUFFER``, in the order they ended."""
    with _lock:
        return list(_buffer)


def request_spans(request: int, since_ns: int) -> List[Span]:
    """The ended spans of ``request`` among those that ended at
    ``since_ns`` or later, in the order they started."""
    out = []
    with _lock:
        for s in reversed(_buffer):
            if s.end_ns < since_ns:
                break
            if s.request == request:
                out.append(s)
    return sorted(out, key=lambda s: s.start_ns)


def clear() -> None:
    """Forget the recorded spans and the table's totals."""
    with _lock:
        _buffer.clear()
        _totals.clear()


def snapshot() -> Dict[str, Tuple[int, float]]:
    """The table: {name: (count, total_seconds)} in first-seen order."""
    with _lock:
        return dict(_totals)


def report(file=None) -> None:
    """Print the stage table (stderr by default) and reset it. The final
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
        _totals.clear()
