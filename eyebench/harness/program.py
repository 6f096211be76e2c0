"""The program's own spans in a traced run's window.

The port records spans while a ``torch.profiler`` trace runs
(``matrix_eyes_tpu_torch.timings``): name, start and end in
``time.time_ns()`` (the trace's clock), parent, request and attributes. A
traced run profiles exactly its window, so the spans recorded in the
process that lie inside ``[run.lo_ns, run.hi_ns]`` are the window's. A
program without the recorder, or a run without a trace, gives None, and
every reader built on this module then reads nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from eyebench.harness import trace


def spans(run) -> Optional[list]:
    """The program's spans inside the traced window, in the order they
    started; None without a trace or without the program's recorder."""
    if run.busy_s is None or run.hi_ns <= run.lo_ns:
        return None
    try:
        from matrix_eyes_tpu_torch import timings
    except ImportError:
        return None
    recorded = getattr(timings, "recorded", None)
    if recorded is None:
        return None
    inside = [s for s in recorded() if run.lo_ns <= s.start_ns and s.end_ns <= run.hi_ns]
    return sorted(inside, key=lambda s: s.start_ns)


def named(run, name: str) -> Optional[list]:
    """The window's spans called ``name``; None where there is none."""
    found = [s for s in spans(run) or () if s.name == name]
    return found or None


def ms_per_photo(run, name: str) -> Optional[float]:
    """Host milliseconds a photo in the spans called ``name``."""
    found = named(run, name)
    if found is None or not run.window.photos:
        return None
    return sum(s.end_ns - s.start_ns for s in found) / 1e6 / run.window.photos


def idle_by_innermost(run) -> Optional[Dict[str, int]]:
    """Nanoseconds of the window with no kernel running on the card, by the
    innermost program span open across them: the one open that started
    last (``trace.open_span``). Time with no program span open is left out.
    None without spans."""
    found = spans(run)
    if not found:
        return None
    idle = trace.gaps(trace.kernels(run.ops), run.lo_ns, run.hi_ns)
    # the stretches between consecutive span boundaries, each with the
    # spans open across it; then their overlap with the idle gaps
    events = sorted([(s.start_ns, 1, i) for i, s in enumerate(found)]
                    + [(s.end_ns, 0, i) for i, s in enumerate(found)])
    out: Dict[str, int] = {}
    open_now: List[tuple] = []
    gi = 0
    for (t0, kind, i), (t1, _k, _j) in zip(events, events[1:]):
        s = found[i]
        if kind:
            open_now.append((s.name, s.start_ns, s.end_ns))
        else:
            open_now.remove((s.name, s.start_ns, s.end_ns))
        if t1 <= t0 or not open_now:
            continue
        name = trace.open_span(open_now, (t0 + t1) // 2, "")
        while gi < len(idle) and idle[gi][1] <= t0:
            gi += 1
        k = gi
        while k < len(idle) and idle[k][0] < t1:
            a, b = max(idle[k][0], t0), min(idle[k][1], t1)
            if b > a:
                out[name] = out.get(name, 0) + (b - a)
            k += 1
    return out


def idle_ms_per_photo(run, name: str) -> Optional[float]:
    """Milliseconds a photo with no kernel running while ``name`` is the
    innermost open program span; None where no span is called ``name``."""
    if named(run, name) is None or not run.window.photos:
        return None
    return idle_by_innermost(run).get(name, 0) / 1e6 / run.window.photos
