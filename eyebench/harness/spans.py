"""Spans the harness records around its calls into the program's layers.

A span is (name, start, end) in ``time.time_ns()``, the clock of the
profiler's trace, so a device operation or an idle gap can be put beside
the span open at its moment. The harness opens spans only in a traced
run: an untraced run calls the program with nothing wrapped.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import List, Tuple


class Spans:
    def __init__(self):
        self._lock = threading.Lock()
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.items.append((name, t0, t1))

    @contextlib.contextmanager
    def wrapped(self, targets):
        """Within the block, each ``(owner, attribute, span name)`` of
        ``targets`` runs inside a span; a missing attribute is left alone."""
        saved = []
        try:
            for owner, attr, name in targets:
                fn = getattr(owner, attr, None)
                if fn is None:
                    continue
                saved.append((owner, attr, owner.__dict__.get(attr, fn)))
                setattr(owner, attr, self._wrap(fn, name))
            yield
        finally:
            for owner, attr, fn in reversed(saved):
                setattr(owner, attr, fn)

    def _wrap(self, fn, name: str):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return run
