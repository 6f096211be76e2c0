"""Progress reporting (the port's own copy of the parts of
``matrix_eyes_tpu/progress.py`` that it uses).

``SplitProgressListener`` subdivides the [0, 1] progress range so each
pipeline stage reports into its own slice (reference mod.rs:374-418);
``ConsoleProgressReporter`` is the CLI's one-line terminal bar
(reconstruction.rs:207-238).
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Protocol, Tuple


class ProgressListener(Protocol):
    """Same protocol as the reference trait (mod.rs:366-372)."""

    def report_status(self, pos: float) -> None: ...

    def update_message(self, status_message: str) -> None: ...


class SplitProgressListener:
    """Maps a child's [0,1] progress into a slice of the parent's range.

    ``split_range(p)`` divides this listener's range at fraction ``p`` and
    returns the (left, right) sub-listeners.
    """

    def __init__(self, pl: Optional[ProgressListener], start: float = 0.0, end: float = 1.0):
        self.pl = pl
        self.start = start
        self.end = end

    def split_range(self, split_position: float) -> Tuple["SplitProgressListener",
                                                          "SplitProgressListener"]:
        mid = self.start + (self.end - self.start) * split_position
        return (
            SplitProgressListener(self.pl, self.start, mid),
            SplitProgressListener(self.pl, mid, self.end),
        )

    def report_status(self, pos: float) -> None:
        if self.pl is not None:
            self.pl.report_status(self.start + pos * (self.end - self.start))

    def update_message(self, status_message: str) -> None:
        if self.pl is not None:
            self.pl.update_message(status_message)


class ConsoleProgressReporter:
    """Terminal progress bar like the reference's indicatif bar.

    Renders ``{bar:40} {percent:.2f}% ({elapsed}): {message}`` on one line
    (reconstruction.rs:213-221) and clears the line when finished.
    """

    def __init__(self, stream=None, enabled: bool = True):
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = enabled and getattr(self.stream, "isatty", lambda: False)()
        self._t0 = time.monotonic()
        self._pos = 0.0
        self._msg = ""

    def report_status(self, pos: float) -> None:
        self._pos = min(max(pos, 0.0), 1.0)
        self._render()

    def update_message(self, status_message: str) -> None:
        self._msg = status_message
        self._render()

    def _render(self) -> None:
        if not self.enabled:
            return
        width = 40
        filled = int(self._pos * width)
        bar = "#" * filled + "-" * (width - filled)
        elapsed = int(time.monotonic() - self._t0)
        mm, ss = divmod(elapsed, 60)
        msg = f": {self._msg}" if self._msg else ""
        self.stream.write(f"\r{bar} {self._pos * 100.0:.2f}% ({mm}m {ss:02d}s){msg}\x1b[K")
        self.stream.flush()

    def finish_and_clear(self) -> None:
        if self.enabled:
            self.stream.write("\r\x1b[K")
            self.stream.flush()
