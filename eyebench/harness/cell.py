"""What a traffic generator is handed, what it hands back, and the seeded
session of the program under test, which the configuration's architecture
builds (``eyebench/harness/architecture.py``).

A generator module (``eyebench/traffic/<name>.py``, named by a mix's
``generator`` key) defines ``Cell(ctx)`` with ``setup()``, ``window(seconds)``,
``samples()`` and ``close()``. ``setup`` builds the program's session and
warms the cell's own program signatures; ``window`` drives the traffic for
at least ``seconds`` and returns a ``Window``; ``samples`` returns the
outputs kept for the correctness check (a seeded sample over the whole
window); ``close`` frees the program's state. A generator takes the
session from ``seeded_session`` and the clamp of its samples from the
architecture's ``clamps``, so that it serves every architecture alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from eyebench.harness import architecture
from eyebench.harness.photos import Photo
from eyebench.harness.spans import Spans


@dataclasses.dataclass
class Context:
    config: Dict[str, Any]      # eyebench/configs/<config>.json
    mix: Dict[str, Any]         # eyebench/traffic/<mix>.json
    seed: int
    device: Any                 # torch.device
    photos: List[Photo]
    tmpdir: str
    trace: bool
    policy: str                 # the --dtype policy the program runs
    spans: Spans = dataclasses.field(default_factory=Spans)
    rgb: Optional[list] = None  # decoded pixels of the photos, where the mix wants them


@dataclasses.dataclass
class Window:
    t0: float                   # perf_counter at the first timed work
    t1: float                   # perf_counter when the window's work was done
    attempted: int
    failed: int
    photos: int                 # photos completed
    latencies: List[float]      # per photo or request, seconds (failed: inf)
    # (photos, variant) of every forward, the variant as the architecture's
    # ledger reads it: some photo had no focal length (Depth Pro: the FOV
    # head ran)
    forwards: List[Tuple[int, bool]]
    info: str = ""              # a line for the run's log


def seeded_session(ctx: Context):
    """The program's session under ``ctx.policy`` on the configuration's
    seeded weights, as the configuration's architecture builds it
    (``eyebench/architectures/<name>.py``'s ``session``)."""
    return architecture.of(ctx.config).session(ctx)
