"""What a traffic generator is handed, what it hands back, and the seeded
session of the program under test.

A generator module (``eyebench/traffic/<name>.py``, named by a mix's
``generator`` key) defines ``Cell(ctx)`` with ``setup()``, ``window(seconds)``,
``samples()`` and ``close()``. ``setup`` builds the program's session and
warms the cell's own program signatures; ``window`` drives the traffic for
at least ``seconds`` and returns a ``Window``; ``samples`` returns the
outputs kept for the correctness check (a seeded sample over the whole
window); ``close`` frees the program's state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

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
    forwards: List[Tuple[int, bool]]  # (photos, FOV head ran) of every forward
    info: str = ""              # a line for the run's log


def model_config(config: Dict[str, Any]):
    from matrix_eyes_tpu_torch.config import ModelConfig

    m = config["model"]
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in m.items()})


def seeded_session(ctx: Context):
    """A ``MatrixEyes`` session under ``ctx.policy`` on weights made on the
    card from the configuration's ``weights_seed``
    (``eyebench.reference.weights``): the session has no constructor that
    takes parameters, so its checkpoint loader is answered with them while
    it is built. Policies other than the weights' own dtype are placed by
    the program's ``place_params``, as its loader places a checkpoint.

    The weights are one model for every run, as a deployment serves one:
    with weights drawn from the run's seed, the depth maps' detail, and with
    it the PNG encoder's work, changed from seed to seed (12 MP PNGs of
    17.8 to 27.6 MB) and so did the host-bound cells' rates."""
    import torch

    from eyebench.reference.weights import make_weights
    from matrix_eyes_tpu_torch import api
    from matrix_eyes_tpu_torch.pt.convert import place_params

    served = {"bf16": torch.bfloat16, "f32": torch.float32}[ctx.config["weights"]]
    cfg = model_config(ctx.config)
    policy = ctx.policy
    as_served = {"bf16": torch.bfloat16, "f32": torch.float32}.get(policy) == served

    def answer(_path, dtype, device, **_kw):
        params = make_weights(ctx.config["model"], ctx.config["weights_seed"], device, served)
        if not as_served:
            f32 = params if served == torch.float32 else _f32(params)
            del params
            params = place_params(f32, device, dtype, quantize_int8=policy == "int8",
                                  mixed_bf16=policy == "mixed")
            del f32
        return cfg, params

    real = api.load_checkpoint
    api.load_checkpoint = answer
    try:
        return api.MatrixEyes(f"random weights, weights_seed {ctx.config['weights_seed']}", dtype=policy,
                              device=ctx.device, cfg=cfg)
    finally:
        api.load_checkpoint = real


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float()
