"""Closed loop, one caller: ``MatrixEyes.inverse_depth_batch`` over a batch
of decoded photos, (H, W, 3) u8 arrays held in memory, each call returning
the (B, S, S) float32 inverse depth to the host before the next starts.

Mix keys: ``batches`` (a cycle of batches over the pool, each a list of
flags: 1 passes the photo's focal length, 0 passes none, so the FOV head
estimates it; the flags of a cycle cover the pool once, in an order drawn
from the seed), ``samples`` (calls whose outputs are kept for the check, drawn from the
seed among the calls that pass every focal length and, as many again,
among those that leave some to the FOV head).
"""

from __future__ import annotations

import random
import time

from eyebench.harness import architecture
from eyebench.harness.cell import Context, Window, seeded_session
from eyebench.harness.stats import Reservoir


class Cell:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.session = None
        order = list(range(len(ctx.photos)))
        random.Random(ctx.seed).shuffle(order)
        pattern = [list(b) for b in ctx.mix["batches"]]
        if sum(len(b) for b in pattern) != len(order):
            raise ValueError("the mix's batches must cover the photo pool once")
        random.Random(ctx.seed + 1).shuffle(pattern)
        self.calls = []  # (photo indices, focal lengths) of one cycle
        it = iter(order)
        for flags in pattern:
            idx = [next(it) for _ in flags]
            self.calls.append((idx, [ctx.photos[i].focal_mm if f else None
                                     for i, f in zip(idx, flags)]))
        # one seeded sample among the calls that pass every focal length, one
        # among those in which the FOV head estimates some
        self.kept = {fov: Reservoir(ctx.mix["samples"], ctx.seed ^ (0x5A5A + fov))
                     for fov in (False, True)}

    def _call(self, k: int):
        idx, focal = self.calls[k % len(self.calls)]
        return self.session.inverse_depth_batch([self.ctx.rgb[i] for i in idx], focal)

    def setup(self) -> None:
        self.session = seeded_session(self.ctx)
        # each program of the cycle twice: an eager call, then the capture
        seen = set()
        for k in range(len(self.calls)):
            key = all(f is not None for f in self.calls[k][1])
            if key not in seen:
                seen.add(key)
                self._call(k)
                self._call(k)

    def _targets(self):
        from matrix_eyes_tpu_torch import api

        return [(api, "preprocess_image", "upload"), (api, "forward_batch", "forward")]

    def window(self, seconds: float) -> Window:
        spans = self.ctx.spans
        lat, forwards, n, photos = [], [], 0, 0
        with spans.wrapped(self._targets() if self.ctx.trace else []):
            t0 = time.perf_counter()
            end = t0 + seconds
            while True:
                s = time.perf_counter()
                if self.ctx.trace:
                    with spans.span("batch"):
                        inv = self._call(n)
                else:
                    inv = self._call(n)
                done = time.perf_counter()
                idx, focal = self.calls[n % len(self.calls)]
                lat.append(done - s)
                forwards.append((len(idx), any(f is None for f in focal)))
                photos += len(idx)
                self.kept[any(f is None for f in focal)].offer((inv, idx, focal))
                n += 1
                if done >= end:
                    break
        return Window(t0=t0, t1=done, attempted=photos, failed=0, photos=photos, latencies=lat,
                      forwards=forwards)

    def samples(self):
        """[("grid", (B, S, S) inverse depth, [(photo, focal passed)], the
        architecture's clamp of the forward)]."""
        clamp = architecture.of(self.ctx.config).clamps["forward"]
        return [("grid", inv, [(self.ctx.photos[i], f) for i, f in zip(idx, focal)], clamp)
                for fov in (False, True) for inv, idx, focal in self.kept[fov].items]

    def close(self) -> None:
        self.session = None
