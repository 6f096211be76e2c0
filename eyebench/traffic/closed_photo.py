"""Closed loop, one caller: a warm ``MatrixEyes`` session turns one photo
file after another into an output file with ``process(photo, output)``,
the next photo starting when the previous file is written. The pool is
cycled in an order drawn from the seed.

Mix keys: ``output`` (the output's file name, its extension choosing the
format), ``format`` (``depthmap`` or ``stereogram``), ``check`` (the kind
of comparison the output file takes, ``png`` by default: a depth map),
``samples`` (outputs
kept for the check, a seeded sample over the window: the file, and the
depth map the session rendered it from, which ``depth_map`` returned).
"""

from __future__ import annotations

import os
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
        self.order = order
        self.out = os.path.join(ctx.tmpdir, ctx.mix["output"])
        self.kept = Reservoir(ctx.mix["samples"], ctx.seed ^ 0x5A5A)
        self.grids = {}  # slot -> the kept output's depth map (its clamped grid)
        self.last = None

    def _kept_path(self, slot: int) -> str:
        stem, ext = os.path.splitext(self.out)
        return f"{stem}-kept{slot}{ext}"

    def _process(self, photo) -> None:
        self.session.process(photo.path, self.out, image_format=self.ctx.mix["format"])

    def setup(self) -> None:
        self.session = seeded_session(self.ctx)
        real = self.session.depth_map

        def depth_map(*args, **kwargs):
            self.last = real(*args, **kwargs)
            return self.last

        self.session.depth_map = depth_map
        # the cell's programs, each twice: an eager call, then the capture
        for i in range(2):
            self._process(self.ctx.photos[self.order[i]])

    def _targets(self):
        from matrix_eyes_tpu_torch import api
        from matrix_eyes_tpu_torch.output.depthmap import DepthMap

        return [(api, "load_source_image", "decode"), (api, "preprocess_image", "upload"),
                (api, "forward_photo", "forward"), (DepthMap, "output_image", "output")]

    def window(self, seconds: float) -> Window:
        spans = self.ctx.spans
        lat, forwards, n = [], [], 0
        with spans.wrapped(self._targets() if self.ctx.trace else []):
            t0 = time.perf_counter()
            end = t0 + seconds
            while True:
                photo = self.ctx.photos[self.order[n % len(self.order)]]
                s = time.perf_counter()
                if self.ctx.trace:
                    with spans.span("photo"):
                        self._process(photo)
                else:
                    self._process(photo)
                done = time.perf_counter()
                lat.append(done - s)
                forwards.append((1, photo.focal_mm is None))
                slot = self.kept.offer(self.order[n % len(self.order)])
                if slot is not None:
                    os.replace(self.out, self._kept_path(slot))
                    self.grids[slot] = self.last.data
                n += 1
                if done >= end:
                    break
        return Window(t0=t0, t1=done, attempted=n, failed=0, photos=n, latencies=lat,
                      forwards=forwards)

    def samples(self):
        """[("png", output path, photo)] and [("grid", its depth map, ...,
        the architecture's clamp of a depth map)] of the kept outputs."""
        clamp = architecture.of(self.ctx.config).clamps["depth_map"]
        out = []
        for slot, i in enumerate(self.kept.items):
            photo = self.ctx.photos[i]
            out.append((self.ctx.mix.get("check", "png"), self._kept_path(slot), photo))
            out.append(("grid", self.grids[slot].cpu().numpy()[None], [(photo, photo.focal_mm)],
                        clamp))
        return out

    def close(self) -> None:
        self.session = self.last = None
        self.grids = {}
