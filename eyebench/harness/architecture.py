"""The architecture a configuration runs, looked up by name.

A configuration file may name its ``"architecture"``; without the key it
is ``depth_pro``. The harness loads ``eyebench/architectures/<name>.py``,
which gives what depends on the model's shapes and on the program's entry
for it:

* ``session(ctx)``: the program's session under ``ctx.policy`` on the
  configuration's seeded weights (``eyebench.harness.cell.Context``);
* ``make_weights(model, seed, device, served)``: those weights, made again
  for the reference;
* ``reference(model, params, rgb, f35, device, precision=None)``: the
  plain reference's inverse depth of one (H, W, 3) u8 photo at the
  program's output grid, the 35 mm focal length ``f35`` passed or None,
  computed in ``precision`` where one is named (the control);
* ``depth_map(inverse_depth, h, w)``: the reference's depth-map PNG pixels
  at the photo's size, for a ``png`` sample;
* ``has_fov``: whether an image passed without a focal length is judged by
  ``fov_gap`` (the model estimates its focal length);
* ``clamps``: the program's clamp of its inverse depth, ``"forward"`` for
  the batch entry's output and ``"depth_map"`` for a depth map's grid;
* the FLOP ledger: ``forward_flops(model, photos, variant)``,
  ``attention_calls(model, photos, variant, vit_dtype)``,
  ``conv3x3_calls(model, photos, dtype)`` and ``policy_dtypes(policy)``,
  ``variant`` being the second item of ``Window.forwards``.

``model`` is the configuration's ``"model"`` group. An architecture module
may import the program; what it names as the reference lives under
``eyebench/reference/`` and imports nothing of the program.
"""

from __future__ import annotations

import importlib.util
import os
import re
from typing import Any, Dict

DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "architectures")
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
_loaded: Dict[str, Any] = {}


class UnknownArchitecture(LookupError):
    pass


def of(config: Dict[str, Any]):
    """The module of ``config``'s architecture (``depth_pro`` where it names
    none); raises ``UnknownArchitecture`` where the directory has no module
    of that name."""
    name = config.get("architecture", "depth_pro")
    path = os.path.join(DIR, f"{name}.py")
    mod = _loaded.get(path)
    if mod is None:
        if not (isinstance(name, str) and _NAME.match(name) and os.path.isfile(path)):
            raise UnknownArchitecture(f"no architecture named {name!r} "
                                      f"(eyebench/architectures/<name>.py)")
        spec = importlib.util.spec_from_file_location(f"eyebench_architecture_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return mod
