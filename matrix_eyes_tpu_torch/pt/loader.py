"""Checkpoint loading with per-part weight caches (``--convert-checkpoints``).

The port of the cache half of ``matrix_eyes_tpu/pt/loader.py``. A cold
load reads ``depth_pro.pt`` at canonical f32 (``convert.read_checkpoint``)
and places the dtype policy on the device (``convert.place_params``); with
``convert_checkpoints=True`` it also writes the caches beside the
checkpoint. A warm load finds them and never reads the ``.pt``, not even
for the architecture: ``<stem>-torch-config.json`` holds it, stamped with
the ``.pt``'s (size, mtime_ns) so that a checkpoint replaced in place
invalidates every cache.

The caches keep the JAX package's values, not the cold run's:

* f32, bf16 and f16 share one cache per part, every leaf rounded to f16
  (the reference's on-disk convention, which the JAX package keeps), cast
  to the compute dtype when placed. So a warm run computes with
  dtype(f16(x)) where the cold run had dtype(x), as the JAX package does;
* int8 caches the placed tree: codes (out, in), f32 scales, and the other
  leaves, all derived from the f16 convention (the cold run quantizes from
  f16(x) too), so cold and warm agree. A warm int8 run that finds only the
  f16 cache quantizes from it;
* mixed caches its placed tree exactly (bf16 block matmul weights, f32
  rest), derived only from the ``.pt``, never from the f16 cache, whose
  rounding it exists to avoid.

Files (``<stem>`` is the checkpoint's path without ``.pt``):
``<stem>-<part>.torch.<kind>.pt`` with kind ``f16``, ``int8`` or
``mixed``, written by ``torch.save`` as ``{"scheme", "leaves"}`` (the
leaves in ``tree_leaves`` order of the part's spec) and read with
``torch.load(weights_only=True, mmap=True)``, and
``<stem>-torch-config.json``. None of these names is one the JAX package
writes or reads (``<stem>-<part>.npz``, ``.packed*``, ``.mixed.npz``,
``<stem>-config.json``), so both packages' caches can share a directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import sys
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from matrix_eyes_tpu_torch import timings
from matrix_eyes_tpu_torch.config import ModelConfig
from matrix_eyes_tpu_torch.errors import LoaderError
from matrix_eyes_tpu_torch.models.spec import param_spec, tree_leaves, tree_map
from matrix_eyes_tpu_torch.ops.quant import QUANT_COMPUTE, QUANT_WEIGHT_ONLY
from matrix_eyes_tpu_torch.pt import convert
from matrix_eyes_tpu_torch.pt.convert import PARTS

KINDS = ("f16", "int8", "mixed")
_SCHEME = "matrix_eyes_tpu_torch-weights-v1"


def _stem(checkpoint_path: str) -> str:
    """Cache-file stem: beside the real checkpoint, so a symlinked ``.pt``
    shares its target's caches; beside the link when caches already live
    there, or the real directory is not writable."""
    link_stem = os.path.splitext(os.path.abspath(checkpoint_path))[0]
    real_stem = os.path.splitext(os.path.realpath(checkpoint_path))[0]
    if real_stem == link_stem:
        return real_stem
    if os.path.exists(real_stem + "-torch-config.json"):
        return real_stem
    if os.path.exists(link_stem + "-torch-config.json"):
        return link_stem
    real_dir = os.path.dirname(real_stem) or "."
    return real_stem if os.access(real_dir, os.W_OK) else link_stem


def cache_path(checkpoint_path: str, part: str, kind: str) -> str:
    return f"{_stem(checkpoint_path)}-{part}.torch.{kind}.pt"


def config_cache_path(checkpoint_path: str) -> str:
    return f"{_stem(checkpoint_path)}-torch-config.json"


def _int8_spec(tree: Any) -> Any:
    """The spec of the int8 layout (``ops/quant.py``): in every stacked
    blocks dict, ``<name>_w`` (L, in, out) becomes ``<name>_qw`` (L, out,
    in) and ``<name>_sw`` (L, out)."""
    if isinstance(tree, dict):
        if "qkv_w" not in tree:
            return {k: _int8_spec(v) for k, v in tree.items()}
        out = {}
        for key, shape in tree.items():
            name = key[:-2] if key.endswith("_w") else None
            if name in QUANT_COMPUTE + QUANT_WEIGHT_ONLY:
                layers, n_in, n_out = shape
                out[f"{name}_qw"], out[f"{name}_sw"] = (layers, n_out, n_in), (layers, n_out)
            else:
                out[key] = shape
        return out
    if isinstance(tree, list):
        return [_int8_spec(v) for v in tree]
    return tree


def _kind_spec(part_spec: Any, kind: str) -> Any:
    return _int8_spec(part_spec) if kind == "int8" else part_spec


def save_part_cache(path: str, tree: Any) -> None:
    """Write one part's leaves (CPU tensors) to ``path``, atomically."""
    tmp = path + ".tmp"
    torch.save({"scheme": _SCHEME, "leaves": tree_leaves(tree)}, tmp)
    os.replace(tmp, path)


def read_part_cache(path: str, part_spec: Any, kind: str) -> Any:
    """One part's cached tree (CPU tensors, memory-mapped), validated
    against the part's spec: the count of leaves, each shape, and int8
    exactly where the int8 layout has codes."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        leaves = blob["leaves"]
        scheme = blob["scheme"]
    except (OSError, RuntimeError, ValueError, KeyError, TypeError,
            pickle.UnpicklingError) as err:
        raise LoaderError(f"cache {path} unreadable: {err} (stale cache? delete it to "
                          "reconvert)") from err
    spec = _kind_spec(part_spec, kind)
    want = []
    tree_map(lambda path_, shape: want.append((path_, tuple(shape))), spec)
    if scheme != _SCHEME or len(leaves) != len(want):
        raise LoaderError(f"cache {path} has {len(leaves)} tensors of scheme {scheme!r}, the "
                          f"model expects {len(want)} of {_SCHEME!r} (stale cache? delete it "
                          "to reconvert)")
    for t, (leaf_path, shape) in zip(leaves, want):
        is_code = str(leaf_path[-1]).endswith("_qw")
        if (not isinstance(t, torch.Tensor) or tuple(t.shape) != shape
                or (t.dtype == torch.int8) != is_code
                or (kind == "f16" and t.dtype != torch.float16)):
            got = (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else type(t)
            raise LoaderError(f"cache {path}: tensor {'.'.join(map(str, leaf_path))} is {got}, "
                              f"expected {shape} (stale cache? delete it to reconvert)")
    it = iter(leaves)
    return tree_map(lambda _p, _shape: next(it), spec)


def _to_device(tree: Any, device) -> Any:
    return tree_map(lambda _p, t: t.to(device), tree)


def _f16_tree(canonical: Any) -> Any:
    """The f16 on-disk convention of a canonical f32 part (CPU tensors)."""
    return tree_map(lambda _p, a: torch.as_tensor(a).to(torch.float16), canonical)


def _pt_stat(checkpoint_path: str) -> Optional[Dict[str, int]]:
    try:
        st = os.stat(checkpoint_path)
        return {"size": st.st_size, "mtime_ns": st.st_mtime_ns}
    except OSError:
        return None


def _load_config_cache(path: str) -> ModelConfig:
    with open(path) as f:
        d = json.load(f)
    d.pop("pt_stat", None)
    for key in ("encoder_feature_dims", "head_last_dims", "highres_block_ids"):
        d[key] = tuple(d[key])
    return ModelConfig(**d)


def _write_cache(path: str, tree: Any, what: str) -> None:
    """``save_part_cache`` of the tree's leaves moved to the host, through
    ``_save_cache_nonfatal``."""
    _save_cache_nonfatal(lambda: save_part_cache(path, tree_map(lambda _p, t: t.cpu(), tree)),
                         what)


def _save_cache_nonfatal(write, what: str) -> None:
    """Run a cache-writing thunk; on OSError warn and go on: the caches are
    an optimization, and a read-only checkpoint directory must load by
    converting every time, not fail."""
    try:
        write()
    except OSError as err:
        print(f"warning: could not write {what}: {err} (continuing without caching)",
              file=sys.stderr)


def _purge_caches(checkpoint_path: str) -> None:
    """Remove every cache of the port for ``checkpoint_path`` (all parts and
    kinds, not only those being loaded, which a partial reconversion would
    otherwise leave stamped as fresh). The JAX package's files stay."""
    for part in PARTS:
        for kind in KINDS:
            try:
                os.remove(cache_path(checkpoint_path, part, kind))
            except OSError:
                pass


def _caches_stale(checkpoint_path: str) -> bool:
    """Whether the ``.pt`` no longer matches the (size, mtime_ns) stamp of
    the config cache: replaced in place, so every cache is stale. A config
    cache without a stamp is trusted unless the ``.pt`` is newer than it."""
    ccache = config_cache_path(checkpoint_path)
    if not os.path.exists(ccache):
        return False
    try:
        with open(ccache) as f:
            stamp = json.load(f).get("pt_stat")
    except (OSError, ValueError):
        return True
    cur = _pt_stat(checkpoint_path)
    if stamp is None:
        try:
            return cur is not None and cur["mtime_ns"] > os.stat(ccache).st_mtime_ns
        except OSError:
            return True
    return cur is not None and stamp != cur


def load_checkpoint(checkpoint_path: str, dtype: torch.dtype, device,
                    convert_checkpoints: bool = False, parts: Sequence[str] = PARTS,
                    cfg: Optional[ModelConfig] = None, use_caches: bool = True,
                    quantize_int8: bool = False,
                    mixed_bf16: bool = False) -> Tuple[ModelConfig, Dict[str, Any]]:
    """(cfg, params of ``parts``) on ``device`` under the dtype policy
    (``dtype`` alone, or bf16 with ``quantize_int8`` or ``mixed_bf16``),
    from the caches where they exist, else from the ``.pt``; with
    ``convert_checkpoints`` the missing caches are written (module
    docstring). ``use_caches=False`` reads the ``.pt`` and touches no cache
    (``convert.load_checkpoint``). The architecture is inferred from the
    checkpoint unless ``cfg`` is given or the config cache holds it."""
    convert._check_policy(dtype, quantize_int8, mixed_bf16)
    if not use_caches:
        return convert.load_checkpoint(checkpoint_path, dtype, device, parts, cfg,
                                       quantize_int8=quantize_int8, mixed_bf16=mixed_bf16)
    policy = dict(quantize_int8=quantize_int8, mixed_bf16=mixed_bf16)
    kind = "int8" if quantize_int8 else "mixed" if mixed_bf16 else "f16"
    stale = _caches_stale(checkpoint_path)
    if stale and convert_checkpoints:
        _purge_caches(checkpoint_path)

    canonical: Optional[Dict[str, Any]] = None  # the .pt's parts, once read

    def read(needed: Sequence[str]):
        with timings.span("read .pt checkpoint"):
            return convert.read_checkpoint(checkpoint_path, tuple(needed), cfg)

    if cfg is None:
        ccache = config_cache_path(checkpoint_path)
        if os.path.exists(ccache) and not stale:
            cfg = _load_config_cache(ccache)
        else:
            cfg, canonical = read(parts)
    spec = param_spec(cfg, include_fov="fov" in parts)

    out: Dict[str, Any] = {}
    uncached = []
    for part in parts:
        path = cache_path(checkpoint_path, part, kind)
        f16_path = cache_path(checkpoint_path, part, "f16")
        if stale:
            uncached.append(part)
        elif os.path.exists(path):
            with timings.span(f"weights {part} -> device ({kind} cache)"):
                tree = _to_device(read_part_cache(path, spec[part], kind), device)
                out[part] = (tree if kind != "f16" else
                             convert.place_params({part: tree}, device, dtype)[part])
        elif kind == "int8" and os.path.exists(f16_path):
            # quantize from the f16 cache: the values a cold run quantizes
            with timings.span(f"weights {part} -> device (int8 from the f16 cache)"):
                tree = _to_device(read_part_cache(f16_path, spec[part], "f16"), device)
                out[part] = convert.place_params({part: tree}, device, dtype, **policy)[part]
            if convert_checkpoints:
                _write_cache(path, out[part], f"int8 cache for '{part}'")
        else:
            uncached.append(part)

    if uncached:
        if canonical is None:
            _, canonical = read(uncached)
        for part in uncached:
            host = canonical.pop(part)
            if convert_checkpoints:
                _write_cache(cache_path(checkpoint_path, part, "f16"), _f16_tree(host),
                             f"f16 cache for '{part}'")
            with timings.span(f"weights {part} -> device"):
                out[part] = convert.place_params({part: host}, device, dtype, **policy)[part]
            if convert_checkpoints and kind != "f16":
                _write_cache(cache_path(checkpoint_path, part, kind), out[part],
                             f"{kind} cache for '{part}'")
        if convert_checkpoints:
            def write_config():
                d = dataclasses.asdict(cfg)
                d["pt_stat"] = _pt_stat(checkpoint_path)
                with open(config_cache_path(checkpoint_path), "w") as f:
                    json.dump(d, f, indent=1)

            _save_cache_nonfatal(write_config, "config cache")
    return cfg, {part: out[part] for part in parts}
