"""Sharding layouts for multi-device Depth Pro inference (port of
``matrix_eyes_tpu/parallel/sharding.py``).

The JAX package runs one program over a device mesh and lets GSPMD insert
the collectives. The port runs one process per device (``parallel.launch``)
and every rank executes the same code on its own shard, calling the
collectives itself (``parallel.collectives``). The mesh has the JAX
package's two axes:

* ``data``: the encoder's pyramid patch batch (35 patches per image) is
  zero-padded to a multiple of ``data`` and split over the data ranks; the
  patch features are all-gathered before the overlap merge. When ``data``
  divides the image batch, everything after the merge (image encoder,
  decoder, head, FOV) runs on this rank's images and the inverse depth and
  FOV are gathered at the end; otherwise it runs replicated.
* ``model``: Megatron tensor parallelism inside every ViT block, on the
  head-group qkv layout (``_tp_permute_qkv``): qkv and fc1 split by
  columns, proj and fc2 by rows, so each block costs two all-reduces and
  attention stays local to a rank, ``num_heads / model`` heads each.

Rank ``r`` sits at ``(r // model, r % model)``, the JAX package's
``reshape(n // model, model)`` of its device list. The model functions
stay mesh-agnostic: the mesh reaches them through a context variable set
by ``patch_sharded``, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_patch_ctx: contextvars.ContextVar = contextvars.ContextVar("me_torch_patch_sharding",
                                                             default=None)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (data, model) mesh: its coordinates, its device
    and the process groups of its two axes (None for an axis of size 1,
    which needs no collective). Equal meshes are the same object, so a
    session can cache sharded parameters per mesh."""

    data: int
    model: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: str = "gloo"
    data_group: Any = None   # the ranks of this rank's model index, in data order
    model_group: Any = None  # the ranks of this rank's data index, in model order

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


def make_mesh(n_devices: Optional[int] = None, model: int = 1, device=None) -> Mesh:
    """Mesh of shape (data, model) over the ranks of the initialised
    ``torch.distributed`` world (``parallel.launch`` starts them). Every
    rank must call it, in the same order as any other group it creates."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n % model != 0:
        raise ValueError(f"n_devices {n} not divisible by model-parallel size {model}")
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} ranks, not {world}")
    data = n // model
    rank = dist.get_rank() if dist.is_initialized() else 0
    model_group = data_group = None
    if model > 1:
        for d in range(data):
            group = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                model_group = group
    if data > 1:
        for m in range(model):
            group = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                data_group = group
    device = torch.device(device) if device is not None else torch.device("cpu")
    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    return Mesh(data, model, rank, device, backend, data_group, model_group)


@contextlib.contextmanager
def patch_sharded(mesh: Optional[Mesh]):
    """Within this context the model runs sharded over ``mesh``: the
    encoder splits its pyramid patch batch over ``data``, the ViT blocks
    run tensor-parallel over ``model``. None runs it on one device."""
    token = _patch_ctx.set(mesh)
    try:
        yield
    finally:
        _patch_ctx.reset(token)


def active_model_parallel() -> Optional[Mesh]:
    """The enclosing mesh when its model axis is larger than 1, else None."""
    mesh = _patch_ctx.get()
    return mesh if mesh is not None and mesh.model > 1 else None


def active_data_mesh() -> Optional[Mesh]:
    """The enclosing mesh when its data axis is larger than 1, else None."""
    mesh = _patch_ctx.get()
    return mesh if mesh is not None and mesh.data > 1 else None


def shard_patches(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """This data rank's rows of the pyramid patch batch (35 * B, P, P, 3),
    zero-padded to the next multiple of ``data`` (35 -> 36 at data 2 or 4:
    18 or 9 per rank; 40 at data 8: 5), and the true count. A no-op
    outside a data-parallel ``patch_sharded`` context. The padding rides
    through the batch-independent ViT; ``gather_patches`` drops it."""
    n = x.shape[0]
    mesh = active_data_mesh()
    if mesh is None:
        return x, n
    per = -(-n // mesh.data)
    if per * mesh.data != n:
        x = torch.cat([x, x.new_zeros((per * mesh.data - n,) + tuple(x.shape[1:]))])
    return x[mesh.data_rank * per:(mesh.data_rank + 1) * per], n


def gather_patches(x: torch.Tensor, n: int) -> torch.Tensor:
    """All data ranks' rows of a patch-batch tensor, the padding sliced off:
    the inverse of ``shard_patches`` (a no-op outside a data mesh)."""
    mesh = active_data_mesh()
    if mesh is None:
        return x
    from matrix_eyes_tpu_torch.parallel.collectives import all_gather_rows

    return all_gather_rows(x, mesh, "data")[:n]


def batch_is_sharded(batch: int, mesh: Optional[Mesh] = None) -> bool:
    """Whether an image batch of ``batch`` splits over the data axis."""
    mesh = mesh if mesh is not None else active_data_mesh()
    return mesh is not None and mesh.data > 1 and batch % mesh.data == 0


def shard_batch(x: torch.Tensor, batch: Optional[int] = None, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """This data rank's images of a tile-major stack (tiles * batch, ...)
    (``batch`` defaults to the leading extent: a plain image batch) when the
    data axis divides ``batch``, else the whole stack (replicated). ``mesh``
    defaults to the enclosing ``patch_sharded`` context."""
    mesh = mesh if mesh is not None else active_data_mesh()
    batch = x.shape[0] if batch is None else batch
    if not batch_is_sharded(batch, mesh):
        return x
    per = batch // mesh.data
    tiles = x.reshape((x.shape[0] // batch, batch) + tuple(x.shape[1:]))
    local = tiles[:, mesh.data_rank * per:(mesh.data_rank + 1) * per]
    return local.reshape((-1,) + tuple(x.shape[1:]))


def gather_batch(x: torch.Tensor, batch: int) -> torch.Tensor:
    """The whole image batch of a (batch / data, ...) result: the inverse of
    ``shard_batch`` (a no-op where the batch ran replicated)."""
    mesh = active_data_mesh()
    if not batch_is_sharded(batch, mesh):
        return x
    from matrix_eyes_tpu_torch.parallel.collectives import all_gather_rows

    return all_gather_rows(x, mesh, "data")


# qkv keys whose output-feature axis spans [q|k|v], and their head-group
# renames: the float layout (qkv_w) and the int8 one (qkv_qw codes with
# their per-output-channel qkv_sw scales, which follow their columns)
_TP_QKV_RENAMES = {"qkv_w": "qkv_gw", "qkv_b": "qkv_gb",
                   "qkv_qw": "qkv_gqw", "qkv_sw": "qkv_gsw"}


def _tp_permute_qkv(blocks: Dict[str, Any], k: int) -> Dict[str, Any]:
    """Permute stacked-block qkv columns from [q|k|v] (heads contiguous in
    each section) to head-group-major [q_0|k_0|v_0|...|q_{k-1}|k_{k-1}|v_{k-1}]
    and rename the keys ``qkv_gw``/``qkv_gb`` (``qkv_gqw``/``qkv_gsw``/
    ``qkv_gb`` under int8), as the JAX package does.

    Split in k contiguous chunks, the checkpoint's [q|k|v] order would give
    rank 0 all of q and part of k; in head-group order each chunk holds the
    complete q, k and v of its own heads, exactly what the attention kernel
    reads with ``num_heads / k`` heads, and the output's feature order is
    the standard head order the row-split proj expects. The rename makes
    the layout self-describing: the ViT dispatches on the key, so a
    permuted tree is never read as a checkpoint-layout one. The degree is
    self-describing too: ``qkv_gb`` is stored grouped, (..., k, 3C / k),
    and its width 3C / k records k on every shard of it.

    The port stores int8 codes (out, in), so ``qkv_qw`` is permuted along
    its second-last axis; every other key along its last."""
    ref = blocks["qkv_qw"].shape[-2] if "qkv_qw" in blocks else blocks["qkv_w"].shape[-1]
    c = ref // 3
    per = c // k
    idx = np.concatenate([
        np.concatenate([sec * c + g * per + np.arange(per) for sec in range(3)])
        for g in range(k)
    ])
    idx = torch.from_numpy(idx)
    out = {key: v for key, v in blocks.items() if key not in _TP_QKV_RENAMES}
    for src, dst in _TP_QKV_RENAMES.items():
        if src in blocks:
            axis = -2 if src == "qkv_qw" else -1
            out[dst] = blocks[src].index_select(blocks[src].dim() + axis,
                                                idx.to(blocks[src].device))
    gb = out["qkv_gb"]
    out["qkv_gb"] = gb.reshape(tuple(gb.shape[:-1]) + (k, ref // k))
    return out


# The axis of a stacked block leaf (L, ...) that is split over "model";
# every other leaf is replicated. This is the JAX package's
# _vit_block_specs on the port's layouts: float weights (L, in, out),
# int8 codes (L, out, in). Column-parallel (qkv, fc1): the output axis,
# with its bias and its int8 scales; row-parallel (proj, fc2): the input
# axis, their scales (per output channel) and biases replicated.
BLOCK_SPLIT_AXIS = {
    "qkv_gw": 2, "qkv_gb": 1, "proj_w": 1, "fc1_w": 2, "fc1_b": 1, "fc2_w": 1,
    "qkv_gqw": 1, "qkv_gsw": 1, "proj_qw": 2, "fc1_qw": 1, "fc1_sw": 1, "fc2_qw": 2,
}


def _is_blocks(p: Dict[str, Any]) -> bool:
    return any(k in p for k in ("qkv_w", "qkv_qw", "qkv_gw", "qkv_gqw"))


def shard_params(params: Dict[str, Any], mesh: Mesh,
                 num_heads: Optional[int] = None) -> Dict[str, Any]:
    """This rank's parameters on ``mesh.device``: with a model axis of size
    k > 1 the stacked ViT blocks are permuted to the head-group layout and
    each split leaf keeps only this rank's 1/k; everything else is
    replicated. Place the tree on the CPU (or map it from a cache) first:
    only the shards are moved to the card, so a rank never holds the full
    ViT blocks there.

    The JAX package's checkpoint-layout TP (no ``num_heads``: GSPMD
    reshards the attention) is not ported: under k > 1 ``num_heads`` is
    required and must be divisible by k."""
    k = mesh.model
    if k > 1:
        if num_heads is None:
            raise ValueError("tensor parallelism needs num_heads: the port runs only the "
                             "head-group qkv layout")
        if num_heads % k != 0:
            raise ValueError(f"num_heads {num_heads} not divisible by model-parallel "
                             f"size {k}")

    def place(p):
        if isinstance(p, dict):
            if k > 1 and _is_blocks(p):
                if "qkv_w" in p or "qkv_qw" in p:
                    p = _tp_permute_qkv(p, k)
                return {key: _split(key, v, mesh) for key, v in p.items()}
            return {key: place(v) for key, v in p.items()}
        if isinstance(p, list):
            return [place(v) for v in p]
        return p.to(mesh.device)

    return place(params)


def _split(key: str, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    axis = BLOCK_SPLIT_AXIS.get(key)
    if axis is None:
        return t.to(mesh.device)
    per = t.shape[axis] // mesh.model
    return t.narrow(axis, mesh.model_rank * per, per).contiguous().to(mesh.device)
