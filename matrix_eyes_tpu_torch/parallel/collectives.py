"""The collectives of the sharded forward, over one axis of a ``Mesh``, and
their counts.

On the TPU, XLA inserts these collectives and the JAX package reads them
off the compiled program (``parallel/production_check.py``, an HLO text
check). The port calls them itself through ``torch.distributed``: NCCL
between cards, gloo on the CPU. Each call is counted in the kernels'
launch ledger (``ops._build.ledger``) under its kind, with its result's
shape and dtype on this rank, as a kernel wrapper counts its launches;
``stats`` and ``gather_shapes`` read calls, bytes and shapes from it, and
``check_forward`` holds a forward's counts to the invariants the JAX
package checks in the HLO. An axis of size 1 needs no collective: the call
returns its input and counts nothing.

The mesh has exactly the two axes (data, model) and ``Mesh.model`` is the
one model-parallel degree every caller reads, so the JAX check's fault of
deriving the degree two ways (once from the mesh's non-data axes, once
from the layout) cannot arise here.

A gloo group cannot take a CUDA tensor for every collective (several ranks
sharing one card run over gloo), so for that backend a CUDA tensor is
copied through pinned host memory, explicitly; NCCL takes it as it is.

Under NCCL a collective is a kernel on a stream and does nothing a CUDA
graph capture forbids (no host read, no pinned buffer, no sync; the
gathered parts' ``torch.cat`` allocates from the graph's pool), so the
mesh's forwards are captured with their collectives (``aot.mesh_cache``).
gloo's exchange is host work that a graph cannot record: a gloo collective
called while the current stream captures raises RuntimeError, naming its
kind, rather than being left out of the graph.
"""

from __future__ import annotations

import math
from typing import List

import torch

from matrix_eyes_tpu_torch.ops import _build
from matrix_eyes_tpu_torch.parallel.sharding import Mesh

_KINDS = ("all-reduce", "all-gather", "broadcast")


def stats() -> dict:
    """{kind: {"calls": n, "bytes": b}} since the ledger's last ``reset``,
    for each kind called."""
    out = {}
    for kind in _KINDS:
        calls = _build.launches(kind)
        if calls:
            out[kind] = {"calls": calls.total(),
                         "bytes": sum(n * math.prod(shape) * dtype.itemsize
                                      for (shape, dtype), n in calls.items())}
    return out


def gather_shapes() -> List[tuple]:
    """The all-gathers' result shapes since the ledger's last ``reset``, one
    per call."""
    return [shape for (shape, _dtype), n in _build.launches("all-gather").items()
            for _ in range(n)]


def _group(mesh: Mesh, axis: str):
    """(process group, size) of ``axis``."""
    if axis == "data":
        return mesh.data_group, mesh.data
    if axis == "model":
        return mesh.model_group, mesh.model
    raise ValueError(f"unknown mesh axis {axis!r}; expected 'data' or 'model'")


def _count(kind: str, result: torch.Tensor) -> None:
    _build.record(kind, tuple(result.shape), result.dtype)


def _staged(mesh: Mesh, t: torch.Tensor, kind: str) -> torch.Tensor:
    """The tensor the backend can take: a pinned host copy of a CUDA tensor
    under gloo, else ``t`` itself or, where it is not contiguous (the
    backends read raw storage), a contiguous copy. Raises for a gloo
    ``kind`` of collective called during a CUDA graph capture."""
    if mesh.backend == "gloo" and t.is_cuda:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"a gloo {kind} cannot be captured in a CUDA graph: gloo "
                               "exchanges host memory, which a replay would skip")
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t.contiguous()


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axis``, on every one of them
    (in ``t`` itself where the backend takes it as it is)."""
    import torch.distributed as dist

    group, size = _group(mesh, axis)
    if size == 1:
        return t
    buf = _staged(mesh, t, "all-reduce")
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    out = buf.to(t.device)
    _count("all-reduce", out)
    return out


def all_gather_rows(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The ranks' ``t`` of ``axis`` concatenated along the first axis, in
    the axis's rank order, on every one of them."""
    import torch.distributed as dist

    group, size = _group(mesh, axis)
    if size == 1:
        return t
    buf = _staged(mesh, t, "all-gather")
    parts = [torch.empty_like(buf) for _ in range(size)]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat(parts).to(t.device)
    _count("all-gather", out)
    return out


def broadcast(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank of the mesh (in place where the
    backend takes ``t`` as it is); returns it."""
    import torch.distributed as dist

    if mesh.size == 1:
        return t
    buf = _staged(mesh, t, "broadcast")
    dist.broadcast(buf, src=src)
    if buf is not t:
        t.copy_(buf)
    _count("broadcast", t)
    return t


def check_forward(cfg, mesh: Mesh, batch: int, n_vits: int = 3, forwards: int = 1) -> dict:
    """Hold the counts of ``forwards`` forwards of ``batch`` images each
    (counted from the ledger's ``reset`` just before them) to the sharded
    layout's invariants, the run-time form of the JAX package's HLO check; raise
    RuntimeError on a broken one. ``n_vits``: 3 with the FOV head, 2
    without.

    * under model > 1: two all-reduces per block per ViT (proj and fc2),
      f32 partial products;
    * no all-gather has a token-sized axis: attention stays local to a rank;
    * under data > 1: the patch merge all-gathers the final tokens and the
      two highres intermediates, each with the padded pyramid's rows, so
      each rank ran padded / data of them.
    Returns the counts and the patch rows per rank."""
    from matrix_eyes_tpu_torch.parallel.sharding import batch_is_sharded

    n_patches = 35 * batch
    padded = -(-n_patches // mesh.data) * mesh.data
    want_reduces = forwards * 2 * cfg.depth * n_vits if mesh.model > 1 else 0
    reduces = _build.launches("all-reduce").total()
    gathers = gather_shapes()
    problems = []
    if reduces != want_reduces:
        problems.append(f"{reduces} all-reduces, expected {want_reduces}")
    token_gathers = [s for s in gathers if cfg.seq_len in s[1:]]
    if token_gathers:
        problems.append(f"all-gathers with a token-sized axis: {token_gathers}")
    s = cfg.tokens_per_side
    merge = [g for g in gathers if g[1:3] == (s, s) and g[0] == padded]
    want_merge = 3 * forwards if mesh.data > 1 else 0
    if len(merge) != want_merge:
        problems.append(f"{len(merge)} patch-merge all-gathers of {padded} rows, expected "
                        f"{want_merge} (all-gathers: {gathers})")
    # a sharded batch gathers its inverse depth, and its FOV where the head ran
    want_gathers = want_merge + forwards * ((2 if n_vits == 3 else 1)
                                            if batch_is_sharded(batch, mesh) else 0)
    if len(gathers) != want_gathers:
        problems.append(f"{len(gathers)} all-gathers, expected {want_gathers}")
    if problems:
        raise RuntimeError("sharded forward broke the layout's invariants: " + "; ".join(problems))
    return {"collectives": stats(), "patch_rows_per_rank": padded // mesh.data,
            "gather_shapes": gathers}
