"""Depth-grid triangulation, vectorised (the port's own copy of
``matrix_eyes_tpu/output/mesh.py``; host numpy, f32 like the reference,
since the file bytes follow f32 rounding).

The reference builds the mesh with nested per-quad loops and incremental
first-use vertex numbering (output.rs:264-363). Both are reproduced exactly:

* face masks: each quad contributes an upper-left [i00, i01, i10] and a
  lower-right [i10, i01, i11] triangle, kept iff max/min of its three
  inverse-depth values <= 1.025 (POLYGON_DEPTH_THRESHOLD, output.rs:40);
* traversal order (y outer, x inner, UL before LR) and first-use vertex
  numbering: the native ``index_mesh`` pass, or without it one np.unique
  over the kept faces' vertex stream, which numbers the same way.

Vertex geometry (output.rs:222-248): z = 1/inverse_depth, x = xmul *
(x_norm - 0.5) * z, y = ymul * (y_norm - 0.5) * z, where xmul/ymul undo the
square resize.
"""

from __future__ import annotations

import dataclasses

import numpy as np

POLYGON_DEPTH_THRESHOLD = np.float32(1.025)


@dataclasses.dataclass
class Mesh:
    vertex_orig_indices: np.ndarray  # (nv,) linear grid index per new vertex id
    faces: np.ndarray  # (nf, 3) int32, new vertex ids, traversal order
    grid_width: int
    grid_height: int

    @property
    def nvertices(self) -> int:
        return int(self.vertex_orig_indices.shape[0])

    @property
    def nfaces(self) -> int:
        return int(self.faces.shape[0])

    def vertex_xy(self):
        """(x_image, y_image) integer grid coordinates per vertex."""
        return (self.vertex_orig_indices % self.grid_width,
                self.vertex_orig_indices // self.grid_width)


def build_mesh(data: np.ndarray) -> Mesh:
    """data: (H, W) clamped inverse depth, f32. Returns the indexed mesh."""
    H, W = data.shape
    v00 = data[:-1, :-1]
    v10 = data[:-1, 1:]
    v01 = data[1:, :-1]
    v11 = data[1:, 1:]

    def keep(a, b, c):
        mx = np.maximum(np.maximum(a, b), c)
        mn = np.minimum(np.minimum(a, b), c)
        return mx / mn <= POLYGON_DEPTH_THRESHOLD

    keep_all = np.stack([keep(v00, v01, v10), keep(v10, v01, v11)], axis=2)

    # kept faces in (y, x, UL/LR) order, from the flat mask positions: quad
    # (y, x) has UL = [i00, i01, i10] and LR = [i10, i01, i11], i00 = y*W + x
    idx = np.flatnonzero(keep_all)
    w1 = W - 1
    y = idx // (2 * w1)
    rem = idx - y * (2 * w1)
    base = y * W + (rem >> 1)
    upper_left = (rem & 1) == 0
    f0 = np.where(upper_left, base, base + 1)
    f1 = base + W
    f2 = np.where(upper_left, base + 1, base + W + 1)
    faces = np.stack([f0, f1, f2], axis=1).astype(np.int64)

    from matrix_eyes_tpu_torch.native.meshwriter import index_mesh

    indexed = index_mesh(faces, H * W)
    if indexed is not None:
        vertex_orig, remapped = indexed
    else:
        uniq, first = np.unique(faces.reshape(-1), return_index=True)
        vertex_orig = uniq[np.argsort(first, kind="stable")]  # first-use order
        remap = np.full(H * W, -1, dtype=np.int64)
        remap[vertex_orig] = np.arange(vertex_orig.shape[0])
        remapped = remap[faces].astype(np.int32)
    return Mesh(vertex_orig_indices=vertex_orig, faces=remapped, grid_width=W, grid_height=H)


def vertex_geometry(mesh: Mesh, data: np.ndarray, original_size: tuple[int, int]):
    """Per-vertex (x, y, z) f64 coordinates in the reference's convention
    (before the writers' (x, -y, -z) flip). original_size = (width, height)
    of the source image."""
    W, H = mesh.grid_width, mesh.grid_height
    ow, oh = original_size
    xmul = np.float32(ow) / np.float32(max(ow, oh))
    ymul = np.float32(oh) / np.float32(max(ow, oh))
    xi, yi = mesh.vertex_xy()
    x_norm = xi.astype(np.float32) / np.float32(W)
    y_norm = yi.astype(np.float32) / np.float32(H)
    z = np.float32(1.0) / data.reshape(-1)[mesh.vertex_orig_indices]
    x = xmul * (x_norm - np.float32(0.5)) * z
    y = ymul * (y_norm - np.float32(0.5)) * z
    return (x.astype(np.float64), y.astype(np.float64), z.astype(np.float64))


def vertex_colors(mesh: Mesh, image_rgb: np.ndarray) -> np.ndarray:
    """Per-vertex u8 RGB from the source image resized to the grid
    (output.rs:206-215, 236-239). image_rgb: (H, W, 3) u8."""
    xi, yi = mesh.vertex_xy()
    return image_rgb[yi, xi]


def vertex_uvs(mesh: Mesh):
    """Normalised (u, v) per vertex (output.rs:228-233)."""
    xi, yi = mesh.vertex_xy()
    u = xi.astype(np.float32) / np.float32(mesh.grid_width)
    v = yi.astype(np.float32) / np.float32(mesh.grid_height)
    return u, v
