"""OBJ / PLY mesh serialisation (the port's own copy of
``matrix_eyes_tpu/output/writers.py``; reference output.rs:365-630).

Formats, byte for byte the JAX package's:

* PLY: ascii header, ``format binary_big_endian 1.0``, double x/y/z with the
  (x, -y, -z) flip, optional uchar RGB (vertex-colors mode only), faces as
  uchar 3 + three big-endian u32 (output.rs:414-482), assembled with numpy
  big-endian structured arrays;
* OBJ: ascii ``v x -y -z [r g b]`` with Rust Display floats
  (``rust_format``), ``vt u 1-v`` only in texture mode, 1-based faces
  ``f i`` / ``f i/i``, and the ``.mtl`` material file in texture mode
  (output.rs:484-630). The native serializer writes the text when it is
  available; the Python writer is the reference implementation.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from matrix_eyes_tpu_torch.errors import OutputError
from matrix_eyes_tpu_torch.output.mesh import Mesh, vertex_colors, vertex_geometry, vertex_uvs
from matrix_eyes_tpu_torch.output.rust_format import format_f64

PLAIN = "plain"
COLOR = "vertex-colors"
TEXTURE = "texture-coordinates"


def write_ply(
    path: str,
    mesh: Mesh,
    data: np.ndarray,
    original_size: tuple[int, int],
    vertex_mode: str,
    image_rgb: Optional[np.ndarray] = None,
) -> None:
    x, y, z = vertex_geometry(mesh, data, original_size)
    with_color = vertex_mode == COLOR
    header = [
        "ply",
        "format binary_big_endian 1.0",
        "comment Matrix Eyes 3D surface",
        f"element vertex {mesh.nvertices}",
        "property double x",
        "property double y",
        "property double z",
    ]
    fields = [(">x", ">f8"), (">y", ">f8"), (">z", ">f8")]
    if with_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        fields += [("r", "u1"), ("g", "u1"), ("b", "u1")]
    header += [
        f"element face {mesh.nfaces}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    verts = np.empty(mesh.nvertices, dtype=np.dtype(fields))
    verts[">x"] = x
    verts[">y"] = -y
    verts[">z"] = -z
    if with_color:
        if image_rgb is None:
            raise OutputError("vertex colors requested but no source image provided")
        rgb = vertex_colors(mesh, image_rgb)
        verts["r"] = rgb[:, 0]
        verts["g"] = rgb[:, 1]
        verts["b"] = rgb[:, 2]
    faces = np.empty(mesh.nfaces, dtype=np.dtype([("n", "u1"), ("i0", ">u4"), ("i1", ">u4"),
                                                  ("i2", ">u4")]))
    faces["n"] = 3
    faces["i0"] = mesh.faces[:, 0]
    faces["i1"] = mesh.faces[:, 1]
    faces["i2"] = mesh.faces[:, 2]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(verts.tobytes())
        f.write(faces.tobytes())


def write_obj(
    path: str,
    mesh: Mesh,
    data: np.ndarray,
    original_size: tuple[int, int],
    vertex_mode: str,
    image_rgb: Optional[np.ndarray] = None,
    source_image_path: str = "",
    use_native: bool = True,
) -> None:
    """``use_native``: write the text with the native serializer when it is
    available (the bytes are the same either way)."""
    from matrix_eyes_tpu_torch.native import meshwriter

    x, y, z = vertex_geometry(mesh, data, original_size)
    texture = vertex_mode == TEXTURE
    rgb = None
    if vertex_mode == COLOR:
        if image_rgb is None:
            raise OutputError("vertex colors requested but no source image provided")
        rgb = vertex_colors(mesh, image_rgb)
    uvs = vertex_uvs(mesh) if texture else None
    stem = os.path.splitext(os.path.basename(path))[0]
    if not (use_native and meshwriter.write_obj(path, x, -y, -z, rgb, uvs, mesh.faces, texture,
                                                stem)):
        _obj_python(path, mesh, x, y, z, rgb, uvs, texture, stem)
    if texture:
        _write_mtl(path, stem, source_image_path)


def _obj_python(path, mesh, x, y, z, rgb, uvs, texture, stem) -> None:
    out = []
    if texture:
        out.append(f"mtllib {stem}.mtl")
        out.append("usemtl Textured")
        u, v = uvs
        for i in range(mesh.nvertices):
            out.append(f"vt {format_f64(float(np.float64(u[i])))} "
                       f"{format_f64(float(np.float64(1.0) - np.float64(v[i])))}")
    nx, ny, nz = x, -y, -z
    if rgb is not None:
        r = rgb.astype(np.float64) / 255.0
        for i in range(mesh.nvertices):
            out.append(
                f"v {format_f64(nx[i])} {format_f64(ny[i])} {format_f64(nz[i])}"
                f" {format_f64(r[i, 0])} {format_f64(r[i, 1])} {format_f64(r[i, 2])}")
    else:
        for i in range(mesh.nvertices):
            out.append(f"v {format_f64(nx[i])} {format_f64(ny[i])} {format_f64(nz[i])}")
    faces1 = mesh.faces + 1
    if texture:
        for a, b, c in faces1:
            out.append(f"f {a}/{a} {b}/{b} {c}/{c}")
    else:
        for a, b, c in faces1:
            out.append(f"f {a} {b} {c}")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def _write_mtl(obj_path: str, stem: str, image_path: str) -> None:
    """Material file for texture mode (output.rs:525-547)."""
    directory = os.path.dirname(obj_path) or "."
    lines = [
        "newmtl Textured",
        "Ka 0.2 0.2 0.2",
        "Kd 0.8 0.8 0.8",
        "Ks 1.0 1.0 1.0",
        "illum 2",
        "Ns 0.000500",
        f"map_Ka {image_path}",
        f"map_Kd {image_path}",
        "",
    ]
    with open(os.path.join(directory, f"{stem}.mtl"), "w") as f:
        f.write("\n".join(lines) + "\n")
