"""The PyTorch port's mesh output (OBJ/PLY) against the JAX package.

The mesh arithmetic is host numpy f32 in both packages, so given the same
depth grid and image the port must write the JAX writers' bytes, in all
three vertex modes, through the native serializer and the Python writer
alike, and the golden files of tests/golden. Through the CLI the two
models differ by f32 rounding, which can flip the 1.025 face-ratio test of
a quad: there the inverse depth is held to the model tolerance and the
files to their structure.
"""

import hashlib
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from matrix_eyes_tpu import cli as jcli
from matrix_eyes_tpu.config import TINY as J_TINY
from matrix_eyes_tpu.native import meshwriter as jmeshwriter
from matrix_eyes_tpu.output import depthmap as jdepthmap
from matrix_eyes_tpu.output import mesh as jmesh
from matrix_eyes_tpu.output import writers as jwriters
from matrix_eyes_tpu.output.rust_format import format_f64 as j_format_f64
from matrix_eyes_tpu_torch import cli as tcli
from matrix_eyes_tpu_torch.errors import OutputError
from matrix_eyes_tpu_torch.native import meshwriter as tmeshwriter
from matrix_eyes_tpu_torch.output import depthmap as tdepthmap
from matrix_eyes_tpu_torch.output import mesh as tmesh
from matrix_eyes_tpu_torch.output import writers as twriters
from matrix_eyes_tpu_torch.output.rust_format import format_f64

import torch_ref
from test_golden_outputs import DATA, IMG, ORIGINAL_SIZE, PLY_PLAIN_SHA256

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
MODES = ["plain", "vertex-colors", "texture-coordinates"]


# --- format_f64 ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["unit", "wide", "tiny", "huge", "integers", "f32"])
def test_format_f64_matches_jax_on_seeded_values(kind):
    rng = np.random.RandomState(sum(map(ord, kind)))
    vals = {
        "unit": rng.uniform(-1, 1, 500),
        "wide": rng.uniform(-1, 1, 500) * 10.0 ** rng.randint(-12, 12, 500),
        "tiny": rng.uniform(-1, 1, 200) * 10.0 ** rng.randint(-320, -290, 200),
        "huge": rng.uniform(-1, 1, 200) * 10.0 ** rng.randint(15, 308, 200),
        "integers": rng.randint(-10 ** 6, 10 ** 6, 200).astype(np.float64),
        "f32": rng.uniform(-30, 30, 500).astype(np.float32).astype(np.float64),
    }[kind]
    for v in vals:
        assert format_f64(float(v)) == j_format_f64(float(v)), v


@pytest.mark.parametrize("v,want", [
    (1.0, "1"), (-1.5, "-1.5"), (0.0, "0"), (-0.0, "-0"),
    (1e-7, "0.0000001"), (1.25e-5, "0.0000125"), (1e16, "10000000000000000"),
    (1.5e22, "15000000000000000000000"), (5e-324, "0." + "0" * 323 + "5"),
    (float("nan"), "NaN"), (float("inf"), "inf"), (float("-inf"), "-inf"),
    (0.1 + 0.2, "0.30000000000000004"),
])
def test_format_f64_edge_cases(v, want):
    assert format_f64(v) == want == j_format_f64(v)


# --- native library ---------------------------------------------------------------

def test_meshwriter_copy_builds_into_the_ports_build_dir():
    from matrix_eyes_tpu_torch import native

    assert tmeshwriter.available()
    assert os.path.dirname(tmeshwriter._lib._name) == native.BUILD_DIR


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_index_mesh_matches_jax(seed):
    rng = np.random.RandomState(seed)
    faces = rng.randint(0, 400, (300, 3)).astype(np.int64)
    want_v, want_f = jmeshwriter.index_mesh(faces, 400)
    got_v, got_f = tmeshwriter.index_mesh(faces, 400)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)
    assert got_f.dtype == np.int32 and got_v.dtype == np.int64


@pytest.mark.parametrize("mode", MODES)
def test_native_write_obj_matches_jax(tmp_path, mode):
    rng = np.random.RandomState(3)
    nv, nf = 50, 70
    x, y, z = (rng.uniform(-3, 3, nv) for _ in range(3))
    rgb = rng.randint(0, 256, (nv, 3)).astype(np.uint8) if mode == "vertex-colors" else None
    uvs = ((rng.uniform(0, 1, nv).astype(np.float32), rng.uniform(0, 1, nv).astype(np.float32))
           if mode == "texture-coordinates" else None)
    faces = rng.randint(0, nv, (nf, 3)).astype(np.int32)
    texture = uvs is not None
    a, b = str(tmp_path / "j.obj"), str(tmp_path / "t.obj")
    assert jmeshwriter.write_obj(a, x, y, z, rgb, uvs, faces, texture, "j")
    assert tmeshwriter.write_obj(b, x, y, z, rgb, uvs, faces, texture, "j")
    assert open(b, "rb").read() == open(a, "rb").read()


# --- build_mesh ------------------------------------------------------------------

def _grid(seed: int, shape=(23, 31)) -> np.ndarray:
    """Inverse depth whose neighbours sit around the 1.025 ratio, with exact
    edge cases: a ratio of exactly 1.025 in f32 (kept) and the next f32
    above it (dropped)."""
    rng = np.random.RandomState(seed)
    data = (1.0 + 0.03 * rng.uniform(0, 1, shape)).astype(np.float32)
    data *= np.float32(rng.uniform(0.1, 5))
    data[0, :4] = [1.0, np.float32(1.025), 1.0, 1.0]
    data[1, :4] = [1.0, 1.0, np.nextafter(np.float32(1.025), np.float32(2)), 1.0]
    return data


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("native", [True, False])
def test_build_mesh_matches_jax(monkeypatch, seed, native):
    data = _grid(seed)
    want = jmesh.build_mesh(data)
    if not native:  # the numpy numbering, the path without the library
        monkeypatch.setattr(tmeshwriter, "index_mesh", lambda faces, size: None)
    got = tmesh.build_mesh(data)
    assert 0 < got.nfaces < 2 * 22 * 30  # the ratio test keeps some faces, drops others
    np.testing.assert_array_equal(got.vertex_orig_indices, want.vertex_orig_indices)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.faces.dtype == want.faces.dtype
    assert (got.grid_width, got.grid_height) == (want.grid_width, want.grid_height)


def test_build_mesh_ratio_edge():
    # quad (0, 0): UL [1, 1, 1.025] kept, LR [1.025, 1, 1] kept; quad (0, 1):
    # UL [1.025, 1, 1] kept, LR [1, 1, next(1.025)] dropped
    data = _grid(0)[:2, :4].copy()
    data[0, 1], data[1, 2] = np.float32(1.025), np.nextafter(np.float32(1.025), np.float32(2))
    got = tmesh.build_mesh(data)
    want = jmesh.build_mesh(data)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.nfaces == want.nfaces == 3


@pytest.mark.parametrize("seed", [4, 5])
def test_vertex_attributes_match_jax(seed):
    data = _grid(seed)
    img = np.random.RandomState(seed).randint(0, 256, data.shape + (3,), dtype=np.uint8)
    mj, mt = jmesh.build_mesh(data), tmesh.build_mesh(data)
    for got, want in zip(tmesh.vertex_geometry(mt, data, (640, 480)),
                         jmesh.vertex_geometry(mj, data, (640, 480))):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tmesh.vertex_colors(mt, img), jmesh.vertex_colors(mj, img))
    for got, want in zip(tmesh.vertex_uvs(mt), jmesh.vertex_uvs(mj)):
        np.testing.assert_array_equal(got, want)


# --- writers ---------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ext,native", [("ply", None), ("obj", True), ("obj", False)])
def test_writers_bytes_match_jax(tmp_path, mode, ext, native):
    data = _grid(6, (17, 26))
    img = np.random.RandomState(6).randint(0, 256, data.shape + (3,), dtype=np.uint8)
    mesh_j, mesh_t = jmesh.build_mesh(data), tmesh.build_mesh(data)
    rgb = img if mode == "vertex-colors" else None
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    pj, pt = str(tmp_path / "j" / f"m.{ext}"), str(tmp_path / "t" / f"m.{ext}")
    if ext == "ply":
        jwriters.write_ply(pj, mesh_j, data, (52, 34), mode, rgb)
        twriters.write_ply(pt, mesh_t, data, (52, 34), mode, rgb)
    else:
        jwriters.write_obj(pj, mesh_j, data, (52, 34), mode, rgb, "src.jpg", use_native=native)
        twriters.write_obj(pt, mesh_t, data, (52, 34), mode, rgb, "src.jpg", use_native=native)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    if mode == "texture-coordinates" and ext == "obj":
        assert (tmp_path / "t" / "m.mtl").read_bytes() == (tmp_path / "j" / "m.mtl").read_bytes()
    else:
        assert not (tmp_path / "t" / "m.mtl").exists()


@pytest.mark.parametrize("write", [
    lambda p, m: twriters.write_ply(p + ".ply", m, DATA, ORIGINAL_SIZE, "vertex-colors"),
    lambda p, m: twriters.write_obj(p + ".obj", m, DATA, ORIGINAL_SIZE, "vertex-colors"),
])
def test_vertex_colors_need_an_image(tmp_path, write):
    with pytest.raises(OutputError, match="no source image"):
        write(str(tmp_path / "m"), tmesh.build_mesh(DATA))


# --- golden files (the fixtures of tests/test_golden_outputs.py) -----------------

@pytest.fixture(scope="module")
def golden_mesh():
    m = tmesh.build_mesh(DATA)
    assert (m.nvertices, m.nfaces) == (9, 8)
    return m


@pytest.mark.parametrize("use_native", [False, True])
def test_obj_vertex_colors_golden(golden_mesh, tmp_path, use_native):
    out = str(tmp_path / "golden.obj")
    twriters.write_obj(out, golden_mesh, DATA, ORIGINAL_SIZE, "vertex-colors", IMG,
                       use_native=use_native)
    assert open(out).read() == open(os.path.join(GOLDEN_DIR, "golden.obj")).read()


@pytest.mark.parametrize("use_native", [False, True])
def test_obj_texture_golden(golden_mesh, tmp_path, use_native):
    out = str(tmp_path / "golden_tex.obj")
    twriters.write_obj(out, golden_mesh, DATA, ORIGINAL_SIZE, "texture-coordinates", None,
                       source_image_path="s.jpg", use_native=use_native)
    assert open(out).read() == open(os.path.join(GOLDEN_DIR, "golden_tex.obj")).read()
    assert open(str(tmp_path / "golden_tex.mtl")).read().startswith("newmtl Textured\n")


def test_ply_plain_golden(golden_mesh, tmp_path):
    out = str(tmp_path / "golden.ply")
    twriters.write_ply(out, golden_mesh, DATA, ORIGINAL_SIZE, "plain")
    raw = open(out, "rb").read()
    assert len(raw) == 520
    assert hashlib.sha256(raw).hexdigest() == PLY_PLAIN_SHA256


# --- DepthMap mesh output ----------------------------------------------------------

def _rotated_jpeg(path, size=(37, 53)):
    """A JPEG whose EXIF orientation says rotate: the grid image must ignore
    it, as the reference does."""
    rgb = np.random.RandomState(8).randint(0, 256, size + (3,), dtype=np.uint8)
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(rgb).save(path, quality=95, exif=exif)


@pytest.mark.parametrize("grid", [(96, 64), (40, 41)])
def test_load_grid_image_matches_jax(tmp_path, grid):
    # both resize the same u8 pixels with Lanczos3 in f32 (held to rtol
    # 1e-5 / atol 2e-4 in test_torch_ops.py), then round: a value that close
    # to a rounding boundary may land one count apart
    path = str(tmp_path / "src.jpg")
    _rotated_jpeg(path)
    want = np.asarray(jdepthmap.DepthMap._load_grid_image(path, grid)).astype(int)
    got = tdepthmap.DepthMap._load_grid_image(path, grid, "cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == grid + (3,)
    diff = np.abs(got.numpy().astype(int) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_load_grid_image_missing_file_is_an_output_error(tmp_path):
    with pytest.raises(OutputError, match="Image error"):
        tdepthmap.DepthMap._load_grid_image(str(tmp_path / "nope.jpg"), (8, 8), "cpu")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ext", ["obj", "ply"])
def test_output_image_mesh_matches_jax_bytes(tmp_path, mode, ext):
    # the same clamped grid and the same source file: the same bytes, the
    # vertex colours within the grid image's one count (none at this seed)
    data = _grid(9, (32, 48))
    src = str(tmp_path / "src.png")
    Image.fromarray(np.random.RandomState(9).randint(0, 256, (60, 90, 3), dtype=np.uint8)).save(src)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    pj, pt = str(tmp_path / "j" / f"m.{ext}"), str(tmp_path / "t" / f"m.{ext}")
    jdepthmap.DepthMap.new(jnp.asarray(data), (90, 60)).output_image(
        pj, src, vertex_mode=jdepthmap.VertexMode(mode))
    tdepthmap.DepthMap.new(torch.from_numpy(data), (90, 60)).output_image(
        pt, src, vertex_mode=tdepthmap.VertexMode(mode))
    assert open(pt, "rb").read() == open(pj, "rb").read()


# --- the slice through the CLI -------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mesh_cli")
    tm = torch_ref.randomize(torch_ref.DepthPro(J_TINY), seed=5)
    ckpt = d / "tiny.pt"
    torch.save(tm.state_dict(), str(ckpt))
    img = np.random.RandomState(0).randint(0, 256, size=(40, 60, 3), dtype=np.uint8)
    src = d / "src.jpg"
    Image.fromarray(img).save(str(src), quality=95)
    return d, str(ckpt), str(src)


def _ply_header(raw: bytes):
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode()
    nv = int(header.split("element vertex ")[1].split("\n")[0])
    nf = int(header.split("element face ")[1].split("\n")[0])
    return header, nv, nf, raw[end:]


def _obj_counts(text: str):
    lines = text.splitlines()
    return (sum(ln.startswith("v ") for ln in lines), sum(ln.startswith("vt ") for ln in lines),
            sum(ln.startswith("f ") for ln in lines))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ext", ["obj", "ply"])
def test_cli_mesh_matches_jax_cli(workdir, monkeypatch, mode, ext):
    d, ckpt, src = workdir
    seen = {}
    for name, cls in (("torch", tdepthmap.DepthMap), ("jax", jdepthmap.DepthMap)):
        def wrapped(self, *a, _real=cls.output_image, _name=name, **kw):
            seen[_name] = self
            return _real(self, *a, **kw)

        monkeypatch.setattr(cls, "output_image", wrapped)
    (d / "t").mkdir(exist_ok=True)
    (d / "j").mkdir(exist_ok=True)
    tout, jout = str(d / "t" / f"m_{mode}.{ext}"), str(d / "j" / f"m_{mode}.{ext}")
    flags = [f"--checkpoint-path={ckpt}", "--focal-length=28", f"--mesh={mode}"]
    assert tcli.main(flags + [src, tout], device="cpu") == 0
    assert jcli.main(flags + [src, jout]) == 0
    # the inverse depth: the f32 model tolerance of the forward
    # (tests/test_torch_model.py: test_forward_with_fnorm)
    tdata, jdata = seen["torch"].data.numpy(), np.asarray(seen["jax"].data)
    np.testing.assert_allclose(tdata, jdata, rtol=2e-3, atol=1e-4)
    # the files' structure: the counts follow each package's own grid
    mesh_t = tmesh.build_mesh(tdata)
    mesh_j = jmesh.build_mesh(jdata)
    assert abs(mesh_t.nfaces - mesh_j.nfaces) <= 1e-3 * mesh_j.nfaces
    if ext == "ply":
        t_header, nv, nf, body = _ply_header(open(tout, "rb").read())
        j_header, *_ = _ply_header(open(jout, "rb").read())
        assert (nv, nf) == (mesh_t.nvertices, mesh_t.nfaces)
        strip = [ln for ln in t_header.splitlines() if not ln.startswith("element")]
        assert strip == [ln for ln in j_header.splitlines() if not ln.startswith("element")]
        vbytes = nv * (24 + (3 if mode == "vertex-colors" else 0))
        assert len(body) == vbytes + nf * 13
        n, *idx = struct.unpack_from(">BIII", body, vbytes)
        assert n == 3 and max(idx) < nv
    else:
        text = open(tout).read()
        nv, nvt, nf = _obj_counts(text)
        assert (nv, nf) == (mesh_t.nvertices, mesh_t.nfaces)
        assert nvt == (nv if mode == "texture-coordinates" else 0)
        first_v = next(ln for ln in text.splitlines() if ln.startswith("v "))
        jfirst_v = next(ln for ln in open(jout).read().splitlines() if ln.startswith("v "))
        assert len(first_v.split()) == len(jfirst_v.split()) == (7 if mode == "vertex-colors"
                                                                 else 4)
        assert "e" not in first_v.replace("v ", "", 1)  # no exponent floats
        if mode == "texture-coordinates":
            assert text.startswith(f"mtllib m_{mode}.mtl\nusemtl Textured\n")
            mtl = open(str(d / "t" / f"m_{mode}.mtl")).read()
            jmtl = open(str(d / "j" / f"m_{mode}.mtl")).read()
            assert mtl == jmtl and f"map_Kd {src}" in mtl


def test_cli_mesh_fov_path(workdir):
    # no focal length: the FOV head runs, a PLY with vertex colours
    d, ckpt, src = workdir
    out = str(d / "fov.ply")
    assert tcli.main([f"--checkpoint-path={ckpt}", src, out], device="cpu") == 0
    header, nv, nf, body = _ply_header(open(out, "rb").read())
    assert "property uchar red" in header and len(body) == nv * 27 + nf * 13
