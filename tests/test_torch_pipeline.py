"""The PyTorch port's preprocess, depth-map output, pipeline and CLI against
the JAX package."""

import collections
import io
import os
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from matrix_eyes_tpu import cli as jcli
from matrix_eyes_tpu.config import TINY as J_TINY
from matrix_eyes_tpu.output import depthmap as jdepthmap
from matrix_eyes_tpu.output import png as jpng
from matrix_eyes_tpu.pipeline import preprocess_image as j_preprocess
from matrix_eyes_tpu_torch import cli as tcli
from matrix_eyes_tpu_torch import native, timings
from matrix_eyes_tpu_torch.config import TINY, RuntimeConfig
from matrix_eyes_tpu_torch.errors import ReconstructionError
from matrix_eyes_tpu_torch.io.image import SourceImage
from matrix_eyes_tpu_torch.models.init import init_params
from matrix_eyes_tpu_torch.native import stagecopy
from matrix_eyes_tpu_torch.ops import _build
from matrix_eyes_tpu_torch.output import depthmap as tdepthmap
from matrix_eyes_tpu_torch.output import png as tpng
from matrix_eyes_tpu_torch.pipeline import extract_depth, preprocess_image, stage

import torch_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _u8_counts(x) -> np.ndarray:
    """Normalised model input back to u8 counts."""
    return np.rint((np.asarray(x, np.float64) + 1.0) * 127.5).astype(np.int64)


def test_preprocess_matches_jax():
    # the Lanczos3 matmuls sum in another order: a value within 1 ulp of a
    # rounding boundary may land one count apart (bound: <= 1 count on
    # <= 1e-4 of values)
    rgb = np.random.RandomState(0).randint(0, 256, (96, 128, 3), dtype=np.uint8)
    want = _u8_counts(j_preprocess(jnp.asarray(rgb), 1536, jnp.float32))
    got = preprocess_image(rgb, 1536, torch.float32, "cpu")
    assert tuple(got.shape) == (1, 1536, 1536, 3) and got.dtype == torch.float32
    diff = np.abs(_u8_counts(got.numpy()) - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-4


def _photo(kind: str) -> np.ndarray:
    """A seeded (40, 56, 3) u8 photo: contiguous, a strided view of a wider
    array, read-only (as ``np.asarray`` gives a decoded PIL image), or a
    view with a negative stride."""
    rng = np.random.RandomState(5)
    if kind == "strided":
        return rng.randint(0, 256, (40, 64, 3), dtype=np.uint8)[:, 3:59]
    rgb = rng.randint(0, 256, (40, 56, 3), dtype=np.uint8)
    if kind == "read_only":
        rgb.flags.writeable = False
    return rgb[::-1] if kind == "reversed" else rgb


@pytest.mark.parametrize("kind", ["contiguous", "strided", "read_only", "reversed"])
def test_stage_copies_the_pixels(kind):
    # the staging helper, given an ordinary host buffer where the card's
    # path gives a pinned one: the caller's pixels bit for bit, no warning
    # (torch.from_numpy warns of a read-only array), the array unchanged
    rgb = _photo(kind)
    want = rgb.copy()
    host = torch.empty(rgb.shape, dtype=torch.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = stage(rgb, host)
    assert got is host
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(rgb, want)


def test_native_stage_copy_builds_and_checks_its_arguments():
    assert stagecopy.available()
    assert os.path.dirname(stagecopy._lib._name) == native.BUILD_DIR
    rgb = _photo("contiguous")
    with pytest.raises(ValueError):
        stagecopy.copy(rgb, np.empty(rgb.nbytes + 1, np.uint8), 2)
    with pytest.raises(ValueError):
        stagecopy.copy(_photo("strided"), np.empty(rgb.shape, np.uint8), 2)
    out = np.empty(rgb.nbytes, np.uint8)
    stagecopy.copy(rgb, out, 2)
    np.testing.assert_array_equal(out, rgb.reshape(-1))


def test_stage_from_many_threads_at_once():
    # callers on more threads than cores share the native copy's helper
    # pool: each call returns its own pixels whole, whoever copied them
    errors, switch = [], sys.getswitchinterval()

    def work(seed):
        rng = np.random.RandomState(seed)
        for _ in range(20):
            rgb = rng.randint(0, 256, (rng.randint(1, 1500), 640, 3), dtype=np.uint8)
            got = stage(rgb, torch.empty(rgb.shape, dtype=torch.uint8))
            if not np.array_equal(got.numpy(), rgb):
                errors.append(seed)

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(seed,))
                   for seed in range(2 * (os.cpu_count() or 1) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


@pytest.mark.parametrize("entry", ["stage", "preprocess_image"])
def test_caller_may_overwrite_its_photo_after_the_call(entry):
    rgb = _photo("contiguous")
    keep = rgb.copy()
    if entry == "stage":
        got = stage(rgb, torch.empty(rgb.shape, dtype=torch.uint8))
        want = torch.from_numpy(keep)
    else:
        got = preprocess_image(rgb, 128, torch.float32, "cpu")
        want = preprocess_image(keep, 128, torch.float32, "cpu")
    rgb[...] = 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("given, path", [("numpy", "host"), ("tensor", "device")])
def test_upload_counts_its_path(given, path, monkeypatch):
    # one count of ("upload", path) in the launch ledger a photo, and the
    # span pipeline.upload naming the path and the photo's bytes
    monkeypatch.setenv("MATRIX_EYES_TIMINGS", "1")
    timings.clear()
    rgb = _photo("contiguous")
    before = collections.Counter(_build.launches("upload"))
    preprocess_image(rgb if given == "numpy" else torch.from_numpy(rgb), 128, torch.float32,
                     "cpu")
    assert _build.launches("upload") - before == collections.Counter({(path,): 1})
    spans = [s for s in timings.recorded() if s.name == "pipeline.upload"]
    assert [s.attrs for s in spans] == [{"path": path, "bytes": rgb.nbytes}]


@pytest.mark.parametrize("kind", ["random", "constant"])
def test_render_grid_bit_exact(kind):
    rng = np.random.RandomState(1)
    data = rng.uniform(1 / 300, 12, (64, 96)).astype(np.float32)
    if kind == "constant":
        data[:] = 0.5
    jclamped = jdepthmap._clamp_inverse_depth(jnp.asarray(data))
    tclamped = tdepthmap.clamp_inverse_depth(torch.from_numpy(data))
    np.testing.assert_array_equal(tclamped.numpy(), np.asarray(jclamped))
    want = np.asarray(jdepthmap._render_depth_map_grid(jclamped))
    got = tdepthmap.render_depth_map_grid(tclamped).numpy()
    np.testing.assert_array_equal(got, want)


def test_render_device_resize_matches_jax():
    # the device-resize path (no native resizer): grid render exact, then
    # Lanczos3 matmuls summed in another order (<= 1 count, <= 1e-4 of values)
    data = np.random.RandomState(2).uniform(0.01, 5, (48, 64)).astype(np.float32)
    want = np.asarray(jdepthmap._render_depth_map(jnp.asarray(data), 97, 131)).astype(int)
    got = tdepthmap.render_depth_map(torch.from_numpy(data), 97, 131).numpy().astype(int)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4


def test_png_bytes_match_jax_host_resize(tmp_path):
    grid = np.random.RandomState(3).randint(0, 256, (40, 52, 3), dtype=np.uint8)
    assert tpng.host_resize_supported()
    jpng.save_depthmap_host_resize(jnp.asarray(grid), str(tmp_path / "j.png"), 97, 131)
    tpng.save_depthmap_host_resize(grid, str(tmp_path / "t.png"), 97, 131)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    tm = torch_ref.randomize(torch_ref.DepthPro(J_TINY), seed=5)
    ckpt = d / "tiny.pt"
    torch.save(tm.state_dict(), str(ckpt))
    # larger than the 512^2 TINY grid, so the save takes the host-resize path
    img = np.random.RandomState(0).randint(0, 256, size=(480, 640, 3), dtype=np.uint8)
    src = d / "src.jpg"
    Image.fromarray(img).save(str(src), quality=95)
    return d, str(ckpt), str(src)


def test_cli_matches_jax_cli(workdir):
    # with a focal length: random weights make the FOV head estimate a tiny
    # angle that clamps every pixel to one colour, which would compare nothing
    d, ckpt, src = workdir
    jout, tout = str(d / "jax.png"), str(d / "torch.png")
    assert jcli.main([f"--checkpoint-path={ckpt}", "--focal-length=28", src, jout]) == 0
    assert tcli.main([f"--checkpoint-path={ckpt}", "--focal-length=28", src, tout],
                     device="cpu") == 0
    a = np.asarray(Image.open(tout).convert("RGB")).astype(int)
    b = np.asarray(Image.open(jout).convert("RGB")).astype(int)
    assert a.shape == b.shape == (480, 640, 3)
    assert len(np.unique(b.reshape(-1, 3), axis=0)) > 1000
    # f32 model differences (test_torch_model.py tolerances) move a few
    # pixels of the colour map by a count or two
    assert (np.abs(a - b) <= 2).all(axis=-1).mean() >= 0.999


def test_cli_fov_path(workdir):
    d, ckpt, src = workdir
    out = str(d / "fov.png")
    assert tcli.main([f"--checkpoint-path={ckpt}", "--dtype=f32", src, out], device="cpu") == 0
    with Image.open(out) as im:
        assert im.format == "PNG" and im.size == (640, 480)


def test_cli_missing_checkpoint_exits_1(workdir, capsys):
    d, _ckpt, src = workdir
    assert tcli.main([f"--checkpoint-path={d / 'nope.pt'}", src, str(d / "x.png")],
                     device="cpu") == 1
    assert "Reconstruction failed" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    [],                                            # no source image
    ["only_src.jpg"],                              # no output image
    ["a.jpg", "b.png", "c.png"],                   # unexpected positional
    ["--focal-length", "a.jpg", "b.png"],          # flag without value
    ["--focal-length=abc", "a.jpg", "b.png"],      # bad value
    ["--dtype=int4", "a.jpg", "b.png"],            # unknown dtype
    ["--devices=0", "a.jpg", "b.png"],             # mesh dimension below 1
    ["--mesh=bogus", "a.jpg", "b.obj"],            # unknown vertex mode
    ["--batch-size=0", "a.jpg", "b.png"],          # batch size below 1
    ["--batch-size=x", "a.jpg", "b.png"],          # bad value
    ["a.jpg", "b.png", "--focal-length=28"],       # options only before positionals
    ["--seed=abc", "a.jpg", "b.png"],              # bad value
    ["--resize-scale=x", "a.jpg", "b.png"],        # bad value
    ["--image-output-format=bogus", "a.jpg", "b.png"],  # unknown output format
    ["--devices=2x", "a.jpg", "b.png"],            # bad mesh shape
])
def test_cli_bad_arguments_exit_2(argv):
    out, err = io.StringIO(), io.StringIO()
    with pytest.raises(SystemExit) as e:
        tcli.parse_args(argv, stdout=out, stderr=err)
    assert e.value.code == 2
    assert "Usage:" in out.getvalue() and err.getvalue()
    assert tcli.main(argv) == 2


@pytest.mark.parametrize("flag", ["--no-flash-attention"])
def test_cli_jax_only_flags_exit_2(flag):
    # the JAX package's kill switch of its attention kernel: the port has none
    out, err = io.StringIO(), io.StringIO()
    with pytest.raises(SystemExit) as e:
        tcli.parse_args([flag, "a.jpg", "b.png"], stdout=out, stderr=err)
    assert e.value.code == 2 and "not supported by the PyTorch port" in err.getvalue()


def test_cli_directory_source_needs_an_output_directory(workdir, tmp_path, capsys):
    d, ckpt, src = workdir
    srcdir = tmp_path / "in"
    srcdir.mkdir()
    (srcdir / "a.jpg").write_bytes(open(src, "rb").read())
    assert tcli.main([f"--checkpoint-path={ckpt}", "--focal-length=28", str(srcdir),
                      str(tmp_path / "not_a_dir.png")], device="cpu") == 1
    assert "must be an existing directory" in capsys.readouterr().out


def test_cli_help_and_unknown_flag():
    out = io.StringIO()
    with pytest.raises(SystemExit) as e:
        tcli.parse_args(["--help"], stdout=out)
    assert e.value.code == 0 and "Usage:" in out.getvalue()
    err = io.StringIO()
    a = tcli.parse_args(["--bogus=1", "in.jpg", "out.png"], stdout=io.StringIO(), stderr=err)
    assert (a.img_src, a.img_out) == ("in.jpg", "out.png")
    assert "Unsupported argument" in err.getvalue()


def test_extract_depth_stage_errors(tmp_path, capsys):
    params = init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    del params["fov"]
    cpu = RuntimeConfig(device="cpu")
    with pytest.raises(ReconstructionError) as e:
        extract_depth(TINY, params, str(tmp_path / "missing.jpg"), str(tmp_path / "o.png"),
                      runtime=cpu)
    assert e.value.stage == "load"
    assert "Failed to load source image" in capsys.readouterr().err
    # no focal length and no FOV weights: a model-stage (systemic) failure
    src = SourceImage(rgb=np.zeros((8, 8, 3), np.uint8), original_size=(8, 8),
                      focal_length_35mm=None)
    with pytest.raises(ReconstructionError) as e:
        extract_depth(TINY, params, "x", str(tmp_path / "o.png"), source=src, runtime=cpu)
    assert e.value.stage == "model"
    assert "Failed to process image" in capsys.readouterr().err


def test_port_imports_no_jax():
    # every module of the port (cli, output.png and the copies of the JAX
    # package's host modules included), then neither jax nor any module of
    # the JAX package may be loaded
    code = ("import importlib, pkgutil, sys\n"
            "import matrix_eyes_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "for name in ('cli', 'api', 'timings', 'output.png', 'output.mesh',\n"
            "             'output.writers', 'output.rust_format', 'errors', 'progress',\n"
            "             'io.image', 'ops.viridis_data', 'native.lanczos',\n"
            "             'native.pngwriter', 'native.meshwriter', 'native.stagecopy',\n"
            "             'ops.quant', 'ops.mixed',\n"
            "             'serve', 'pt.loader', 'debug', 'parallel.sharding',\n"
            "             'parallel.collectives', 'parallel.launch', 'parallel.checks',\n"
            "             'aot', 'flops', 'ops.prng'):\n"
            "    assert 'matrix_eyes_tpu_torch.' + name in sys.modules, name\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'matrix_eyes_tpu' or m.startswith('matrix_eyes_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(int(bool(bad)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr or proc.stdout
