"""The PyTorch port's own copies of the JAX package's host modules, held to
their originals on seeded inputs, and the port's device policy.

The port imports nothing of the JAX package, so it carries copies of the
error hierarchy, the progress listeners, the image loader with its EXIF
probe, the stage timings, the viridis tables and the native host libraries
(Lanczos3 resizer, striped PNG encoder; the OBJ serializer and the mesh
modules are held in test_torch_mesh.py). Each copy must give what its original gives: the same bytes, the
same decoded image and EXIF focal length, the same tables.
"""

import inspect
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from matrix_eyes_tpu import errors as jerrors
from matrix_eyes_tpu import progress as jprogress
from matrix_eyes_tpu.io import image as jimage
from matrix_eyes_tpu.native import lanczos as jlanczos
from matrix_eyes_tpu.native import pngwriter as jpngwriter
from matrix_eyes_tpu.ops import viridis_data as jviridis
from matrix_eyes_tpu_torch import cli as tcli
from matrix_eyes_tpu_torch import errors as terrors
from matrix_eyes_tpu_torch import native as tnative
from matrix_eyes_tpu_torch import progress as tprogress
from matrix_eyes_tpu_torch.config import NoCudaDevice, RuntimeConfig
from matrix_eyes_tpu_torch.io import image as timage
from matrix_eyes_tpu_torch.native import lanczos as tlanczos
from matrix_eyes_tpu_torch.native import pngwriter as tpngwriter
from matrix_eyes_tpu_torch.ops import viridis_data as tviridis


# --- native host libraries ------------------------------------------------------

def test_native_copies_build_into_the_ports_build_dir():
    assert tlanczos.available() and tpngwriter.available()
    assert os.path.basename(os.path.dirname(tnative.BUILD_DIR)) == "matrix_eyes_tpu_torch"
    for mod in (tlanczos, tpngwriter):
        assert os.path.dirname(mod._lib._name) == tnative.BUILD_DIR


@pytest.mark.parametrize("src,dst", [
    ((40, 52), (97, 131)),     # upsize, the depth-map grid to the photo
    ((97, 131), (40, 52)),     # downsize
    ((1, 7), (3, 20)),         # one-row source
    ((64, 64), (64, 64)),      # same size
])
def test_lanczos_copy_bytes_match_jax(src, dst):
    rgb = np.random.RandomState(sum(src + dst)).randint(0, 256, src + (3,), dtype=np.uint8)
    want = jlanczos.resize_rgb8(rgb, *dst)
    got = tlanczos.resize_rgb8(rgb, *dst)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filt", [jpngwriter.FILTER_NONE, jpngwriter.FILTER_UP,
                                  jpngwriter.FILTER_PAETH])
@pytest.mark.parametrize("stripes", [1, 3])
def test_png_copy_plain_bytes_match_jax(tmp_path, filt, stripes):
    rgb = np.random.RandomState(filt).randint(0, 256, (37, 29, 3), dtype=np.uint8)
    paths = {}
    for name, mod in (("jax", jpngwriter), ("torch", tpngwriter)):
        paths[name] = str(tmp_path / f"{name}.png")
        with mod.PngEncoder(paths[name], 29, 37, level=1, filter=filt) as enc:
            for part in np.array_split(rgb, stripes):
                enc.write_rows(part)
    data = open(paths["torch"], "rb").read()
    assert data == open(paths["jax"], "rb").read()
    np.testing.assert_array_equal(np.asarray(Image.open(paths["torch"]).convert("RGB")), rgb)


def test_png_copy_one_shot_encode_matches_jax(tmp_path):
    rgb = np.random.RandomState(4).randint(0, 256, (300, 17, 3), dtype=np.uint8)
    a, b = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    assert jpngwriter.encode(rgb, a, stripe_rows=64) and tpngwriter.encode(rgb, b, stripe_rows=64)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("pw,stripes", [(5, 1), (12, 2), (40, 3)])
def test_png_copy_split_bytes_match_jax(tmp_path, pw, stripes):
    # the compact stereogram form: the encoder replays the linker scan
    rng = np.random.RandomState(pw)
    shift = rng.randint(0, pw // 2 + 1, (24, 41)).astype(np.uint8)
    noise = rng.randint(0, 256, (24, pw, 3), dtype=np.uint8)
    paths = {}
    for name, mod in (("jax", jpngwriter), ("torch", tpngwriter)):
        paths[name] = str(tmp_path / f"{name}.png")
        with mod.PngEncoder(paths[name], 41, 24, level=1, filter=mod.FILTER_NONE) as enc:
            for s, n in zip(np.array_split(shift, stripes), np.array_split(noise, stripes)):
                enc.write_stereo_rows(s, n, pw)
    assert open(paths["torch"], "rb").read() == open(paths["jax"], "rb").read()


# --- image loading ---------------------------------------------------------------

def _write(path, kind):
    rgb = np.random.RandomState(len(kind)).randint(0, 256, (30, 44, 3), dtype=np.uint8)
    img = Image.fromarray(rgb)
    if kind == "png":
        img.save(path)
        return
    exif = Image.Exif()
    if kind in ("exif_focal", "exif_rotated"):
        exif[0xA405] = 28
    if kind == "exif_rotated":
        exif[0x0112] = 6  # orientation: rotate 90 degrees clockwise
    img.save(path, quality=95, exif=exif)


@pytest.mark.parametrize("kind,focal", [
    ("png", None),            # no EXIF at all
    ("plain_jpeg", None),     # EXIF without a focal length
    ("exif_focal", None),     # FocalLengthIn35mmFilm = 28
    ("exif_focal", 50.0),     # the caller's focal length wins over EXIF
    ("exif_rotated", None),   # orientation applied, focal length read
])
def test_load_source_image_copy_matches_jax(tmp_path, kind, focal):
    path = str(tmp_path / ("src.png" if kind == "png" else "src.jpg"))
    _write(path, kind)
    want = jimage.load_source_image(path, focal)
    got = timage.load_source_image(path, focal)
    assert isinstance(got, timage.SourceImage)
    np.testing.assert_array_equal(got.rgb, want.rgb)
    assert got.original_size == want.original_size
    assert got.focal_length_35mm == want.focal_length_35mm
    assert got.focal_length_px() == want.focal_length_px()
    assert got.f_norm() == want.f_norm()
    if kind == "exif_rotated":
        assert got.original_size == (30, 44) and got.focal_length_35mm == 28.0


@pytest.mark.parametrize("kind", ["png", "plain_jpeg", "exif_focal", "exif_rotated",
                                  "broken", "missing"])
def test_probe_focal_length_copy_matches_jax(tmp_path, kind):
    # header only: a file without EXIF, without the tag, with it, rotated; a
    # JPEG whose header is cut off and a missing file give None
    path = str(tmp_path / ("src.png" if kind == "png" else "src.jpg"))
    if kind == "broken":
        _write(path, "exif_focal")
        data = open(path, "rb").read()
        open(path, "wb").write(data[:40])
    elif kind != "missing":
        _write(path, kind)
    got = timage.probe_focal_length_35mm(path)
    assert got == jimage.probe_focal_length_35mm(path)
    assert got == (28.0 if kind in ("exif_focal", "exif_rotated") else None)


def test_timings_copy_matches_jax(monkeypatch):
    # the same spans give the same table, up to the seconds
    import re

    from matrix_eyes_tpu import timings as jtimings
    from matrix_eyes_tpu_torch import timings as ttimings

    monkeypatch.setenv("MATRIX_EYES_TIMINGS", "1")
    tables = []
    for mod in (jtimings, ttimings):
        for name in ("decode source image", "model forward", "model forward", "write output"):
            with mod.span(name):
                pass
        snap = mod.snapshot()
        assert [(k, n) for k, (n, _t) in snap.items()] == [
            ("decode source image", 1), ("model forward", 2), ("write output", 1)]
        out = io.StringIO()
        mod.report(out)
        # seconds, and the padding of their field, differ between the runs
        tables.append(re.sub(r" +\d+\.\d{3} s", " T s", out.getvalue()))
        assert mod.snapshot() == {}
    assert tables[0] == tables[1] and "model forward" in tables[1]
    monkeypatch.setenv("MATRIX_EYES_TIMINGS", "0")
    with ttimings.span("off"):
        pass
    assert ttimings.snapshot() == {} and not ttimings.enabled()


def test_load_source_image_copy_raises_the_ports_error(tmp_path):
    with pytest.raises(terrors.ImageError, match="IO error"):
        timage.load_source_image(str(tmp_path / "missing.jpg"))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image")
    with pytest.raises(terrors.ImageError, match="Image error"):
        timage.load_source_image(str(bad))


# --- tables, errors, progress ----------------------------------------------------

@pytest.mark.parametrize("name", ["VIRIDIS_R", "VIRIDIS_G", "VIRIDIS_B"])
def test_viridis_copy_equals_jax(name):
    assert getattr(tviridis, name) == getattr(jviridis, name)
    assert len(getattr(tviridis, name)) == 256


_ERRORS = [name for name, obj in inspect.getmembers(jerrors, inspect.isclass)
           if issubclass(obj, Exception) and obj.__module__ == jerrors.__name__]


@pytest.mark.parametrize("name", _ERRORS)
def test_error_hierarchy_copy_mirrors_jax(name):
    jcls, tcls = getattr(jerrors, name), getattr(terrors, name)
    assert tcls is not jcls and tcls.__module__ == terrors.__name__
    assert [b.__name__ for b in tcls.__mro__] == [b.__name__ for b in jcls.__mro__]


def test_checkpoint_missing_keys_message_matches_jax():
    keys = [f"k{i}" for i in range(11)]
    assert str(terrors.CheckpointMissingKeys(keys)) == str(jerrors.CheckpointMissingKeys(keys))


def test_split_progress_copy_matches_jax():
    class Rec:
        def __init__(self):
            self.events = []

        def report_status(self, pos):
            self.events.append(round(pos, 12))

        def update_message(self, msg):
            self.events.append(msg)

    recs = []
    for mod in (jprogress, tprogress):
        rec = Rec()
        a, b = mod.SplitProgressListener(rec).split_range(0.9)
        a1, a2 = a.split_range(0.05)
        a1.update_message("load")
        a1.report_status(1.0)
        a2.report_status(0.5)
        b.report_status(1.0)
        recs.append(rec.events)
    assert recs[0] == recs[1]


def test_console_progress_copy_is_silent_off_a_terminal(capsys):
    bar = tprogress.ConsoleProgressReporter()
    bar.update_message("x")
    bar.report_status(0.5)
    bar.finish_and_clear()
    assert capsys.readouterr().err == ""


# --- the card unless the caller asks for the CPU ----------------------------------

def test_resolved_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RuntimeConfig().resolved_device()
    with pytest.raises(NoCudaDevice):
        RuntimeConfig().resolved_dtype()


def test_resolved_device_is_cuda_when_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert RuntimeConfig().resolved_device() == torch.device("cuda")
    assert RuntimeConfig().resolved_dtype() == torch.bfloat16


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_resolved_device_honours_cpu(monkeypatch, device):
    for available in (False, True):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
        cfg = RuntimeConfig(device=device)
        assert cfg.resolved_device() == torch.device("cpu")
        assert cfg.resolved_dtype() == torch.float32


def test_cli_without_a_card_exits_1(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "src.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(str(src))
    assert tcli.main([str(src), str(tmp_path / "out.png")]) == 1
    assert "no CUDA device" in capsys.readouterr().out
    assert not (tmp_path / "out.png").exists()
