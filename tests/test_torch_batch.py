"""The PyTorch port's batched path against the JAX package and against its
own one-photo loop: ``forward_with_mixed_fnorm``, directory mode with
``--batch-size``, its failure isolation, and the ``MatrixEyes`` session.

TINY, f32, on the CPU. Model outputs against JAX are held to the f32
tolerances of tests/test_torch_model.py; a batch against the one-photo
loop of the same package to the file's bytes (the batch axis is
independent through the whole network, so each photo's arithmetic is the
same).
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from matrix_eyes_tpu.api import MatrixEyes as JMatrixEyes
from matrix_eyes_tpu.config import TINY as J_TINY
from matrix_eyes_tpu.models import depth_pro as jdepth_pro
from matrix_eyes_tpu.models.init import init_params as j_init_params
from matrix_eyes_tpu_torch import cli as tcli
from matrix_eyes_tpu_torch import pipeline as tpipeline
from matrix_eyes_tpu_torch.api import MatrixEyes
from matrix_eyes_tpu_torch.config import TINY, NoCudaDevice, RuntimeConfig
from matrix_eyes_tpu_torch.errors import ReconstructionError
from matrix_eyes_tpu_torch.models import depth_pro as tdepth_pro
from matrix_eyes_tpu_torch.models.init import init_params
from matrix_eyes_tpu_torch.pt import loader as tloader
from matrix_eyes_tpu_torch.pt.convert import from_jax_params

import torch_ref


# --- the mixed-focal forward ---------------------------------------------------------

def test_forward_with_mixed_fnorm_matches_jax():
    jparams = j_init_params(J_TINY, seed=11)
    tparams = from_jax_params(TINY, jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    img = np.random.RandomState(5).uniform(-1, 1, (3, TINY.img_size, TINY.img_size, 3))
    img = img.astype(np.float32)
    f_norm = np.array([0.8, 1.0, 1.3], np.float32)
    has_f = np.array([True, False, True])
    jinv, jdeg = jdepth_pro.forward_with_mixed_fnorm(J_TINY, jparams, jnp.asarray(img),
                                                     jnp.asarray(f_norm), jnp.asarray(has_f))
    tinv, tdeg = tdepth_pro.forward_with_mixed_fnorm(TINY, tparams, torch.from_numpy(img),
                                                     torch.from_numpy(f_norm),
                                                     torch.from_numpy(has_f))
    # the tolerances of test_torch_model.py's test_forward_with_fov (the FOV
    # image carries the FOV head's f32 differences) and test_forward_with_fnorm
    np.testing.assert_allclose(tdeg.numpy(), np.asarray(jdeg), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tinv[1].numpy(), np.asarray(jinv[1]), rtol=5e-3, atol=2e-4)
    np.testing.assert_allclose(tinv[[0, 2]].numpy(), np.asarray(jinv)[[0, 2]], rtol=2e-3,
                               atol=1e-4)
    # known focal lengths override the FOV estimate image by image
    one = tdepth_pro.forward_with_fnorm(TINY, tparams, torch.from_numpy(img[2:]), 1.3)
    np.testing.assert_allclose(tinv[2:].numpy(), one.numpy(), rtol=1e-5, atol=1e-6)


# --- directory mode --------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_batch")
    tm = torch_ref.randomize(torch_ref.DepthPro(J_TINY), seed=5)
    path = d / "tiny.pt"
    torch.save(tm.state_dict(), str(path))
    return str(path)


def _varied_dir(path, n, focals=None):
    """n photos of different content and sizes; EXIF focal lengths where
    ``focals`` gives one."""
    path.mkdir()
    for i in range(n):
        rng = np.random.RandomState(100 + i)
        img = Image.fromarray(rng.randint(0, 256, size=(40 + 4 * i, 60 - 2 * i, 3),
                                          dtype=np.uint8))
        kw = {"quality": 95}
        if focals and focals[i] is not None:
            exif = Image.Exif()
            exif[0xA405] = focals[i]
            kw["exif"] = exif
        img.save(str(path / f"img{i}.jpg"), **kw)
    return path


def _run(argv):
    return tcli.main(argv, device="cpu")


@pytest.mark.parametrize("fmt", ["depthmap", "stereogram"])
def test_batch_size_outputs_match_batch1(ckpt, tmp_path, fmt):
    # --batch-size=2 over 3 photos pads the last chunk: the same bytes as
    # the one-photo loop, so padding never leaks into a real photo
    src = _varied_dir(tmp_path / "in", 3)
    out1, out2 = tmp_path / "b1", tmp_path / "b2"
    out1.mkdir()
    out2.mkdir()
    base = [f"--checkpoint-path={ckpt}", "--focal-length=28", f"--image-output-format={fmt}"]
    assert _run(base + [str(src), str(out1)]) == 0
    assert _run(base + ["--batch-size=2", str(src), str(out2)]) == 0
    for i in range(3):
        a, b = (out1 / f"img{i}.png").read_bytes(), (out2 / f"img{i}.png").read_bytes()
        assert a == b, f"img{i} differs between the batch-1 and batch-2 runs"
        with Image.open(out2 / f"img{i}.png") as im:
            assert im.size == (60 - 2 * i, 40 + 4 * i)


def test_batch_size_mixed_exif(ckpt, tmp_path, monkeypatch):
    # one chunk, one photo with an EXIF focal length and one without: the
    # mixed forward runs, and each photo matches its own one-photo run
    calls = []
    real = tdepth_pro.forward_with_mixed_fnorm
    monkeypatch.setattr(tdepth_pro, "forward_with_mixed_fnorm",
                        lambda *a: calls.append(a[4].tolist()) or real(*a))
    src = _varied_dir(tmp_path / "in", 2, focals=[28, None])
    out1, out2 = tmp_path / "b1", tmp_path / "b2"
    out1.mkdir()
    out2.mkdir()
    assert _run([f"--checkpoint-path={ckpt}", str(src), str(out1)]) == 0
    assert _run([f"--checkpoint-path={ckpt}", "--batch-size=2", str(src), str(out2)]) == 0
    assert calls == [[True, False]]
    for i in range(2):
        assert (out1 / f"img{i}.png").read_bytes() == (out2 / f"img{i}.png").read_bytes()


@pytest.mark.parametrize("all_exif", [True, False])
def test_fov_weights_load_only_when_needed(ckpt, tmp_path, monkeypatch, all_exif):
    src = _varied_dir(tmp_path / "in", 2, focals=[28, 35 if all_exif else None])
    out = tmp_path / "out"
    out.mkdir()
    seen = {}
    real = tloader.load_checkpoint

    def spy(*a, **k):
        seen["parts"] = tuple(k["parts"])
        return real(*a, **k)

    monkeypatch.setattr(tloader, "load_checkpoint", spy)
    assert _run([f"--checkpoint-path={ckpt}", "--batch-size=2", str(src), str(out)]) == 0
    assert ("fov" in seen["parts"]) == (not all_exif)
    assert (out / "img0.png").exists() and (out / "img1.png").exists()


@pytest.mark.parametrize("batch", ["1", "2"])
def test_decode_error_is_isolated(ckpt, tmp_path, capsys, batch):
    # a corrupt file in the middle: its stage message, the rest written,
    # one summary and exit 1
    src = _varied_dir(tmp_path / "in", 4)
    (src / "img1x.jpg").write_bytes(b"not a jpeg")  # sorts mid-run
    out = tmp_path / "out"
    out.mkdir()
    assert _run([f"--checkpoint-path={ckpt}", "--focal-length=28", f"--batch-size={batch}",
                 str(src), str(out)]) == 1
    cap = capsys.readouterr()
    assert "Failed to load source image" in cap.err and "img1x.jpg" in cap.err
    assert "1 of 5 images failed" in cap.out
    for i in range(4):
        assert (out / f"img{i}.png").is_file(), i
    assert not (out / "img1x.png").exists()


@pytest.mark.parametrize("batch", ["1", "2"])
def test_output_error_is_isolated(ckpt, tmp_path, capsys, batch):
    src = _varied_dir(tmp_path / "in", 3)
    out = tmp_path / "out"
    out.mkdir()
    (out / "img1.png").mkdir()  # img1's write must fail
    assert _run([f"--checkpoint-path={ckpt}", "--focal-length=28", f"--batch-size={batch}",
                 str(src), str(out)]) == 1
    cap = capsys.readouterr()
    assert "Failed to output result" in cap.err and "img1.png" in cap.err
    assert "1 of 3 images failed" in cap.out
    assert (out / "img0.png").is_file() and (out / "img2.png").is_file()


def test_model_failure_flushes_the_finished_chunk(ckpt, tmp_path, capsys, monkeypatch):
    # the second chunk's forward fails: the first chunk's files are written
    # before the systemic failure ends the run
    calls = {"n": 0}
    real = tpipeline.forward_batch

    def fail_second(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("device exploded")
        return real(*a, **k)

    monkeypatch.setattr(tpipeline, "forward_batch", fail_second)
    src = _varied_dir(tmp_path / "in", 3)
    out = tmp_path / "out"
    out.mkdir()
    assert _run([f"--checkpoint-path={ckpt}", "--focal-length=28", "--batch-size=2",
                 str(src), str(out)]) == 1
    assert calls["n"] == 2
    assert "Failed to process image: device exploded" in capsys.readouterr().err
    assert (out / "img0.png").is_file() and (out / "img1.png").is_file()
    assert not (out / "img2.png").exists()


def test_batch1_loop_aborts_on_model_failure(ckpt, tmp_path, capsys, monkeypatch):
    # a model failure is systemic: the loop stops at the first, it does not
    # retry the forward photo by photo
    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        raise RuntimeError("device exploded")

    monkeypatch.setattr(tdepth_pro, "forward_with_fnorm", boom)
    src = _varied_dir(tmp_path / "in", 3)
    out = tmp_path / "out"
    out.mkdir()
    assert _run([f"--checkpoint-path={ckpt}", "--focal-length=28", str(src), str(out)]) == 1
    assert calls["n"] == 1
    assert "Failed to process image" in capsys.readouterr().err


def test_missing_fov_weights_is_a_model_error(tmp_path, capsys):
    src = _varied_dir(tmp_path / "in", 1)
    params = init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    del params["fov"]
    with pytest.raises(ReconstructionError, match="FOV weights were not loaded") as e:
        tpipeline.extract_depth_batch(TINY, params, [(str(src / "img0.jpg"),
                                                      str(tmp_path / "o.png"))], 2,
                                      runtime=RuntimeConfig(device="cpu"))
    assert e.value.stage == "model"
    assert "Failed to process image" in capsys.readouterr().err


def test_directory_source_needs_an_output_directory(ckpt, tmp_path, capsys):
    src = _varied_dir(tmp_path / "in", 1)
    assert _run([f"--checkpoint-path={ckpt}", "--focal-length=28", str(src),
                 str(tmp_path / "not_a_dir.png")]) == 1
    assert "must be an existing directory" in capsys.readouterr().out


def test_empty_directory_exits_1(ckpt, tmp_path, capsys):
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "notes.txt").write_text("no photos here")
    (tmp_path / "out").mkdir()
    assert _run([f"--checkpoint-path={ckpt}", str(tmp_path / "in"), str(tmp_path / "out")]) == 1
    assert "no images in" in capsys.readouterr().out


def test_batch_size_ignored_for_a_single_file(ckpt, tmp_path, capsys):
    src = _varied_dir(tmp_path / "in", 1) / "img0.jpg"
    out = tmp_path / "one.png"
    assert _run([f"--checkpoint-path={ckpt}", "--focal-length=28", "--batch-size=4",
                 str(src), str(out)]) == 0
    assert out.is_file()
    assert "--batch-size only applies" in capsys.readouterr().err


def test_batch_mesh_outputs(ckpt, tmp_path):
    # directory mode writes PNGs named after the sources, whatever the
    # mesh flag says (as the JAX package's CLI does)
    src = _varied_dir(tmp_path / "in", 2)
    out = tmp_path / "out"
    out.mkdir()
    assert _run([f"--checkpoint-path={ckpt}", "--focal-length=28", "--mesh=plain",
                 "--batch-size=2", str(src), str(out)]) == 0
    assert sorted(os.listdir(out)) == ["img0.png", "img1.png"]


def test_timings_table(ckpt, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MATRIX_EYES_TIMINGS", "1")
    src = _varied_dir(tmp_path / "in", 3)
    out = tmp_path / "out"
    out.mkdir()
    assert _run([f"--checkpoint-path={ckpt}", "--focal-length=28", "--batch-size=2",
                 str(src), str(out)]) == 0
    err = capsys.readouterr().err
    assert "-- timings (wall clock) --" in err and "process total" in err
    for stage, n in (("decode source image", 3), ("preprocess (device)", 2),
                     ("model forward", 2), ("write output", 3)):
        line = next(ln for ln in err.splitlines() if ln.strip().startswith(stage))
        assert line.rstrip().endswith(f"x{n}"), line


# --- the MatrixEyes session ------------------------------------------------------------

@pytest.fixture(scope="module")
def sessions(ckpt):
    return JMatrixEyes(ckpt), MatrixEyes(ckpt, device="cpu")


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_api")
    rng = np.random.RandomState(1)
    imgs = [rng.randint(0, 256, size=s, dtype=np.uint8) for s in ((33, 50, 3), (21, 40, 3),
                                                                   (44, 30, 3))]
    path = str(d / "s.png")
    Image.fromarray(imgs[0]).save(path)
    return d, path, imgs


def test_session_dtype_and_device():
    with pytest.raises(ValueError, match="Unsupported dtype"):
        MatrixEyes("unused.pt", dtype="int4", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDevice):
            MatrixEyes("unused.pt")


@pytest.mark.parametrize("focal", [35.0, None])
def test_session_inverse_depth_matches_jax(sessions, photos, focal):
    jme, tme = sessions
    _d, path, _imgs = photos
    want = jme.inverse_depth(path, focal_length_35mm=focal)
    got = tme.inverse_depth(path, focal_length_35mm=focal)
    assert got.shape == want.shape == (TINY.img_size, TINY.img_size)
    # test_torch_model.py: fnorm path 2e-3 / 1e-4, FOV path 5e-3 / 2e-4
    rtol, atol = (2e-3, 1e-4) if focal else (5e-3, 2e-4)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("focals", [35.0, [35.0, None, 50.0], None])
def test_session_inverse_depth_batch_matches_jax(sessions, photos, focals):
    jme, tme = sessions
    _d, _path, imgs = photos
    want = jme.inverse_depth_batch(imgs, focal_length_35mm=focals)
    got = tme.inverse_depth_batch(imgs, focal_length_35mm=focals)
    assert got.shape == want.shape == (3, TINY.img_size, TINY.img_size)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=2e-4)
    # each photo as it comes out of its own one-photo forward
    for i, f in enumerate(focals if isinstance(focals, list) else [focals] * 3):
        one = tme.depth_map(imgs[i], f).data.numpy()
        np.testing.assert_allclose(np.clip(got[i], 1 / 250, 10), one, rtol=1e-5, atol=1e-6)


def test_session_depth_maps_pad_to_pow2_matches_jax(sessions, photos):
    jme, tme = sessions
    _d, _path, imgs = photos
    jsrc = [jme._load(im, f) for im, f in zip(imgs, (35.0, None, 50.0))]
    tsrc = [tme._load(im, f) for im, f in zip(imgs, (35.0, None, 50.0))]
    want = jme.depth_maps(jsrc, pad_to_pow2=True)
    got = tme.depth_maps(tsrc, pad_to_pow2=True)
    assert len(got) == len(want) == 3
    for g, w, s in zip(got, want, tsrc):
        assert g.original_size == w.original_size == s.original_size
        np.testing.assert_allclose(g.data.numpy(), np.asarray(w.data), rtol=5e-3, atol=2e-4)
    unpadded = tme.depth_maps(tsrc)
    for g, u in zip(got, unpadded):
        np.testing.assert_allclose(g.data.numpy(), u.data.numpy(), rtol=1e-5, atol=1e-6)


def test_session_process_and_process_batch(sessions, photos, tmp_path):
    _jme, tme = sessions
    _d, path, imgs = photos
    tme.process(path, str(tmp_path / "o1.png"), focal_length_35mm=35.0)
    tme.process(path, str(tmp_path / "o2.png"), focal_length_35mm=35.0,
                image_format="stereogram", resize_scale=2.0)
    tme.process(path, str(tmp_path / "o3.obj"), focal_length_35mm=35.0, vertex_mode="plain")
    with Image.open(str(tmp_path / "o1.png")) as im:
        assert im.size == (50, 33)
    with Image.open(str(tmp_path / "o2.png")) as im:
        assert im.size == (100, 66)
    assert (tmp_path / "o3.obj").read_text().startswith("v ")
    jobs = []
    for i, im in enumerate(imgs):
        p = str(tmp_path / f"p{i}.png")
        Image.fromarray(im).save(p)
        jobs.append((p, str(tmp_path / f"b{i}.png")))
    tme.process_batch(jobs, batch_size=2, focal_length_35mm=35.0)
    for (p, o), im in zip(jobs, imgs):
        tme.process(p, o + ".one.png", focal_length_35mm=35.0)
        # the CPU GEMMs of a batch of two and of one photo may round the
        # image encoder's sums apart by an ulp (1.5e-7 measured at these
        # photos), which can move a colour by one count
        with Image.open(o) as a, Image.open(o + ".one.png") as b:
            pa, pb = np.asarray(a).astype(int), np.asarray(b).astype(int)
        assert pa.shape == pb.shape == im.shape
        assert np.abs(pa - pb).max() <= 1 and (pa != pb).mean() <= 1e-3

