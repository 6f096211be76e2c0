"""The PyTorch port's stereogram output against the JAX package.

Geometry, the normalised depth, the shift plane, the linker scan and the PNG
bytes go through both packages on the same inputs (numpy seeds). Both
packages draw the noise of a seed as ``jax.random.randint(PRNGKey(seed), ...,
0, 256, uint8)`` (the port through ``ops/prng.py``, held to JAX bit for bit
in test_torch_prng.py), so the stereogram and its PNG files are held to the
JAX package's given the same depth grid and seed; the scan and the PNG
encoders are also held given the same injected noise plane. On the CPU the
``linker_scan`` and ``randint_u8`` wrappers run their plain versions; the
CUDA kernels themselves are checked on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from matrix_eyes_tpu import cli as jcli
from matrix_eyes_tpu.config import TINY as J_TINY
from matrix_eyes_tpu.ops import stereogram as jst
from matrix_eyes_tpu.ops.stereogram_kernel import linker_scan_tpu
from matrix_eyes_tpu.output import depthmap as jdepthmap
from matrix_eyes_tpu.output import png as jpng
from matrix_eyes_tpu_torch import cli as tcli
from matrix_eyes_tpu_torch.ops import _build
from matrix_eyes_tpu_torch.ops import stereogram as tst
from matrix_eyes_tpu_torch.ops.stereogram_kernel import linker_scan, linker_scan_plain
from matrix_eyes_tpu_torch.output import depthmap as tdepthmap
from matrix_eyes_tpu_torch.output import png as tpng
from matrix_eyes_tpu_torch.output.depthmap import DepthMap, ImageOutputFormat

import torch_ref

STEREO = ImageOutputFormat.STEREOGRAM


def _grid(shape, seed):
    """A clamped inverse-depth grid (f32, in [1/250, 1/0.1])."""
    return np.random.RandomState(seed).uniform(1 / 250, 1 / 0.1, shape).astype(np.float32)


def _decode(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


# --- geometry: integer and f32 scalar arithmetic, exact ---------------------

@pytest.mark.parametrize("amplitude", [0.0, 0.5 / 16, 0.05, 1 / 16, 0.1, 0.45])
@pytest.mark.parametrize("width", [1, 10, 33, 640, 4032, 6048])
def test_geometry_matches_jax(width, amplitude):
    dm, pw = jst.stereogram_geometry(width, amplitude)
    assert tst.stereogram_geometry(width, amplitude) == (dm, pw)
    assert tst._max_shift(dm) == jst._max_shift(dm)
    assert tst._split_geometry(width, amplitude) == jst._split_geometry(width, amplitude)
    if pw > 0:
        assert tst._doubling_iterations(width, pw, dm) == jst._doubling_iterations(width, pw, dm)


@pytest.mark.parametrize("scale", [None, 1.0, 1.5, 0.37])
@pytest.mark.parametrize("size", [(640, 480), (4032, 3024), (3, 7)])
def test_stereogram_size_matches_jax(size, scale):
    assert tdepthmap.stereogram_size(size, scale) == jdepthmap.stereogram_size(size, scale)


# --- normalised depth and shift plane ----------------------------------------

@pytest.mark.parametrize("grid,out,amplitude", [
    ((48, 64), (97, 131), 1 / 16),
    ((32, 32), (720, 960), 0.1),
    ((64, 48), (40, 30), 0.45),
    ((24, 40), (300, 500), 0.5 / 16),
])
def test_norm_depth_and_shift_plane_match_jax(grid, out, amplitude):
    # the bilinear matmuls may order or fuse their two taps differently:
    # dnorm to a few f32 ulp; the shift plane identical on >= 99.99 % of
    # pixels and one count off at most elsewhere
    depth = _grid(grid, sum(grid))
    oh, ow = out
    want = np.asarray(jst._norm_depth(jnp.asarray(depth), oh, ow))
    got = tst._norm_depth(torch.from_numpy(depth), oh, ow).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.min() >= 0.0 and got.max() <= 1.0

    dm, _pw = tst.stereogram_geometry(ow, amplitude)
    pw, pairs = jst.synthesize_stereogram_split(jnp.asarray(depth), oh, ow, amplitude,
                                                band_rows=oh)
    jshift = np.asarray(pairs[0][0]).astype(int)
    tshift = tst.shift_plane(torch.from_numpy(depth), oh, ow, dm, torch.uint8).numpy().astype(int)
    assert tshift.shape == jshift.shape == (oh, ow)
    diff = np.abs(tshift - jshift)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.9999
    assert tshift.max() <= tst._max_shift(dm)


# --- the linker scan ---------------------------------------------------------

@pytest.mark.parametrize("H,W,amplitude", [
    (12, 256, 0.02),    # tiny pattern width
    (6, 33, 0.45),      # extreme amplitude, wide window
    (5, 64, 0.11),
    (130, 101, 0.0625),  # rows > one lane tile
    (8, 40, 0.3),
    (1, 300, 0.0625),   # one row
])
def test_linker_scan_plain_bit_exact(H, W, amplitude):
    # exact: every pixel is a copy of a noise pixel
    rng = np.random.RandomState(0)
    dm, pw = jst.stereogram_geometry(W, amplitude)
    dnorm = rng.uniform(0, 1, size=(H, W)).astype(np.float32)
    shift = np.floor(dnorm * np.float32(dm) + 0.5).astype(np.int32)
    noise = rng.randint(0, 256, size=(H, pw, 3), dtype=np.uint8)
    win = jst._max_shift(dm) + 1
    want = jst.reference_rows(dnorm, noise, pw, dm)
    np.testing.assert_array_equal(
        np.asarray(linker_scan_tpu(jnp.asarray(shift), jnp.asarray(noise), pw, win,
                                   interpret=True)), want)
    args = (torch.from_numpy(shift), torch.from_numpy(noise), pw, win)
    np.testing.assert_array_equal(linker_scan_plain(*args).numpy(), want)
    before = dict(_build.ledger)
    np.testing.assert_array_equal(linker_scan(*args).numpy(), want)
    assert dict(_build.ledger) == before  # the CPU path launches nothing


@pytest.mark.parametrize("H,W,amplitude", [
    (4, 10, 0.05),    # dm = 0.5: max_shift == pw, wide
    (3, 20, 0.025),   # wide
    (5, 16, 0.0),     # pw == 0
    (2, 7, 0.01),     # pw == 0
])
def test_wide_and_degenerate_match_reference(H, W, amplitude):
    # exact, given the port's full-width noise
    dm, pw = tst.stereogram_geometry(W, amplitude)
    assert pw == 0 or tst._max_shift(dm) + 1 > pw
    depth = torch.from_numpy(_grid((8, 6), H + W))
    got = tst.synthesize_stereogram(depth, H, W, amplitude, seed=4).numpy()
    dnorm = tst._norm_depth(depth, H, W).numpy()
    noise = tst.stereogram_noise(4, H, W, "cpu").numpy()
    np.testing.assert_array_equal(got, jst.reference_rows(dnorm, noise, pw, dm))


# --- the whole stereogram against the JAX package, seed for seed ---------------

# the two packages' f32 bilinear matmuls may round a sample one ulp apart, and
# a shift whose dnorm * dm + 0.5 lies within that ulp of an integer then
# differs by one (test_norm_depth_and_shift_plane_match_jax: one pixel in
# ~1e6; 720x960 at amplitude 0.1 from a 32x32 grid has one). On these grids
# the shift planes agree, which the test checks first, so that such a pixel
# is reported as the shift plane's and not as the noise's.
@pytest.mark.parametrize("amplitude", [0.0, 0.5 / 16, 1 / 16, 0.1])
@pytest.mark.parametrize("grid,out", [((32, 48), (64, 96)), ((48, 64), (97, 131)),
                                      ((24, 40), (300, 500))])
def test_synthesize_stereogram_matches_jax(grid, out, amplitude):
    # exact: the same noise, shift plane and scan
    depth = _grid(grid, out[1])
    oh, ow = out
    dm, pw = tst.stereogram_geometry(ow, amplitude)
    if pw:
        jshift = np.floor(np.asarray(jst._norm_depth(jnp.asarray(depth), oh, ow))
                          * np.float32(dm) + np.float32(0.5)).astype(np.int32)
        np.testing.assert_array_equal(
            tst.shift_plane(torch.from_numpy(depth), oh, ow, dm, torch.int32).numpy(), jshift)
    for seed in (0, 7, 2**31 + 3):
        want = np.asarray(jst.synthesize_stereogram(jnp.asarray(depth), oh, ow, amplitude,
                                                    seed=seed))
        got = tst.synthesize_stereogram(torch.from_numpy(depth), oh, ow, amplitude, seed=seed)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size,amplitude", [((96, 64), 1 / 16),   # compact
                                            ((600, 40), 0.45)])   # resolved: shifts over 255
def test_png_files_match_jax(tmp_path, size, amplitude):
    # exact bytes: the same pixels through the same encoder and profile
    grid = _grid((16, 24), 1)
    assert (tst._split_geometry(size[0], amplitude) is None) == (amplitude == 0.45)
    t, j = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    DepthMap.new(torch.from_numpy(grid), size).output_image(t, "", STEREO, amplitude=amplitude,
                                                            seed=11)
    jdepthmap.DepthMap.new(jnp.asarray(grid), size).output_image(
        j, "", jdepthmap.ImageOutputFormat.STEREOGRAM, amplitude=amplitude, seed=11)
    assert open(t, "rb").read() == open(j, "rb").read()


def test_split_noise_is_the_resolved_forms_noise():
    # the compact form's noise plane is the device-resolved form's
    depth = torch.from_numpy(_grid((8, 12), 3))
    pw, _shift, noise = tst.synthesize_stereogram_split(depth, 20, 64, 1 / 16, seed=5)
    np.testing.assert_array_equal(noise.numpy(), tst.stereogram_noise(5, 20, pw, "cpu").numpy())
    np.testing.assert_array_equal(
        noise.numpy(), np.asarray(jax.random.randint(jax.random.PRNGKey(5), (20, pw, 3), 0, 256,
                                                     jnp.uint8)))


@pytest.mark.parametrize("bad", [
    lambda: linker_scan(torch.zeros(2, 8, dtype=torch.int32, device="meta"),
                        torch.zeros(2, 4, 3, dtype=torch.uint8, device="meta"), 4, 2),
    lambda: linker_scan(torch.zeros(2, 8, dtype=torch.int32),
                        torch.zeros(2, 4, 3, dtype=torch.uint8), 4, 5),   # win > pw
    lambda: linker_scan(torch.zeros(2, 8, dtype=torch.int32),
                        torch.zeros(2, 4, 3, dtype=torch.uint8), 4, 0),   # win < 1
    lambda: linker_scan(torch.zeros(2, 8, dtype=torch.int32),
                        torch.zeros(2, 3, 3, dtype=torch.uint8), 4, 2),   # noise < pw
    lambda: linker_scan(torch.zeros(2, 8, dtype=torch.int64),
                        torch.zeros(2, 4, 3, dtype=torch.uint8), 4, 2),   # shift dtype
])
def test_linker_scan_rejects_bad_arguments(bad):
    with pytest.raises(ValueError):
        bad()


# --- PNG forms ---------------------------------------------------------------

@pytest.mark.parametrize("oh,ow,amplitude", [
    (64, 96, 1 / 16),
    (50, 77, 0.05),
    (40, 2100, 0.1),
    (300, 97, 1 / 16),  # more than one ENCODE_ROWS stripe
])
def test_split_png_bytes_match_jax_and_device_resolved(tmp_path, oh, ow, amplitude):
    # exact bytes: the same encoder, stripes and profile on the same pixels
    depth = torch.from_numpy(_grid((32, 48), ow))
    pw, shift, noise = tst.synthesize_stereogram_split(depth, oh, ow, amplitude, seed=3)
    shift, noise = shift.numpy(), noise.numpy()
    assert shift.shape == (oh, ow) and noise.shape == (oh, pw, 3)
    t, j, r = (str(tmp_path / f"{n}.png") for n in ("t", "j", "r"))
    tpng.save_stereogram_split(shift, noise, t, pw)
    jpng.save_stereogram_split([(shift, noise)], j, pw)
    rgb = tst.synthesize_stereogram(depth, oh, ow, amplitude, seed=3).numpy()
    tpng.save_rgb(rgb, r, tpng.STEREOGRAM)
    data = open(t, "rb").read()
    assert data == open(j, "rb").read() == open(r, "rb").read()
    np.testing.assert_array_equal(_decode(t), rgb)


@pytest.mark.parametrize("amplitude", [1 / 16, 0.45])  # compact; shifts over 255
def test_png_routes_and_seed_determinism(tmp_path, amplitude):
    # exact bytes for one seed, other bytes for another
    dm = DepthMap.new(torch.from_numpy(_grid((16, 24), 1)), (600, 40))
    assert (tst._split_geometry(600, amplitude) is None) == (amplitude == 0.45)
    paths = [str(tmp_path / f"s{i}.png") for i in range(3)]
    for path, seed in zip(paths, (7, 7, 8)):
        dm.output_image(path, "", STEREO, amplitude=amplitude, seed=seed)
    a, b, c = (open(p, "rb").read() for p in paths)
    assert a == b and a != c
    np.testing.assert_array_equal(_decode(paths[0]),
                                  dm.render_stereogram(None, amplitude, seed=7).numpy())


def test_jpg_route_writes_through_pil(tmp_path, monkeypatch):
    dm = DepthMap.new(torch.from_numpy(_grid((16, 24), 2)), (96, 64))
    calls = []
    real = tpng.pil_save

    def spy(rgb, path, **kw):
        calls.append(path)
        real(rgb, path, **kw)

    monkeypatch.setattr(tpng, "pil_save", spy)
    out = str(tmp_path / "s.jpg")
    dm.output_image(out, "", STEREO, resize_scale=0.5, seed=1)
    assert calls == [out]
    with Image.open(out) as im:
        assert im.format == "JPEG" and im.size == (48, 32)


# --- the slice through the CLI -----------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_stereo_cli")
    tm = torch_ref.randomize(torch_ref.DepthPro(J_TINY), seed=5)
    ckpt = d / "tiny.pt"
    torch.save(tm.state_dict(), str(ckpt))
    img = np.random.RandomState(0).randint(0, 256, size=(480, 640, 3), dtype=np.uint8)
    src = d / "src.jpg"
    Image.fromarray(img).save(str(src), quality=95)
    return d, str(ckpt), str(src)


def test_cli_stereogram_matches_jax(workdir, monkeypatch):
    # the PNG equals the port's device-resolved render exactly; its shift
    # plane matches the JAX pipeline's on >= 99.9 % of pixels (the f32
    # model tolerance of test_cli_matches_jax_cli)
    d, ckpt, src = workdir
    seen = {}
    for name, cls in (("torch", tdepthmap.DepthMap), ("jax", jdepthmap.DepthMap)):
        def wrapped(self, *a, _real=cls.output_image, _name=name, **kw):
            seen[_name] = self
            return _real(self, *a, **kw)

        monkeypatch.setattr(cls, "output_image", wrapped)
    flags = [f"--checkpoint-path={ckpt}", "--image-output-format=stereogram",
             "--resize-scale=1.5", "--seed=7", "--focal-length=28"]
    tout, jout = str(d / "torch_stereo.png"), str(d / "jax_stereo.png")
    assert tcli.main(flags + [src, tout], device="cpu") == 0
    assert jcli.main(flags + [src, jout]) == 0
    got = _decode(tout)
    assert got.shape == (720, 960, 3)
    np.testing.assert_array_equal(got, seen["torch"].render_stereogram(1.5, 1 / 16, 7).numpy())

    dm, _pw = tst.stereogram_geometry(960, 1 / 16)
    tshift = tst.shift_plane(seen["torch"].data, 720, 960, dm, torch.uint8).numpy()
    jdnorm = np.asarray(jst._norm_depth(seen["jax"].data, 720, 960))
    jshift = np.floor(jdnorm * np.float32(dm) + np.float32(0.5)).astype(np.uint8)
    assert len(np.unique(jshift)) > 10
    assert (tshift == jshift).mean() >= 0.999
