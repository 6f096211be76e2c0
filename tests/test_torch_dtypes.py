"""The PyTorch port's dtype policies (bf16, f16, int8, mixed) against the
JAX package's, on the CPU.

Both packages load the same ``torch_ref`` checkpoints (TINY and MID,
seeded): the port's ``pt.convert.load_checkpoint`` and the JAX package's
``pt.loader.load_checkpoint(..., use_caches=False)`` must give the same
leaves bit for bit under every policy. The forwards are held against the
JAX package's eager stage functions (``canonical_inverse_depth`` and
``fov.forward``; its jitted ``forward_with_fov`` rounds bf16 elsewhere and
gives an FOV nearer f32 than its stages do). Tolerance: the port's gap to
JAX under a policy is at most twice JAX's own gap between that policy and
f32, since both sides round to the narrow type at different points (an
int8 activation code flips by one wherever two f32 sums round apart).
The quantizers, ``qlinear`` and the mixed policy's wide-bias linear are
held bit for bit.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from matrix_eyes_tpu.api import MatrixEyes as JMatrixEyes
from matrix_eyes_tpu.config import MID as J_MID
from matrix_eyes_tpu.config import TINY as J_TINY
from matrix_eyes_tpu.config import parse_dtype_policy as j_parse_dtype_policy
from matrix_eyes_tpu.models import depth_pro as jdepth_pro
from matrix_eyes_tpu.models import fov as jfov
from matrix_eyes_tpu.models import vit as jvit
from matrix_eyes_tpu.ops import nn as jnn
from matrix_eyes_tpu.ops import quant as jquant
from matrix_eyes_tpu.pt.loader import load_checkpoint as j_load_checkpoint
from matrix_eyes_tpu_torch import cli as tcli
from matrix_eyes_tpu_torch.api import MatrixEyes
from matrix_eyes_tpu_torch.config import MID, TINY, RuntimeConfig, parse_dtype_policy
from matrix_eyes_tpu_torch.errors import LoaderError
from matrix_eyes_tpu_torch.models import depth_pro as tdepth_pro
from matrix_eyes_tpu_torch.models import fov as tfov
from matrix_eyes_tpu_torch.models import vit as tvit
from matrix_eyes_tpu_torch.models.spec import tree_map
from matrix_eyes_tpu_torch.ops import _build
from matrix_eyes_tpu_torch.ops import nn as tnn
from matrix_eyes_tpu_torch.ops import quant as tquant
from matrix_eyes_tpu_torch.ops.mixed import MIXED_BF16_KEYS, cast_params_mixed
from matrix_eyes_tpu_torch.pt.convert import load_checkpoint

import torch_ref

POLICIES = ("bf16", "f16", "int8", "mixed")
_J_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16,
             "int8": jnp.bfloat16, "mixed": jnp.bfloat16}
_CFGS = {"TINY": (TINY, J_TINY), "MID": (MID, J_MID)}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dtypes")
    paths = {}
    for name, (_t, jcfg) in _CFGS.items():
        paths[name] = str(d / f"{name.lower()}.pt")
        torch.save(torch_ref.randomize(torch_ref.DepthPro(jcfg), seed=9).state_dict(),
                   paths[name])
    return paths


@pytest.fixture(scope="module")
def loaded(ckpts):
    """(JAX params, port params) of (config name, policy), loaded once."""
    cache = {}

    def get(name, policy):
        if (name, policy) not in cache:
            tcfg, jcfg = _CFGS[name]
            dtype, q8, mixed = parse_dtype_policy(policy)
            _, jp = j_load_checkpoint(ckpts[name], dtype=_J_DTYPES[policy], use_caches=False,
                                      cfg=jcfg, quantize_int8=q8, mixed_bf16=mixed)
            _, tp = load_checkpoint(ckpts[name], dtype=dtype, cfg=tcfg, quantize_int8=q8,
                                    mixed_bf16=mixed)
            cache[name, policy] = jp, tp
        return cache[name, policy]

    return get


@pytest.fixture(scope="module")
def forwards(loaded):
    """Canonical inverse depth (JAX eager stages, port) and the FOV of both
    from JAX's lowres features, as numpy, of (config name, policy)."""
    cache = {}

    def get(name, policy):
        if (name, policy) not in cache:
            tcfg, jcfg = _CFGS[name]
            jp, tp = loaded(name, policy)
            dtype, q8, mixed = parse_dtype_policy(policy)
            runtime = RuntimeConfig(dtype=dtype, device="cpu", quantize_int8=q8,
                                    mixed_bf16=mixed)
            img = np.random.RandomState(5).uniform(-1, 1, (1, jcfg.img_size, jcfg.img_size, 3))
            img = img.astype(np.float32)
            jimg = jnp.asarray(img).astype(_J_DTYPES["f32" if policy == "mixed" else policy])
            timg = torch.from_numpy(img).to(runtime.image_dtype())
            jcan, jlow = jdepth_pro.canonical_inverse_depth(jcfg, jp, jimg)
            jdeg = jfov.forward(jcfg, jp["fov"], jimg, jlow)
            with torch.no_grad():
                tcan, _ = tdepth_pro.canonical_inverse_depth(tcfg, tp, timg)
                tlow = torch.tensor(np.asarray(jlow.astype(jnp.float32)))
                tdeg = tfov.forward(tcfg, tp["fov"], timg, tlow)
            cache[name, policy] = (np.asarray(jcan.astype(jnp.float32)), tcan.float().numpy(),
                                   np.asarray(jdeg, np.float32), tdeg.numpy(), tdeg.dtype)
        return cache[name, policy]

    return get


def _gap(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


# --- parsing and validation (mirrors of tests/test_quant.py and tests/test_mixed.py) ----

@pytest.mark.parametrize("name", ["f32", "bf16", "f16", "float16", "int8", "mixed", "MIXED"])
def test_parse_dtype_policy_matches_jax(name):
    dtype, q8, mixed = parse_dtype_policy(name)
    jdtype, jq8, jmixed = j_parse_dtype_policy(name)
    assert (str(dtype).split(".")[-1], q8, mixed) == (jnp.dtype(jdtype).name, jq8, jmixed)


def test_parse_dtype_policy_rejects_unknown():
    with pytest.raises(ValueError, match="int8.*mixed"):
        parse_dtype_policy("int4")


def test_runtime_config_validation():
    rt = RuntimeConfig(device="cpu", mixed_bf16=True)
    assert rt.resolved_dtype() == torch.bfloat16 and rt.image_dtype() == torch.float32
    q8 = RuntimeConfig(device="cpu", quantize_int8=True)
    assert q8.resolved_dtype() == q8.image_dtype() == torch.bfloat16
    assert RuntimeConfig(device="cpu").image_dtype() == RuntimeConfig(device="cpu").resolved_dtype()
    assert RuntimeConfig(dtype=torch.float16, device="cpu").image_dtype() == torch.float16
    for bad in (dict(dtype=torch.float32, quantize_int8=True),
                dict(mixed_bf16=True, quantize_int8=True),
                dict(mixed_bf16=True, dtype=torch.float32),
                dict(mixed_bf16=True, dtype=torch.float16)):
        with pytest.raises(ValueError):
            RuntimeConfig(device="cpu", **bad)


def test_loader_policy_validation(ckpts):
    for kw in (dict(dtype=torch.float32, quantize_int8=True),
               dict(dtype=torch.float32, mixed_bf16=True),
               dict(dtype=torch.bfloat16, mixed_bf16=True, quantize_int8=True)):
        with pytest.raises(LoaderError):
            load_checkpoint(ckpts["TINY"], cfg=TINY, **kw)


def test_kernels_take_f16():
    assert [_build.dtype_code(d) for d in (torch.float32, torch.bfloat16, torch.float16)] == [
        0, 1, 2]
    with pytest.raises(TypeError):
        _build.dtype_code(torch.int8)


# --- loader leaves, bit for bit ---------------------------------------------------------

def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("policy", POLICIES)
def test_loader_leaves_bit_exact(loaded, policy):
    jp, tp = loaded("TINY", policy)
    jleaves, tleaves = dict(_flat(jp)), dict(_flat(tp))
    assert set(jleaves) == set(tleaves)
    n_int8 = 0
    for path, j in jleaves.items():
        t = tleaves[path]
        j = np.asarray(j)
        if str(path[-1]).endswith("_qw"):
            # codes: the port stores (out, in), the layout cuBLASLt's int8 GEMM takes
            assert t.dtype == torch.int8 and j.dtype == np.int8, path
            np.testing.assert_array_equal(t.numpy(), np.swapaxes(j, -1, -2), err_msg=str(path))
            n_int8 += 1
            continue
        if path[0] == "fov":  # the port keeps the FOV's float leaves f32 (its compute dtype)
            assert t.dtype == torch.float32, path
        else:
            assert str(t.dtype).split(".")[-1] == j.dtype.name, (path, t.dtype, j.dtype)
        np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32),
                                      err_msg=str(path))
    # int8: four matmuls in each of the three ViTs
    assert n_int8 == (12 if policy == "int8" else 0)
    if policy == "mixed":  # everything but the block matmul weights is the checkpoint's f32
        bf16 = [p for p, t in tleaves.items() if t.dtype == torch.bfloat16]
        assert len(bf16) == 8 and all(p[-1] in MIXED_BF16_KEYS for p in bf16)


def test_cast_params_mixed_dtype_map(loaded):
    _jp, tp = loaded("TINY", "bf16")
    mixed = cast_params_mixed(tp)
    n = 0

    def check(path, t):
        nonlocal n
        if "blocks" in path and path[-1] in MIXED_BF16_KEYS:
            assert t.dtype == torch.bfloat16
            n += 1
        else:
            assert t.dtype == torch.float32, path

    tree_map(check, mixed)
    assert n == 12  # 3 ViTs x 4 matmul weights


# --- quantizers and the int8 linear -----------------------------------------------------

def _with_ties(rng, shape):
    """Random weights whose abs-max is 127 along axis -2, so that the scale is
    1 and every x.5 value is a tie that rounds half to even."""
    w = rng.normal(size=shape).astype(np.float32) * 40
    w[..., 0, :] = 127.0
    w[..., 1:7, :] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5], np.float32)[:, None]
    return w


def test_quantize_weight_bit_exact():
    rng = np.random.RandomState(0)
    for w in (_with_ties(rng, (3, 64, 24)), rng.normal(size=(64, 48)).astype(np.float32),
              np.zeros((16, 8), np.float32)):
        jq, js = jquant.quantize_weight(w)
        tq, ts = tquant.quantize_weight(torch.from_numpy(w))
        np.testing.assert_array_equal(tq.numpy(), jq)
        np.testing.assert_array_equal(ts.numpy(), js)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    # from f16 weights, as the int8 loader quantizes
    w16 = rng.normal(size=(32, 40)).astype(np.float16)
    jq, js = jquant.quantize_weight(w16)
    tq, ts = tquant.quantize_weight(torch.from_numpy(w16))
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)


def test_quantize_act_bit_exact():
    rng = np.random.RandomState(1)
    x = np.swapaxes(_with_ties(rng, (2, 48, 10)), -1, -2).copy()  # ties along the last axis
    x[0, 3] = 0.0  # an all-zero row
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jq, js = jquant.quantize_act(jnp.asarray(x).astype(jdt))
        tq, ts = tquant.quantize_act(torch.from_numpy(x).to(dt))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(np.abs(tq.numpy()[0, 3]).max()) == 0


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_qlinear_and_dequantize_bit_exact(dtype):
    rng = np.random.RandomState(2)
    x = rng.normal(size=(3, 40, 64)).astype(np.float32)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    jdt, tdt = _J_DTYPES[dtype], {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    qw, sw = jquant.quantize_weight(w)
    tqw = torch.from_numpy(qw).t().contiguous()  # the port's stored (out, in) layout
    want = jquant.qlinear(jnp.asarray(x).astype(jdt), jnp.asarray(qw), jnp.asarray(sw),
                          jnp.asarray(b).astype(jdt))
    got = tquant.qlinear(torch.from_numpy(x).to(tdt), tqw, torch.from_numpy(sw),
                         torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (3, 40, 48)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    jw = jquant.dequantize_weight(jnp.asarray(qw), jnp.asarray(sw), jdt)
    tw = tquant.dequantize_weight(tqw, torch.from_numpy(sw), tdt)
    assert tuple(tw.shape) == (64, 48)
    np.testing.assert_array_equal(tw.float().numpy(), np.asarray(jw.astype(jnp.float32)))


def test_linear_wide_bias_rounds_once():
    # the mixed policy's f32 biases on bf16 block matmuls: added to the f32
    # product, one rounding, as the JAX package's nn.linear
    rng = np.random.RandomState(3)
    x = rng.normal(size=(5, 30, 64)).astype(np.float32)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32) * 10
    want = jnn.linear(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16),
                      jnp.asarray(b))
    got = tnn.linear(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                     torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    rounded_first = (torch.from_numpy(x).bfloat16() @ torch.from_numpy(w).bfloat16()
                     + torch.from_numpy(b).bfloat16())
    assert not torch.equal(rounded_first, got)


# --- the forward under each policy --------------------------------------------------------

@pytest.mark.parametrize("name", ["TINY", "MID"])
@pytest.mark.parametrize("policy", POLICIES)
def test_forward_matches_jax_policy(forwards, name, policy):
    jref = forwards(name, "f32")[0]
    jcan, tcan, _jdeg, _tdeg, _ = forwards(name, policy)
    assert np.isfinite(tcan).all()
    port_gap, jax_gap = _gap(tcan, jcan), _gap(jcan, jref)
    assert jax_gap > 0
    assert port_gap <= 2 * jax_gap, (name, policy, port_gap, jax_gap)


@pytest.mark.parametrize("name", ["TINY", "MID"])
def test_mixed_nearer_f32_than_bf16(forwards, name):
    ref = forwards(name, "f32")[1]  # the port's own f32 forward
    mixed_gap = _gap(forwards(name, "mixed")[1], ref)
    bf16_gap = _gap(forwards(name, "bf16")[1], ref)
    assert mixed_gap * 5 <= bf16_gap, (mixed_gap, bf16_gap)


@pytest.mark.parametrize("name", ["TINY", "MID"])
@pytest.mark.parametrize("policy", POLICIES)
def test_fov_runs_f32_from_the_same_lowres(forwards, name, policy):
    # the same lowres features into both FOV heads: f32 activations on the
    # same weights agree to f32 sums in another order; under int8 an
    # activation code may flip by one
    _j, _t, jdeg, tdeg, tdtype = forwards(name, policy)
    jref = forwards(name, "f32")[2]
    assert tdtype == torch.float32
    rel = float(np.abs(tdeg - jdeg).max() / np.abs(jdeg).max())
    assert rel <= (1e-3 if policy == "int8" else 1e-4), rel
    assert rel <= 2 * float(np.abs(jdeg - jref).max() / np.abs(jref).max())


@pytest.mark.parametrize("name", ["TINY", "MID"])
def test_vit_bf16_carry_and_layerscale_cast(loaded, name):
    # bf16 weights, f32 residual carry, branch outputs cast up before the
    # LayerScale multiply. The final tokens are rounded to bf16, so the max
    # difference is one bf16 step either way; the mean tells the policy
    # apart: 1.2e-5 (TINY) and 5.1e-5 (MID) of max |ref| as ported, while
    # LayerScale applied before the cast reads 5.3e-5 and 9.3e-5 and a bf16
    # carry 4.3e-4 and 6.0e-4.
    tcfg, jcfg = _CFGS[name]
    jp, tp = loaded(name, "bf16")
    x = np.random.RandomState(1).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    jout, _ = jvit.forward_features(jcfg, jp["encoder"]["patch_encoder"],
                                    jnp.asarray(x).astype(jnp.bfloat16))
    jout = np.asarray(jout.astype(jnp.float32))
    bound = {"TINY": 3e-5, "MID": 7e-5}[name]
    means = {}
    with torch.no_grad():
        for carry in (True, False):
            out, _ = tvit.forward_features(dataclasses.replace(tcfg, vit_f32_residual=carry),
                                           tp["encoder"]["patch_encoder"],
                                           torch.from_numpy(x).bfloat16())
            assert out.dtype == torch.bfloat16
            means[carry] = float(np.abs(out.float().numpy() - jout).mean() / np.abs(jout).max())
    assert means[True] <= bound, means
    assert means[False] > 2 * bound, means


# --- entry points -------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["f16", "int8", "mixed"])
def test_cli_writes_png_per_policy(ckpts, tmp_path, policy):
    src = tmp_path / "in.png"
    Image.fromarray(np.random.RandomState(4).randint(0, 256, (40, 56, 3), np.uint8)).save(src)
    out = tmp_path / f"out_{policy}.png"
    rc = tcli.main([f"--checkpoint-path={ckpts['TINY']}", f"--dtype={policy}", str(src),
                    str(out)], device="cpu")
    assert rc == 0
    with Image.open(out) as im:
        assert im.format == "PNG" and im.size == (56, 40)


def test_cli_usage_names_every_policy():
    out = io.StringIO()
    with pytest.raises(SystemExit):
        tcli.parse_args(["--help"], stdout=out)
    assert "[possible values: f32, bf16, f16, int8, mixed]" in out.getvalue()


def test_session_mixed_matches_jax(ckpts):
    img = np.random.RandomState(5).randint(0, 256, (48, 64, 3), np.uint8)
    want = JMatrixEyes(ckpts["TINY"], dtype="mixed").inverse_depth(img, focal_length_35mm=35.0)
    me = MatrixEyes(ckpts["TINY"], dtype="mixed", device="cpu")
    assert me.runtime.mixed_bf16 and me.runtime.image_dtype() == torch.float32
    got = me.inverse_depth(img, focal_length_35mm=35.0)
    f32 = MatrixEyes(ckpts["TINY"], dtype="f32", device="cpu").inverse_depth(
        img, focal_length_35mm=35.0)
    # the port's f32 session stands for JAX's (test_torch_batch.py holds the two)
    assert _gap(got, want) <= 2 * _gap(want, f32), (_gap(got, want), _gap(want, f32))
    assert got.dtype == np.float32 and np.isfinite(got).all()
