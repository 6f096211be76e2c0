"""The PyTorch port's model stages and weight loading against the JAX package.

TINY, f32, the JAX model on its XLA path (use_flash=False); the port gets
the same weights through pt.convert.from_jax_params and the same numpy
inputs. Tolerances are those of tests/test_parity_torch.py (JAX vs the
PyTorch reference model): f32 sums in another order in every stage, and
the later stages carry the earlier stages' differences.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matrix_eyes_tpu.config import DEPTH_PRO as J_DEPTH_PRO
from matrix_eyes_tpu.config import MID as J_MID
from matrix_eyes_tpu.config import TINY as J_TINY
from matrix_eyes_tpu.models import decoder as jdecoder
from matrix_eyes_tpu.models import depth_pro as jdepth_pro
from matrix_eyes_tpu.models import encoder as jencoder
from matrix_eyes_tpu.models import fov as jfov
from matrix_eyes_tpu.models import head as jhead
from matrix_eyes_tpu.models import vit as jvit
from matrix_eyes_tpu.models.init import init_params as j_init_params
from matrix_eyes_tpu.models.spec import param_spec as j_param_spec
from matrix_eyes_tpu.pt.convert import convert_state_dict as j_convert_state_dict
from matrix_eyes_tpu_torch.config import DEPTH_PRO, MID, TINY
from matrix_eyes_tpu_torch.errors import CheckpointBadShape, CheckpointMissingKeys, LoaderError
from matrix_eyes_tpu_torch.models import decoder as tdecoder
from matrix_eyes_tpu_torch.models import depth_pro as tdepth_pro
from matrix_eyes_tpu_torch.models import encoder as tencoder
from matrix_eyes_tpu_torch.models import fov as tfov
from matrix_eyes_tpu_torch.models import head as thead
from matrix_eyes_tpu_torch.models import vit as tvit
from matrix_eyes_tpu_torch.models.init import init_params as t_init_params
from matrix_eyes_tpu_torch.models.spec import tree_leaves
from matrix_eyes_tpu_torch.pt.convert import from_jax_params, load_checkpoint

import torch_ref


@pytest.fixture(scope="module")
def weights():
    jparams = j_init_params(J_TINY, seed=11)
    np_params = jax.tree.map(np.asarray, jparams)
    return jparams, from_jax_params(TINY, np_params, "cpu", torch.float32)


@pytest.fixture(scope="module")
def image():
    rng = np.random.RandomState(5)
    return rng.uniform(-1, 1, (1, TINY.img_size, TINY.img_size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def encodings(weights, image):
    jparams, tparams = weights
    j = jencoder.forward_encodings(J_TINY, jparams["encoder"], jnp.asarray(image))
    with torch.no_grad():
        t = tencoder.forward_encodings(TINY, tparams["encoder"], torch.from_numpy(image))
    return j, t


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_config_matches_jax():
    assert dataclasses.asdict(TINY) == dataclasses.asdict(J_TINY)
    assert dataclasses.asdict(DEPTH_PRO) == dataclasses.asdict(J_DEPTH_PRO)


def test_vit_with_intermediates(weights):
    jparams, tparams = weights
    x = np.random.RandomState(1).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    jout, jinters = jvit.forward_features(J_TINY, jparams["encoder"]["patch_encoder"],
                                          jnp.asarray(x), J_TINY.highres_block_ids)
    with torch.no_grad():
        tout, tinters = tvit.forward_features(TINY, tparams["encoder"]["patch_encoder"],
                                              torch.from_numpy(x), TINY.highres_block_ids)
    _close(tout, jout, 2e-4, 2e-5)
    assert len(tinters) == len(jinters) == 2
    for t, j in zip(tinters, jinters):
        _close(t, j, 2e-4, 2e-5)


@pytest.mark.parametrize("level", range(5))
def test_encodings(encodings, level):
    j, t = encodings
    assert tuple(t[level].shape) == tuple(j[level].shape)
    _close(t[level], j[level], 2e-4, 2e-5)


@pytest.mark.parametrize("output", ["features", "lowres"])
def test_decoder(weights, encodings, output):
    jparams, tparams = weights
    jenc, _ = encodings
    # the same encodings into both decoders, so this measures the decoder alone
    j = jdecoder.forward(jparams["decoder"], jenc)
    with torch.no_grad():
        t = tdecoder.forward(tparams["decoder"], [torch.tensor(np.asarray(e)) for e in jenc])
    idx = 0 if output == "features" else 1
    _close(t[idx], j[idx], 2e-4, 2e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_head(weights, fused):
    jparams, tparams = weights
    feat = np.random.RandomState(2).uniform(-1, 1, (1, 64, 64, TINY.decoder_features))
    feat = feat.astype(np.float32)
    jfn = jhead.forward if fused else jhead.forward_unfused
    tfn = thead.forward if fused else thead.forward_unfused
    want = jfn(jparams["head"], jnp.asarray(feat))
    with torch.no_grad():
        got = tfn(tparams["head"], torch.from_numpy(feat))
    assert tuple(got.shape) == (1, 128, 128, 1)
    _close(got, want, 5e-4, 5e-5)


@pytest.mark.parametrize("name", ["TINY", "MID"])
def test_head_composed_input_padded_to_8(name):
    # the composed deconv+conv input is the features, the ones-channel and
    # zero channels up to a multiple of 8 (136 at DEPTH_PRO), against zero
    # weight rows: the same function as the unfused head and the JAX head
    jcfg, tcfg = {"TINY": (J_TINY, TINY), "MID": (J_MID, MID)}[name]
    jall = j_init_params(jcfg, seed=13)
    jparams = jall["head"]
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jall), "cpu")["head"]
    w, _b = thead._compose_deconv_conv(tparams)
    ci = tcfg.decoder_features // 2
    assert w.shape[2] % 8 == 0 and ci + 1 <= w.shape[2] < ci + 9
    assert not w[:, :, ci + 1:].any()
    feat = np.random.RandomState(6).uniform(-1, 1, (1, 24, 20, tcfg.decoder_features))
    feat = feat.astype(np.float32)
    want = jhead.forward(jparams, jnp.asarray(feat))
    with torch.no_grad():
        fused = thead.forward(tparams, torch.from_numpy(feat))
        unfused = thead.forward_unfused(tparams, torch.from_numpy(feat))
    assert tuple(fused.shape) == (1, 48, 40, 1)
    _close(fused, unfused.numpy(), 5e-4, 5e-5)
    _close(fused, want, 5e-4, 5e-5)


def test_fov_degrees(weights, image):
    jparams, tparams = weights
    low = np.random.RandomState(4).uniform(-1, 1, (1, 16, 16, TINY.decoder_features))
    low = low.astype(np.float32)
    want = jfov.forward(J_TINY, jparams["fov"], jnp.asarray(image), jnp.asarray(low))
    with torch.no_grad():
        got = tfov.forward(TINY, tparams["fov"], torch.from_numpy(image), torch.from_numpy(low))
    _close(got, want, 1e-3, 1e-4)


def test_forward_with_fnorm(weights, image):
    jparams, tparams = weights
    want = jdepth_pro.forward_with_fnorm(J_TINY, jparams, jnp.asarray(image), jnp.float32(0.8))
    got = tdepth_pro.forward_with_fnorm(TINY, tparams, torch.from_numpy(image), 0.8)
    _close(got, want, 2e-3, 1e-4)


def test_forward_with_fov(weights, image):
    jparams, tparams = weights
    jinv, jdeg = jdepth_pro.forward_with_fov(J_TINY, jparams, jnp.asarray(image))
    tinv, tdeg = tdepth_pro.forward_with_fov(TINY, tparams, torch.from_numpy(image))
    _close(tdeg, jdeg, 1e-3, 1e-4)
    _close(tinv, jinv, 5e-3, 2e-4)


# --- weights carried across ---------------------------------------------------

@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    tm = torch_ref.randomize(torch_ref.DepthPro(J_TINY), seed=7)
    sd = tm.state_dict()
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pt"
    torch.save(sd, str(path))
    return str(path), {k: v.numpy() for k, v in sd.items()}


def test_load_checkpoint_matches_convert_state_dict(tiny_checkpoint):
    path, flat = tiny_checkpoint
    cfg, params = load_checkpoint(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(J_TINY)
    want, _ = jax.tree.flatten(j_convert_state_dict(J_TINY, flat, device=False))
    got = tree_leaves(params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_load_checkpoint_parts_and_dtype(tiny_checkpoint):
    path, _ = tiny_checkpoint
    _, params = load_checkpoint(path, dtype=torch.bfloat16, parts=("head", "fov"))
    assert sorted(params) == ["fov", "head"]
    assert params["head"]["conv0_w"].dtype == torch.bfloat16
    # the FOV runs in f32 on the compute dtype's values
    qkv = params["fov"]["encoder"]["blocks"]["qkv_w"]
    assert qkv.dtype == torch.float32
    assert torch.equal(qkv, qkv.to(torch.bfloat16).float())


def test_load_checkpoint_errors(tiny_checkpoint, tmp_path):
    path, flat = tiny_checkpoint
    with pytest.raises(LoaderError):
        load_checkpoint(str(tmp_path / "missing.pt"))
    sd = {k: torch.from_numpy(v) for k, v in flat.items() if k != "head.0.bias"}
    torch.save(sd, str(tmp_path / "missing_key.pt"))
    with pytest.raises(CheckpointMissingKeys):
        load_checkpoint(str(tmp_path / "missing_key.pt"))
    sd = {k: torch.from_numpy(v) for k, v in flat.items()}
    sd["head.2.bias"] = torch.zeros(7)
    torch.save(sd, str(tmp_path / "bad_shape.pt"))
    with pytest.raises(CheckpointBadShape):
        load_checkpoint(str(tmp_path / "bad_shape.pt"))


def test_init_params_meta_matches_param_spec():
    params = t_init_params(DEPTH_PRO, None, torch.device("meta"), torch.bfloat16)
    want, _ = jax.tree.flatten(j_param_spec(J_DEPTH_PRO))
    got = tree_leaves(params)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert all(g.device.type == "meta" for g in got)
    assert params["encoder"]["patch_encoder"]["blocks"]["qkv_w"].dtype == torch.bfloat16
    assert params["fov"]["encoder"]["blocks"]["qkv_w"].dtype == torch.float32


def test_init_params_is_seeded_and_random():
    a = t_init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    b = t_init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    c = t_init_params(TINY, torch.Generator().manual_seed(1), "cpu")
    qkv = a["encoder"]["patch_encoder"]["blocks"]["qkv_w"]
    assert torch.equal(qkv, b["encoder"]["patch_encoder"]["blocks"]["qkv_w"])
    assert not torch.equal(qkv, c["encoder"]["patch_encoder"]["blocks"]["qkv_w"])
    assert qkv.std() > 0.1  # fan-in scale, not a constant fill
