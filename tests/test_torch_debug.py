"""The port's per-stage dump (``matrix_eyes_tpu_torch/debug.py``) against the
JAX package's (``matrix_eyes_tpu/debug.py``) on the same TINY f32 weights
and image, on the CPU: the same stage names, each stage within the f32
tolerance of tests/test_parity_torch.py (rtol 2e-4, atol 2e-5), and
``compare_dumps`` as the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_eyes_tpu.config import TINY as J_TINY
from matrix_eyes_tpu.debug import compare_dumps as j_compare_dumps
from matrix_eyes_tpu.debug import dump_stages as j_dump_stages
from matrix_eyes_tpu.models.init import init_params as j_init_params
from matrix_eyes_tpu_torch.config import TINY
from matrix_eyes_tpu_torch.debug import ENCODING_NAMES, compare_dumps, dump_stages, save_dump
from matrix_eyes_tpu_torch.pt.convert import from_jax_params

@pytest.fixture(scope="module")
def dumps():
    jparams = j_init_params(J_TINY, seed=2)
    tparams = from_jax_params(TINY, jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    img = np.random.RandomState(0).uniform(-1, 1, (1, TINY.img_size, TINY.img_size, 3))
    img = img.astype(np.float32)
    return j_dump_stages(J_TINY, jparams, jnp.asarray(img)), dump_stages(
        TINY, tparams, torch.from_numpy(img))


def test_stage_names_match_jax(dumps):
    jd, td = dumps
    assert set(td) == set(jd)
    assert {f"enc_{n}" for n in ENCODING_NAMES} <= set(td)
    assert td["canonical_inverse_depth"].shape == (1, TINY.img_size, TINY.img_size)


@pytest.mark.parametrize("stage", [
    "patch_tokens", "patch_highres0", "patch_highres1", "enc_latent0", "enc_latent1",
    "enc_x0", "enc_x1", "enc_global", "dec_features", "dec_lowres",
    "canonical_inverse_depth", "fov_deg"])
def test_stage_matches_jax(dumps, stage):
    jd, td = dumps
    assert td[stage].dtype == np.float32 and td[stage].shape == jd[stage].shape
    np.testing.assert_allclose(td[stage], jd[stage], rtol=2e-4, atol=2e-5)


def test_compare_dumps_matches_jax(dumps, tmp_path):
    jd, td = dumps
    report = compare_dumps(td, jd)
    assert report == j_compare_dumps(td, jd)
    path = str(tmp_path / "d.npz")
    save_dump(td, path)
    with np.load(path) as z:
        reloaded = {k: z[k] for k in z.files}
    assert all(v == 0.0 for v in compare_dumps(td, reloaded).values())
    # a perturbed stage shows, the others do not; a shape mismatch is inf
    reloaded["dec_features"] = reloaded["dec_features"] + 1.0
    reloaded["fov_deg"] = reloaded["fov_deg"][None]
    report = compare_dumps(td, reloaded)
    assert report == j_compare_dumps(td, reloaded)
    assert report["dec_features"] > 0.1 and report["canonical_inverse_depth"] == 0.0
    assert report["fov_deg"] == float("inf")
