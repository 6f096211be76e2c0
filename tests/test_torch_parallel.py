"""The PyTorch port's multi-device path (``matrix_eyes_tpu_torch.parallel``,
``--devices``) against the JAX package's sharded forward, on the CPU.

The JAX side runs on the conftest's virtual 8-device CPU mesh; the port
runs one process per rank over gloo (``parallel.launch``), each world
started once per mesh shape and running several cases (the rank function
is the port's own ``parallel.checks.run_cases``, so no rank imports this
module or jax). Both get the same seeded ``init_params`` weights (the
port's, as arrays for the JAX package and through
``pt.convert.from_jax_params`` for the port) and the same numpy-seeded
images.

Tolerances: f32 at rtol 2e-4 / atol 1e-5, the JAX package's own for its
sharded forward against its one-device one (``tests/test_parallel.py``):
the ranks sum the row-split products in another order; the inverse depth
in canonical units (``_close_forward``). int8 and mixed:
the port's gap to JAX's sharded forward under the policy at most twice
JAX's own gap between that policy and f32 (``tests/test_torch_dtypes.py``).
"""

import functools
import importlib
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from matrix_eyes_tpu.config import MID as J_MID
from matrix_eyes_tpu.config import TINY as J_TINY
from matrix_eyes_tpu.models import depth_pro as jdepth_pro
from matrix_eyes_tpu.parallel import sharding as jsharding
from matrix_eyes_tpu.pt.loader import load_checkpoint as j_load_checkpoint
from matrix_eyes_tpu_torch import cli as tcli
from matrix_eyes_tpu_torch.config import MID, TINY, RuntimeConfig, parse_dtype_policy
from matrix_eyes_tpu_torch.models import depth_pro as tdepth_pro
from matrix_eyes_tpu_torch.models import vit as tvit
from matrix_eyes_tpu_torch.models.init import init_params as t_init_params
from matrix_eyes_tpu_torch.models.spec import tree_leaves, tree_map
from matrix_eyes_tpu_torch.io.image import load_source_image
from matrix_eyes_tpu_torch.ops import _build
from matrix_eyes_tpu_torch.ops.quant import quantize_params
from matrix_eyes_tpu_torch.parallel import collectives, launch
from matrix_eyes_tpu_torch.parallel import sharding as tsharding
from matrix_eyes_tpu_torch.parallel.checks import (
    cli_rank_failing,
    run_cases,
    run_entry_points,
    run_graph_cases,
)
from matrix_eyes_tpu_torch.pipeline import extract_depth_batch, forward_batch, preprocess_image
from matrix_eyes_tpu_torch.pt.convert import from_jax_params, load_checkpoint

import torch_ref

tlaunch = importlib.import_module("matrix_eyes_tpu_torch.parallel.launch")
F32_RTOL, F32_ATOL = 2e-4, 1e-5
_CFGS = {"TINY": (TINY, J_TINY), "MID": (MID, J_MID)}
_J_POLICY_DTYPES = {"f32": jnp.float32, "int8": jnp.bfloat16, "mixed": jnp.bfloat16}


def _image(cfg, batch, seed):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (batch, cfg.img_size, cfg.img_size, 3)).astype(np.float32)


def _weights(name, seed):
    """(JAX params, the port's params on the CPU): the port's seeded
    init_params, carried to the JAX package as the same arrays (both keep
    one layout; ``from_jax_params`` validates the copy back)."""
    tcfg, _jcfg = _CFGS[name]
    tparams = t_init_params(tcfg, torch.Generator().manual_seed(seed), "cpu", torch.float32)
    np_params = tree_map(lambda _p, t: t.numpy(), tparams)
    return jax.tree.map(jnp.asarray, np_params), from_jax_params(tcfg, np_params, "cpu")


def _jax_forward(jcfg, jparams, img, mesh_shape=None):
    """JAX's forward_with_fov, on one device or sharded over a mesh of the
    virtual devices (tests/test_parallel.py's recipe)."""
    fwd = jax.jit(lambda p, x: jdepth_pro.forward_with_fov.__wrapped__(jcfg, p, x))
    if mesh_shape is None:
        inv, fov = fwd(jparams, jnp.asarray(img))
    else:
        data, model = mesh_shape
        mesh = jsharding.make_mesh(data * model, model=model)
        sparams = jsharding.shard_params(jparams, mesh, num_heads=jcfg.num_heads)
        with jsharding.patch_sharded(mesh):
            inv, fov = fwd(sparams, jsharding.shard_batch(jnp.asarray(img), mesh))
    return np.asarray(inv, np.float32), np.asarray(fov, np.float32)


def _port_forward(tcfg, tparams, img):
    inv, fov = tdepth_pro.forward_with_fov(tcfg, tparams, torch.from_numpy(img))
    return inv.numpy(), fov.numpy()


def _launch(mesh_shape, cases):
    n = mesh_shape[0] * mesh_shape[1]
    results = launch(run_cases, mesh_shape, cases, devices=["cpu"] * n, timeout=300)
    for r in results:
        assert r["foreign_modules"] == [], "a rank loaded jax or the JAX package"
    return results


def _case(name, tparams, img, **kw):
    return dict(cfg=_CFGS[name][0], params=tparams, img=torch.from_numpy(img), **kw)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)


def _close_forward(got, inv, fov):
    """The forward's (inverse depth, FOV) against a reference's. The
    inverse depth is compared in canonical units (times the reference's
    f_norm, as chip_smoke.py phase 6 does): random weights make the FOV
    head estimate a tiny angle whose 1/f_norm (~770 at TINY) multiplies
    every value, which would put f32 rounding above atol. On the raw
    inverse depth this is rtol 2e-4 with an atol of 1e-5 / f_norm (~7.7e-3
    at TINY); the FOV is held at rtol 2e-4 / atol 1e-5 as it is."""
    f_norm = (np.tan(0.5 * np.asarray(fov, np.float64) * np.pi / 180.0) / 0.5)[:, None, None]
    _close(got["inv"].numpy() * f_norm, inv * f_norm)
    _close(got["fov"].numpy(), fov)


def _gap(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


# --- the layout: permutation, split rule, placement ---------------------------------------

@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_tp_permute_qkv_matches_jax(k, kind):
    rng = np.random.RandomState(k)
    L, C = 2, 32
    if kind == "float":
        jblocks = {"qkv_w": rng.randn(L, C, 3 * C).astype(np.float32),
                   "qkv_b": rng.randn(L, 3 * C).astype(np.float32)}
        tblocks = {key: torch.from_numpy(v) for key, v in jblocks.items()}
    else:
        codes = rng.randint(-127, 128, (L, C, 3 * C)).astype(np.int8)  # JAX: (in, out)
        jblocks = {"qkv_qw": codes, "qkv_sw": rng.rand(L, 3 * C).astype(np.float32),
                   "qkv_b": rng.randn(L, 3 * C).astype(np.float32)}
        tblocks = {"qkv_qw": torch.from_numpy(codes).transpose(-1, -2).contiguous(),
                   "qkv_sw": torch.from_numpy(jblocks["qkv_sw"]),
                   "qkv_b": torch.from_numpy(jblocks["qkv_b"])}
    jblocks["ls1"] = rng.randn(L, C).astype(np.float32)
    tblocks["ls1"] = torch.from_numpy(jblocks["ls1"])
    want = jsharding._tp_permute_qkv(jblocks, k)
    got = tsharding._tp_permute_qkv(tblocks, k)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if key == "qkv_gqw":  # the port stores int8 codes (out, in)
            g = g.transpose(-1, -2)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=key)
    assert got["qkv_gb"].shape == (L, k, 3 * C // k)


def _jax_model_axis(spec):
    return next((i for i, a in enumerate(spec) if a == "model"), None)


@pytest.mark.parametrize("policy", ["f32", "int8"])
def test_block_split_rule_matches_jax(policy):
    # every key of a head-group block, float and int8, split along JAX's
    # _vit_block_specs axis (the port's int8 codes are (out, in): the JAX
    # axis transposed), every other key replicated
    dtype, q8, _mixed = parse_dtype_policy(policy)
    tparams = t_init_params(TINY, torch.Generator().manual_seed(0), "cpu", torch.float32)
    tparams = from_jax_params(TINY, tree_map(lambda _p, t: t.numpy(), tparams), "cpu", dtype,
                              quantize_int8=q8)
    blocks = tsharding._tp_permute_qkv(tparams["encoder"]["patch_encoder"]["blocks"], 2)
    jspecs = jsharding._vit_block_specs()
    for key in blocks:
        want = _jax_model_axis(jspecs.get(key, ()))
        if want is not None and key.endswith("qw"):
            want = {1: 2, 2: 1}[want]
        assert tsharding.BLOCK_SPLIT_AXIS.get(key) == want, key
    mesh = tsharding.Mesh(data=1, model=2, rank=1)
    cut = tsharding.shard_params(tparams, mesh, num_heads=TINY.num_heads)
    local = cut["encoder"]["patch_encoder"]["blocks"]
    for key, full in blocks.items():
        axis = tsharding.BLOCK_SPLIT_AXIS.get(key)
        want = full if axis is None else full.chunk(2, dim=axis)[1]
        assert torch.equal(local[key], want), key
    # outside the stacked blocks everything is replicated
    pairs = [(cut["decoder"], tparams["decoder"]), (cut["head"], tparams["head"]),
             (cut["fov"]["linear"], tparams["fov"]["linear"]),
             (cut["encoder"]["patch_encoder"]["norm"], tparams["encoder"]["patch_encoder"]["norm"])]
    for a, b in pairs:
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_shard_patches_and_batch_rows():
    # 35 patches padded to 36 over data 2 (18 per rank) and 4 (9), to 40 over 8 (5)
    x = torch.arange(35.0).reshape(35, 1)
    for data, per in ((2, 18), (4, 9), (8, 5)):
        for rank in (0, data - 1):
            mesh = tsharding.Mesh(data=data, model=1, rank=rank)
            with tsharding.patch_sharded(mesh):
                got, n = tsharding.shard_patches(x)
            assert n == 35 and got.shape == (per, 1)
            want = torch.cat([x, torch.zeros(per * data - 35, 1)])[rank * per:(rank + 1) * per]
            assert torch.equal(got, want)
    # tile-major stacks: a rank takes its images of every tile
    mesh = tsharding.Mesh(data=2, model=1, rank=1)
    tiles = torch.arange(3 * 4).reshape(3 * 4, 1)  # 3 tiles x 4 images
    got = tsharding.shard_batch(tiles, 4, mesh)
    assert got.flatten().tolist() == [2, 3, 6, 7, 10, 11]
    assert torch.equal(tsharding.shard_batch(tiles[:3], mesh=mesh), tiles[:3])  # 3 % 2: whole


def test_make_mesh_error_matches_jax():
    with pytest.raises(ValueError) as want:
        jsharding.make_mesh(3, model=2)
    with pytest.raises(ValueError) as got:
        tsharding.make_mesh(3, model=2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_grouped_params_without_mesh_raise(kind):
    _, tparams = _weights("MID", 11)
    if kind == "int8":
        tparams = quantize_params(tparams)
    blocks = tsharding._tp_permute_qkv(tparams["encoder"]["patch_encoder"]["blocks"], 2)
    p = dict(tparams["encoder"]["patch_encoder"], blocks=blocks)
    x = torch.zeros(1, MID.vit_img_size, MID.vit_img_size, 3)
    match = "quantized qkv parameters" if kind == "int8" else r"qkv parameters \(qkv_gw"
    with pytest.raises(ValueError, match="patch_sharded") as e:
        tvit.forward_features(MID, p, x)
    assert e.match(match)


def test_grouped_params_reject_mismatched_degree():
    # cut for k=2, run under a k=4 mesh: the degree recorded in qkv_gb's
    # width refuses before any collective
    _, tparams = _weights("MID", 11)
    cut = tsharding.shard_params(tparams, tsharding.Mesh(data=1, model=2), num_heads=4)
    p = cut["encoder"]["patch_encoder"]
    x = torch.zeros(1, MID.vit_img_size, MID.vit_img_size, 3)
    with tsharding.patch_sharded(tsharding.Mesh(data=2, model=4)):
        with pytest.raises(ValueError, match="degree 2"):
            tvit.forward_features(MID, p, x)
    # checkpoint-layout parameters under a model-parallel mesh, and a head
    # count the degree does not divide
    with tsharding.patch_sharded(tsharding.Mesh(data=1, model=2)):
        with pytest.raises(ValueError, match="shard_params"):
            tvit.forward_features(MID, tparams["encoder"]["patch_encoder"], x)
    with pytest.raises(ValueError, match="not divisible"):
        tsharding.shard_params(tparams, tsharding.Mesh(data=1, model=3), num_heads=4)


# --- the sharded forward against JAX's, one world per mesh shape ---------------------------

@pytest.fixture(scope="module")
def tiny():
    jparams, tparams = _weights("TINY", 0)
    img = _image(TINY, 1, 0)
    return jparams, tparams, img, _port_forward(TINY, tparams, img)


@pytest.fixture(scope="module")
def mid():
    jparams, tparams = _weights("MID", 3)
    img = _image(MID, 1, 4)
    return jparams, tparams, img, _port_forward(MID, tparams, img)


@pytest.fixture(scope="module")
def policy_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_parallel") / "tiny.pt"
    torch.save(torch_ref.randomize(torch_ref.DepthPro(J_TINY), seed=9).state_dict(), str(path))
    return str(path)


@pytest.fixture(scope="module")
def policies(policy_ckpt):
    """(JAX params, port params) of each policy, both loaders reading one
    checkpoint, and JAX's sharded f32 forward on the policy image."""
    out = {}
    for policy in ("f32", "int8", "mixed"):
        dtype, q8, mixed = parse_dtype_policy(policy)
        _, jp = j_load_checkpoint(policy_ckpt, dtype=_J_POLICY_DTYPES[policy], use_caches=False,
                                  cfg=J_TINY, quantize_int8=q8, mixed_bf16=mixed)
        _, tp = load_checkpoint(policy_ckpt, dtype=dtype, cfg=TINY, quantize_int8=q8,
                                mixed_bf16=mixed)
        out[policy] = jp, tp
    out["jax_f32_2x2"] = _jax_forward(J_TINY, out["f32"][0], _image(TINY, 1, 6), (2, 2))[0]
    return out


@pytest.fixture(scope="module")
def world_2(tiny):
    """One 2-rank world: TINY at 1x2 and at 2x1."""
    _, tparams, img, _ = tiny
    return _launch((1, 2), [_case("TINY", tparams, img), _case("TINY", tparams, img, model=1)])


@pytest.fixture(scope="module")
def world_2x2(tiny, mid, policies):
    """One 2x2 world: TINY f32, TINY under int8 and mixed, MID f32."""
    _, tparams, img, _ = tiny
    _, mparams, mimg, _ = mid
    cases = [_case("TINY", tparams, img)]
    pimg = _image(TINY, 1, 6)
    for policy in ("int8", "mixed"):
        img_dtype = torch.float32 if policy == "mixed" else torch.bfloat16
        cases.append(dict(cfg=TINY, params=policies[policy][1],
                          img=torch.from_numpy(pimg).to(img_dtype)))
    cases.append(_case("MID", mparams, mimg))
    return _launch((2, 2), cases)


@pytest.fixture(scope="module")
def world_8(tiny, mid):
    """One 8-rank world: TINY at 4x2, MID at 2x4 (one head per shard) and
    a batch of 8 TINY images at 8x1."""
    _, tparams, img, _ = tiny
    _, mparams, mimg, _ = mid
    batch = _image(TINY, 8, 1)
    return _launch((4, 2), [_case("TINY", tparams, img),
                            _case("MID", mparams, mimg, model=4),
                            _case("TINY", tparams, batch, model=1)]), batch


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 1)])
def test_sharded_tiny_matches_jax(tiny, world_2, mesh_shape):
    jparams, _tparams, img, (one_inv, one_fov) = tiny
    index = [(1, 2), (2, 1)].index(mesh_shape)
    results = [r["cases"][index] for r in world_2]
    got = results[0]
    assert got["mesh"] == mesh_shape
    jinv, jfov = _jax_forward(J_TINY, jparams, img, mesh_shape)
    for inv, fov in ((jinv, jfov), (one_inv, one_fov)):
        _close_forward(got, inv, fov)
    for r in results[1:]:  # the ranks agree bit for bit
        assert torch.equal(r["inv"], got["inv"])
    data, model = mesh_shape
    assert got["qkv_width"] == 3 * TINY.embed_dim // model
    assert got["report"]["patch_rows_per_rank"] == -(-35 // data)


def test_sharded_tiny_2x2_matches_jax(tiny, world_2x2):
    jparams, _tparams, img, (one_inv, one_fov) = tiny
    got = world_2x2[0]["cases"][0]
    jinv, jfov = _jax_forward(J_TINY, jparams, img, (2, 2))
    for inv, fov in ((jinv, jfov), (one_inv, one_fov)):
        _close_forward(got, inv, fov)


@pytest.mark.parametrize("policy", ["int8", "mixed"])
def test_sharded_policy_2x2_matches_jax(world_2x2, policies, policy):
    index = {"int8": 1, "mixed": 2}[policy]
    got = world_2x2[0]["cases"][index]["inv"].numpy()
    pimg = _image(TINY, 1, 6)
    jimg = pimg if policy == "mixed" else jnp.asarray(pimg).astype(jnp.bfloat16)
    jinv, _ = _jax_forward(J_TINY, policies[policy][0], jimg, (2, 2))
    jref = policies["jax_f32_2x2"]
    assert np.isfinite(got).all()
    port_gap, jax_gap = _gap(got, jinv), _gap(jinv, jref)
    assert jax_gap > 0
    assert port_gap <= 2 * jax_gap, (policy, port_gap, jax_gap)


def test_collectives_mid_2x2(world_2x2):
    # MID 2x2, one image: 2 all-reduces per block per ViT (3 ViTs), the
    # patch merge's three all-gathers of the padded pyramid (36 rows, 18
    # per rank), none with a token-sized axis, no batch gathers (1 image)
    for rank in world_2x2:
        report = rank["cases"][3]["report"]
        calls = {k: v["calls"] for k, v in report["collectives"].items()}
        assert calls == {"all-reduce": 2 * MID.depth * 3, "all-gather": 3}
        assert report["patch_rows_per_rank"] == 18
        s = MID.tokens_per_side
        assert report["gather_shapes"] == [(36, s, s, MID.embed_dim)] * 3
        # f32 partials: (rows, tokens, C) of this rank's 18 patches, images
        # and FOV at one row each
        n_tok = MID.seq_len * MID.embed_dim * 4
        assert report["collectives"]["all-reduce"]["bytes"] == 2 * MID.depth * n_tok * (18 + 1 + 1)


def test_check_forward_flags_a_token_gather():
    _build.reset()
    collectives._count("all-gather", torch.empty(4, MID.seq_len, MID.embed_dim, device="meta"))
    with pytest.raises(RuntimeError, match="token-sized"):
        collectives.check_forward(MID, tsharding.Mesh(data=1, model=1), 1)
    _build.reset()


def test_sharded_tiny_4x2_matches_jax(tiny, world_8):
    jparams, _tparams, img, (one_inv, one_fov) = tiny
    got = world_8[0][0]["cases"][0]
    jinv, jfov = _jax_forward(J_TINY, jparams, img, (4, 2))
    for inv, fov in ((jinv, jfov), (one_inv, one_fov)):
        _close_forward(got, inv, fov)
    assert got["report"]["patch_rows_per_rank"] == 9


def test_sharded_mid_2x4_matches_jax(mid, world_8):
    jparams, _mparams, img, (one_inv, one_fov) = mid
    got = world_8[0][0]["cases"][1]
    assert got["mesh"] == (2, 4) and got["qkv_width"] == 3 * MID.embed_dim // 4
    jinv, jfov = _jax_forward(J_MID, jparams, img, (2, 4))
    for inv, fov in ((jinv, jfov), (one_inv, one_fov)):
        _close_forward(got, inv, fov)


def test_batch_8x1_equals_one_image_runs(tiny, world_8):
    _jparams, tparams, _img, _ = tiny
    results, batch = world_8
    got = results[0]["cases"][2]
    assert got["mesh"] == (8, 1) and got["inv"].shape == (8, TINY.img_size, TINY.img_size)
    # 8 images over 8 data ranks: one image each past the merge, 280 patches, 35 per rank
    assert got["report"]["patch_rows_per_rank"] == 35
    for i in (0, 3, 7):
        inv, fov = _port_forward(TINY, tparams, batch[i:i + 1])
        _close_forward({"inv": got["inv"][i:i + 1], "fov": got["fov"][i:i + 1]}, inv, fov)


# --- the mesh's forwards through its CUDA-graph cache, one world for every case ------------

@pytest.fixture(scope="module")
def graphs_world_2(tiny):
    """One 2-rank gloo world running the forwards through the mesh's graph
    cache on ``aot.HostGraphs`` (no card): TINY at 1x2 and at 2x1 (one
    image, the FOV head), two images at 2x1 (the batch split, the mixed
    forward), then the ranks disagreeing on a mode at 1x2."""
    _, tparams, img, _ = tiny
    cases = [_case("TINY", tparams, img), _case("TINY", tparams, img, model=1),
             _case("TINY", tparams, _image(TINY, 2, 2), model=1, f_norms=[None, 0.9]),
             _case("TINY", tparams, img, disagree_rank=1)]
    results = launch(run_graph_cases, (1, 2), cases, graphs="host", devices=["cpu"] * 2,
                     timeout=300)
    for r in results:
        assert r["foreign_modules"] == [], "a rank loaded jax or the JAX package"
    return results


@pytest.mark.parametrize("index,mesh_shape,program,collective_calls", [
    (0, (1, 2), "fwd_fov", {"all-reduce": 2 * TINY.depth * 3}),
    (1, (2, 1), "fwd_fov", {"all-gather": 3}),
    (2, (2, 1), "fwd_mixed_b2", {"all-gather": 3 + 2}),  # the merge, then inverse depth and FOV
])
def test_graph_replay_equals_eager(tiny, graphs_world_2, index, mesh_shape, program,
                                   collective_calls):
    _jparams, _tparams, _img, (one_inv, one_fov) = tiny
    for r in graphs_world_2:
        got = r["cases"][index]
        assert got["mesh"] == mesh_shape
        assert [(c["program"], c["mode"]) for c in got["calls"]] == [
            (program, mode) for mode in ("eager", "eager", "capture", "replay")]
        assert got["bit_equal"]
        # every call counts one forward's collectives, the replay included
        for c in got["calls"]:
            assert {k: v["calls"] for k, v in c["report"]["collectives"].items()} == \
                collective_calls
            assert c["report"] == got["calls"][0]["report"]
            assert c["kernels"] == got["calls"][0]["kernels"]
        assert torch.equal(got["inv"], graphs_world_2[0]["cases"][index]["inv"])
    if index < 2:  # one image: the one-device forward, in canonical units
        f_norm = float(np.tan(0.5 * one_fov[0] * np.pi / 180.0) / 0.5)
        _close(graphs_world_2[0]["cases"][index]["inv"].numpy() * f_norm, one_inv[0] * f_norm)


def test_ranks_that_disagree_on_a_mode_raise_on_every_rank(graphs_world_2):
    # rank 1 runs the capture call with the cache off: both ranks raise
    # after the vote, before either captures or calls a collective of it
    for rank, r in enumerate(graphs_world_2):
        msg = r["cases"][3]["disagreement"]
        assert "1x2 mesh disagree on how to run fwd_fov: 1 eager, 1 capture" in msg
        assert f"(rank {rank}: {'eager' if rank == 1 else 'capture'})" in msg


def test_launch_raises_a_rank_failure(tiny):
    # every rank refuses a model degree its world does not divide; the
    # launcher ends the ranks and raises with a rank's traceback
    _, tparams, img, _ = tiny
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed(.|\n)*not divisible"):
        launch(run_cases, (1, 2), [_case("TINY", tparams, img, model=3)],
               devices=["cpu"] * 2, timeout=120)


# --- the CLI ----------------------------------------------------------------------------

@pytest.mark.parametrize("value,want", [("8", (8, 1)), ("4x2", (4, 2)), ("1", (1, 1)),
                                        ("2X2", (2, 2))])
def test_parse_devices(value, want):
    assert tcli.parse_args([f"--devices={value}", "a", "b"]).devices == want


@pytest.mark.parametrize("bad", ["0", "axb", "3x", "2x2x2", "-4x2", "0x2"])
def test_parse_devices_rejects(bad):
    with pytest.raises(SystemExit) as e:
        tcli.parse_args([f"--devices={bad}", "a", "b"])
    assert e.value.code == 2


@pytest.fixture(scope="module")
def cli_workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel_cli")
    ckpt = d / "tiny.pt"
    torch.save(torch_ref.randomize(torch_ref.DepthPro(J_TINY), seed=5).state_dict(), str(ckpt))
    src = d / "src.jpg"
    img = np.random.RandomState(0).randint(0, 256, size=(480, 640, 3), dtype=np.uint8)
    Image.fromarray(img).save(str(src), quality=95)
    srcdir = d / "photos"
    srcdir.mkdir()
    for i in range(3):
        rng = np.random.RandomState(100 + i)
        Image.fromarray(rng.randint(0, 256, (40 + 4 * i, 60 - 2 * i, 3), dtype=np.uint8)).save(
            str(srcdir / f"img{i}.jpg"), quality=95)
    return d, str(ckpt), str(src), srcdir


def test_cli_devices_too_many_exits_1(cli_workdir, capsys):
    d, _ckpt, src, _ = cli_workdir
    n = max(64, (os.cpu_count() or 1) + 1)
    # the mesh is refused before the checkpoint is read: the path does not exist
    rc = tcli.main([f"--checkpoint-path={d / 'nope.pt'}", f"--devices={n}", src,
                    str(d / "never.png")], device="cpu")
    assert rc == 1
    out = capsys.readouterr().out
    assert (f"Device error: --devices={n}x1 needs {n} devices but only "
            f"{os.cpu_count()} are available") in out
    assert not (d / "never.png").exists()


def _pngs_close(a_path, b_path):
    a = np.asarray(Image.open(a_path).convert("RGB")).astype(int)
    b = np.asarray(Image.open(b_path).convert("RGB")).astype(int)
    assert a.shape == b.shape
    diff = np.abs(a - b).max(axis=-1)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("fail_rank", [0, 1])
def test_cli_devices_rank_failure_ends_every_rank(cli_workdir, monkeypatch, capfd, fail_rank):
    # one rank's forward raises under 1x2; the other waits in the forward's
    # first all-reduce. The command reports the failure and returns 1 at
    # once instead of waiting on the collective (the launch deadline set
    # here only turns a regression into a failure rather than a hang)
    d, ckpt, src, _ = cli_workdir
    monkeypatch.setattr(tcli, "_rank_main", functools.partial(cli_rank_failing, fail_rank))
    real_launch = tlaunch.launch
    monkeypatch.setattr(tlaunch, "launch", lambda *a, **k: real_launch(*a, **dict(k, timeout=120)))
    out = d / f"fail{fail_rank}.png"
    t0 = time.monotonic()
    rc = tcli.main([f"--checkpoint-path={ckpt}", "--focal-length=28", "--devices=1x2", src,
                    str(out)], device="cpu")
    wall = time.monotonic() - t0
    printed = capfd.readouterr().out
    assert rc == 1 and wall < 60, (rc, wall)
    want = ("Reconstruction failed: Failed to process image: a fault on rank 0" if fail_rank == 0
            else "Reconstruction failed on rank 1: Failed to process image: a fault on rank 1")
    assert want in printed
    assert not out.exists()


def test_cli_devices_photo_matches_one_device(cli_workdir):
    d, ckpt, src, _ = cli_workdir
    base = [f"--checkpoint-path={ckpt}", "--focal-length=28"]
    assert tcli.main(base + [src, str(d / "one.png")], device="cpu") == 0
    assert tcli.main(base + ["--devices=2x2", src, str(d / "mesh.png")], device="cpu") == 0
    _pngs_close(d / "mesh.png", d / "one.png")


def test_cli_devices_batch_directory_matches_one_device(cli_workdir):
    # 3 photos at --batch-size=2: the first chunk splits over data 2, the
    # second (one photo padded to 2) too
    d, ckpt, _src, srcdir = cli_workdir
    outs = {}
    for name, extra in (("one", []), ("mesh", ["--devices=2x2"])):
        outs[name] = d / f"out_{name}"
        outs[name].mkdir()
        argv = [f"--checkpoint-path={ckpt}", "--focal-length=28", "--batch-size=2", *extra,
                str(srcdir), str(outs[name])]
        assert tcli.main(argv, device="cpu") == 0
    for i in range(3):
        _pngs_close(outs["mesh"] / f"img{i}.png", outs["one"] / f"img{i}.png")


def test_session_on_a_2x2_mesh_matches_one_device(tiny, cli_workdir):
    # MatrixEyes.inverse_depth_batch and process_batch with mesh= on four
    # gloo ranks (the session's parameters cut per mesh) against the same
    # forward and the same pipeline on one device
    _, tparams, _img, _ = tiny
    d, _ckpt, src, _ = cli_workdir
    weights = str(d / "tiny_tree.pt")
    torch.save(tparams, weights)
    out = str(d / "session_mesh.png")
    calls = [dict(inverse_depth_batch=[src], batch=1, n_vits=3, forwards=1),
             dict(process_batch=[(src, out)], batch_size=1, batch=1, n_vits=3, forwards=1)]
    ranks = launch(run_entry_points, (2, 2), TINY, weights, calls, devices=["cpu"] * 4,
                   timeout=300)
    assert all(r["foreign_modules"] == [] for r in ranks)
    # a gloo mesh runs its forwards eagerly, on every rank and every call
    assert all(c["modes"] == ["eager"] for r in ranks for c in r["calls"])
    img = preprocess_image(load_source_image(src).rgb, TINY.img_size, torch.float32, "cpu")
    want = forward_batch(TINY, tparams, img, [None]).numpy()
    _, fov = tdepth_pro.forward_with_fov(TINY, tparams, img)
    f_norm = float(np.tan(0.5 * fov.item() * np.pi / 180.0) / 0.5)
    got = ranks[0]["calls"][0]["inv"].numpy()
    _close(got * f_norm, want * f_norm)  # canonical units, as _close_forward
    assert all(torch.equal(r["calls"][0]["inv"], ranks[0]["calls"][0]["inv"]) for r in ranks)
    one = str(d / "session_one.png")
    extract_depth_batch(TINY, tparams, [(src, one)], 1, runtime=RuntimeConfig(device="cpu"))
    _pngs_close(out, one)
