"""Depth Anything V2 in the port against the plain ``torch.nn`` reference
(``torch_ref_dav2.py``, written from the published code) on the CPU, f32,
at the tiny size (``config.DAV2_TINY``) on seeded random weights: the
forward on non-square photos, the converter on the published key names,
the position embedding's interpolation, the resize rule, the FLOP ledger,
and the session's entries (depth maps unclamped, meshes refused, the
policies, the CLI).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image
from torch.utils.flop_counter import FlopCounterMode

import torch_ref_dav2 as ref
from matrix_eyes_tpu_torch import cli, flops
from matrix_eyes_tpu_torch.api import MatrixEyes
from matrix_eyes_tpu_torch.config import (
    DAV2_LARGE,
    DAV2_TINY,
    DepthAnythingConfig,
    config_from_dict,
    config_to_dict,
)
from matrix_eyes_tpu_torch.errors import ReconstructionError
from matrix_eyes_tpu_torch.models import depth_anything, vit
from matrix_eyes_tpu_torch.models.spec import param_spec, tree_leaves, tree_map
from matrix_eyes_tpu_torch.ops import nn
from matrix_eyes_tpu_torch.pt import convert

# the port against the reference, f32 on both sides: the same arithmetic in
# another order (the conv3x3 epilogue's f32 sums, the fused qkv split, the
# normalisation's division) differs by a few f32 roundings, 1.2e-6 of the
# largest value here; the faults below move it by 1e-2 or more
GAP = 1e-5


def _reference(cfg: DepthAnythingConfig = DAV2_TINY, seed: int = 3):
    return ref.randomize(ref.DepthAnythingV2(
        features=cfg.features, out_channels=cfg.out_channels, img_size=cfg.input_size,
        patch_size=cfg.patch_size, embed_dim=cfg.embed_dim, depth=cfg.depth,
        num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio, head_features_2=cfg.head_widths[1],
        intermediate_layer_idx=list(cfg.taps)), seed=seed).eval()


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(reference module, its .pth under the published key names, a
    session on it)."""
    m = _reference()
    path = str(tmp_path_factory.mktemp("dav2") / "depth_anything_v2_tiny.pth")
    torch.save(m.state_dict(), path)
    return m, path, MatrixEyes(path, device="cpu", dtype="f32")


def _photo(h, w, seed=0):
    """A smooth scene with some texture: gradients and a few boxes."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x / w, y / h, 0.5 + 0.5 * np.sin(x / 7 + y / 11)], -1) * 200
    for _ in range(4):
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        img[y0:y0 + h // 3, x0:x0 + w // 3] = rng.randint(0, 256, 3)
    img += rng.randint(-20, 21, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("hw", [(96, 160), (160, 96), (70, 70), (123, 301)])
def test_port_matches_the_reference(model, hw):
    m, _path, me = model
    rgb = _photo(*hw, seed=sum(hw))
    want = ref.infer(m, rgb, DAV2_TINY.input_size).numpy()
    got = me.inverse_depth_batch([rgb])
    assert got.shape == (1,) + want.shape == (1,) + DAV2_TINY.input_hw(*hw)
    assert got.dtype == np.float32 and (got >= 0).all()
    assert _gap(got[0], want) < GAP


def _unscaled(real):
    def run(qkv, num_heads, scale, n_valid=None):
        return real(qkv, num_heads, 1.0, n_valid)
    return run


def _taps_before_the_norm(cfg, params, x):
    """``vit.forward_taps`` with each tap taken before the final LayerNorm."""
    B, H, W, _ = x.shape
    gh, gw = H // cfg.patch_size, W // cfg.patch_size
    t = nn.patch_embed(x, params["patch_embed"]["w"], params["patch_embed"]["b"], cfg.patch_size)
    t = torch.cat([params["cls_token"].expand(B, 1, t.shape[2]), t], dim=1)
    t = t + vit.interpolate_pos_embed(params["pos_embed"], gh, gw)
    taps = []
    for i in range(cfg.depth):
        t = vit.block_forward(cfg, {k: v[i] for k, v in params["blocks"].items()}, t)
        if i in cfg.taps:
            taps.append(t[:, 1:].reshape(B, gh, gw, -1))
    return taps


@pytest.mark.parametrize("fault", ["attention_unscaled", "taps_before_the_norm"])
def test_the_tolerance_refuses_a_fault(model, monkeypatch, fault):
    m, _path, me = model
    rgb = _photo(96, 160)
    want = ref.infer(m, rgb, DAV2_TINY.input_size).numpy()
    if fault == "attention_unscaled":
        monkeypatch.setattr(vit, "attention_qkv", _unscaled(vit.attention_qkv))
    else:
        monkeypatch.setattr(vit, "forward_taps", _taps_before_the_norm)
    assert _gap(me.inverse_depth_batch([rgb])[0], want) > 100 * GAP


def test_a_batch_is_its_photos(model):
    m, _path, me = model
    photos = [_photo(96, 160, seed=s) for s in range(3)]
    got = me.inverse_depth_batch(photos, focal_length_35mm=[28.0, None, 50.0])
    assert got.shape == (3, 70, 112)
    for g, rgb in zip(got, photos):
        assert _gap(g, ref.infer(m, rgb, DAV2_TINY.input_size).numpy()) < GAP
    with pytest.raises(ValueError, match="one input size"):
        me.inverse_depth_batch([photos[0], _photo(160, 96)])


# -- the converter -----------------------------------------------------------------------

def test_infer_config_reads_the_published_keys(model):
    m, _path, _me = model
    flat = {k: v.numpy() for k, v in m.state_dict().items()}
    assert convert.infer_config(flat) == DAV2_TINY
    # the published Large's shapes give the published configuration
    with torch.device("meta"):
        large = ref.DepthAnythingV2()
    shapes = {k: np.broadcast_to(np.float32(0), tuple(v.shape))
              for k, v in large.state_dict().items()}
    assert convert.infer_config(shapes) == DAV2_LARGE


def test_converter_gives_the_specs_layouts(model):
    m, _path, _me = model
    flat = {k: v.numpy() for k, v in m.state_dict().items()}
    params = convert.convert_state_dict(DAV2_TINY, flat, convert.PARTS)
    assert set(params) == {"pretrained", "depth_head"}
    spec = param_spec(DAV2_TINY)
    got = tree_map(lambda _p, a: tuple(a.shape), params)
    assert got == spec
    # every published tensor but the mask token is read
    assert sum(a.size for a in tree_leaves(params)) == sum(
        v.numel() for k, v in m.state_dict().items() if not k.endswith("mask_token"))


@pytest.mark.parametrize("k", [2, 4])
def test_deconv_matches_conv_transpose(k):
    g = torch.Generator().manual_seed(k)
    x = torch.randn(2, 5, 7, 6, generator=g)
    w = torch.randn(6, 3, k, k, generator=g)
    b = torch.randn(3, generator=g)
    want = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, b, stride=k).permute(0, 2, 3, 1)
    got = nn.deconv(x, torch.from_numpy(convert.t_deconv(w.numpy())), b, k)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if k == 2:
        assert torch.equal(nn.deconv2x2(x, torch.from_numpy(convert.t_deconv2x2(w.numpy())), b),
                           got)


def test_missing_keys_are_named(model):
    m, _path, _me = model
    flat = {k: v.numpy() for k, v in m.state_dict().items()
            if not k.startswith("depth_head.scratch.refinenet2.")}
    with pytest.raises(convert.CheckpointMissingKeys, match="refinenet2"):
        convert.convert_state_dict(DAV2_TINY, flat)


def test_config_round_trips_through_a_dict():
    for cfg in (DAV2_LARGE, DAV2_TINY):
        d = config_to_dict(cfg)
        assert d["architecture"] == "depth_anything_v2" and config_from_dict(d) == cfg


# -- the position embedding and the resize ----------------------------------------------

@pytest.mark.parametrize("grid", [(37, 66), (37, 49), (49, 37), (37, 37)])
def test_pos_embed_interpolation_is_dinov2s(grid):
    gh, gw = grid
    dino = ref.DinoVisionTransformer(depth=1)
    with torch.no_grad():
        dino.pos_embed.copy_(torch.randn(dino.pos_embed.shape,
                                         generator=torch.Generator().manual_seed(gh * gw)))
    x = torch.zeros(1, 1 + gh * gw, 1024)
    want = dino.interpolate_pos_encoding(x, gh * 14, gw * 14)
    got = vit.interpolate_pos_embed(dino.pos_embed.detach(), gh, gw)
    assert got.shape == (1, 1 + gh * gw, 1024)
    assert torch.equal(got, want.detach())
    if grid == (37, 37):
        assert got is dino.pos_embed.detach() or torch.equal(got, dino.pos_embed)


def test_the_grid_pos_embed_is_computed_once_and_dropped_with_its_weights():
    pe = torch.randn(1, 26, 32, generator=torch.Generator().manual_seed(2))
    a = vit.grid_pos_embed(pe, 5, 8)
    assert vit.grid_pos_embed(pe, 5, 8) is a
    assert torch.equal(a, vit.interpolate_pos_embed(pe, 5, 8))
    assert vit.grid_pos_embed(pe, 8, 5) is not a
    keys = [k for k in vit._GRID_POS_EMBEDS if k[0] == id(pe)]
    assert len(keys) == 2
    del pe
    assert not set(keys) & set(vit._GRID_POS_EMBEDS)


@pytest.mark.parametrize("wh,want", [((1920, 1080), (518, 924)), ((4032, 3024), (518, 686)),
                                     ((3024, 4032), (686, 518)), ((518, 518), (518, 518)),
                                     ((160, 96), (518, 868)), ((641, 480), (518, 686))])
def test_resize_rule(wh, want):
    w, h = wh
    assert DAV2_LARGE.input_hw(h, w) == want == ref.resize_size(h, w)


def test_preprocess_is_the_references(model):
    _m, _path, me = model
    rgb = _photo(123, 301)
    got = me._preprocess(me._load(rgb, None))
    want = ref.image2tensor(rgb, DAV2_TINY.input_size).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


# -- the FLOP ledger ---------------------------------------------------------------------

@pytest.mark.parametrize("cfg,hw", [(DAV2_TINY, (70, 112)), (DAV2_TINY, (154, 70)),
                                    (DAV2_LARGE, (518, 924)), (DAV2_LARGE, (686, 518))])
def test_flops_count_the_references_products(cfg, hw):
    """``flops.dav2_flops`` against PyTorch's count of the reference's
    matmuls and convolutions (the Large on the meta device: shapes only)."""
    device = "meta" if cfg is DAV2_LARGE else "cpu"
    with torch.device(device):
        m = ref.DepthAnythingV2(
            features=cfg.features, out_channels=cfg.out_channels, img_size=cfg.input_size,
            embed_dim=cfg.embed_dim, depth=cfg.depth, num_heads=cfg.num_heads,
            head_features_2=cfg.head_widths[1], intermediate_layer_idx=list(cfg.taps))
        x = torch.zeros(2, 3, *hw)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        m(x)
    assert flops.dav2_flops(cfg, *hw, batch=2)["total"] == counter.get_total_flops()


def test_flops_at_the_published_frame():
    ledger = flops.dav2_flops(DAV2_LARGE, 518, 924)
    assert ledger["total"] == 2583110724096.0
    # the attention: 4 N^2 D a block at N = 2443
    assert 24 * 4 * 2443 ** 2 * 1024 / ledger["total"] == pytest.approx(0.2271, abs=1e-4)
    assert set(ledger) == {"vit", "reassemble", "fusion", "head", "total"}


# -- the session's entries ---------------------------------------------------------------

def test_depth_map_is_relative_and_unclamped(model):
    _m, _path, me = model
    rgb = _photo(96, 160)
    dm = me.depth_map(rgb)
    assert not dm.metric and dm.original_size == (160, 96)
    inv = me.inverse_depth_batch([rgb])[0]
    np.testing.assert_array_equal(dm.to_numpy(), inv)
    np.testing.assert_array_equal(me.inverse_depth(rgb), inv)


@pytest.mark.parametrize("fmt", ["depthmap", "stereogram"])
def test_process_writes_a_png_at_the_photos_size(model, tmp_path, fmt):
    _m, _path, me = model
    src = str(tmp_path / "photo.png")
    Image.fromarray(_photo(96, 160)).save(src)
    out = str(tmp_path / f"{fmt}.png")
    me.process(src, out, image_format=fmt)
    with Image.open(out) as im:
        assert im.size == (160, 96)
        px = np.asarray(im.convert("RGB"))
    assert len(np.unique(px.reshape(-1, 3), axis=0)) > 10


def test_depth_map_spans_the_palette(model, tmp_path):
    """Min-max normalised without the metric clamp: the nearest pixel takes
    one end of the colour map and the farthest the other."""
    from matrix_eyes_tpu_torch.ops.viridis_data import VIRIDIS_B, VIRIDIS_G, VIRIDIS_R
    from matrix_eyes_tpu_torch.output.depthmap import render_depth_map_grid

    _m, _path, me = model
    dm = me.depth_map(_photo(96, 160))
    grid = {tuple(p) for p in render_depth_map_grid(dm.data).numpy().reshape(-1, 3)}
    for i in (0, -1):
        assert (VIRIDIS_R[i], VIRIDIS_G[i], VIRIDIS_B[i]) in grid


def test_a_mesh_is_refused(model, tmp_path):
    _m, _path, me = model
    src = str(tmp_path / "photo.png")
    Image.fromarray(_photo(96, 160)).save(src)
    with pytest.raises(ReconstructionError, match="no metric depth"):
        me.process(src, str(tmp_path / "mesh.ply"))


def test_depth_maps_run_a_forward_per_size(model):
    m, _path, me = model
    photos = [_photo(96, 160, 1), _photo(160, 96, 2), _photo(96, 160, 3)]
    maps = me.depth_maps([me._load(p, None) for p in photos], pad_to_pow2=True)
    assert [tuple(d.data.shape) for d in maps] == [(70, 112), (112, 70), (70, 112)]
    for d, rgb in zip(maps, photos):
        assert _gap(d.to_numpy(), ref.infer(m, rgb, DAV2_TINY.input_size).numpy()) < GAP


@pytest.mark.parametrize("policy", ["bf16", "f16", "mixed", "int8"])
def test_policies_run_the_shared_blocks(model, policy):
    """bf16 and f16 follow from the f32 path; mixed (bf16 ViT block matmul
    weights, the rest f32) and int8 (int8 ViT block weights) run through
    the blocks' own code. Each lands near f32, none falls back to it."""
    m, path, me = model
    rgb = _photo(96, 160)
    f32 = me.inverse_depth_batch([rgb])[0]
    other = MatrixEyes(path, device="cpu", dtype=policy)
    got = other.inverse_depth_batch([rgb])[0]
    assert got.shape == f32.shape and np.isfinite(got).all()
    gap = _gap(got, f32)
    assert 0 < gap < 0.1, gap
    blocks = other.params["pretrained"]["blocks"]
    if policy == "int8":
        assert blocks["qkv_qw"].dtype == torch.int8
    elif policy == "mixed":
        assert blocks["qkv_w"].dtype == torch.bfloat16
        assert other.params["depth_head"]["output_conv1"]["w"].dtype == torch.float32


def test_a_device_mesh_is_refused(model):
    from matrix_eyes_tpu_torch.parallel.sharding import Mesh

    _m, _path, me = model
    mesh = Mesh(data=1, model=2, rank=0, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ReconstructionError, match="one device"):
        me.inverse_depth_batch([_photo(96, 160)], mesh=mesh)


def test_cli_writes_a_depth_map(model, tmp_path):
    _m, path, _me = model
    src = str(tmp_path / "photo.jpg")
    Image.fromarray(_photo(96, 160)).save(src, quality=95)
    out = str(tmp_path / "out.png")
    assert cli.main([f"--checkpoint-path={path}", "--dtype=f32", src, out], device="cpu") == 0
    with Image.open(out) as im:
        assert im.size == (160, 96)
    assert cli.main([f"--checkpoint-path={path}", src, str(tmp_path / "m.obj")],
                    device="cpu") != 0


def test_forward_is_the_sessions(model):
    """``models.depth_anything.forward`` on a preprocessed batch is what the
    session returns, and its input grid is the patch grid times 14."""
    _m, _path, me = model
    rgb = _photo(96, 160)
    img = me._preprocess(me._load(rgb, None))
    assert tuple(img.shape) == (1, 70, 112, 3) and math.gcd(70, 112) % 14 == 0
    np.testing.assert_array_equal(depth_anything.forward(me.cfg, me.params, img)[0].numpy(),
                                  me.inverse_depth_batch([rgb])[0])


def test_cli_directory_batches_each_size(model, tmp_path):
    """``--batch-size`` over a directory of landscape and portrait photos:
    a forward per input size, every file written at its photo's size."""
    _m, path, _me = model
    src, out = tmp_path / "src", tmp_path / "out"
    src.mkdir()
    out.mkdir()
    sizes = {"a.png": (96, 160), "b.png": (160, 96), "c.png": (96, 160)}
    for name, hw in sizes.items():
        Image.fromarray(_photo(*hw, seed=len(name) + hw[0])).save(str(src / name))
    assert cli.main([f"--checkpoint-path={path}", "--dtype=f32", "--batch-size=2", str(src),
                     str(out)], device="cpu") == 0
    for name, (h, w) in sizes.items():
        with Image.open(str(out / name)) as im:
            assert im.size == (w, h)


def test_server_answers_with_relative_depth(model):
    import io
    import json
    import threading
    import urllib.request

    from matrix_eyes_tpu_torch.serve import create_server

    _m, _path, me = model
    rgb = _photo(96, 160)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG")
    server = create_server(me, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz") as r:
            assert json.loads(r.read())["model"] == "depth_anything_v2"
        req = urllib.request.Request(base + "/v1/depth", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req) as r:
            got = np.load(io.BytesIO(r.read()))
        np.testing.assert_array_equal(got, me.inverse_depth(rgb))
        req = urllib.request.Request(base + "/v1/process?format=depthmap", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req) as r:
            with Image.open(io.BytesIO(r.read())) as im:
                assert im.size == (160, 96)
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
