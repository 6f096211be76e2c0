"""The PyTorch port's weight caches (``pt/loader.py``, ``--convert-checkpoints``)
against the JAX package's (``matrix_eyes_tpu/pt/loader.py``), on the CPU.

Each package loads its own copy of one ``torch_ref`` TINY checkpoint: a
cold ``load_checkpoint(convert_checkpoints=True)`` that writes the caches,
then a warm load that reads them. Under every policy the port's leaves
equal the JAX package's bit for bit, cold against cold and warm against
warm (the comparison of tests/test_torch_dtypes.py: the port stores int8
codes (out, in) and the FOV's float leaves f32). The float policies' warm
leaves are dtype(f16(x)), not the cold run's dtype(x), in both packages.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from matrix_eyes_tpu import cli as jcli
from matrix_eyes_tpu.config import TINY as J_TINY
from matrix_eyes_tpu.pt import loader as jloader
from matrix_eyes_tpu_torch import cli as tcli
from matrix_eyes_tpu_torch.config import TINY, parse_dtype_policy
from matrix_eyes_tpu_torch.errors import LoaderError
from matrix_eyes_tpu_torch.pt import convert as tconvert
from matrix_eyes_tpu_torch.pt import loader as tloader

import torch_ref

POLICIES = ("f32", "bf16", "f16", "int8", "mixed")
_J_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16,
             "int8": jnp.bfloat16, "mixed": jnp.bfloat16}
_T_PARTS = ("encoder.torch.f16.pt", "decoder.torch.f16.pt", "head.torch.f16.pt",
            "fov.torch.f16.pt")


@pytest.fixture(scope="module")
def tiny_pt(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_loader")
    path = str(d / "tiny.pt")
    torch.save(torch_ref.randomize(torch_ref.DepthPro(J_TINY), seed=21).state_dict(), path)
    return path


def _copy(src: str, d) -> str:
    os.makedirs(d, exist_ok=True)
    dst = os.path.join(str(d), "m.pt")
    shutil.copy2(src, dst)
    return dst


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _assert_leaves_equal(jp, tp):
    jleaves, tleaves = dict(_flat(jp)), dict(_flat(tp))
    assert set(jleaves) == set(tleaves)
    for path, j in jleaves.items():
        t, j = tleaves[path], np.asarray(j)
        if str(path[-1]).endswith("_qw"):
            assert t.dtype == torch.int8 and j.dtype == np.int8, path
            np.testing.assert_array_equal(t.numpy(), np.swapaxes(j, -1, -2), err_msg=str(path))
            continue
        if path[0] == "fov":
            assert t.dtype == torch.float32, path
        else:
            assert str(t.dtype).split(".")[-1] == j.dtype.name, (path, t.dtype, j.dtype)
        np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32),
                                      err_msg=str(path))


def _assert_same(a, b):
    """Two of the port's trees: the same leaves, dtypes and bits."""
    aleaves, bleaves = dict(_flat(a)), dict(_flat(b))
    assert set(aleaves) == set(bleaves)
    for path, x in aleaves.items():
        y = bleaves[path]
        assert x.dtype == y.dtype and torch.equal(x, y), path


def _t_load(path, policy, **kw):
    dtype, q8, mixed = parse_dtype_policy(policy)
    return tloader.load_checkpoint(path, dtype, "cpu", quantize_int8=q8, mixed_bf16=mixed,
                                   **kw)


def _j_load(path, policy, **kw):
    _dtype, q8, mixed = parse_dtype_policy(policy)
    return jloader.load_checkpoint(path, dtype=_J_DTYPES[policy], quantize_int8=q8,
                                   mixed_bf16=mixed, **kw)


def _no_pt_reads(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a warm load read the .pt")

    monkeypatch.setattr(tconvert, "read_checkpoint", boom)
    monkeypatch.setattr(jloader, "read_pt_state_dict", boom)


@pytest.mark.parametrize("policy", POLICIES)
def test_cold_and_warm_leaves_match_jax(tiny_pt, tmp_path, monkeypatch, policy):
    jpath, tpath = _copy(tiny_pt, tmp_path / "jax"), _copy(tiny_pt, tmp_path / "torch")
    jcfg, jcold = _j_load(jpath, policy, convert_checkpoints=True)
    tcfg, tcold = _t_load(tpath, policy, convert_checkpoints=True)
    assert tcfg == TINY and jcfg == J_TINY
    _assert_leaves_equal(jcold, tcold)
    written = sorted(os.listdir(tmp_path / "torch"))
    kind = {"int8": "int8", "mixed": "mixed"}.get(policy)
    want = ["m-torch-config.json", "m.pt"] + [f"m-{p}" for p in _T_PARTS]
    if kind:
        want += [f"m-{p}.torch.{kind}.pt" for p in ("encoder", "decoder", "head", "fov")]
    assert written == sorted(want)

    _no_pt_reads(monkeypatch)
    jcfg2, jwarm = _j_load(jpath, policy)
    tcfg2, twarm = _t_load(tpath, policy)
    assert tcfg2 == tcfg and jcfg2 == jcfg
    _assert_leaves_equal(jwarm, twarm)
    if policy in ("f32", "bf16"):
        # the f16 on-disk convention: the warm leaves differ from the cold ones
        _, encoder_cold = next(_flat(tcold["encoder"]["patch_encoder"]["blocks"]["qkv_w"]))
        _, encoder_warm = next(_flat(twarm["encoder"]["patch_encoder"]["blocks"]["qkv_w"]))
        assert not torch.equal(encoder_cold, encoder_warm)


def test_int8_warm_from_the_f16_cache(tiny_pt, tmp_path, monkeypatch):
    # only the float caches (a bf16 run converted): the int8 run quantizes
    # from them, as the JAX package's does, and reads no .pt
    jpath, tpath = _copy(tiny_pt, tmp_path / "jax"), _copy(tiny_pt, tmp_path / "torch")
    _j_load(jpath, "bf16", convert_checkpoints=True)
    _t_load(tpath, "bf16", convert_checkpoints=True)
    _no_pt_reads(monkeypatch)
    _, jq = _j_load(jpath, "int8", convert_checkpoints=True)
    _, tq = _t_load(tpath, "int8", convert_checkpoints=True)
    _assert_leaves_equal(jq, tq)
    assert os.path.exists(str(tmp_path / "torch" / "m-head.torch.int8.pt"))
    _, tq2 = _t_load(tpath, "int8")  # and from the int8 cache it wrote
    _assert_leaves_equal(jq, tq2)


def test_mixed_never_derives_from_the_f16_cache(tiny_pt, tmp_path, monkeypatch):
    tpath = _copy(tiny_pt, tmp_path)
    _t_load(tpath, "bf16", convert_checkpoints=True)
    reads = []
    real = tconvert.read_checkpoint
    monkeypatch.setattr(tconvert, "read_checkpoint",
                        lambda *a, **k: reads.append(a[1]) or real(*a, **k))
    _, mixed = _t_load(tpath, "mixed")
    assert reads == [("encoder", "decoder", "head", "fov")]
    _, exact = tconvert.load_checkpoint(tpath, torch.bfloat16, "cpu", mixed_bf16=True)
    _assert_same(exact, mixed)


def test_shared_directory(tiny_pt, tmp_path, monkeypatch):
    # both packages' caches beside one .pt: each warm load reads only its own
    path = _copy(tiny_pt, tmp_path)
    _j_load(path, "bf16", convert_checkpoints=True)
    jax_files = {n: os.stat(os.path.join(str(tmp_path), n)).st_mtime_ns
                 for n in os.listdir(tmp_path)}
    reads = []
    real = tconvert.read_checkpoint
    monkeypatch.setattr(tconvert, "read_checkpoint",
                        lambda *a, **k: reads.append(a[1]) or real(*a, **k))
    _, tcold = _t_load(path, "bf16", convert_checkpoints=True)
    assert len(reads) == 1  # the JAX package's caches are not the port's
    now = set(os.listdir(tmp_path))
    assert now - set(jax_files) == {"m-torch-config.json"} | {f"m-{p}" for p in _T_PARTS}
    assert {n: os.stat(os.path.join(str(tmp_path), n)).st_mtime_ns
            for n in jax_files} == jax_files
    _no_pt_reads(monkeypatch)
    _, jwarm = _j_load(path, "bf16")
    _, twarm = _t_load(path, "bf16")
    _assert_leaves_equal(jwarm, twarm)


def test_replaced_checkpoint_ignores_then_purges_the_ports_caches(tiny_pt, tmp_path):
    path = _copy(tiny_pt, tmp_path)
    _j_load(path, "f32", convert_checkpoints=True)
    _, old = _t_load(path, "f32", convert_checkpoints=True)
    # a different checkpoint at the same path: a new size or mtime
    torch.save(torch_ref.randomize(torch_ref.DepthPro(J_TINY), seed=99).state_dict(), path)
    now = os.stat(path).st_mtime + 10
    os.utime(path, (now, now))
    before = {n: os.stat(os.path.join(str(tmp_path), n)).st_mtime_ns
              for n in os.listdir(tmp_path)}
    assert tloader._caches_stale(path)
    _, new = _t_load(path, "f32", parts=("head",))
    fresh = tconvert.load_checkpoint(path, torch.float32, "cpu", parts=("head",))[1]
    _assert_same(fresh, new)
    assert not torch.equal(old["head"]["conv0_w"], new["head"]["conv0_w"])
    after = {n: os.stat(os.path.join(str(tmp_path), n)).st_mtime_ns
             for n in os.listdir(tmp_path)}
    assert after == before  # without the flag nothing is written
    # with the flag only the port's files go and come back; fov is not
    # reloaded, so its old cache must go rather than stay stamped as fresh
    _t_load(path, "f32", convert_checkpoints=True, parts=("encoder", "decoder", "head"))
    names = set(os.listdir(tmp_path))
    assert "m-fov.torch.f16.pt" not in names
    assert "m-head.torch.f16.pt" in names and not tloader._caches_stale(path)
    for name, mtime in before.items():
        if ".torch." not in name and "-torch-" not in name and name != "m.pt":
            assert os.stat(os.path.join(str(tmp_path), name)).st_mtime_ns == mtime, name


def test_unwritable_directory_warns_and_loads(tiny_pt, tmp_path, monkeypatch, capsys):
    path = _copy(tiny_pt, tmp_path)

    def refuse(*a, **k):
        raise OSError(30, "Read-only file system")

    real_open = open

    def read_only_open(file, mode="r", *a, **k):
        if "w" in mode:
            refuse()
        return real_open(file, mode, *a, **k)

    monkeypatch.setattr(tloader, "save_part_cache", refuse)
    monkeypatch.setattr(tloader, "open", read_only_open, raising=False)
    _, params = _t_load(path, "bf16", convert_checkpoints=True)
    _, plain = tconvert.load_checkpoint(path, torch.bfloat16, "cpu")
    _assert_same(plain, params)
    err = capsys.readouterr().err
    assert "warning: could not write f16 cache for 'encoder'" in err
    assert "warning: could not write config cache" in err
    assert os.listdir(tmp_path) == ["m.pt"]


def test_corrupt_cache_is_a_loader_error(tiny_pt, tmp_path):
    path = _copy(tiny_pt, tmp_path)
    _t_load(path, "f32", convert_checkpoints=True)
    head = str(tmp_path / "m-head.torch.f16.pt")
    blob = torch.load(head, weights_only=True)
    blob["leaves"][0] = blob["leaves"][0][..., :1].clone()
    torch.save(blob, head)
    with pytest.raises(LoaderError, match="stale cache"):
        _t_load(path, "f32")
    with open(head, "r+b") as f:
        f.truncate(100)
    with pytest.raises(LoaderError, match="stale cache"):
        _t_load(path, "f32")


def test_missing_checkpoint_and_cache(tmp_path):
    with pytest.raises(LoaderError, match="no such file"):
        _t_load(str(tmp_path / "nope.pt"), "f32")


def test_use_caches_false_touches_no_cache(tiny_pt, tmp_path):
    path = _copy(tiny_pt, tmp_path)
    _t_load(path, "f32", convert_checkpoints=True)
    before = sorted(os.listdir(tmp_path))
    _, params = _t_load(path, "f32", use_caches=False, convert_checkpoints=True)
    assert sorted(os.listdir(tmp_path)) == before
    _, plain = tconvert.load_checkpoint(path, torch.float32, "cpu")
    _assert_same(plain, params)  # the .pt's f32 values, not f16(x)


def test_symlinked_checkpoint_shares_caches(tiny_pt, tmp_path):
    real = _copy(tiny_pt, tmp_path / "real")
    os.makedirs(tmp_path / "link")
    link = str(tmp_path / "link" / "m.pt")
    os.symlink(real, link)
    _t_load(real, "f32", convert_checkpoints=True)
    assert os.path.exists(str(tmp_path / "real" / "m-head.torch.f16.pt"))
    _, via_link = _t_load(link, "f32", convert_checkpoints=True)
    assert os.listdir(tmp_path / "link") == ["m.pt"]
    _, direct = _t_load(real, "f32")
    _assert_same(direct, via_link)


# --- the CLI ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_loader_cli")
    src = str(d / "photo.jpg")
    yy, xx = np.mgrid[0:480, 0:640]
    rgb = np.stack([xx * 255 // 639, yy * 255 // 479, (xx + yy) * 255 // 1118], -1)
    rgb = (rgb + np.random.RandomState(2).randint(-20, 21, rgb.shape)).clip(0, 255)
    Image.fromarray(rgb.astype(np.uint8)).save(src, quality=95)
    return src


def test_cli_parses_convert_checkpoints():
    args = tcli.parse_args(["--convert-checkpoints", "--dtype=int8", "a.jpg", "b.png"])
    assert args.convert_checkpoints and args.dtype == "int8"
    assert not tcli.parse_args(["a.jpg", "b.png"]).convert_checkpoints


def test_cli_convert_then_warm_matches_jax_cli(tiny_pt, photo, tmp_path, monkeypatch):
    jpath, tpath = _copy(tiny_pt, tmp_path / "jax"), _copy(tiny_pt, tmp_path / "torch")
    outs = {}
    for run in ("cold", "warm"):
        flag = ["--convert-checkpoints"] if run == "cold" else []
        outs["jax", run], outs["torch", run] = (str(tmp_path / f"{p}_{run}.png")
                                                for p in ("jax", "torch"))
        assert jcli.main(flag + [f"--checkpoint-path={jpath}", "--focal-length=28", photo,
                                 outs["jax", run]]) == 0
        assert tcli.main(flag + [f"--checkpoint-path={tpath}", "--focal-length=28", photo,
                                 outs["torch", run]], device="cpu") == 0
        if run == "cold":
            # a known focal length: the FOV part is neither loaded nor cached
            assert sorted(n for n in os.listdir(tmp_path / "torch") if ".torch." in n) == [
                "m-decoder.torch.f16.pt", "m-encoder.torch.f16.pt", "m-head.torch.f16.pt"]
            _no_pt_reads(monkeypatch)
    for run in ("cold", "warm"):
        a = np.asarray(Image.open(outs["torch", run]).convert("RGB")).astype(int)
        b = np.asarray(Image.open(outs["jax", run]).convert("RGB")).astype(int)
        assert a.shape == b.shape == (480, 640, 3)
        assert len(np.unique(b.reshape(-1, 3), axis=0)) > 1000
        # the rule of test_cli_matches_jax_cli
        assert (np.abs(a - b) <= 2).all(axis=-1).mean() >= 0.999, run
