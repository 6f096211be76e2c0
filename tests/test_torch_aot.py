"""The port's CUDA-graph cache (``matrix_eyes_tpu_torch/aot.py``) on the CPU.

The cache's bookkeeping (keys, the warm-up call, capture, replay, the
launch counters, threads, the bound, failures) runs here through a capture
backend that needs no card; the graphs themselves are captured and
replayed on the card by ``chip_smoke.py`` phase 17. Also here: the program
names the pipeline, the library session and the outputs pass to
``call_cached`` (the JAX package's), their results against the JAX
package, the device constants of the resamplers and the colour map, the
forwards' device-tensor focal lengths, and ``--profile=DIR``.
"""

import collections
import contextlib
import glob
import json
import os
import sys
import threading
import time

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
from matrix_eyes_tpu_torch import aot
from matrix_eyes_tpu_torch import cli as tcli
from matrix_eyes_tpu_torch.api import MatrixEyes
from matrix_eyes_tpu_torch.config import TINY, RuntimeConfig
from matrix_eyes_tpu_torch.models import depth_pro as tdepth_pro
from matrix_eyes_tpu_torch.ops import _build, colormap, resize
from matrix_eyes_tpu_torch.output.depthmap import ImageOutputFormat
from matrix_eyes_tpu_torch.parallel import collectives
from matrix_eyes_tpu_torch.parallel.sharding import Mesh
from matrix_eyes_tpu_torch import pipeline
from matrix_eyes_tpu_torch.pipeline import extract_depth, extract_depth_batch
from matrix_eyes_tpu_torch.pt.convert import from_jax_params

import torch_ref


class FakeGraphs(aot.HostGraphs):
    """The package's capture backend without a card (the warm-up runs the
    program, a "capture" runs its Python once more, as capturing on the
    card does, a replay runs nothing), which can also wait before the
    capture or fail it."""

    def __init__(self, fail: bool = False, delay: float = 0.0):
        super().__init__()
        self.fail, self.delay = fail, delay

    def warm_and_capture(self, device, warm, capture):
        def failing_capture():
            time.sleep(self.delay)
            if self.fail:
                raise RuntimeError("operation not permitted when stream is capturing")
            return capture()

        return super().warm_and_capture(device, warm, failing_capture)


@pytest.fixture
def counters():
    """The launch ledger, empty for the test and restored after it."""
    snap = collections.Counter(_build.ledger)
    _build.reset()
    yield
    _build.reset()
    _build.ledger.update(snap)


@pytest.fixture
def graphs_on(monkeypatch):
    monkeypatch.delenv("MATRIX_EYES_AOT", raising=False)


def _tree():
    return {"w": torch.ones(3, 3), "blocks": [torch.zeros(2), torch.ones(4)], "n": 2}


def _program(params, x, scale):
    return x @ params["w"] * scale


# -- the key ---------------------------------------------------------------------------

_TREE = _tree()
_X = torch.arange(12.0).reshape(4, 3)


@pytest.mark.parametrize("change", [
    "shape", "dtype", "strides", "salt", "tree", "value", "matmul_tf32", "cudnn_tf32",
    "bf16_reduction"])
def test_key_changes_with(change, monkeypatch):
    cache = aot.GraphCache(FakeGraphs())
    base = cache.key("fwd", (_TREE, _X, 2.0), "cfg")
    name, args, salt = "fwd", [_TREE, _X, 2.0], "cfg"
    if change == "shape":
        args[1] = torch.zeros(5, 3)
    elif change == "dtype":
        args[1] = _X.double()
    elif change == "strides":
        args[1] = torch.zeros(3, 4).t()
    elif change == "salt":
        salt = "other cfg"
    elif change == "tree":  # the same values in other tensors: another graph
        args[0] = {k: (v.clone() if isinstance(v, torch.Tensor) else
                       [t.clone() for t in v] if isinstance(v, list) else v)
                   for k, v in _TREE.items()}
    elif change == "value":
        args[2] = 3.0
    elif change == "matmul_tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    elif change == "cudnn_tf32":
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                            not torch.backends.cudnn.allow_tf32)
    elif change == "bf16_reduction":
        flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        monkeypatch.setattr(torch.backends.cuda.matmul,
                            "allow_bf16_reduced_precision_reduction", not flag)
    assert cache.key(name, tuple(args), salt) != base


def test_key_changes_with_the_mesh():
    # the JAX package salts a sharded forward with |mesh=: a mesh's key
    # names its (data, model) shape and its backend
    args = (_TREE, _X, 2.0)
    keys = [aot.GraphCache(FakeGraphs()).key("fwd_fov", args, "cfg")]
    for data, model, backend in ((1, 2, "nccl"), (2, 1, "nccl"), (1, 2, "gloo"), (2, 2, "nccl")):
        mesh = Mesh(data=data, model=model, backend=backend)
        keys.append(aot.MeshGraphCache(mesh, FakeGraphs()).key("fwd_fov", args, "cfg"))
    assert len(set(keys)) == len(keys)
    # the same shape and backend on another rank: the same program
    other = Mesh(data=1, model=2, rank=1, backend="nccl")
    assert aot.MeshGraphCache(other, FakeGraphs()).key("fwd_fov", args, "cfg") == keys[1]


def test_key_is_the_same_for_the_same_leaves():
    # a new dict over the same tensors is the same weights: one graph
    cache = aot.GraphCache(FakeGraphs())
    wrapper = dict(_TREE)
    assert cache.key("fwd", (wrapper, _X, 2.0)) == cache.key("fwd", (_TREE, _X.clone(), 2.0))
    assert cache.key("fwd", (_TREE, _X)) != cache.key("fwd_fov", (_TREE, _X))


# -- eager paths -----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["cpu", "aot_off"])
def test_eager_calls_run_fn_every_time(mode, monkeypatch):
    calls = []

    def fn(params, x, scale):
        calls.append(1)
        return _program(params, x, scale)

    if mode == "cpu":  # the process's cache: CPU tensors never capture
        monkeypatch.delenv("MATRIX_EYES_AOT", raising=False)
        call = aot.call_cached
    else:  # a backend that would capture, switched off by the JAX package's switch
        monkeypatch.setenv("MATRIX_EYES_AOT", "off")
        backend = FakeGraphs()
        call = aot.GraphCache(backend).call
    for i in range(4):
        x = _X + i
        got = call("fwd", fn, (_TREE, x, 2.0))
        torch.testing.assert_close(got, _program(_TREE, x, 2.0), rtol=0, atol=0)
    assert len(calls) == 4
    if mode == "aot_off":
        assert backend.captures == backend.replays == 0


# -- capture and replay ----------------------------------------------------------------

_ATTENTION = (35, 577, 16, 64, "bfloat16", "resident")
_CONV = (1, 768, 768, 256, 256, torch.bfloat16, True, 2, True)
_GATHER = (36, 24, 24, 1024)


def _launch_everything():
    """What the kernel wrappers count when their kernels launch, and the
    collectives when a mesh's forward calls them (results on the meta
    device: a shape and a dtype, no memory)."""
    _build.check_launch(0, "attention_qkv", *_ATTENTION)
    _build.check_launch(0, "attention_flash")
    for _ in range(2):
        _build.check_launch(0, "conv3x3", *_CONV)
    _build.check_launch(0, "linker_scan")
    for _ in range(2):
        collectives._count("all-reduce", torch.empty(1024, device="meta"))
    collectives._count("all-gather", torch.empty(_GATHER, dtype=torch.bfloat16, device="meta"))


@pytest.mark.parametrize("replays", [1, 5])
def test_replays_add_the_capture_counts(replays, counters, graphs_on):
    backend = FakeGraphs()
    cache = aot.GraphCache(backend)
    calls = []

    def fn(x):
        calls.append(1)
        _launch_everything()
        return x * 2

    for _ in range(2 + replays):
        torch.testing.assert_close(cache.call("fwd_fov", fn, (_X,)), _X * 2)
    # the eager call, the capture call's eager run, then one capture that
    # counts nothing itself; every replay adds what the capture recorded
    assert len(calls) == 3 and backend.captures == 1 and backend.replays == replays
    runs = 2 + replays
    assert _build.launches("attention_qkv") == collections.Counter({_ATTENTION: runs})
    assert _build.launches("attention_flash") == collections.Counter({(): runs})
    assert _build.launches("conv3x3") == collections.Counter({_CONV: 2 * runs})
    assert _build.launches("linker_scan").total() == runs
    # the collectives of a mesh's forward: calls, bytes and the gather
    # shapes a replay adds as the eager call did
    assert collectives.stats() == {
        "all-reduce": {"calls": 2 * runs, "bytes": 2 * 4096 * runs},
        "all-gather": {"calls": runs, "bytes": 36 * 24 * 24 * 1024 * 2 * runs}}
    assert collectives.gather_shapes() == [_GATHER] * runs


def test_a_kernel_the_cache_never_heard_of_is_counted_on_replay(counters, graphs_on):
    backend = FakeGraphs()
    cache = aot.GraphCache(backend)

    def fn(x):
        _build.check_launch(0, "a_kernel_added_later", tuple(x.shape))
        return x + 1

    for i in range(5):
        cache.call("fwd", fn, (_X,))
        assert _build.launches("a_kernel_added_later") == collections.Counter({((4, 3),): i + 1})
    assert backend.captures == 1 and backend.replays == 3


def test_a_failed_launch_is_not_counted(counters):
    _build.check_launch(0, "conv3x3", *_CONV)
    before = collections.Counter(_build.ledger)
    with pytest.raises(RuntimeError, match="conv3x3 launch failed with code 700"):
        _build.check_launch(700, "conv3x3", *_CONV)
    assert _build.ledger == before


def test_reset_clears_every_kernel_and_collective(counters):
    from matrix_eyes_tpu_torch.parallel import checks

    kernels = ("attention_qkv", "attention_flash", "conv3x3", "linker_scan", "threefry",
               "gelu", "scaled_residual", "resize_bilinear")
    for kernel in kernels:
        _build.check_launch(0, kernel, 1)
    collectives._count("all-reduce", torch.empty(1024, device="meta"))
    collectives._count("all-gather", torch.empty(_GATHER, device="meta"))
    counts = checks._kernel_counts()
    assert {k: counts[k] for k in kernels} == dict.fromkeys(kernels, 1)
    assert set(collectives.stats()) == {"all-reduce", "all-gather"}
    _build.reset()
    counts = checks._kernel_counts()
    assert {k: counts[k] for k in kernels} == dict.fromkeys(kernels, 0)
    assert counts["attention_by_shape"] == counts["conv3x3_by_batch"] == {}
    assert collectives.stats() == {} and collectives.gather_shapes() == []
    assert not _build.ledger


def test_replay_copies_inputs_and_clones_outputs(graphs_on):
    # the static input takes each call's tensor; a replay's result is a
    # fresh tensor, never the graph's own output
    backend = FakeGraphs()
    cache = aot.GraphCache(backend)
    seen = []

    def fn(x):
        seen.append(x)
        return x + 1

    a, b, c = torch.ones(3), torch.full((3,), 2.0), torch.full((3,), 3.0)
    cache.call("p", fn, (a,))
    cache.call("p", fn, (b,))
    static = seen[-1]
    assert static is not b and torch.equal(static, b)
    out1 = cache.call("p", fn, (c,))
    out2 = cache.call("p", fn, (c,))
    assert torch.equal(static, c) and out1 is not out2
    assert out1.data_ptr() != out2.data_ptr()


def test_concurrent_cold_calls_capture_once(graphs_on):
    # the port of tests/test_aot.py::test_concurrent_cold_misses_compile_once:
    # four threads on one cold key; the first call warms, one captures
    backend = FakeGraphs(delay=0.05)
    cache = aot.GraphCache(backend)
    eager = []
    barrier = threading.Barrier(4)
    errors = []

    def fn(x):
        eager.append(1)
        return x * 3

    def worker():
        try:
            barrier.wait(timeout=10)
            for _ in range(3):
                torch.testing.assert_close(cache.call("fwd_fnorm", fn, (_X,)), _X * 3)
        except Exception as err:  # reported below
            errors.append(err)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert backend.captures == 1 and backend.replays == 10 and len(eager) == 3


def test_the_bound_evicts_the_oldest_graph(graphs_on):
    backend = FakeGraphs()
    cache = aot.GraphCache(backend, capacity=2)
    for name in ("a", "b", "c"):
        for _ in range(2):
            cache.call(name, lambda x: x + 1, (_X,))
    assert cache.live() == ["b", "c"] and backend.captures == 3
    cache.call("a", lambda x: x + 1, (_X,))  # evicted: captured again
    assert cache.live() == ["c", "a"] and backend.captures == 4


def test_a_freed_parameter_tree_ends_its_graph(graphs_on):
    cache = aot.GraphCache(FakeGraphs())
    params = {"w": torch.ones(3, 3)}
    for _ in range(2):
        cache.call("fwd", _program, (params, _X, 1.0))
    assert cache.live() == ["fwd"]
    del params  # the graph read these weights: it must never replay again
    assert cache.live() == []


@pytest.mark.parametrize("where", ["process", "mesh"])
def test_a_failed_capture_raises_without_an_eager_fallback(graphs_on, where):
    if where == "process":
        cache = aot.GraphCache(FakeGraphs(fail=True))
    else:  # a mesh of one rank, whose lock step has no other rank to ask
        cache = aot.MeshGraphCache(Mesh(data=1, model=1, backend="nccl"), FakeGraphs(fail=True))
    calls = []

    def fn(x):
        calls.append(1)
        return x

    cache.call("render_depthmap", fn, (_X,))  # the warm-up
    with pytest.raises(RuntimeError, match="capture of render_depthmap failed"):
        cache.call("render_depthmap", fn, (_X,))
    # the capture call's own eager run, and no call of fn behind the failure
    assert len(calls) == 2 and cache.live() == []


def test_a_mesh_cache_records_each_calls_mode(graphs_on):
    mesh = Mesh(data=1, model=1, backend="nccl")
    cache = aot.mesh_cache(mesh, FakeGraphs())
    assert aot.mesh_cache(mesh) is cache and aot.mesh_cache(Mesh(1, 1)) is not cache
    for _ in range(3):
        cache.call("fwd_fov", lambda x: x + 1, (_X,))
    with aot.disabled():
        cache.call("fwd_fov", lambda x: x + 1, (_X,))
    assert list(cache.modes) == [("fwd_fov", m) for m in ("eager", "capture", "replay", "eager")]


@pytest.mark.parametrize("where", ["process", "mesh"])
def test_each_call_records_a_dispatch_span_with_its_program(graphs_on, monkeypatch, where):
    # the spans' count by mode is the replay counter; each names its program
    from matrix_eyes_tpu_torch import timings

    monkeypatch.setenv("MATRIX_EYES_TIMINGS", "1")
    timings.clear()
    cache = (aot.GraphCache(FakeGraphs()) if where == "process"
             else aot.mesh_cache(Mesh(data=1, model=1, backend="nccl"), FakeGraphs()))
    try:
        for name in ("fwd_fnorm", "fwd_fnorm", "render_depthmap", "fwd_fnorm", "fwd_fnorm"):
            cache.call(name, lambda x: x + 1, (_X,))
        with aot.disabled():
            cache.call("fwd_fnorm", lambda x: x + 1, (_X,))
        spans = timings.recorded()
    finally:
        timings.clear()
    assert [(s.name, s.attrs) for s in spans] == [
        ("dispatch.eager", {"program": "fwd_fnorm"}), ("dispatch.capture", {"program": "fwd_fnorm"}),
        ("dispatch.eager", {"program": "render_depthmap"}),
        ("dispatch.replay", {"program": "fwd_fnorm"}), ("dispatch.replay", {"program": "fwd_fnorm"}),
        ("dispatch.eager", {"program": "fwd_fnorm"})]
    assert [m for _n, m in cache.modes] == [s.name.split(".")[1] for s in spans]
    assert all(s.parent is None and s.start_ns <= s.end_ns for s in spans)


def test_a_gloo_mesh_never_reaches_the_capture_backend(graphs_on, monkeypatch):
    # gloo stages CUDA tensors through host memory: its mesh's forwards run
    # eagerly by rule, on every call, and no graph backend is consulted
    def refuse(*_args, **_kwargs):
        raise AssertionError("a gloo mesh reached the CUDA-graph backend")

    monkeypatch.setattr(aot.CudaGraphs, "applies", refuse)
    monkeypatch.setattr(aot.CudaGraphs, "warm_and_capture", refuse)
    mesh = Mesh(data=1, model=2, backend="gloo")
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    for _ in range(4):
        torch.testing.assert_close(pipeline._program(mesh, "fwd_fov", fn, (_X,), "cfg"), _X * 2)
    cache = aot.mesh_cache(mesh)
    assert isinstance(cache.backend, aot.NoGraphs) and len(calls) == 4
    assert [m for _n, m in cache.modes] == ["eager"] * 4 and cache.live() == []


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "broadcast"])
def test_a_gloo_collective_refuses_a_capture(kind, monkeypatch):
    # a capture would record the pinned-memory copies but not gloo's
    # exchange: the collective raises, naming its kind, before any of it
    t = torch.ones(4)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    mesh = Mesh(data=2, model=2, backend="gloo")
    call = {"all-reduce": lambda: collectives.all_reduce_sum(t, mesh, "model"),
            "all-gather": lambda: collectives.all_gather_rows(t, mesh, "data"),
            "broadcast": lambda: collectives.broadcast(t, mesh)}[kind]
    with pytest.raises(RuntimeError, match=f"a gloo {kind} cannot be captured"):
        call()


def test_a_pool_whose_graphs_were_all_freed_is_not_captured_into(monkeypatch):
    # the allocator refuses a capture into a pool whose graphs have all been
    # freed (until its memory is released): the card's backend shares one
    # pool among live graphs and opens a new one once the last is gone
    handles = iter(range(1, 100))
    pools = []

    class Stream:
        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

    class Graph:
        def capture_begin(self, pool, capture_error_mode):
            pools.append(pool)

        def capture_end(self):
            pass

    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: next(handles))
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    backend, dev = aot.CudaGraphs(), torch.device("cuda", 0)

    def capture():
        return backend.warm_and_capture(dev, lambda: None, lambda: None)[1]

    first, second = capture(), capture()
    del first
    third = capture()  # the pool still has a live graph: shared
    del second, third
    assert backend.memory(dev) == 0  # no pool of live graphs: nothing to count
    capture()  # every graph of the pool is gone: a new pool
    assert pools == [1, 1, 1, 2]


# -- the device constants --------------------------------------------------------------

def test_constants_reach_the_device_once(monkeypatch):
    made = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda a: made.append(a.shape) or real(a))
    img = torch.rand(17, 23, 3)
    depth = torch.rand(19, 21)
    value = torch.rand(5, 7)
    first = (resize.resize_lanczos3(img, 29, 31), resize.depthmap_bilinear_resample(depth, 13, 11),
             colormap.map_depth(value))
    made.clear()
    again = (resize.resize_lanczos3(img, 29, 31), resize.depthmap_bilinear_resample(depth, 13, 11),
             colormap.map_depth(value))
    assert made == []
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_a_capture_keeps_its_constants_alive():
    held = []
    aot._capturing.held = held
    try:
        resize.resize_lanczos3(torch.rand(9, 8, 3), 4, 5)
        colormap.map_depth(torch.rand(3))
    finally:
        aot._capturing.held = None
    assert [tuple(t.shape) for t in held] == [(4, 9), (5, 8), (256, 3)]


# -- the forwards take the focal lengths as tensors ------------------------------------

@pytest.fixture(scope="module")
def tiny_params():
    jparams = j_init_params(J_TINY, seed=11)
    return jparams, from_jax_params(TINY, jax.tree.map(np.asarray, jparams), "cpu",
                                    torch.float32)


def test_forward_with_fnorm_takes_a_tensor(tiny_params):
    jparams, tparams = tiny_params
    img = np.random.RandomState(6).uniform(-1, 1, (2, TINY.img_size, TINY.img_size, 3))
    img = img.astype(np.float32)
    f_norm = np.array([0.7, 1.2], np.float32)
    want = jdepth_pro.forward_with_fnorm(J_TINY, jparams, jnp.asarray(img), jnp.asarray(f_norm))
    got = tdepth_pro.forward_with_fnorm(TINY, tparams, torch.from_numpy(img),
                                        torch.from_numpy(f_norm))
    # test_torch_model.py's tolerance of the known-focal forward
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=1e-4)


def test_forward_with_mixed_fnorm_takes_tensors(tiny_params):
    jparams, tparams = tiny_params
    img = np.random.RandomState(7).uniform(-1, 1, (2, TINY.img_size, TINY.img_size, 3))
    img = img.astype(np.float32)
    f_norm = np.array([0.9, 1.0], np.float32)
    has_f = np.array([True, False])
    jinv, jdeg = jdepth_pro.forward_with_mixed_fnorm(J_TINY, jparams, jnp.asarray(img),
                                                     jnp.asarray(f_norm), jnp.asarray(has_f))
    tinv, tdeg = tdepth_pro.forward_with_mixed_fnorm(TINY, tparams, torch.from_numpy(img),
                                                     torch.from_numpy(f_norm),
                                                     torch.from_numpy(has_f))
    # test_torch_batch.py's tolerances of the mixed forward
    np.testing.assert_allclose(tdeg.numpy(), np.asarray(jdeg), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tinv[0].numpy(), np.asarray(jinv[0]), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(tinv[1].numpy(), np.asarray(jinv[1]), rtol=5e-3, atol=2e-4)


# -- the programs the product runs -----------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_aot")
    tm = torch_ref.randomize(torch_ref.DepthPro(J_TINY), seed=5)
    ckpt = str(d / "tiny.pt")
    torch.save(tm.state_dict(), ckpt)
    rng = np.random.RandomState(3)
    photos = []
    for i, shape in enumerate(((480, 640, 3), (300, 200, 3))):
        photos.append(str(d / f"p{i}.png"))
        Image.fromarray(rng.randint(0, 256, shape, dtype=np.uint8)).save(photos[-1])
    return d, ckpt, photos


@pytest.fixture
def spy(monkeypatch):
    names = []
    real = aot.call_cached

    def call_cached(name, fn, args, salt=""):
        names.append(name)
        return real(name, fn, args, salt)

    monkeypatch.setattr(aot, "call_cached", call_cached)
    return names


@pytest.mark.parametrize("focal", [28.0, None])
def test_extract_depth_programs(workdir, spy, focal):
    d, ckpt, photos = workdir
    jme, tme = JMatrixEyes(ckpt), MatrixEyes(ckpt, device="cpu")
    dm = extract_depth(tme.cfg, tme.params, photos[0], str(d / "x.png"), focal_length_35mm=focal,
                       runtime=RuntimeConfig(device="cpu"))
    fwd = "fwd_fnorm" if focal else "fwd_fov"
    # upsizing a PNG: the grid image crosses to the host (render_depthmap_grid)
    assert spy == ["preprocess", fwd, "render_depthmap_grid"]
    # test_torch_model.py's tolerances: known focal 2e-3 / 1e-4, FOV 5e-3 / 2e-4
    rtol, atol = (2e-3, 1e-4) if focal else (5e-3, 2e-4)
    np.testing.assert_allclose(dm.data.numpy(), jme.inverse_depth(photos[0], focal),
                               rtol=rtol, atol=atol)
    spy.clear()
    tme.process(photos[1], str(d / "x.jpg"), focal_length_35mm=focal)
    assert spy == ["preprocess", fwd, "render_depthmap"]


@pytest.mark.parametrize("focal", [35.0, None])
def test_batch_programs(workdir, spy, focal, tmp_path):
    d, ckpt, photos = workdir
    jme, tme = JMatrixEyes(ckpt), MatrixEyes(ckpt, device="cpu")
    jobs = [(p, str(tmp_path / f"{i}.png")) for i, p in enumerate(photos)]
    extract_depth_batch(tme.cfg, tme.params, jobs, 2, focal_length_35mm=focal,
                        runtime=RuntimeConfig(device="cpu"))
    fwd = "fwd_fnorm_b2" if focal else "fwd_mixed_b2"
    assert spy[:3] == ["preprocess", "preprocess", fwd]
    # the larger photo's PNG upsizes the grid image on the host, the smaller
    # one's is resized on the device
    assert sorted(spy[3:]) == ["render_depthmap", "render_depthmap_grid"]
    spy.clear()
    got = tme.inverse_depth_batch(photos, focal_length_35mm=focal)
    assert spy == ["preprocess", "preprocess", fwd]
    # test_torch_batch.py's tolerance of the session's batch against JAX
    np.testing.assert_allclose(got, jme.inverse_depth_batch(photos, focal_length_35mm=focal),
                               rtol=5e-3, atol=2e-4)


@pytest.mark.parametrize("dest,program", [("s.png", "stereogram_shift"),
                                          ("s.jpg", "stereogram")])
def test_stereogram_programs(workdir, spy, dest, program):
    d, ckpt, photos = workdir
    tme = MatrixEyes(ckpt, device="cpu")
    extract_depth(tme.cfg, tme.params, photos[0], str(d / dest), focal_length_35mm=28.0,
                  image_format=ImageOutputFormat.STEREOGRAM, runtime=RuntimeConfig(device="cpu"))
    # the compact form draws its noise in a program of its own, as the JAX
    # package's; the resolved form draws it inside "stereogram"
    noise = ["stereogram_noise"] if dest.endswith(".png") else []
    assert spy == ["preprocess", "fwd_fnorm"] + noise + [program]


def test_cli_profile_writes_a_trace(workdir, tmp_path):
    d, ckpt, photos = workdir
    trace_dir = tmp_path / "trace"
    assert tcli.main([f"--profile={trace_dir}", f"--checkpoint-path={ckpt}",
                      "--focal-length=28", photos[1], str(tmp_path / "o.png")],
                     device="cpu") == 0
    traces = glob.glob(os.path.join(trace_dir, "matrix_eyes*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    with Image.open(tmp_path / "o.png") as im:
        assert im.size == (200, 300)


@pytest.mark.parametrize("n,d,dtype,path", [
    (577, 64, torch.bfloat16, "resident"),    # Depth Pro's ViTs
    (2443, 64, torch.bfloat16, "streamed"),   # Depth Anything V2 at 1080p
    (640, 64, torch.bfloat16, "resident"), (641, 64, torch.bfloat16, "streamed"),
    (1536, 32, torch.float16, "resident"), (1537, 32, torch.float16, "streamed"),
    (577, 64, torch.float32, "streamed"),     # the 3xTF32 kernel's rings
    (70, 8, torch.bfloat16, "cuda_cores")])
def test_attention_counter_tells_the_kv_path(counters, n, d, dtype, path):
    """A launch's key names how the kernel read K and V, as the library
    reports it (``me_attention_kv_path``, card-only: ``chip_smoke.py``
    holds its answers at these cases): whole in shared memory up to 640
    keys at D = 64 (1536 at D = 32), else streamed through the ring."""
    from matrix_eyes_tpu_torch.ops import flash_attention

    assert path in flash_attention._KV_PATHS
    _build.check_launch(0, "attention_qkv", 8, n, 16, d, str(dtype).split(".")[-1], path)
    assert _build.launches("attention_qkv") == collections.Counter(
        {(8, n, 16, d, str(dtype).split(".")[-1], path): 1})


def test_the_capture_log_names_the_kv_path(counters, graphs_on, monkeypatch, capsys):
    """``MATRIX_EYES_AOT_LOG``'s line of a capture lists its attention
    launches with their K/V path."""
    monkeypatch.setenv("MATRIX_EYES_AOT_LOG", "1")
    cache = aot.GraphCache(FakeGraphs())

    def fn(x):
        for _ in range(24):
            _build.check_launch(0, "attention_qkv", 8, 2443, 16, 64, "bfloat16", "streamed")
        return x * 2

    for _ in range(2):
        cache.call("dav2_fwd_b8", fn, (_X,))
    err = capsys.readouterr().err
    line = [x for x in err.splitlines() if x.startswith("aot: CAPTURE dav2_fwd_b8")]
    assert len(line) == 1
    assert "attention 24 x (8, 2443, 16, 64, 'bfloat16', 'streamed')" in line[0]
