"""Per-signature CUDA-graph cache: the port's counterpart of
``matrix_eyes_tpu/aot.py``.

The JAX package compiles every device program of the product (preprocess,
the forwards, the renders, the stereogram) once per input signature and
keeps the executable, in process and on disk, behind ``call_cached(name,
fn, args, salt)``. The port compiles nothing per shape: its one build,
``nvcc``, is cached in ``_build/``. What eager PyTorch pays on every call
is the host's launch path: a bf16 forward is ~1300 launches, each through
Python dispatch. A CUDA graph replays them with one host call, so the port
keeps the same program boundaries and the same names, and caches a graph
per signature where the JAX package caches an executable:

* the first call of a key runs ``fn`` eagerly: the warm-up (the kernel
  libraries load, cuBLAS and cuDNN make their handles, lazily loaded
  kernels load, the allocator grows);
* the second call runs ``fn`` eagerly once more on a side stream (its
  result is the call's result; it makes this thread's handles and the
  side stream's cuBLAS workspace before any capture needs them) and then
  captures ``fn`` on that stream into a ``torch.cuda.CUDAGraph``, reading
  static copies of the tensor arguments;
* every later call copies its tensor arguments into those static buffers,
  replays the graph on the caller's stream and returns clones of the
  graph's outputs (a caller may hold a result while the next call runs:
  ``pipeline.extract_depth_batch`` keeps chunk k's grid during chunk
  k+1's forward, the server's DepthMaps outlive the call).

Arguments: ``args`` is a tuple. A tensor in it is a graph input (copied
into the static buffer at each call); a dict or list in it is a parameter
tree, bound by address: the graph reads its tensors where they lie, so the
key holds the identity of every tensor leaf and the cache entry goes as
soon as one of them is freed, and a replay never reads freed weights; any
other value is part of the key as it is (a size, an amplitude, a dtype).
The key also holds the name, the salt, each input's shape, dtype, strides
and device, the TF32 and reduced-precision flags of cuBLAS and cuDNN
(``config.configure_precision``), the torch version and the device's name:
the JAX key of ``matrix_eyes_tpu/aot.py:_key`` without its XLA items.

Graphs of one cache and device share one memory pool (a new one once
all of them have been freed: the allocator refuses a capture into a pool
whose graphs are all gone until it releases its memory). That is safe
because every replay, its input copies and the clones of its outputs run
under one lock, in stream order behind the previous replay: the pool's
memory is in use only between a graph's launch and its outputs' clones. A
capture reuses the blocks that earlier captures freed, but a freed block
serves only a request no larger than itself, so the pool's size depends on
the order of the captures: the largest program first, and the others fit
in what it freed (bf16 at four photos alone 8.9 GiB, then the f32 and bf16
one-photo forwards +0); the smallest first, and each larger program adds
most of its own (12.0 GiB in that order, against 15.7 GiB for the three
pools apart; ``scripts/torch_graph_pool.py``, NVIDIA H100 80GB HBM3, 700 W).
A graph also holds its static inputs and outputs. At most ``CAPACITY``
graphs stay live; the oldest goes first.

CPU tensors run ``fn`` eagerly (every kernel wrapper sends them to its
plain version), and so does every call under ``MATRIX_EYES_AOT=off``, the
JAX package's switch, read on every call: the kernels run in both modes,
the switch chooses only how they are launched. ``MATRIX_EYES_AOT_LOG=1``
prints one line per capture, as the JAX package prints one per miss, with
the capture's attention launches by shape and K/V path (resident or
streamed). A failed capture raises with the program's name; nothing falls
back to the eager path behind it. A graph cannot be serialized, so the
JAX package's on-disk cache (``MATRIX_EYES_AOT_CACHE``) has no
counterpart: the port's persistent artefacts are ``_build/`` and the
weight caches.

Every call records a span of the program's trace (``timings.trace``) while
spans are recorded: ``dispatch.eager``, ``dispatch.capture`` or
``dispatch.replay``, from just after the call's mode is known to its end,
with the program's name as its ``program`` attribute. Their count by mode
is the replay counter over any window (``modes`` keeps the latest 256
calls), and a replay's span is the host's issue time: the input copies
enqueued, the graph launched, the output clones enqueued.

The kernel wrappers count their launches in Python, which a replay does
not run: the counters' increments during a capture are recorded and added
again at every replay (``_LaunchCounters``), so a forward counts 72
attention, 24 conv3x3, 72 gelu and 144 scaled_residual launches however it
ran, and on a mesh the collectives it called (``parallel.collectives``'
counts, bytes and gather shapes), which ``collectives.check_forward`` reads.

On a device mesh (``parallel``: one process per rank) the forwards go
through a cache of the mesh's own (``mesh_cache``), whose key also names
the mesh's (data, model) shape and backend, as the JAX package salts its
sharded forwards with ``|mesh=``. Rank 0 alone also runs ``preprocess``
and the renders through the process's cache: were the forwards in it, rank
0 would evict in another order than the other ranks. An NCCL collective is
a CUDA kernel on a stream, so a capture records it with the rest of the
forward, and a replay runs the 144 all-reduces and the merge all-gathers
as the eager call did. The ranks must capture together and replay in one
order: a rank that captured or replayed alone would wait forever on a
collective that no other rank launches. So before each program every rank
states its mode for the key (eager, capture or replay) in one all-reduce
over the mesh, and where the ranks disagree every rank raises, naming the
program and the modes. A gloo mesh runs eagerly: gloo moves a CUDA tensor
through pinned host memory (``collectives._staged``), host work that a
graph cannot record (a collective called while a gloo rank captures
raises).
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import time
import weakref
from concurrent.futures import Future
from functools import lru_cache
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from matrix_eyes_tpu_torch import timings

CAPACITY = 16  # live graphs
MODES = ("eager", "capture", "replay")  # how a call runs its program
_DISPATCH_SPANS = {m: f"dispatch.{m}" for m in MODES}
_PROGRAM_ATTRS: Dict[str, Dict[str, str]] = {}  # a span's attributes, one dict per program
_WARM_KEYS = 1024  # keys whose warm-up call ran, remembered for their second call


def enabled() -> bool:
    return os.environ.get("MATRIX_EYES_AOT", "on").lower() not in ("0", "off", "false")


def _log_enabled() -> bool:
    return bool(os.environ.get("MATRIX_EYES_AOT_LOG"))


def _span(name: str, mode: str):
    """The span of a call's run: ``dispatch.<mode>``, the program's name as
    its attribute (one dict per program, so a call allocates none)."""
    attrs = _PROGRAM_ATTRS.get(name)
    if attrs is None:
        attrs = _PROGRAM_ATTRS.setdefault(name, {"program": name})
    return timings.trace(_DISPATCH_SPANS[mode], attrs)


# -- the wrappers' launch counters -------------------------------------------

class _LaunchCounters:
    """Every kernel wrapper's launch counter and the collectives' counts
    (ints, Counters and the list of gather shapes, which only grows):
    snapshot, the difference of two snapshots, restore, and add a
    difference."""

    @staticmethod
    def _fields() -> List[Tuple[Any, str]]:
        from matrix_eyes_tpu_torch.ops.conv3x3 import conv3x3
        from matrix_eyes_tpu_torch.ops.flash_attention import attention_flash, attention_qkv
        from matrix_eyes_tpu_torch.ops.nn import gelu_, scaled_residual
        from matrix_eyes_tpu_torch.ops.prng import randint_u8
        from matrix_eyes_tpu_torch.ops.stereogram_kernel import linker_scan
        from matrix_eyes_tpu_torch.parallel import collectives

        return [(attention_qkv, "launches"), (attention_qkv, "launches_by_dtype"),
                (attention_qkv, "launches_by_batch"), (attention_qkv, "launches_by_shape"),
                (attention_flash, "launches"), (conv3x3, "launches"),
                (conv3x3, "launches_by_shape"), (linker_scan, "launches"),
                (collectives, "counts"), (collectives, "result_bytes"),
                (collectives, "gather_shapes"), (randint_u8, "launches"),
                (gelu_, "launches"), (gelu_, "launches_by_shape"),
                (scaled_residual, "launches"), (scaled_residual, "launches_by_shape")]

    @classmethod
    def snapshot(cls) -> list:
        return [collections.Counter(v) if isinstance(v, collections.Counter)
                else list(v) if isinstance(v, list) else v
                for v in (getattr(o, a) for o, a in cls._fields())]

    @staticmethod
    def delta(before: list, after: list) -> list:
        # a list's difference is the tail appended since the first snapshot
        return [b2[len(b1):] if isinstance(b1, list) else b2 - b1
                for b1, b2 in zip(before, after)]

    @classmethod
    def restore(cls, snap: list) -> None:
        for (owner, attr), v in zip(cls._fields(), snap):
            if isinstance(v, collections.Counter):
                getattr(owner, attr).clear()
                getattr(owner, attr).update(v)
            elif isinstance(v, list):
                getattr(owner, attr)[:] = v
            else:
                setattr(owner, attr, v)

    @classmethod
    def add(cls, delta: list) -> None:
        for (owner, attr), d in zip(cls._fields(), delta):
            if isinstance(d, collections.Counter):
                getattr(owner, attr).update(d)
            elif isinstance(d, list):
                getattr(owner, attr).extend(d)
            elif d:
                setattr(owner, attr, getattr(owner, attr) + d)


def _attention_paths(delta: list) -> str:
    """A capture's attention launches by (B, N, heads, D, dtype, K/V path),
    for its ``MATRIX_EYES_AOT_LOG`` line."""
    from matrix_eyes_tpu_torch.ops.flash_attention import attention_qkv

    for (owner, attr), d in zip(_LaunchCounters._fields(), delta):
        if owner is attention_qkv and attr == "launches_by_shape" and d:
            return "; attention " + ", ".join(f"{n} x {k}" for k, n in sorted(d.items()))
    return ""


# -- constants a graph reads -------------------------------------------------

_capturing = threading.local()


def keep_alive(tensor: torch.Tensor) -> torch.Tensor:
    """A device constant that a program reads (a resampling matrix, the
    colour table): while a graph is being captured on this thread, the
    graph keeps it alive, so that evicting it from its own cache never
    frees memory a replay reads. Returns ``tensor``."""
    held = getattr(_capturing, "held", None)
    if held is not None:
        held.append(tensor)
    return tensor


# -- backends ----------------------------------------------------------------

class CudaGraphs:
    """The card's capture backend: the eager run and the capture on one
    side stream per device, graphs in one memory pool per device."""

    def __init__(self):
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._pools: Dict[torch.device, Any] = {}  # the pool of the device's live graphs
        self._live: collections.Counter = collections.Counter()  # live graphs by device

    def applies(self, device: torch.device) -> bool:
        # a call made while this thread captures belongs to the outer graph
        return device.type == "cuda" and not torch.cuda.is_current_stream_capturing()

    @staticmethod
    def device_name(device: torch.device) -> str:
        return _cuda_name(device.index if device.index is not None
                          else torch.cuda.current_device())

    def memory(self, device: torch.device) -> int:
        """Bytes of the device's graph pool (its segments in the caching
        allocator)."""
        pool = self._pools.get(device)
        if pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if seg["device"] == device.index
                   and tuple(seg.get("segment_pool_id", ())) == tuple(pool))

    def warm_and_capture(self, device: torch.device, warm: Callable[[], Any],
                         capture: Callable[[], Any]) -> Tuple[Any, Any, Any]:
        """Run ``warm()`` eagerly, then capture ``capture()``, both on the
        device's side stream; returns (warm's result, graph, the graph's
        static outputs)."""
        cur = torch.cuda.current_stream(device)
        side = self._streams.get(device)
        if side is None:
            side = self._streams[device] = torch.cuda.Stream(device)
        if device not in self._pools:
            self._pools[device] = torch.cuda.graph_pool_handle()
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        self._live[device] += 1
        weakref.finalize(graph, self._graph_gone, device)
        try:
            with torch.cuda.stream(side):
                result = warm()
                # "thread_local": the server's handler threads keep copying
                # photos to pinned memory, reading results back and running
                # renders eagerly while one thread captures, and on an NCCL
                # mesh ProcessGroupNCCL's watchdog thread queries its CUDA
                # events; "global" would fail their calls, and "relaxed"
                # would let this thread's own unsafe calls pass unseen
                graph.capture_begin(pool=self._pools[device], capture_error_mode="thread_local")
                try:
                    out = capture()
                finally:
                    graph.capture_end()
        finally:
            cur.wait_stream(side)
        for t in _tensors(result):  # made on the side stream, used on the caller's
            t.record_stream(cur)
        return result, graph, out

    def _graph_gone(self, device: torch.device) -> None:
        self._live[device] -= 1
        if not self._live[device]:
            # the allocator keeps a pool whose graphs have all been freed
            # until it releases the pool's memory, and refuses a capture into
            # it ("use_count > 0"): the next capture opens a new pool
            del self._pools[device]

    @staticmethod
    def replay(graph) -> None:
        graph.replay()


class HostGraphs:
    """A capture backend that needs no card, for the CPU tests and the mesh
    rank functions they start (``parallel.checks.run_graph_cases``): the
    warm-up runs the program, a "capture" runs its Python once more (as a
    capture on the card does, collectives included) and a replay runs
    nothing, so a replay returns the capture's outputs."""

    def __init__(self):
        self.captures = self.replays = 0

    def applies(self, device: torch.device) -> bool:
        return True

    @staticmethod
    def device_name(device: torch.device) -> str:
        return "host"

    @staticmethod
    def memory(device: torch.device) -> int:
        return 0

    def warm_and_capture(self, device: torch.device, warm: Callable[[], Any],
                         capture: Callable[[], Any]) -> Tuple[Any, Any, Any]:
        result = warm()
        self.captures += 1
        return result, object(), capture()

    def replay(self, graph) -> None:
        self.replays += 1


class NoGraphs:
    """The backend of a cache whose every call runs eagerly (a gloo mesh)."""

    @staticmethod
    def applies(device: torch.device) -> bool:
        return False

    @staticmethod
    def memory(device: torch.device) -> int:
        return 0


@lru_cache(maxsize=None)
def _cuda_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


# -- the cache ---------------------------------------------------------------

def _tensors(tree) -> List[torch.Tensor]:
    """The tensor leaves of a result or a parameter tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _tree_key(tree) -> Tuple[Hashable, ...]:
    """A parameter tree's part of the key: each tensor leaf by identity,
    anything else by value."""
    if isinstance(tree, dict):
        return tuple((k, _tree_key(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_tree_key(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (id(tree),)
    return (tree,)


def _device(args: Sequence[Any]) -> Optional[torch.device]:
    """The device of the first tensor argument, else of the first tensor
    leaf of a parameter tree; None without a tensor."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    for a in args:
        if isinstance(a, (dict, list)):
            leaves = _tensors(a)
            if leaves:
                return leaves[0].device
    return None


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree


class _Entry:
    __slots__ = ("name", "graph", "inputs", "outputs", "delta", "held", "finalizers")

    def __init__(self, name, graph, inputs, outputs, delta, held):
        self.name = name
        self.graph = graph
        self.inputs = inputs  # [(argument index, static tensor)]
        self.outputs = outputs
        self.delta = delta  # the launch counters' increments of one run
        self.held = held  # the constants the graph reads
        self.finalizers: List[weakref.finalize] = []


class GraphCache:
    """The per-signature graph cache over a capture ``backend``
    (``CudaGraphs`` on the card; the tests inject one that needs no
    card)."""

    def __init__(self, backend=None, capacity: int = CAPACITY):
        self.backend = backend if backend is not None else CudaGraphs()
        self.capacity = capacity
        self._live: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
        self._warm: "collections.OrderedDict[tuple, None]" = collections.OrderedDict()
        self._guard = threading.RLock()  # _live, _warm, the key locks
        self._key_locks: Dict[tuple, threading.Lock] = {}
        self._capture_lock = threading.Lock()  # one capture at a time in the process
        self._replay_lock = threading.Lock()  # replays share the pool: one at a time
        self._last_replay: Dict[torch.device, Any] = {}
        # the latest captures: (name, seconds, the pool's growth in bytes)
        self.captured: "collections.deque[Tuple[str, float, int]]" = collections.deque(maxlen=64)
        # the latest calls: (name, one of MODES)
        self.modes: "collections.deque[Tuple[str, str]]" = collections.deque(maxlen=256)

    def key(self, name: str, args: Sequence[Any], salt: str = "") -> tuple:
        """The cache key of ``fn(*args)`` under ``name`` and ``salt``."""
        parts: list = [name, salt, torch.__version__,
                       torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                       torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
                       torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction]
        for a in args:
            if isinstance(a, torch.Tensor):
                parts.append((tuple(a.shape), a.dtype, a.stride(), a.device))
            elif isinstance(a, (dict, list)):
                parts.append(_tree_key(a))
            else:
                parts.append(a)
        device = _device(args)
        parts.append(None if device is None else self.backend.device_name(device))
        return tuple(parts)

    def call(self, name: str, fn: Callable, args: Tuple, salt: str = ""):
        """``fn(*args)``: eagerly on the first call of a key, then through a
        CUDA graph (see the module's docstring)."""
        device = _device(args)
        if not enabled() or device is None or not self.backend.applies(device):
            self._begin(name, "eager")
            with _span(name, "eager"):
                return fn(*args)
        join_prefetch()
        key = self.key(name, args, salt)
        entry = self._live.get(key)
        if entry is None:
            with self._guard:
                key_lock = self._key_locks.setdefault(key, threading.Lock())
            with key_lock:
                entry = self._live.get(key)
                if entry is None:
                    with self._guard:
                        first = key not in self._warm
                        self._warm[key] = None
                        self._warm.move_to_end(key)
                        while len(self._warm) > _WARM_KEYS:
                            gone, _ = self._warm.popitem(last=False)
                            self._key_locks.pop(gone, None)
                    mode = "eager" if first else "capture"
                    self._begin(name, mode)
                    with _span(name, mode):
                        if first:
                            return fn(*args)
                        return self._capture(name, fn, args, key, device)
        self._begin(name, "replay")
        with _span(name, "replay"):
            return self._replay(entry, args, device)

    def _begin(self, name: str, mode: str) -> None:
        """Record a call's mode (``modes``) just before it runs."""
        self.modes.append((name, mode))

    def _capture(self, name, fn, args, key, device):
        t0 = time.perf_counter()
        inputs = [(i, torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device=a.device))
                  for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        static_args = list(args)
        for i, s in inputs:
            s.copy_(args[i])
            static_args[i] = s
        held: List[torch.Tensor] = []  # the constants the graph reads (keep_alive)
        delta: list = []

        def capture():
            before = _LaunchCounters.snapshot()
            _capturing.held = held
            try:
                return fn(*static_args)
            finally:
                _capturing.held = None
                delta[:] = _LaunchCounters.delta(before, _LaunchCounters.snapshot())
                _LaunchCounters.restore(before)

        with self._capture_lock:
            mem0 = self.backend.memory(device)
            try:
                result, graph, outputs = self.backend.warm_and_capture(
                    device, lambda: fn(*args), capture)
            except Exception as err:
                raise RuntimeError(f"CUDA graph capture of {name} failed: {err}") from err
            pool_bytes = self.backend.memory(device) - mem0
        seconds = time.perf_counter() - t0
        entry = _Entry(name, graph, inputs, outputs, delta, held)
        with self._guard:
            self._live[key] = entry
            # a freed leaf of the parameter tree ends the entry at once
            entry.finalizers = [weakref.finalize(t, self._forget, key)
                                for a in args if isinstance(a, (dict, list))
                                for t in _tensors(a)]
            while len(self._live) > self.capacity:
                _k, old = self._live.popitem(last=False)
                for f in old.finalizers:
                    f.detach()
            self.captured.append((name, seconds, pool_bytes))
        if _log_enabled():
            print(f"aot: CAPTURE {name} in {seconds * 1e3:.1f} ms, graph pool "
                  f"+{pool_bytes / 2**20:.1f} MiB ({len(self._live)} live)"
                  f"{_attention_paths(delta)}", file=sys.stderr, flush=True)
        return result

    def _forget(self, key) -> None:
        with self._guard:
            entry = self._live.pop(key, None)
        if entry is not None:
            for f in entry.finalizers:
                f.detach()

    def _replay(self, entry: _Entry, args, device):
        with self._replay_lock:
            cur = torch.cuda.current_stream(device) if device.type == "cuda" else None
            last = self._last_replay.get(device)
            if last is not None:
                cur.wait_event(last)
            for i, s in entry.inputs:
                s.copy_(args[i], non_blocking=True)
            self.backend.replay(entry.graph)
            out = _clone(entry.outputs)
            if cur is not None:
                ev = torch.cuda.Event()
                ev.record(cur)
                self._last_replay[device] = ev
        _LaunchCounters.add(entry.delta)
        return out

    def live(self) -> List[str]:
        """The names of the live graphs, oldest first."""
        return [e.name for e in list(self._live.values())]


_cache = GraphCache()


class MeshGraphCache(GraphCache):
    """The graph cache of one rank's forwards on a mesh (``mesh_cache``):
    the key names the mesh, and every call runs in the mode of every rank's
    call or raises on every rank (see the module's docstring). A gloo mesh
    gets ``NoGraphs`` unless a ``backend`` is given (the CPU tests give
    ``HostGraphs``)."""

    def __init__(self, mesh, backend=None, capacity: int = CAPACITY):
        if backend is None and mesh.backend == "gloo":
            backend = NoGraphs()
        super().__init__(backend, capacity)
        self.shape = (mesh.data, mesh.model)
        self.mesh_backend = mesh.backend
        self.rank = mesh.rank
        # the vote's device: NCCL reduces on the card, gloo on the host
        self._vote_device = mesh.device if mesh.backend == "nccl" else torch.device("cpu")

    def key(self, name: str, args: Sequence[Any], salt: str = "") -> tuple:
        data, model = self.shape
        return super().key(name, args, f"{salt}|mesh={{'data': {data}, 'model': {model}}}"
                                       f"|{self.mesh_backend}")

    def _begin(self, name: str, mode: str) -> None:
        """Hold this rank's mode against every rank's, in one all-reduce of
        a one-hot vote over the world (the mesh's ranks): unless all ranks
        run ``name`` in one mode, every rank raises RuntimeError here, before
        any of them captures, replays or calls a collective of the
        program."""
        import torch.distributed as dist

        super()._begin(name, mode)
        data, model = self.shape
        if data * model == 1 or isinstance(self.backend, NoGraphs):
            return  # nothing to agree on: one rank, or every rank eager by rule
        vote = torch.tensor([int(m == mode) for m in MODES], dtype=torch.int32,
                            device=self._vote_device)
        dist.all_reduce(vote)
        counts = vote.tolist()
        if max(counts) != data * model:
            seen = ", ".join(f"{n} {m}" for m, n in zip(MODES, counts) if n)
            raise RuntimeError(f"the ranks of the {data}x{model} mesh disagree on how to run "
                               f"{name}: {seen} (rank {self.rank}: {mode})")


_mesh_caches: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_mesh_caches_lock = threading.Lock()


def mesh_cache(mesh, backend=None) -> MeshGraphCache:
    """The graph cache of ``mesh``'s forwards on this rank, made on the
    first call (with ``backend``: the card's graphs by default, ``NoGraphs``
    on a gloo mesh) and gone with the mesh."""
    with _mesh_caches_lock:
        cache = _mesh_caches.get(mesh)
        if cache is None:
            cache = _mesh_caches[mesh] = MeshGraphCache(mesh, backend)
        return cache


def call_cached(name: str, fn: Callable, args: Tuple, salt: str = ""):
    """Call ``fn(*args)`` through the process's graph cache (see the
    module's docstring). ``fn`` must close over all static configuration;
    ``salt`` folds in whatever the closure holds (the model config)."""
    return _cache.call(name, fn, args, salt)


def cache() -> GraphCache:
    """The process's graph cache (its live graphs, ``captured``)."""
    return _cache


# -- warm-up during the weight load ------------------------------------------

_prefetch_lock = threading.Lock()
_prefetch: Optional[Future] = None


def prefetch_async(device) -> Optional[Future]:
    """Start the first call's one-time work on a background thread: the
    CUDA context on ``device``, the five kernel libraries (built if
    missing, loaded) and their kernels (loaded, their shared-memory limits
    set). The CLI calls this before the checkpoint load, as the JAX CLI
    starts deserializing its executables before the weight upload. A
    failure is raised by the next ``call_cached`` on the card, never
    swallowed. Nothing happens on the CPU or under ``MATRIX_EYES_AOT=off``.

    The cuBLAS, cuBLASLt and cuDNN handles are left to the first forward:
    made on this thread, they ran alongside the weight load about three
    times slower than alone and held up the first program by 1.4-2.0 s
    (NVIDIA H100 80GB HBM3, 700 W; ``scripts/torch_warmup_variants.py``)."""
    global _prefetch
    device = torch.device(device)
    if not enabled() or device.type != "cuda":
        return None
    fut: Future = Future()

    def run():
        try:
            _warm_up(device)
        except BaseException as err:  # handed to the caller through the future
            fut.set_exception(err)
        else:
            fut.set_result(None)

    with _prefetch_lock:
        _prefetch = fut
    threading.Thread(target=run, name="me-prefetch", daemon=True).start()
    return fut


def join_prefetch() -> None:
    """Wait for a pending ``prefetch_async`` and raise its failure."""
    global _prefetch
    if _prefetch is None:
        return
    with _prefetch_lock:
        fut, _prefetch = _prefetch, None
    if fut is not None:
        fut.result()


def _warm_up(device: torch.device) -> None:
    from matrix_eyes_tpu_torch.ops import conv3x3, flash_attention, nn, prng, stereogram_kernel

    with torch.cuda.device(device):
        torch.cuda.init()
        for module in (flash_attention, conv3x3, nn, stereogram_kernel, prng):
            module.prepare()


@contextlib.contextmanager
def disabled():
    """Run the enclosed calls eagerly (``MATRIX_EYES_AOT=off``)."""
    old = os.environ.get("MATRIX_EYES_AOT")
    os.environ["MATRIX_EYES_AOT"] = "off"
    try:
        yield
    finally:
        if old is None:
            del os.environ["MATRIX_EYES_AOT"]
        else:
            os.environ["MATRIX_EYES_AOT"] = old
