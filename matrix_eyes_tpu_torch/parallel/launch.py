"""Start the ranks of a mesh from one call: one process per rank, each with
its ``torch.distributed`` process group and its ``Mesh``.

    from matrix_eyes_tpu_torch.parallel import launch

    results = launch(fn, (data, model), *args)   # fn(mesh, *args) on each rank

The default backend is NCCL on the cards (rank r on ``cuda:r``) and gloo
on the CPU (``devices=["cpu"] * n``). ``backend="gloo"`` with
``devices=["cuda:0"] * n`` puts several ranks on one card, which runs the
sharded arithmetic and the kernels at their per-shard shapes on a machine
with one card (the collectives then pass through host memory).

Each rank is a fresh interpreter (``python -c``) that imports this package
and the module of ``fn``, nothing of the caller's ``__main__``: keep ``fn``
in this package, never in a test module, or every rank imports what that
module imports. The rendezvous is a ``FileStore`` in a fresh temporary
directory, so concurrent launches never meet. ``init_process_group`` gets
``timeout`` for every collective, and the whole launch a deadline of its
own: a hung rank fails the call instead of blocking it. A failure on any
rank ends every rank and is raised here with that rank's traceback; a rank
that ends the run on purpose (the CLI, once it has reported a failure)
raises ``RankStop``, which ends every rank and is raised here in turn.
``fn``, its arguments and its result travel as plain pickles through files
of that directory (tensors by value; a rank's tensors are moved to the CPU
before they are written).
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

# seconds a follower's RankStop waits for rank 0's own (see RankStop)
STOP_GRACE = 2.0


class RankStop(Exception):
    """Raised by ``fn`` on a rank to end the launch with an exit ``code``
    and no traceback: ``launch`` ends every rank still running (they may
    wait in a collective the stopped rank will never join) and raises it
    in the caller with ``rank`` set. A stop of a rank other than 0 first
    waits up to ``STOP_GRACE`` seconds for rank 0: if rank 0 stops too,
    its stop is raised (a follower often stops on a failure that rank 0
    reports). ``message``: what the rank has not printed itself."""

    def __init__(self, code: int, message: str = "", rank: Optional[int] = None):
        super().__init__(code, message, rank)
        self.code, self.message, self.rank = code, message, rank

    def __str__(self) -> str:
        return f"rank {self.rank} stopped with code {self.code}: {self.message}"


def _to_cpu(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _rank_main(rank: int, data: int, model: int, backend: str, device: str,
               workdir: str, timeout: Optional[float]) -> None:
    """A rank's process: join the group, build the mesh, run fn, write
    ("ok", result), ("stop", (code, message)) or ("error", traceback) to
    its result file."""
    import torch.distributed as dist

    from matrix_eyes_tpu_torch.parallel.sharding import make_mesh

    status, body = "ok", None
    try:
        with open(os.path.join(workdir, "payload.pkl"), "rb") as f:
            fn, args, kwargs = pickle.load(f)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{os.path.join(workdir, 'store')}",
                                world_size=data * model, rank=rank,
                                timeout=(None if timeout is None
                                         else datetime.timedelta(seconds=timeout)))
        mesh = make_mesh(data * model, model=model, device=dev)
        body = _to_cpu(fn(mesh, *args, **kwargs))
    except RankStop as stop:
        status, body = "stop", (stop.code, stop.message)
    except BaseException:
        status, body = "error", traceback.format_exc()
    path = os.path.join(workdir, f"result-{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump((status, body), f)
    os.replace(path + ".tmp", path)
    if status != "ok":
        # the other ranks may wait in a collective: stay until the launcher
        # ends this rank (leaving would fail their collectives, and another
        # rank could report that failure before this one's is read), then
        # leave without the group's teardown
        sys.stdout.flush()
        sys.stderr.flush()
        time.sleep(STOP_GRACE + 60.0)
        os._exit(1)
    dist.destroy_process_group()


_RANK_CODE = ("import sys; from matrix_eyes_tpu_torch.parallel.launch import _rank_main; "
              "_rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], "
              "sys.argv[5], sys.argv[6], float(sys.argv[7]) if sys.argv[7] else None)")


def _read_result(workdir: str, r: int):
    with open(os.path.join(workdir, f"result-{r}.pkl"), "rb") as f:
        return pickle.load(f)


def _stop(workdir: str, r: int, body) -> Exception:
    """What to raise for rank r's stop: rank 0's stop or failure where rank 0
    has one within STOP_GRACE, else rank r's stop."""
    lead = os.path.join(workdir, "result-0.pkl")
    if r != 0:
        deadline = time.monotonic() + STOP_GRACE
        while not os.path.exists(lead) and time.monotonic() < deadline:
            time.sleep(0.05)
        if os.path.exists(lead):
            status, lead_body = _read_result(workdir, 0)
            if status == "error":
                return RuntimeError(f"rank 0 failed:\n{lead_body}")
            if status == "stop":
                r, body = 0, lead_body
    return RankStop(*body, rank=r)


def default_devices(n: int) -> List[str]:
    """The first n cards, one rank each; raises if fewer are visible."""
    available = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > available:
        raise RuntimeError(f"{n} ranks need {n} CUDA devices but only {available} are "
                           "available")
    return [f"cuda:{i}" for i in range(n)]


def launch(fn: Callable, mesh_shape: Tuple[int, int], *args, backend: Optional[str] = None,
           devices: Optional[Sequence] = None, timeout: Optional[float] = 600.0,
           **kwargs) -> List[Any]:
    """Run ``fn(mesh, *args, **kwargs)`` on ``data * model`` ranks and return
    their results in rank order. ``devices``: one per rank (default: the
    cards, ``cuda:0`` ... ``cuda:n-1``); ``backend``: NCCL when every device
    is a card, else gloo, by default; ``timeout``: seconds for any one
    collective and for the whole launch (None: torch.distributed's default
    for a collective, and no deadline). Raises RuntimeError with the
    traceback of a rank that failed, ``RankStop`` for a rank that stopped
    the run, TimeoutError past the deadline."""
    data, model = mesh_shape
    n = data * model
    if data < 1 or model < 1:
        raise ValueError(f"mesh dimensions must be >= 1, got {mesh_shape}")
    devices = [str(d) for d in (devices if devices is not None else default_devices(n))]
    if len(devices) != n:
        raise ValueError(f"{n} ranks but {len(devices)} devices")
    if backend is None:
        backend = "nccl" if all(d.startswith("cuda") for d in devices) else "gloo"
    workdir = tempfile.mkdtemp(prefix="me_torch_launch_")
    with open(os.path.join(workdir, "payload.pkl"), "wb") as f:
        pickle.dump((fn, args, kwargs), f)
    # the ranks import this package from where the caller did
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs: List[subprocess.Popen] = []
    out = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK_CODE, str(r), str(data), str(model), backend,
                 devices[r], workdir, "" if timeout is None else repr(timeout)], env=env))
        seen = {}  # rank -> an "ok" result whose process has not exited yet
        while len(out) < n:
            for r, p in enumerate(procs):
                if r in out:
                    continue
                done = p.poll() is not None  # before the file: a rank writes, then exits
                if r not in seen and os.path.exists(os.path.join(workdir, f"result-{r}.pkl")):
                    status, body = _read_result(workdir, r)
                    if status == "error":
                        raise RuntimeError(f"rank {r} of {n} failed:\n{body}")
                    if status == "stop":
                        raise _stop(workdir, r, body)
                    seen[r] = body
                if not done:
                    continue
                if r not in seen:
                    raise RuntimeError(f"rank {r} of {n} exited with code {p.returncode} "
                                       "without a result")
                out[r] = seen.pop(r)
            if len(out) < n:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(n)) - set(out))} of {n} did "
                                       f"not finish within {timeout:g} s")
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        shutil.rmtree(workdir, ignore_errors=True)
    return [out[r] for r in range(n)]
