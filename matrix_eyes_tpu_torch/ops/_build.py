"""Build and load the port's CUDA kernels (``csrc/*.cu``) on first use.

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, bound through ctypes (a few seconds per
file; nothing includes PyTorch's headers). Libraries land in ``_build/``
inside the package, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited kernel is rebuilt and a stale
library is never loaded. ptxas's report (registers, shared memory, spills
per kernel) is kept beside each library (``ptxas_report``). Nothing here
runs at import time: the package imports on a machine without CUDA.

Every launch that ``check_launch`` passes is counted in one ledger,
``ledger``, under (kernel, *key): the key is what the wrapper names the
launch by (its shapes, dtypes, flags). The mesh's collectives count there
too (``parallel.collectives``), and each photo's copy to the device under
its path (``pipeline.upload``). A CUDA graph's replay runs no wrapper, so
the graph cache (``aot``) adds a capture's counts again at every replay;
a new wrapper needs no more than its key for its launches to be counted
however they run. ``launches(kernel)`` reads one kernel's counts by key and
``reset()`` clears them all.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Dict, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

Signatures = Dict[str, Tuple[object, Sequence[object]]]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of matrix_eyes_tpu_torch are "
            "built from source and need the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    """Build ``csrc/<name>.cu`` unless an up-to-date library exists; return
    the library's path."""
    src = os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        with open(out + ".ptxas.txt", "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def ptxas_report(name: str) -> str:
    """ptxas's report of the current build of ``csrc/<name>.cu`` (empty
    when the library was built before reports were kept)."""
    path = library_path(name) + ".ptxas.txt"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str, signatures: Signatures) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, with ``restype`` and
    ``argtypes`` set from ``signatures`` ({function: (restype, argtypes)})."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(library_path(name))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
            _libs[name] = lib
        return lib


def dtype_code(dtype) -> int:
    """The kernels' dtype argument: 0 = float32, 1 = bfloat16, 2 = float16."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    if dtype not in codes:
        raise TypeError(f"the CUDA kernels take float32, bfloat16 or float16, got {dtype}")
    return codes[dtype]


ledger: collections.Counter = collections.Counter()  # (kernel, *key) -> launches


def record(kernel: str, *key) -> None:
    """Count one launch of ``kernel`` (or one collective, or one upload)
    under ``key``."""
    ledger[(kernel, *key)] += 1


def check_launch(rc: int, kernel: str, *key) -> None:
    """Raise unless the library returned 0 for the launch; else count it."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with code {rc}")
    record(kernel, *key)


def launches(kernel: str) -> collections.Counter:
    """``kernel``'s launches by key since the last ``reset``."""
    return collections.Counter({k[1:]: n for k, n in ledger.items() if k[0] == kernel and n})


def reset() -> None:
    ledger.clear()
