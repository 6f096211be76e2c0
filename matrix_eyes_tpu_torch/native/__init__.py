"""Host (C++) libraries of the port: the Lanczos3 RGB8 resizer
(``lanczos.cpp``), the striped PNG encoder (``pngwriter.cpp``) and the OBJ
serializer (``meshwriter.cpp``), the port's own copies of the JAX
package's ``native`` sources, and the photo's staging copy into pinned
memory (``stagecopy.cpp``), the port's own.

Each builds with ``g++`` on first use into the git-ignored ``_build/``
directory of the package, beside the CUDA libraries, under a name hashed
from the source and the flags (an edited source is rebuilt, a stale
library never loaded), and is bound through ctypes.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")


def build(name: str, flag_sets: Sequence[Sequence[str]]) -> str:
    """Build ``<name>.cpp`` into ``_build/lib<name>-<hash>.so`` with the
    first of ``flag_sets`` that the toolchain accepts (each a list of g++
    flags placed after the source) unless that library exists; return its
    path. Raises OSError or subprocess.SubprocessError when none builds."""
    src = os.path.join(_HERE, name + ".cpp")
    with open(src, "rb") as f:
        source = f.read()
    failure: Exception = OSError(f"no flags given for {src}")
    for flags in flag_sets:
        digest = hashlib.sha256(source + " ".join(flags).encode()).hexdigest()[:16]
        out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-std=c++17", "-shared", "-fPIC", src, "-o", tmp, *flags],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)  # atomic: concurrent builders never see half a file
            return out
        except (OSError, subprocess.SubprocessError) as e:
            failure = e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    raise failure
