"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import os

import pytest

from eyebench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "matrix_eyes_tpu"}


def _modules():
    for d, _dirs, files in os.walk(os.path.join(ROOT, "eyebench")):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), ROOT)


def _imported(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", list(_modules()))
def test_no_jax(path):
    assert not set(_imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in _modules() if "/reference/" in p])
def test_reference_is_independent(path):
    assert "matrix_eyes_tpu_torch" not in set(_imported(path))


def test_top_level_names_are_compared_whole():
    from eyebench import run

    assert "matrix_eyes_tpu_torch".split(".")[0] not in run.FORBIDDEN
    assert "matrix_eyes_tpu" in run.FORBIDDEN
