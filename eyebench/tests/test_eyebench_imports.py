"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), the
reference imports nothing of the program, and only Depth Pro's
architecture module names Depth Pro's reference and ledger: the harness
reaches every architecture through ``eyebench/harness/architecture.py``."""

import ast
import os

import pytest

from eyebench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "matrix_eyes_tpu"}
# Depth Pro's reference and its frozen ledger functions
DEPTH_PRO = {"eyebench.reference.model", "eyebench.reference.weights",
             "eyebench.harness.ledger.model_flops", "eyebench.harness.ledger.attention_calls",
             "eyebench.harness.ledger.conv3x3_calls"}


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


def _depth_pro_names(path):
    """The names of ``DEPTH_PRO`` that ``path`` imports or reaches as
    ``<module>.<name>``."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    short = {".".join(n.split(".")[-2:]) for n in DEPTH_PRO}  # ledger.model_flops, ...
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names if a.name in DEPTH_PRO)
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module in DEPTH_PRO:
                yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names
                        if f"{node.module}.{a.name}" in DEPTH_PRO)
        elif isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            if f"{node.value.id}.{node.attr}" in short:
                yield f"{node.value.id}.{node.attr}"


@pytest.mark.parametrize("path", [p for p in _modules()
                                  if p != os.path.join("eyebench", "architectures", "depth_pro.py")
                                  and "/tests/" not in p and "/reference/" not in p])
def test_only_depth_pros_module_names_depth_pro(path):
    """``check.py``, ``cell.py``, the generators and every metric reader
    take Depth Pro's reference and ledger from the architecture alone. The
    reference's own files are left out: another model's reference may
    share Depth Pro's layers."""
    assert not list(_depth_pro_names(path))


def test_the_scan_sees_depth_pros_names():
    assert set(_depth_pro_names(os.path.join("eyebench", "architectures", "depth_pro.py"))) >= {
        "eyebench.reference.weights", "eyebench.reference.model", "ledger.model_flops",
        "ledger.attention_calls", "ledger.conv3x3_calls"}


def test_top_level_names_are_compared_whole():
    from eyebench import run

    assert "matrix_eyes_tpu_torch".split(".")[0] not in run.FORBIDDEN
    assert "matrix_eyes_tpu" in run.FORBIDDEN
