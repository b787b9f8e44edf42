"""Nothing under dgrbench/ imports JAX or the JAX package, and the yardstick
(reference, traffic, roofline, metric readers) imports nothing of the
program. Top-level module names are compared whole: the port's name begins
with the JAX package's."""

import ast
import os

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "dgrbench")
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "deepglobalregistration_tpu"}
PROGRAM = "deepglobalregistration_tpu_torch"
YARDSTICK = ("reference", "traffic", "roofline", "metrics")


def _modules():
    out = []
    for d, _, files in os.walk(BENCH):
        if ".cache" in d or "__pycache__" in d:
            continue
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def top_level_imports(path):
    """Top-level names of every module the file imports (relative imports
    resolve inside dgrbench)."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("dgrbench" if node.level else node.module.split(".")[0])
    return names


def test_walks_every_module():
    mods = _modules()
    assert len(mods) > 20
    assert any(m.endswith(os.path.join("reference", "judge.py")) for m in mods)


@pytest.mark.parametrize("path", _modules(), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not (top_level_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in _modules()
                                  if os.path.relpath(p, BENCH).split(os.sep)[0] in YARDSTICK],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_yardstick_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)


def test_whole_name_comparison():
    """The port's name is not the JAX package's, though it begins with it."""
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    src = "import deepglobalregistration_tpu_torch.ops\nfrom jax import numpy\n"
    path = os.path.join(ROOT, "dgrbench", ".cache", "probe_imports.py")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(src)
    try:
        assert top_level_imports(path) == {PROGRAM, "jax"}
    finally:
        os.remove(path)
