"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: each import's top-level name
(the part before the first dot) is compared whole, since the program's
name begins with the JAX package's."""

import ast
import os

import pytest

from conftest import BENCH

JAX_NAMES = {"jax", "jaxlib", "flax", "horizonnet_tpu"}


def _sources(sub=""):
    top = os.path.join(BENCH, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    assert not top_level_imports(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_no_program(path):
    assert "horizonnet_tpu_torch" not in top_level_imports(path)


def test_names_compared_whole():
    """The check tells the program's name from the JAX package's."""
    src = "import horizonnet_tpu_torch.models\nfrom horizonnet_tpu import x\n"
    tree = ast.parse(src)
    tops = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
            else n.module.split(".")[0] for n in tree.body}
    assert tops & JAX_NAMES == {"horizonnet_tpu"}
    assert "horizonnet_tpu_torch" not in JAX_NAMES


def test_run_refuses_a_process_holding_jax(monkeypatch):
    import sys
    import types

    from harness import runner

    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert runner.forbidden_modules() == ["jax"]
