"""The port's layers import downward: ``entry`` -> ``step`` -> (``ops/*``,
``_graph``) -> ``ops/_ext``. Read from the sources with ``ast``, so an
import deferred into a function body counts as well.

* ``_graph`` (capture and replay) knows no tail, no kernel and no route: it
  imports neither ``step`` nor ``entry`` nor any ``ops`` module but
  ``ops._ext`` (the conditional node's entry point);
* no ``ops`` module imports ``step``, ``entry`` or ``_graph``;
* the tail's kernel wrapper imports no other ``ops`` module but ``_ext``,
  so the two kernel modules do not import each other.
"""
import ast
from pathlib import Path

import pytest

import msm_we_tpu_torch

PKG = Path(msm_we_tpu_torch.__file__).resolve().parent
OPS = sorted(p.stem for p in (PKG / "ops").glob("*.py"))


def _imports(path):
    """The dotted names a source file imports, relative to the package
    (``"step"``, ``"ops._ext"``; ``from X import y`` gives ``X`` and
    ``X.y``, as ``y`` may be a module), at any depth of the file."""
    here = list(path.relative_to(PKG).parent.parts)
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name.split(".") for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = here[:len(here) - node.level + 1]
                base += node.module.split(".") if node.module else []
            else:
                base = node.module.split(".")
            mods = [base] + [base + [a.name] for a in node.names]
        else:
            continue
        for m in mods:
            if m[:1] == [PKG.name]:
                m = m[1:]
            found.add(".".join(m))
    return found


def test_the_imports_are_read_relative_to_the_package():
    assert {"_graph", "ops.steady_tail", "ops.steady_tail._fixed_squarings",
            "ops.stratified_assign"} <= _imports(PKG / "step.py")
    assert {"ops._ext", "ops._ext._count_launch", "ops.steady_tail",
            "torch"} <= _imports(PKG / "ops" / "stratified_assign.py")
    assert {"tracing", "ops._ext"} <= _imports(PKG / "_graph.py")


def test_graph_knows_no_tail_kernel_or_route():
    got = _imports(PKG / "_graph.py")
    assert not got & {"step", "entry"}
    assert {m for m in got if m.startswith("ops.")} <= {
        "ops._ext", "ops._ext.check", "ops._ext.library"}


@pytest.mark.parametrize("name", OPS)
def test_no_ops_module_imports_upward(name):
    got = _imports(PKG / "ops" / f"{name}.py")
    assert not {m.split(".")[0] for m in got} & {"step", "entry", "_graph"}, got


def test_the_tail_kernel_imports_no_other_kernel_module():
    got = _imports(PKG / "ops" / "steady_tail.py")
    assert {m.split(".")[1] for m in got if m.startswith("ops.")} <= {"_ext"}
