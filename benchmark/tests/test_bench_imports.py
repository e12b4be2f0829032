"""No module of the benchmark imports JAX or the JAX package, and the plain
references import nothing of the program. Top-level names are compared
whole: ``msm_we_tpu_torch`` (the port) begins with ``msm_we_tpu`` (the JAX
package) and is not it."""
import ast
import json
import os
import subprocess
import sys

import pytest

import bench_helpers

FORBIDDEN = {"jax", "jaxlib", "flax", "msm_we_tpu"}
PROGRAM = "msm_we_tpu_torch"


def _modules():
    for d, _dirs, files in os.walk(bench_helpers.BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    """Top-level names of the absolute imports in ``path``, with the
    modules named by string to ``import_module`` or ``__import__``."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
            if node.module == "benchmark":
                names |= {f"benchmark.{a.name}" for a in node.names}
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            names.add(node.args[0].value)
    return names


def _top(names):
    return {n.split(".")[0] for n in names}


def test_the_top_level_comparison_is_whole():
    assert _top({"msm_we_tpu_torch.entry", "msm_we_tpu_torchx"}) & FORBIDDEN == set()
    assert _top({"msm_we_tpu.model"}) & FORBIDDEN == {"msm_we_tpu"}
    assert _top({"jax.numpy", "jaxlib"}) & FORBIDDEN == {"jax", "jaxlib"}
    run = bench_helpers.harness(bench_helpers.BENCH)
    assert run.forbidden_loaded(["msm_we_tpu_torch", "msm_we_tpu_torch.ops"]) == []
    assert run.forbidden_loaded(["msm_we_tpu.ops", "jax._src", "flax"]) == [
        "flax", "jax", "msm_we_tpu"]


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(
    p, bench_helpers.BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top(_imports(path)) & FORBIDDEN


def _module_file(name):
    """The file of the benchmark module ``benchmark.x.y``, or None."""
    rel = name.split(".")[1:]
    base = os.path.join(bench_helpers.BENCH, *rel)
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(cand):
            return cand
    return None


def test_the_reference_imports_nothing_of_the_program():
    """The reference and every benchmark module it imports, followed."""
    ref = os.path.join(bench_helpers.BENCH, "reference")
    todo = [os.path.join(ref, f) for f in os.listdir(ref) if f.endswith(".py")]
    seen = set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        names = _imports(path)
        assert not _top(names) & (FORBIDDEN | {PROGRAM}), path
        todo += [f for f in map(_module_file, (n for n in names
                                               if n.startswith("benchmark.")))
                 if f]
    assert len(seen) >= 2


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.hot_step, benchmark.reference.build; "
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=bench_helpers.ROOT,
                         capture_output=True, text=True, check=True, timeout=300)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {PROGRAM})
