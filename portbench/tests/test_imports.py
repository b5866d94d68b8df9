"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name; the reference imports nothing of the
program."""

import ast
import subprocess
import sys

import pytest

from portbench import harness

FILES = sorted(p for p in harness.BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
    return found


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "deepcharuco_tpu_torch" not in top_level_imports(path)


def test_names_are_compared_whole(monkeypatch):
    for name in ("deepcharuco_tpu_torch.pipeline", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "deepcharuco_tpu.pipeline", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert set(harness.forbidden_modules()) - set(before) == {"deepcharuco_tpu", "jax"}


def test_loading_every_module_imports_no_jax():
    code = ("import sys, importlib, pkgutil, portbench, portbench.drivers; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "portbench.__path__, 'portbench.') if '.tests' not in m.name]; "
            "import deepcharuco_tpu_torch.pipeline, deepcharuco_tpu_torch.serving, "
            "deepcharuco_tpu_torch.train; "
            "from portbench import harness; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
