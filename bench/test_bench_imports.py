"""Nothing under bench/ imports the JAX stack, the JAX package or its
benchmarks folder, and the reference imports nothing of the port. Module
names are compared by their top-level name, whole: ``repro_torch`` is not
``repro``."""
import ast
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import run

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted(p for p in BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def path_constants(path: Path) -> set[str]:
    """String constants that name a file of the JAX package's benchmarks."""
    return {n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and any(seg == "benchmarks" for seg in n.value.replace("\\", "/").split("/")[:-1])}


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN
    assert not path_constants(path)


def test_reference_imports_nothing_of_the_port():
    assert top_level_imports(BENCH / "reference.py") <= {"__future__", "numpy", "torch"}


def test_top_level_names_compare_whole(monkeypatch):
    """On a process's module table of its own (a test worker may hold the
    JAX package, loaded by the port's comparison tests)."""
    loaded = {"repro_torch": sys, "repro_torch.mining": sys, "jaxtyping": sys,
              "numpy": sys}
    monkeypatch.setattr(run, "sys", SimpleNamespace(modules=loaded))
    assert run.forbidden_modules() == []
    loaded.update({"repro.fake": sys, "jax.numpy": sys})
    assert run.forbidden_modules() == ["jax", "repro"]


def test_run_loads_no_jax():
    """A harness import and a small CPU cell leave no JAX module behind."""
    code = ("import sys, time; sys.path[:0] = ['src', '.']\n"
            "from bench import run\n"
            "r = run.run_cell(run.load_spec(), 'mico.cliques', 5, 0.01, False, "
            "device='cpu', scale=0.003, t_start=time.perf_counter())\n"
            "assert r['correct'], r\n"
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
