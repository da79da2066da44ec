"""Nothing a run loads is JAX or solr_tpu (top-level names compared
whole), and the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "dataclasses", "math", "torch",
                              "solbench"}
    assert "solr_tpu_torch" not in _imports(path)


@pytest.mark.parametrize("path", sorted(p for p in HERE.rglob("*.py")
                                        if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_benchmark_imports_no_jax(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "solr_tpu"}


def test_a_run_loads_no_jax_or_solr_tpu():
    code = (
        "import time, torch\n"
        "torch.set_num_threads(2)\n"
        "from solbench import harness\n"
        "from solbench.tests.solbench_tiny import tiny_cell\n"
        "res = harness.run(tiny_cell('molecule100k.auto'), 3, 0.0, False,"
        " 'cpu', time.perf_counter())\n"
        "assert res['correct'], res\n"
        "print('FORBIDDEN', harness.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from solbench import harness

    monkeypatch.setitem(sys.modules, "solr_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxy.sub", object())
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.loaded_forbidden() == ["jax"]
