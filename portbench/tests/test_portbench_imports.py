"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole), chip_smoke or benchmarks/; the references import
nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

PKG = harness.PKG
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


def imported(path: Path) -> set[str]:
    """Top-level names of every module a source imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_forbidden_import(path):
    bad = imported(path) & {"jax", "jaxlib", "flax", "ruvector_tpu", "chip_smoke", "benchmarks"}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert imported(path) <= {"__future__", "torch", "numpy", "portbench", "math"}
    text = path.read_text()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.ImportFrom) and node.module:
            assert node.module.startswith("portbench.reference") or node.module in (
                "__future__",), node.module


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules({"ruvector_tpu_torch": 1, "ruvector_tpu_torch.nn": 1,
                                      "jaxtyping": 1, "numpy": 1}) == []
    assert harness.forbidden_modules({"ruvector_tpu.nn": 1, "jax.numpy": 1, "flax": 1,
                                      "jaxlib.xla": 1}) == ["flax", "jax", "jaxlib",
                                                            "ruvector_tpu"]


def test_a_run_loads_no_jax():
    """The harness, the drivers, the port's entry points and the references
    imported in one process leave no forbidden module behind."""
    code = ("import portbench.run, portbench.controls, portbench.program as p\n"
            "from portbench import harness\n"
            "s = harness.Spec()\n"
            "[s.driver(s.traffic(w['traffic'])) for w in s.doc['workloads']]\n"
            "import ruvector_tpu_torch.graph_transformer.gated, "
            "ruvector_tpu_torch.nn.block_dense_layer, ruvector_tpu_torch.graph.block_dense\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card_or_the_port(tmp_path):
    """No card: exit 3 and no result line. A directory with BENCHMARK.json
    and the benchmark's files alone: no result either."""
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "config5-1m.drift", "--seed", "1", "--seconds", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "cache", "__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "config5-1m.drift", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
