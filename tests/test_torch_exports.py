"""The port exports what the JAX package exports.

For every module that exists in both packages (the top level, each
subpackage's `__init__` and each module under the same path), the port's
public names are a superset of the JAX module's. A JAX module's public
names are its `__all__`, or else its top-level names that do not start
with "_", less those its import statements bind. A name that a JAX
`__init__` re-exports from a module the port does not have yet is held
back until that module is ported; each such module is listed in WAITING
with the ROADMAP item that ports it, so a module left out of both fails.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "ruvector_tpu"
PORT_ROOT = REPO / "ruvector_tpu_torch"

# JAX modules the port does not have yet, and the ROADMAP item that ports
# each; a name that a shared `__init__` re-exports from one waits for it
# (empty: every JAX module outside ops/pallas has its counterpart)
WAITING: dict[str, str] = {}


def _relative(path: Path, root: Path) -> str:
    parts = path.relative_to(root).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _shared_modules() -> list[str]:
    """Module paths (relative, "" for the top level) that exist in both
    packages, from the file trees alone (nothing is imported to collect)."""
    port = {_relative(p, PORT_ROOT) for p in PORT_ROOT.rglob("*.py")}
    jax = {_relative(p, JAX_ROOT) for p in JAX_ROOT.rglob("*.py")}
    return sorted(port & jax)


def _imported_names(module) -> set[str]:
    """The names that the module's import statements bind."""
    tree = ast.parse(Path(module.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return names


def _public_names(module) -> set[str]:
    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {n for n in vars(module) if not n.startswith("_")} - _imported_names(module)


def _defining_module(module, name: str) -> str | None:
    """The JAX module that defines `name`, relative to the package, where
    the value says so (functions and classes)."""
    defined_in = getattr(getattr(module, name, None), "__module__", None) or ""
    if defined_in.startswith("ruvector_tpu."):
        return defined_in[len("ruvector_tpu."):]
    return None


def _module(rel: str, package: str):
    return importlib.import_module(f"{package}.{rel}" if rel else package)


SHARED = _shared_modules()


def test_shared_modules_cover_this_slice():
    for rel in ("", "ops", "utils", "utils.checkpoint", "utils.cold_tier", "utils.metrics",
                "utils.mmap_store", "utils.monitoring", "utils.profiler", "training",
                "training.mining", "training.worker", "training.metrics_hook", "sona",
                "sona.engine", "sona.export", "sona.federated", "sona.lora", "sona.types",
                "sona.trajectory", "sona.ewc_pp", "sona.reasoning_bank", "parallel.ordering",
                "native", "index", "index.filter", "index.hnsw", "index.hyperbolic_hnsw",
                "index.vector_db", "graph", "graph.property", "graph.cypher", "mincut",
                "mincut.dynamic", "mincut.global_dynamic", "mincut.local", "mincut.sparsify",
                "mincut.expander", "mincut.jtree", "parallel", "parallel.mesh",
                "parallel.partition", "parallel.halo", "parallel.tp", "parallel.ep",
                "parallel.pp", "parallel.sp", "parallel.multihost", "serve.distributed",
                "serve", "serve.sql", "serve.server", "serve.mcp", "__main__"):
        assert rel in SHARED, rel
    assert not WAITING, "a module is still listed as waiting"


def test_every_jax_module_has_a_counterpart():
    """Apart from the Pallas kernels (each has a CUDA counterpart), every
    module of the JAX package exists in the port."""
    jax = {_relative(p, JAX_ROOT) for p in JAX_ROOT.rglob("*.py")}
    missing = sorted(m for m in jax - set(SHARED)
                     if m != "ops.pallas" and not m.startswith("ops.pallas."))
    assert missing == []


@pytest.mark.parametrize("rel", SHARED, ids=lambda r: r or "<top>")
def test_port_exports_a_superset_of_jax(rel):
    jax_mod = _module(rel, "ruvector_tpu")
    port_mod = _module(rel, "ruvector_tpu_torch")
    missing = []
    for name in sorted(_public_names(jax_mod)):
        if hasattr(port_mod, name):
            continue
        source = _defining_module(jax_mod, name)
        if source is not None and source not in SHARED:
            assert source in WAITING, f"{name}: {source} is neither ported nor listed"
        else:
            missing.append(name)
    assert not missing, f"ruvector_tpu_torch.{rel} lacks {missing}"


_LAZY = """
import sys
import ruvector_tpu_torch as r
loaded = sorted(m for m in sys.modules if m.startswith("ruvector_tpu_torch."))
assert loaded == ["ruvector_tpu_torch.device"], loaded
assert "graph" not in vars(r) and "sona" not in vars(r)
names = [r.build_knn_graph, r.NeighborGraph, r.CSRGraph, r.models, r.sona, r.training,
         r.utils, r.ops.pairwise_cosine, r.ops.cosine_similarity, r.mincut.DynamicMinCut,
         r.native.bdense_plan]
assert "ruvector_tpu_torch.native" in sys.modules and not r.native._libs
assert r.NeighborGraph.__module__ == "ruvector_tpu_torch.graph.neighbors"
print("ok")
"""


def test_top_level_resolves_lazily():
    """A bare `import ruvector_tpu_torch` loads no subpackage; the graph
    types and the subpackages resolve on first use."""
    out = subprocess.run([sys.executable, "-c", _LAZY], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
