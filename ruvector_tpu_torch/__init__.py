"""ruvector_tpu_torch — the PyTorch/CUDA port of ruvector_tpu for NVIDIA Hopper.

Layout mirrors the JAX package (`ops/`, `nn/`, `graph/`, `models/`,
`parallel/`) with the same function names. Plain tensor code is PyTorch;
every Pallas kernel of the JAX package on the ported path is a CUDA C++
kernel for `sm_90a` (sources in `csrc/`, wrappers in `ops/kernels/`), each
with a plain PyTorch version beside it that the CPU path uses.

This package imports torch and numpy only — never jax, and nothing of
`ruvector_tpu`. Parameters use the JAX layout (linear kernels `[in, out]`,
`y = x @ W + b`) so a JAX parameter tree converts with
`convert.params_from_numpy`.
"""

from ruvector_tpu_torch.device import resolve_device

__version__ = "0.1.0"

# the graph types, resolved on first use like the subpackages, so that
# `import ruvector_tpu_torch` loads none of them
_GRAPH_NAMES = ("NeighborGraph", "CSRGraph", "build_knn_graph")
_SUBPACKAGES = frozenset({
    "graph", "ops", "nn", "attention", "models", "transformer", "graph_transformer",
    "training", "sona", "solver", "parallel", "index", "serve", "utils",
})

__all__ = ["NeighborGraph", "CSRGraph", "build_knn_graph", "resolve_device", "__version__"]


def __getattr__(name):
    """Lazy access to the graph types and the subpackages
    (`ruvector_tpu_torch.models`, `.sona`, ...) without importing them at
    `import ruvector_tpu_torch`."""
    import importlib

    if name in _GRAPH_NAMES:
        return getattr(importlib.import_module("ruvector_tpu_torch.graph"), name)
    if name in _SUBPACKAGES:
        return importlib.import_module(f"ruvector_tpu_torch.{name}")
    raise AttributeError(f"module 'ruvector_tpu_torch' has no attribute {name!r}")

