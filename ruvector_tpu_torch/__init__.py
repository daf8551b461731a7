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

__all__ = ["resolve_device"]
__version__ = "0.1.0"
