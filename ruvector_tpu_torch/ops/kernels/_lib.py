"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for `sm_90a` into its own shared
library with a plain C interface, loaded with ctypes (no PyTorch headers,
so a build takes seconds). Libraries are built at first use into
`ruvector_tpu_torch/_build/` (git-ignored), named by a hash of the source
and flags so an edited source rebuilds. `build()` starts one nvcc per
source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("neighbor_mix", "block_dense_attn", "gated_block_attn", "mincut_gate_block",
           "gated_block_layer", "gated_block_mha", "flash_neighbor", "spmm_gather")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of each library: argument types (every one returns the
# cudaError_t of its launch as an int)
SIGNATURES = {
    "neighbor_mix": {
        "neighbor_mix_f32": [_P] * 6 + [_I] * 6 + [_F, _P],
    },
    "block_dense_attn": {
        "block_dense_attention": [_P] * 7 + [_I] * 7 + [_F, _P],
        "block_dense_layer_fused": [_P] * 7 + [_I] * 8 + [_F, _F, _P],
        "block_dense_edge_bits_words": [_I] * 3,
    },
    "gated_block_attn": {
        "block_gate_signature_ln_x": [_P] * 8 + [_I] * 8 + [_F, _P],
        "block_gate_signature_x": [_P] * 6 + [_I] * 8 + [_F, _P],
        "block_gate_signature": [_P] * 6 + [_I] * 5 + [_F, _F, _P],
    },
    "mincut_gate_block": {
        "mincut_gate_block_from_x": [_P] * 10 + [_I] * 8 + [_F, _F, _P],
    },
    "gated_block_layer": {
        "gated_block_layer": [_P] * 13 + [_I] * 9 + [_F, _F, _P],
    },
    "gated_block_mha": {
        "gated_block_mha_fwd": [_P] * 8 + [_I] * 7 + [_P],
        "gated_block_mha_bwd": [_P] * 11 + [_I] * 8 + [_P],
        "gated_block_mha_scratch_floats": [_I] * 5,
        "reduce_partials": [_P] + [_I] * 2 + [_P, _P],
    },
    "flash_neighbor": {
        "flash_neighbor_f32": [_P] * 5 + [_I] * 3 + [_F, _I, _P],
    },
    "spmm_gather": {
        "spmm_gather_f32": [_P] * 4 + [_I] * 5 + [_P],
        "spmm_gather_rows_per_tile": [_I],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        candidates.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """The built library of `csrc/<name>.cu`, named by a hash of the source,
    the shared headers it may include and the flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def log_path(name: str) -> Path:
    """The nvcc output (ptxas register and spill report) of the last build."""
    return library_path(name).with_suffix(".log")


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library in `names` that is not built yet, one nvcc per
    source, all started together. Returns each compiled source's seconds
    (from the common start to its nvcc's exit) and the whole build's
    under "total"."""
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(log_path(name), "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        jobs.append((name, out, tmp, log,
                     subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed, seconds = [], {}
    while len(seconds) < len(jobs):
        for name, out, tmp, log, proc in jobs:
            if name in seconds or proc.poll() is None:
                continue
            seconds[name] = time.perf_counter() - t0
            log.close()
            if proc.returncode == 0:
                os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            else:
                failed.append(f"{name} (nvcc rc={proc.returncode}):\n"
                              f"{log_path(name).read_text()[-4000:]}")
        time.sleep(0.05)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    seconds["total"] = time.perf_counter() - t0
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        lib.rvt_error_string.argtypes = [ctypes.c_int]
        lib.rvt_error_string.restype = ctypes.c_char_p
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.rvt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream of tensor t's device, as a C pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, what: str) -> None:
    """Input check of a kernel wrapper: raise ValueError unless cond."""
    if not cond:
        raise ValueError(what)
