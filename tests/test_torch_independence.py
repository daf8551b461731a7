"""The port stands alone: it imports neither jax nor ruvector_tpu, its
entry points default to the CUDA card (and raise without one instead of
running on the CPU), and its kernel wrappers take the plain version only
for CPU tensors — never for a device tensor, and never counting a launch.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ruvector_tpu_torch.ops.kernels as kernels
from ruvector_tpu_torch import resolve_device
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import NeighborGraph, build_block_dense, build_knn_graph
from ruvector_tpu_torch.graph_transformer import (
    GatedGraphTransformerConfig,
    gated_graph_transformer_init,
)
from ruvector_tpu_torch.index import FlatIndex
from ruvector_tpu_torch.models import RuvectorNetConfig, ruvector_net_init
from ruvector_tpu_torch.nn.ruvector_layer import RuvectorLayerConfig, ruvector_layer_init
from ruvector_tpu_torch.ops.kernels.block_dense_attn import (
    block_dense_attention,
    block_dense_layer_fused,
)
from ruvector_tpu_torch.ops.kernels.flash_neighbor import flash_neighbor_attention
from ruvector_tpu_torch.ops.kernels.gated_block_attn import (
    block_gate_signature,
    block_gate_signature_ln_x,
    block_gate_signature_x,
    gated_block_attention_bwd,
    gated_block_attention_fwd,
    head_concat,
    pack_keep,
)
from ruvector_tpu_torch.ops.kernels.gated_block_layer import (
    gated_block_layer,
    gated_block_layer_with_sig,
)
from ruvector_tpu_torch.ops.kernels.mincut_gate_block import mincut_gate_block_from_x
from ruvector_tpu_torch.ops.kernels.neighbor_mix import fused_neighbor_mix
from ruvector_tpu_torch.ops.kernels.spmm import spmm_gather

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import ruvector_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ruvector_tpu_torch.__path__, "ruvector_tpu_torch.")]
assert "ruvector_tpu_torch.training.train" in names and "ruvector_tpu_torch.ops.distance" in names
assert "ruvector_tpu_torch.serve.rerank" in names and "ruvector_tpu_torch.ops.kernels.spmm" in names
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ruvector_tpu"))
print(len(names), bad)
"""


def test_imports_no_jax_and_no_jax_package():
    """Whole module names: `ruvector_tpu_torch` starts with `ruvector_tpu`.
    The walk covers every module, the training package, the distance ops,
    the serving path and the K8/K9 wrappers included."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 38
    assert bad == "[]"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")


_ENTRY_POINTS = {
    "resolve_device": lambda: resolve_device(),
    "ruvector_layer_init": lambda: ruvector_layer_init(0, RuvectorLayerConfig(8, 8, heads=2)),
    "ruvector_net_init": lambda: ruvector_net_init(0, RuvectorNetConfig(8, 8)),
    "params_from_numpy": lambda: params_from_numpy({"w": np.zeros(3, np.float32)}),
    "from_lists": lambda: NeighborGraph.from_lists([[1], [0]]),
    "build_knn_graph": lambda: build_knn_graph(np.eye(4, dtype=np.float32), k=2),
    "gated_graph_transformer_init": lambda: gated_graph_transformer_init(
        0, GatedGraphTransformerConfig(dim=8, num_heads=2, num_layers=1)),
    "build_block_dense": lambda: build_block_dense(
        np.zeros((4, 1), np.int32), np.ones((4, 1), np.float32),
        np.ones((4, 1), np.float32), block=4),
    "FlatIndex": lambda: FlatIndex(dim=4),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_points_raise_without_card(name):
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[name]()


def test_cpu_requested_explicitly_runs():
    assert resolve_device("cpu") == torch.device("cpu")
    params = ruvector_layer_init(0, RuvectorLayerConfig(8, 8, heads=2), device="cpu")
    assert params["w_msg"]["kernel"].device.type == "cpu"


def _k3_inputs(device):
    n, h, m, d = 5, 2, 3, 32
    g = torch.Generator().manual_seed(0)
    return [torch.randn(s, generator=g).to(device)
            for s in ((n, h, d), (n, h), (n, m, d), (n, m), (n, m))]


def _k2_inputs(device):
    g = torch.Generator().manual_seed(1)
    L = torch.randn(1, 64, 32, generator=g)
    u = torch.randn(2, 1, 8, 32, generator=g)
    sb = torch.randn(2, 1, 8, generator=g)
    wd = torch.rand(1, 8, 64, generator=g)
    return [x.to(device) for x in (L, u, sb, wd)]


def _k1_inputs(device):
    from ruvector_tpu_torch.ops.kernels.block_dense_attn import _folded_shapes

    g = torch.Generator().manual_seed(2)
    L, _, _, wd = _k2_inputs(device)
    msg = torch.randn(1, 8, 32, generator=g).to(device)
    folded = {k: torch.randn(s, generator=g).to(device)
              for k, s in _folded_shapes(2, 32).items()}
    return L, msg, wd, folded


def _gated_inputs(device):
    """K4a/K4b/K6c/K7 inputs: 2 partitions of 32 rows, D=32, 2 heads."""
    from ruvector_tpu_torch.ops.kernels.gated_block_layer import _folded_shapes

    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 32, 32, generator=g)
    pad = torch.ones(2, 32)
    keep = pack_keep(torch.rand(2, 32, 32, generator=g) > 0.5)
    wd = torch.rand(2, 32, 32, generator=g)
    A = 0.1 * torch.randn(32, 32, generator=g)
    ln = (torch.ones(32), torch.zeros(32))
    folded = {k: 0.1 * torch.randn(s, generator=g) for k, s in _folded_shapes(2, 32, 2).items()}
    return (x.to(device), pad.to(device), A.to(device), tuple(v.to(device) for v in ln),
            keep.to(device), wd.to(device), {k: v.to(device) for k, v in folded.items()})


def _k8_inputs(device):
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(s, generator=g) for s in ((3, 32), (3, 5, 32), (3, 5, 32)))
    mask = (torch.rand(3, 5, generator=g) > 0.3).float()
    return [x.to(device) for x in (q, k, v, mask)]


def _k9_inputs(device):
    g = torch.Generator().manual_seed(5)
    feats = torch.randn(10, 8, generator=g)
    idx = torch.randint(0, 10, (4, 3), generator=g, dtype=torch.int32)
    w = torch.rand(4, 3, generator=g)
    return [x.to(device) for x in (feats, idx, w)]


def _run(kernel, device):
    if kernel == "flash_neighbor_attention":
        return flash_neighbor_attention(*_k8_inputs(device))
    if kernel == "spmm_gather":
        return spmm_gather(*_k9_inputs(device))
    if kernel == "fused_neighbor_mix":
        return fused_neighbor_mix(*_k3_inputs(device), heads=2, scale=0.5)
    if kernel == "block_dense_attention":
        return block_dense_attention(*_k2_inputs(device), scale=0.5)
    if kernel == "block_dense_layer_fused":
        return block_dense_layer_fused(*_k1_inputs(device), dropout=0.0, eps=1e-5)
    x, pad, A, ln, keep, wd, folded = _gated_inputs(device)
    if kernel == "gated_block_layer":
        return gated_block_layer(x, keep, pad, wd, folded, compute_bf16=False)
    if kernel == "gated_block_layer_with_sig":
        return gated_block_layer_with_sig(x, keep, pad, wd, folded, A, *ln,
                                          compute_bf16=False, sig_eps=0.01)[0]
    if kernel == "block_gate_signature_ln_x":
        return block_gate_signature_ln_x(x, pad, A, *ln, eps=0.01, compute_bf16=False)[0]
    if kernel == "block_gate_signature_x":
        return block_gate_signature_x(x, pad, A, eps=0.01, compute_bf16=False)[0]
    if kernel == "block_gate_signature":
        return block_gate_signature(x, x, pad, eps=0.01, scale=0.5)[0]
    A_cat = head_concat(torch.stack([A, A]))
    if kernel == "gated_block_attention_fwd":
        return gated_block_attention_fwd(x, keep, pad, A_cat, A_cat, compute_bf16=False)
    if kernel == "gated_block_attention_bwd":
        return gated_block_attention_bwd(x, keep, pad, A_cat, A_cat, x, compute_bf16=False)[1]
    return mincut_gate_block_from_x(x, pad, A, lam=0.5, eps=0.01, ln=ln)[1]


_KERNELS = ["fused_neighbor_mix", "block_dense_attention", "block_dense_layer_fused",
            "gated_block_layer", "gated_block_layer_with_sig", "gated_block_attention_fwd",
            "gated_block_attention_bwd", "block_gate_signature", "block_gate_signature_x",
            "block_gate_signature_ln_x", "mincut_gate_block_from_x", "flash_neighbor_attention",
            "spmm_gather"]


@pytest.mark.parametrize("kernel", _KERNELS)
def test_cpu_tensors_take_plain_version_without_counting(kernel):
    kernels.reset_launch_counts()
    out = _run(kernel, "cpu")
    assert torch.isfinite(out.float()).all()
    assert kernels.launch_counts() == {k: 0 for k in _KERNELS}
    assert sorted(k.__name__ for k in kernels.KERNELS) == sorted(_KERNELS)


@pytest.mark.parametrize("kernel", _KERNELS)
def test_non_cpu_tensors_never_fall_back(kernel):
    """A tensor off the CPU goes to the kernel path: here (a `meta` tensor,
    no kernel for it) that must raise, not quietly compute the plain
    version."""
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        _run(kernel, "meta")
    assert kernels.launch_counts()[kernel] == 0


def test_kernel_build_dir_is_ignored():
    from ruvector_tpu_torch.ops.kernels import _lib

    assert _lib.BUILD_DIR == REPO / "ruvector_tpu_torch" / "_build"
    assert "ruvector_tpu_torch/_build/" in (REPO / ".gitignore").read_text().split()
    assert all((_lib.CSRC_DIR / f"{s}.cu").exists() for s in _lib.SOURCES)
    assert set(_lib.SIGNATURES) == set(_lib.SOURCES)
    assert all("sm_90a" in f for f in _lib.NVCC_FLAGS if "arch=" in f)
