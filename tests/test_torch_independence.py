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
import torch_parallel_ranks
from ruvector_tpu_torch import resolve_device
from ruvector_tpu_torch.attention import (
    EdgeFeaturedConfig,
    LinearAttentionConfig,
    SparseMaskBuilder,
    TrainableAttention,
    edge_featured_init,
    linear_attention_init,
)
from ruvector_tpu_torch.attention.cgt import CgtConfig, cgt_init
from ruvector_tpu_torch.attention.dual_space import DualSpaceConfig, dual_space_init
from ruvector_tpu_torch.attention.info_bottleneck import IBConfig, ib_init
from ruvector_tpu_torch.attention.mincut import hysteresis_init
from ruvector_tpu_torch.attention.moe import MoEAttentionConfig, moe_attention_init
from ruvector_tpu_torch.attention.sdk import preset
from ruvector_tpu_torch.attention.local_global import local_global_mask
from ruvector_tpu_torch.attention.rope import rope_tables
from ruvector_tpu_torch.attention.sheaf import SheafAttentionConfig, sheaf_init
from ruvector_tpu_torch.attention.transport import TransportConfig, transport_init
from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import CSRGraph, NeighborGraph, build_block_dense, build_knn_graph
from ruvector_tpu_torch.graph_transformer import (
    GatedGraphTransformerConfig,
    GraphTransformerConfig,
    MorphogeneticField,
    gated_graph_transformer_init,
    graph_transformer_init,
)
from ruvector_tpu_torch.graph.property import PropertyGraph
from ruvector_tpu_torch.index import (
    DbOptions,
    FlatIndex,
    HnswConfig,
    HnswIndex,
    HyperbolicIndex,
    VectorDB,
)
from ruvector_tpu_torch.index.hyperbolic_hnsw import HyperbolicConfig
from ruvector_tpu_torch.mincut import spectral_sparsify
from ruvector_tpu_torch.parallel import (
    EpConfig,
    HaloPlan,
    TpLayerConfig,
    ep_init,
    make_blocked_layer_forward,
    pad_features_for_plan,
    run_ranks,
    tp_layer_init,
)
from ruvector_tpu_torch.models import (
    GATConfig,
    GCNConfig,
    GraphSAGENetConfig,
    RuvectorNetConfig,
    gat_init,
    gcn_init,
    graphsage_net_init,
    ruvector_net_init,
)
from ruvector_tpu_torch.nn.ruvector_layer import RuvectorLayerConfig, ruvector_layer_init
from ruvector_tpu_torch.ops import temporal_tensor, temporal_tiers
from ruvector_tpu_torch.ops.compress import TensorCompress
from ruvector_tpu_torch.ops.quantization import pq_train
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
from ruvector_tpu_torch.__main__ import main as cli_main
from ruvector_tpu_torch.serve.mcp import McpServer
from ruvector_tpu_torch.serve.server import RuvectorServer
from ruvector_tpu_torch.serve.sql import SqlEngine
from ruvector_tpu_torch.solver import BmsspSolver, TrueSolver, cg_solve, forward_push_ppr
from ruvector_tpu_torch.sona import BaseLoRA, MicroLoRA, SonaEngine
from ruvector_tpu_torch.sona.federated import FederatedAggregator
from ruvector_tpu_torch.training.mining import in_batch_negatives
from ruvector_tpu_torch.transformer import (
    Decoder,
    GatePacket,
    GatePolicy,
    KVCacheConfig,
    MincutGatedTransformer,
    SpecDecodeConfig,
    TransformerConfig,
    init_weights,
    kv_cache_init,
    make_batched_generate_fn,
    make_decode_step,
    make_generate_fn,
    make_speculative_generate_fn,
)
from ruvector_tpu_torch.transformer.mamba import MambaConfig, mamba_init, mamba_state_init
from ruvector_tpu_torch.transformer.train_spec import train_early_exit
from ruvector_tpu_torch.utils.cold_tier import ColdTierTrainer, HyperbatchConfig, HyperbatchIterator
from ruvector_tpu_torch.utils.profiler import Profiler

REPO = Path(__file__).resolve().parents[1]


class _Rows:
    """A 4 x 2 feature store in memory (FeatureStorage's read interface)."""

    num_nodes, dim = 4, 2

    def read_batch(self, ids):
        return np.zeros((len(ids), 2), np.float32)

# the transformer's entry points at a tiny width (2 layers, hidden 16)
_TINY = TransformerConfig(seq_len_max=16, hidden=16, heads=2, layers=2, window_normal=4,
                          window_degraded=2, logits=32, vocab=32, layers_degraded=1,
                          seq_len_degraded=8, seq_len_safe=4)
_TINY_CACHE = KVCacheConfig(hot_capacity=4, warm_capacity=4, archive_capacity=4, heads=2,
                            head_dim=8)

# a one-shard halo plan of a 2-node graph
_PLAN = HaloPlan(
    n_shards=1, block=2, halo=1, send_idx=np.zeros((1, 1, 1), np.int32),
    send_mask=np.zeros((1, 1, 1), np.float32), local_nbr_idx=np.zeros((1, 2, 1), np.int32),
    nbr_mask=np.zeros((1, 2, 1), np.float32), edge_weight=np.zeros((1, 2, 1), np.float32),
    node_pad_mask=np.ones((1, 2), np.float32))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import ruvector_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ruvector_tpu_torch.__path__, "ruvector_tpu_torch.")]
assert "ruvector_tpu_torch.training.train" in names and "ruvector_tpu_torch.ops.distance" in names
assert "ruvector_tpu_torch.serve.rerank" in names and "ruvector_tpu_torch.ops.kernels.spmm" in names
assert "ruvector_tpu_torch.models.graphsage" in names and "ruvector_tpu_torch.attention.sheaf" in names
for new in ("attention.dual_space", "attention.mixed_curvature", "attention.topology",
            "attention.mincut", "attention.mincut_device", "attention.cgt", "attention.moe",
            "attention.sdk", "utils.witness", "ops.quantization", "ops.compress", "ops.q15",
            "ops.temporal_tensor", "ops.temporal_tiers"):
    assert "ruvector_tpu_torch." + new in names, new
for mod in ("config", "packets", "gate", "quant", "kv_cache", "sparse_attention",
            "mod_routing", "model", "trace", "decode", "spec_decode", "train_spec",
            "speculative", "kv_metrics", "kv_quantizers", "spike", "spike_attention",
            "mamba", "spectral"):
    assert "ruvector_tpu_torch.transformer." + mod in names, mod
for mod in ("solver.iterative", "solver.push", "solver.bmssp", "solver.true_solver",
            "solver.router", "graph_transformer.block", "graph_transformer.sublinear",
            "graph_transformer.physics", "graph_transformer.biological",
            "graph_transformer.self_organizing", "graph_transformer.manifold",
            "graph_transformer.temporal", "graph_transformer.economic",
            "graph_transformer.verified"):
    assert "ruvector_tpu_torch." + mod in names, mod
for mod in ("utils.metrics", "utils.monitoring", "utils.profiler", "utils.checkpoint",
            "utils.mmap_store", "utils.cold_tier", "training.metrics_hook", "training.mining",
            "training.worker", "sona", "sona.types", "sona.trajectory", "sona.lora",
            "sona.ewc_pp", "sona.reasoning_bank", "sona.engine", "sona.federated",
            "sona.export"):
    assert "ruvector_tpu_torch." + mod in names, mod
for mod in ("native", "index.filter", "index.hnsw", "index.hyperbolic_hnsw", "index.vector_db",
            "graph.property", "graph.cypher", "mincut", "mincut.dynamic", "mincut.global_dynamic",
            "mincut.local", "mincut.sparsify", "mincut.expander", "mincut.jtree"):
    assert "ruvector_tpu_torch." + mod in names, mod
for mod in ("parallel.mesh", "parallel.partition", "parallel.halo", "parallel.tp",
            "parallel.ep", "parallel.pp", "parallel.sp", "parallel.multihost", "parallel.gated",
            "serve.distributed", "serve.sql", "serve.server", "serve.mcp", "__main__"):
    assert "ruvector_tpu_torch." + mod in names, mod
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ruvector_tpu"))
print(len(names), bad)
"""


def test_imports_no_jax_and_no_jax_package():
    """Whole module names: `ruvector_tpu_torch` starts with `ruvector_tpu`.
    The walk covers every module, the training package, the distance ops,
    the serving path, the K8/K9 wrappers, the GNN model family, the whole
    attention family, the witness log, the quantization ops, the 19
    modules of the min-cut-gated transformer, the solvers, the rest of
    the graph transformers, SONA, mining, the worker, the host utilities,
    the native runtime, the indexes, the property graph, Cypher, the
    min-cut toolkit, the parallel package and the front ends (SQL, HTTP,
    MCP, the CLI) included."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 155
    assert bad == "[]"


def test_port_names_no_path_of_the_jax_package_native_runtime():
    """The port builds its own copy of the C++ runtime: no code of the port
    names the JAX package's native directory. (The two .cpp files are
    byte-for-byte copies, whose header comment names the JAX package's
    loader; tests/test_torch_native.py holds them equal to the originals.)"""
    jax_native = "ruvector_tpu" + "/native"
    hits = [str(p.relative_to(REPO)) for p in (REPO / "ruvector_tpu_torch").rglob("*")
            if p.is_file() and p.suffix in (".py", ".cu", ".cuh")
            and jax_native in p.read_text(errors="replace")]
    assert hits == []


# modules whose first import in a fresh process once closed an import
# cycle (the kernels' wrappers, the attention package, the training
# package and the layers that import the kernels)
_FIRST_IMPORTS = ("nn.ruvector_layer", "nn.block_dense_layer", "training.train",
                  "ops.kernels.mincut_gate_block", "models.ruvector_net", "sona.engine",
                  "training.mining", "utils.cold_tier", "native", "index.vector_db",
                  "graph.cypher", "mincut", "mincut.jtree", "serve.sql", "serve.server",
                  "serve.mcp", "__main__")


@pytest.mark.parametrize("mod", _FIRST_IMPORTS)
def test_module_imports_first_in_a_fresh_process(mod):
    out = subprocess.run([sys.executable, "-c", f"import ruvector_tpu_torch.{mod}"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


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
    "gcn_init": lambda: gcn_init(0, GCNConfig(8, 8)),
    "gat_init": lambda: gat_init(0, GATConfig(node_dim=8, num_heads=2)),
    "graphsage_net_init": lambda: graphsage_net_init(0, GraphSAGENetConfig(8, 8, 8)),
    "edge_featured_init": lambda: edge_featured_init(0, EdgeFeaturedConfig(8, 2, 2)),
    "linear_attention_init": lambda: linear_attention_init(0, LinearAttentionConfig(8)),
    "transport_init": lambda: transport_init(0, TransportConfig(dim=8)),
    "sheaf_init": lambda: sheaf_init(0, SheafAttentionConfig(dim=8, restriction_dim=8)),
    "ib_init": lambda: ib_init(0, IBConfig(dim=8, bottleneck_dim=4)),
    "TrainableAttention": lambda: TrainableAttention("hyperbolic"),
    "SparseMaskBuilder": lambda: SparseMaskBuilder(8),
    "rope_tables": lambda: rope_tables(8, 4),
    "local_global_mask": lambda: local_global_mask(8, 2, 1),
    "dual_space_init": lambda: dual_space_init(0, DualSpaceConfig(dim=8)),
    "moe_attention_init": lambda: moe_attention_init(0, MoEAttentionConfig(dim=8)),
    "cgt_init": lambda: cgt_init(0, CgtConfig(dim=8)),
    "hysteresis_init": lambda: hysteresis_init((3,)),
    "preset": lambda: preset("switch_transformer", 8),
    "pq_train": lambda: pq_train(np.eye(8, dtype=np.float32), 2, 4, 1),
    "TensorCompress": lambda: TensorCompress().compress(np.eye(8, dtype=np.float32), 0.9),
    "quantize_bits": lambda: temporal_tensor.quantize_bits(np.ones(4, np.float32), 8),
    "TemporalTensorStore": lambda: temporal_tensor.TemporalTensorStore(),
    "temporal_tiers.TemporalTensorStore": lambda: temporal_tiers.TemporalTensorStore(8),
    "transformer.init_weights": lambda: init_weights(torch.Generator(), _TINY),
    "MincutGatedTransformer": lambda: MincutGatedTransformer(_TINY, GatePolicy(), {}),
    "Decoder": lambda: Decoder(_TINY, GatePolicy(), {"layers": []}),
    "make_decode_step": lambda: make_decode_step(_TINY, _TINY_CACHE),
    "make_generate_fn": lambda: make_generate_fn(_TINY, _TINY_CACHE, 2, 2),
    "make_batched_generate_fn": lambda: make_batched_generate_fn(_TINY, _TINY_CACHE, 2, 2),
    "make_speculative_generate_fn": lambda: make_speculative_generate_fn(
        _TINY, _TINY_CACHE, SpecDecodeConfig(), 2),
    "kv_cache_init": lambda: kv_cache_init(_TINY_CACHE),
    "train_early_exit": lambda: train_early_exit(_TINY, steps=1, batch=1, seq_len=4),
    "mamba_init": lambda: mamba_init(torch.Generator(), MambaConfig.micro()),
    "mamba_state_init": lambda: mamba_state_init(MambaConfig.micro()),
    "graph_transformer_init": lambda: graph_transformer_init(0, GraphTransformerConfig(dim=8)),
    "BmsspSolver": lambda: BmsspSolver(),
    "MorphogeneticField.init_state": lambda: MorphogeneticField().init_state(4),
    "SonaEngine": lambda: SonaEngine(8),
    "MicroLoRA": lambda: MicroLoRA(8),
    "BaseLoRA": lambda: BaseLoRA(8, 2),
    "FederatedAggregator": lambda: FederatedAggregator(8),
    "in_batch_negatives": lambda: in_batch_negatives(4),
    "Profiler.device_memory_stats": lambda: Profiler.device_memory_stats(),
    "HyperbatchIterator": lambda: HyperbatchIterator(_Rows(), HyperbatchConfig(2)),
    "ColdTierTrainer": lambda: ColdTierTrainer(_Rows(), HyperbatchConfig(2)),
    "HnswIndex": lambda: HnswIndex(HnswConfig(dim=4)),
    "VectorDB": lambda: VectorDB(DbOptions(dimensions=4)),
    "HyperbolicIndex": lambda: HyperbolicIndex(HyperbolicConfig(dim=4)),
    "PropertyGraph.to_csr": lambda: PropertyGraph().to_csr(),
    "spectral_sparsify": lambda: spectral_sparsify([0, 1], [1, 2], [1.0, 1.0], 3),
    "run_ranks": lambda: run_ranks(print, 2),
    "tp_layer_init": lambda: tp_layer_init(0, TpLayerConfig(8, 2, 4, 16)),
    "ep_init": lambda: ep_init(0, EpConfig(8, 16, 2)),
    "pad_features_for_plan": lambda: pad_features_for_plan(
        np.zeros((2, 2), np.float32), _PLAN, np.arange(2)),
    "make_blocked_layer_forward": lambda: make_blocked_layer_forward(
        RuvectorNetConfig(2, 4, heads=2), _PLAN),
    "SqlEngine": lambda: SqlEngine(),
    "RuvectorServer": lambda: RuvectorServer(port=0),
    "McpServer": lambda: McpServer(),
    "cli_main": lambda: cli_main(["info", "no-such-collection"]),
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


_CPU_INITS = {
    "gcn_init": lambda: gcn_init(0, GCNConfig(8, 8), device="cpu"),
    "gat_init": lambda: gat_init(0, GATConfig(node_dim=8, num_heads=2), device="cpu"),
    "graphsage_net_init": lambda: graphsage_net_init(0, GraphSAGENetConfig(8, 8, 8),
                                                     device="cpu"),
    "edge_featured_init": lambda: edge_featured_init(0, EdgeFeaturedConfig(8, 2, 2),
                                                     device="cpu"),
    "linear_attention_init": lambda: linear_attention_init(0, LinearAttentionConfig(8),
                                                           device="cpu"),
    "transport_init": lambda: transport_init(0, TransportConfig(dim=8), device="cpu"),
    "sheaf_init": lambda: sheaf_init(0, SheafAttentionConfig(dim=8, restriction_dim=8),
                                     device="cpu"),
    "ib_init": lambda: ib_init(0, IBConfig(dim=8, bottleneck_dim=4), device="cpu"),
    "TrainableAttention": lambda: TrainableAttention(
        "edge_featured", EdgeFeaturedConfig(8, 2, 2), device="cpu").params,
    "dual_space_init": lambda: dual_space_init(0, DualSpaceConfig(dim=8), device="cpu"),
    "moe_attention_init": lambda: moe_attention_init(0, MoEAttentionConfig(dim=8),
                                                     device="cpu"),
    "cgt_init": lambda: cgt_init(0, CgtConfig(dim=8), device="cpu"),
    "preset": lambda: preset("switch_transformer", 8, device="cpu").params,
    "pq_train": lambda: [pq_train(np.eye(8, dtype=np.float32), 2, 4, 1,
                                  device="cpu").codebooks],
    "transformer.init_weights": lambda: init_weights(torch.Generator().manual_seed(0), _TINY,
                                                     device="cpu"),
    "transformer.init_weights_f32": lambda: init_weights(torch.Generator().manual_seed(0),
                                                         _TINY, quantize=False, device="cpu"),
    "kv_cache_init": lambda: [kv_cache_init(_TINY_CACHE, device="cpu", batch=2).hot_k],
    "mamba_init": lambda: mamba_init(torch.Generator().manual_seed(0), MambaConfig.micro(),
                                     device="cpu"),
    "graph_transformer_init": lambda: graph_transformer_init(
        0, GraphTransformerConfig(dim=8, num_heads=2), device="cpu"),
    "MorphogeneticField.init_state": lambda: list(MorphogeneticField().init_state(
        4, device="cpu")),
}


def test_solver_and_graph_transformer_entry_points_run_on_the_cpu_when_asked():
    """The AMG solver asked for the CPU solves there; the solvers, PPR and
    the sketched solve follow the device of the matrix they are given."""
    src = np.repeat(np.arange(6), 2)
    dst = np.stack([(np.arange(6) + 1) % 6, (np.arange(6) - 1) % 6], 1).reshape(-1)
    rows = np.concatenate([src, np.arange(6)])
    cols = np.concatenate([dst, np.arange(6)])
    vals = np.concatenate([-np.ones(12), np.full(6, 3.0)])
    amg = BmsspSolver(device="cpu").setup(rows, cols, vals, 6)
    x, _, _ = amg.solve(np.ones(6))
    assert x.device.type == "cpu"
    mat = CSRGraph.from_edges(rows, cols, vals, 6, device="cpu")
    assert cg_solve(mat, np.ones(6)).x.device.type == "cpu"
    assert forward_push_ppr(mat, 0).device.type == "cpu"
    assert TrueSolver(jl_dimension=6).solve(mat, np.ones(6)).device.type == "cpu"


@pytest.mark.parametrize("name", sorted(_CPU_INITS))
def test_family_inits_run_on_the_cpu_when_asked(name):
    """The GNN and attention families' init entry points with
    device="cpu": every parameter on the CPU."""
    from ruvector_tpu_torch.training.optimizers import tree_leaves

    leaves = tree_leaves(_CPU_INITS[name]())
    assert leaves and all(t.device.type == "cpu" for t in leaves)


def test_transformer_entry_points_run_on_the_cpu_when_asked():
    """The tiered model, the decoder and the generation factories with
    device="cpu": every output on the CPU, and speculative decoding equal
    to greedy."""
    weights = init_weights(torch.Generator().manual_seed(0), _TINY, device="cpu")
    out = MincutGatedTransformer(_TINY, GatePolicy(), weights, device="cpu").infer(
        tokens=np.arange(5), gate=GatePacket())
    assert out.logits.shape == (32,) and out.witness.layers_run == 2
    dec = Decoder(_TINY, GatePolicy(), weights, cache_cfg=_TINY_CACHE, device="cpu")
    greedy = dec.generate(np.asarray([1, 2]), max_new_tokens=3).tokens
    assert dec.generate_speculative(np.asarray([1, 2]), max_new_tokens=3, gamma=2).tokens == \
        greedy
    step = make_decode_step(_TINY, _TINY_CACHE, device="cpu")
    logits, caches = step(weights, dec.init_caches(), 1, 0, True)
    assert logits.device.type == "cpu" and caches[0].hot_k.device.type == "cpu"
    toks, _ = make_generate_fn(_TINY, _TINY_CACHE, 2, 3, device="cpu")(
        weights, dec.init_caches(), np.asarray([1, 2]))
    assert toks.tolist() == greedy[:5]
    toks_b, _ = make_batched_generate_fn(_TINY, _TINY_CACHE, 2, 3, device="cpu")(
        weights, dec.init_caches(batch=2), np.asarray([[1, 2], [1, 2]]))
    assert toks_b.tolist() == [greedy[:5]] * 2
    spec = make_speculative_generate_fn(_TINY, _TINY_CACHE, SpecDecodeConfig(2, 1), 3,
                                        device="cpu")
    _, c = make_generate_fn(_TINY, _TINY_CACHE, 2, 0, device="cpu")(
        weights, dec.init_caches(), np.asarray([1, 2]))
    assert spec(weights, c, greedy[2])[0].tolist() == greedy[2:5]


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


def test_spawned_ranks_import_no_jax():
    """A rank process of the launcher has neither jax nor the JAX package
    loaded (its function's module, tests/torch_parallel_ranks.py, imports
    the port only)."""
    mods = run_ranks(torch_parallel_ranks.modules_rank, 2, device="cpu", threads=1)
    assert mods == [[], []]
