"""Min-cut toolkit: dynamic maintenance, sparsification, local cuts (port
of ruvector_tpu/mincut/).

The JAX package's equivalent of ruvector-mincut (51k LoC; module map lib.rs:1-57
— linkcut/euler/expander/sparsify/jtree/localkcut/monitoring). The
reference maintains subpolynomial-update dynamic min-cut via link-cut and
Euler-tour trees; at the graph sizes the attention gate and partitioner
actually consume (10^2-10^5 nodes per query/shard) the pragmatic
design is (host maintainers; the CSR and CG parts on the graph's device):

- dynamic:   recompute-on-dirty exact min-cut (native Dinic) with
             threshold monitoring callbacks — the reference's monitoring/
             semantics on an exact core
- sparsify:  spectral sparsification by effective-resistance sampling,
             with resistances from CG Laplacian solves (solver/iterative)
             — cuts preserved within (1±eps)
- local:     Andersen-Chung-Lang local clustering — PPR push + sweep cut
             (solver/push) — the localkcut/ role: low-conductance cut
             around a seed without touching the whole graph
"""

from ruvector_tpu_torch.mincut.dynamic import DynamicMinCut, GlobalMinCutFacade
from ruvector_tpu_torch.mincut.global_dynamic import (
    GlobalDynamicMinCut,
    stoer_wagner,
)
from ruvector_tpu_torch.mincut.sparsify import spectral_sparsify, cut_value
from ruvector_tpu_torch.mincut.local import (
    LocalCut,
    conductance,
    local_cluster,
    local_k_cut,
)
from ruvector_tpu_torch.mincut.expander import expander_decompose
from ruvector_tpu_torch.mincut.jtree import JTree

__all__ = [
    "DynamicMinCut",
    "GlobalDynamicMinCut",
    "GlobalMinCutFacade",
    "stoer_wagner",
    "spectral_sparsify",
    "cut_value",
    "local_cluster",
    "local_k_cut",
    "LocalCut",
    "conductance",
    "expander_decompose",
    "JTree",
]
