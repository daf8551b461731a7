"""Models built from the port's layers: RuvectorNet and the GNN family
(GraphSAGE with fanout sampling, GCN, GAT, generic message passing)."""

from ruvector_tpu_torch.models.gat import GATConfig, gat_apply, gat_init
from ruvector_tpu_torch.models.gcn import GCNConfig, gcn_apply, gcn_init
from ruvector_tpu_torch.models.graphsage import (
    GraphSAGEConfig,
    GraphSAGENetConfig,
    graphsage_apply,
    graphsage_init,
    graphsage_net_apply,
    graphsage_net_init,
    sample_fanout,
)
from ruvector_tpu_torch.models.ruvector_net import (
    RuvectorNetConfig,
    ruvector_net_apply,
    ruvector_net_init,
)

__all__ = [
    "RuvectorNetConfig", "ruvector_net_init", "ruvector_net_apply",
    "GraphSAGEConfig", "GraphSAGENetConfig", "graphsage_net_init", "graphsage_net_apply",
    "graphsage_init", "graphsage_apply", "sample_fanout",
    "GCNConfig", "gcn_init", "gcn_apply",
    "GATConfig", "gat_init", "gat_apply",
]
