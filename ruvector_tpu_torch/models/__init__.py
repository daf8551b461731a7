"""Models built from the port's layers."""

from ruvector_tpu_torch.models.ruvector_net import (
    RuvectorNetConfig,
    ruvector_net_apply,
    ruvector_net_init,
)

__all__ = ["RuvectorNetConfig", "ruvector_net_init", "ruvector_net_apply"]
