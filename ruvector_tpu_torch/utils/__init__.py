"""Host-side utilities of the port: checkpoints (`checkpoint`), metrics
(`metrics`), threshold and health monitoring (`monitoring`), the profiler
(`profiler`), the mmap embedding store (`mmap_store`), out-of-core
training (`cold_tier`) and the witness log (`witness`)."""

from ruvector_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from ruvector_tpu_torch.utils.metrics import Counter, Histogram, MetricsRegistry
from ruvector_tpu_torch.utils.profiler import Profiler, profile_region
from ruvector_tpu_torch.utils.witness import WitnessLog, WitnessRecord, tensor_witness

__all__ = ["Counter", "Histogram", "MetricsRegistry", "Profiler", "WitnessLog", "WitnessRecord",
           "profile_region", "restore_checkpoint", "save_checkpoint", "tensor_witness"]
