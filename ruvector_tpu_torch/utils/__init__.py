"""Host-side utilities of the port: the witness log (`witness`)."""

from ruvector_tpu_torch.utils.witness import WitnessLog, WitnessRecord, tensor_witness

__all__ = ["WitnessLog", "WitnessRecord", "tensor_witness"]
