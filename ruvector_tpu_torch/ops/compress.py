"""Access-frequency-tiered embedding compression (port of
ruvector_tpu/ops/compress.py; reference ruvector-gnn src/compress.rs).

A compression level follows the access frequency (hot > 0.8 keeps f32,
warm half precision, cool PQ8, cold int4 with exact outliers, archive
<= 0.01 binary; compress.rs:15-33). Half precision is bfloat16, as in the
JAX package; PQ and binary come from ops.quantization. The policy is host
logic; every payload stays on the data's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ruvector_tpu_torch.attention.sheaf import quantile
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.ops.quantization import (
    BinaryQuantized,
    PQCodebook,
    binary_quantize,
    int4_dequantize,
    int4_quantize,
    pq_decode,
    pq_encode,
    pq_train,
    u64_from_words,
)


def level_for_access_frequency(freq: float) -> str:
    """Tier policy (compress.rs:15-33): hot > 0.8 none, > 0.5 half, > 0.1
    pq8, > 0.01 pq4, else binary."""
    if freq > 0.8:
        return "none"
    if freq > 0.5:
        return "half"
    if freq > 0.1:
        return "pq8"
    if freq > 0.01:
        return "pq4"
    return "binary"


@dataclasses.dataclass
class CompressedTensor:
    level: str
    payload: Any
    dim: int

    @property
    def bytes_per_vector(self) -> float:
        if self.level == "none":
            return self.dim * 4
        if self.level == "half":
            return self.dim * 2
        if self.level == "pq8":
            cb: PQCodebook = self.payload["codebook"]
            return cb.subvectors
        if self.level == "pq4":
            return self.payload["int4"].packed.shape[1]
        if self.level == "binary":
            return self.payload.bits.shape[1] * 4
        raise ValueError(self.level)


class TensorCompress:
    """Compress and decompress batches of embeddings by tier, on `device`
    (a tensor's own device where the data is a tensor)."""

    def __init__(self, pq_subvectors: int = 8, pq_centroids: int = 256, device=None):
        self.pq_subvectors = pq_subvectors
        self.pq_centroids = pq_centroids
        self.device = device

    def compress(self, data, access_frequency: float) -> CompressedTensor:
        if isinstance(data, torch.Tensor):
            x = data.float()
        else:
            x = torch.from_numpy(np.asarray(data, np.float32)).to(resolve_device(self.device))
        return self.compress_level(x, level_for_access_frequency(access_frequency))

    def compress_level(self, x: torch.Tensor, level: str) -> CompressedTensor:
        n, d = x.shape
        if level == "none":
            return CompressedTensor("none", x, d)
        if level == "half":
            return CompressedTensor("half", x.to(torch.bfloat16), d)
        if level == "pq8":
            cb = pq_train(x, self.pq_subvectors, min(self.pq_centroids, n), device=x.device)
            return CompressedTensor("pq8", {"codebook": cb, "codes": pq_encode(cb, x)}, d)
        if level == "pq4":
            # 4-bit scalar plus the 1% largest errors kept exact (row-major
            # (row, col) pairs and values, as np.argwhere gives them)
            q = int4_quantize(x)
            err = torch.abs(x - int4_dequantize(q))
            outlier = err > quantile(err, 0.99)
            return CompressedTensor("pq4", {"int4": q, "outlier_idx": torch.nonzero(outlier),
                                            "outlier_val": x[outlier]}, d)
        if level == "binary":
            return CompressedTensor("binary", binary_quantize(x), d)
        raise ValueError(f"unknown level {level}")

    def decompress(self, t: CompressedTensor) -> torch.Tensor:
        if t.level == "none":
            return t.payload
        if t.level == "half":
            return t.payload.float()
        if t.level == "pq8":
            return pq_decode(t.payload["codebook"], t.payload["codes"])
        if t.level == "pq4":
            dec = int4_dequantize(t.payload["int4"])
            idx = t.payload["outlier_idx"]
            if len(idx):
                dec[idx[:, 0], idx[:, 1]] = t.payload["outlier_val"]
            return dec
        if t.level == "binary":
            b: BinaryQuantized = t.payload
            # sign reconstruction at unit scale
            shifts = torch.arange(32, dtype=torch.int64, device=b.bits.device)
            bits = (u64_from_words(b.bits)[:, :, None] >> shifts) & 1
            return bits.reshape(b.bits.shape[0], -1)[:, :b.dim].float() * 2.0 - 1.0
        raise ValueError(t.level)
