"""SONA export: safetensors-format LoRA state, dataset export.

Reference: sona/src/export/{safetensors,dataset,pretrain}.rs — LoRA adapters
serialized in the safetensors wire format (8-byte header length + JSON
header + raw tensor bytes), trajectory datasets exported as JSONL for
offline pretraining. (The huggingface_hub push is omitted: this environment
has no egress; the safetensors files are drop-in compatible.)

The writer below implements the safetensors format directly (stdlib-only,
little-endian, C-contiguous f32) — readable by the standard `safetensors`
library. The port's own copy of ruvector_tpu/sona/export.py: for the same
adapter state its files are byte-identical to the JAX package's.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

_DTYPES = {"float32": "F32", "float16": "F16", "int32": "I32", "int8": "I8"}
_INV_DTYPES = {v: k for k, v in _DTYPES.items()}


def save_safetensors(path: str | Path, tensors: dict[str, np.ndarray],
                     metadata: dict | None = None):
    """Write a .safetensors file (format: u64 header_len | JSON | data)."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        dt = _DTYPES.get(str(arr.dtype))
        if dt is None:
            arr = arr.astype(np.float32)
            dt = "F32"
        raw = arr.tobytes()
        header[name] = {
            "dtype": dt,
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        blobs.append(raw)
        offset += len(raw)
    hjson = json.dumps(header, sort_keys=True).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)


def load_safetensors(path: str | Path) -> tuple[dict[str, np.ndarray], dict]:
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        data = f.read()
    meta = header.pop("__metadata__", {})
    out = {}
    for name, info in header.items():
        lo, hi = info["data_offsets"]
        arr = np.frombuffer(data[lo:hi],
                            dtype=_INV_DTYPES[info["dtype"]])
        out[name] = arr.reshape(info["shape"]).copy()
    return out, meta


def export_lora(engine, path: str | Path):
    """Export the engine's Micro + Base LoRA adapters as safetensors
    (sona/src/export/safetensors.rs parity)."""
    micro = engine.coordinator.instant.micro_lora
    base = engine.coordinator.background.base_lora
    tensors = {
        "micro_lora.down": micro.down,
        "micro_lora.up": micro.up,
    }
    for i in range(base.num_layers):
        tensors[f"base_lora.layers.{i}.down"] = base.down[i]
        tensors[f"base_lora.layers.{i}.up"] = base.up[i]
    save_safetensors(path, tensors, metadata={
        "format": "sona-lora", "micro_rank": micro.rank,
        "base_rank": base.rank, "hidden_dim": micro.hidden_dim,
        "num_layers": base.num_layers,
    })


def import_lora(engine, path: str | Path):
    tensors, meta = load_safetensors(path)
    micro = engine.coordinator.instant.micro_lora
    base = engine.coordinator.background.base_lora
    micro.down = tensors["micro_lora.down"].copy()
    micro.up = tensors["micro_lora.up"].copy()
    for i in range(base.num_layers):
        base.down[i] = tensors[f"base_lora.layers.{i}.down"].copy()
        base.up[i] = tensors[f"base_lora.layers.{i}.up"].copy()


def export_trajectory_dataset(trajectories, path: str | Path):
    """JSONL dataset export (sona/src/export/dataset.rs)."""
    with open(path, "w") as f:
        for t in trajectories:
            f.write(json.dumps({
                "id": t.id,
                "query_embedding": np.asarray(t.query_embedding).tolist(),
                "quality": t.final_quality,
                "steps": [
                    {"activations": np.asarray(s.activations).tolist(),
                     "reward": s.reward, "name": s.name}
                    for s in t.steps
                ],
                "model_route": t.model_route,
                "latency_us": t.latency_us,
            }) + "\n")
