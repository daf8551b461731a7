"""Witness logging: deterministic audit hashes of tensors (the port's own
copy of ruvector_tpu/utils/witness.py; numpy and hashlib only).

A witness is the SHA-256 of the tensors' shapes, dtypes and raw bytes; the
log chains each record's payload onto the previous chain hash, so the same
inputs give the same chain head, and any edit of a record breaks
`verify()`. Callers hand numpy arrays (a torch tensor: `.cpu().numpy()`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np


def tensor_witness(*arrays) -> str:
    """sha256 over the concatenated raw bytes of the given arrays."""
    h = hashlib.sha256()
    for a in arrays:
        arr = np.asarray(a)
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class WitnessRecord:
    step: int
    label: str
    tensor_hash: str
    prev_hash: str
    chain_hash: str
    meta: dict


def _chain_hash(label: str, tensor_hash: str, prev: str, meta: dict) -> str:
    payload = json.dumps(
        {"label": label, "hash": tensor_hash, "prev": prev,
         "meta": {k: str(v) for k, v in sorted(meta.items())}},
        sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()


class WitnessLog:
    """Append-only hash-chained witness log."""

    def __init__(self):
        self.records: list[WitnessRecord] = []
        self._chain = "genesis"

    def record(self, label: str, *arrays, **meta) -> WitnessRecord:
        th = tensor_witness(*arrays)
        chain = _chain_hash(label, th, self._chain, meta)
        rec = WitnessRecord(step=len(self.records), label=label, tensor_hash=th,
                            prev_hash=self._chain, chain_hash=chain, meta=meta)
        self._chain = chain
        self.records.append(rec)
        return rec

    @property
    def head(self) -> str:
        return self._chain

    def verify(self) -> bool:
        """Re-derive the chain; True iff untampered."""
        chain = "genesis"
        for rec in self.records:
            if rec.prev_hash != chain:
                return False
            chain = _chain_hash(rec.label, rec.tensor_hash, chain, rec.meta)
            if rec.chain_hash != chain:
                return False
        return True
