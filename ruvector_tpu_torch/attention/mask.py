"""Sparse attention mask builder: composable band, block, strided and
global patterns (port of ruvector_tpu/attention/mask.py).

Masks are dense boolean [S, S] tensors composed with |=; `to_coo` exports
the allowed positions as the reference's COO edge list.
"""

from __future__ import annotations

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device


class SparseMaskBuilder:
    """Compose attention patterns into one [S, S] boolean mask on `device`."""

    def __init__(self, seq_len: int, device=None):
        self.seq_len = seq_len
        self.device = resolve_device(device)
        self.mask = torch.zeros((seq_len, seq_len), dtype=torch.bool, device=self.device)

    def _arange(self) -> torch.Tensor:
        return torch.arange(self.seq_len, device=self.device)

    def add_local_window(self, window: int, dilation: int = 1):
        """Band of width `window` around the diagonal (Longformer local)."""
        i = self._arange()
        delta = i[:, None] - i[None, :]
        band = torch.abs(delta) <= window * dilation
        if dilation > 1:
            band = band & (torch.remainder(delta, dilation) == 0)
        self.mask = self.mask | band
        return self

    def add_global_tokens(self, token_ids):
        """Rows and columns fully attended (Longformer global)."""
        ids = torch.as_tensor(token_ids, dtype=torch.long, device=self.device)
        sel = torch.zeros((self.seq_len,), dtype=torch.bool, device=self.device)
        sel[ids] = True
        self.mask = self.mask | sel[:, None] | sel[None, :]
        return self

    def add_block_diagonal(self, block_size: int):
        """Block-sparse: full attention inside fixed-size blocks."""
        blk = torch.div(self._arange(), block_size, rounding_mode="floor")
        self.mask = self.mask | (blk[:, None] == blk[None, :])
        return self

    def add_strided(self, stride: int):
        """Every stride-th column visible to every row (BigBird-style)."""
        cols = torch.remainder(self._arange(), stride) == 0
        self.mask = self.mask | cols[None, :]
        return self

    def add_causal(self):
        self.mask = self.mask & torch.tril(torch.ones(
            (self.seq_len, self.seq_len), dtype=torch.bool, device=self.device))
        return self

    def build(self) -> torch.Tensor:
        return self.mask

    def density(self) -> float:
        return float(torch.mean(self.mask.float()))

    def to_coo(self) -> tuple[np.ndarray, np.ndarray]:
        """(rows, cols) of the allowed positions, int32."""
        r, c = np.nonzero(self.mask.cpu().numpy())
        return r.astype(np.int32), c.astype(np.int32)
