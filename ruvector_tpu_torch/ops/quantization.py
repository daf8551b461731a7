"""Vector quantization: scalar int8, int4, product quantization (PQ) and
binary codes (port of ruvector_tpu/ops/quantization.py; reference
ruvector-core src/quantization.rs: ScalarQuantized :36, PQ train/encode
:104-190, Int4Quantized :196-285, BinaryQuantized with Hamming :289-400).

Everything is batched over rows on the tensor's device, and every
distance is asymmetric (float queries against codes). At full width the
JAX forms would materialise intermediates that do not fit the card (PQ
encoding's [N, S, K, d_sub], the ADC one-hot [N, S, K], Hamming's
[Na, Nb, W]); the port computes the same functions over row chunks of at
most _CHUNK_BYTES each, with the same integers and the same float sums.

uint32 words (binary codes) are held as int32 tensors with the same bits:
torch's uint32 lacks shifts and sums on several backends, so the bit
arithmetic runs in int64 lanes masked to 32 bits. `uint32_words` gives the
numpy uint32 view.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ruvector_tpu_torch.convert import to_numpy
from ruvector_tpu_torch.device import resolve_device

_CHUNK_BYTES = 1 << 30      # largest intermediate of a chunked computation
_MASK32 = 0xFFFFFFFF


def _row_chunks(n: int, bytes_per_row: int):
    """Slices of [0, n) whose intermediates stay under _CHUNK_BYTES."""
    step = max(1, _CHUNK_BYTES // max(bytes_per_row, 1))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b correctly rounded on every device, as numpy and XLA divide. A
    Python-number divisor makes CUDA multiply by its reciprocal, which is
    one bit off at times (and a code then rounds the other way); a 0-dim
    tensor on a's device does not."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def words_from_u64(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def u64_from_words(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 lanes holding their uint32 values."""
    return words.to(torch.int64) & _MASK32


def uint32_words(words: torch.Tensor) -> np.ndarray:
    """The numpy uint32 view of int32 words (JAX's stored dtype)."""
    return words.detach().cpu().numpy().view(np.uint32)


# --- scalar int8 (4x compression) -------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScalarQuantized:
    codes: torch.Tensor      # [N, D] int8
    scale: torch.Tensor      # [N] f32
    offset: torch.Tensor     # [N] f32


def scalar_quantize(x: torch.Tensor) -> ScalarQuantized:
    """Per-vector affine int8: c = round((x - min) / scale) - 128, in JAX's
    order of operations (subtract, divide, round half to even, clip) and
    with correctly rounded divisions, so the codes are bit-equal."""
    lo = torch.amin(x, dim=-1, keepdim=True)
    hi = torch.amax(x, dim=-1, keepdim=True)
    scale = true_div(torch.clamp(hi - lo, min=1e-12), 255.0)
    codes = torch.clamp(torch.round((x - lo) / scale) - 128, -128, 127).to(torch.int8)
    return ScalarQuantized(codes, scale[..., 0], lo[..., 0])


def scalar_dequantize(q: ScalarQuantized) -> torch.Tensor:
    return (q.codes.float() + 128.0) * q.scale[..., None] + q.offset[..., None]


def scalar_distance(query: torch.Tensor, q: ScalarQuantized) -> torch.Tensor:
    """Asymmetric squared L2: f32 queries [B, D] against the int8 rows,
    [B, N]. ||q - (c s + o)||^2 expands into one product with the codes
    and per-row scalars; computed over chunks of database rows."""
    b, d = query.shape
    n = q.codes.shape[0]
    q_sq = torch.sum(query * query, dim=-1, keepdim=True)
    q_sum = torch.sum(query, dim=-1, keepdim=True)
    out = torch.empty((b, n), dtype=torch.float32, device=query.device)
    for rows in _row_chunks(n, 4 * (b + d)):
        c = q.codes[rows].float() + 128.0
        dots = query @ c.T
        c_sq = torch.sum(c * c, dim=-1)[None, :]
        c_sum = torch.sum(c, dim=-1)[None, :]
        s, o = q.scale[rows][None, :], q.offset[rows][None, :]
        cross = s * dots + o * q_sum
        dec_sq = s * s * c_sq + 2 * s * o * c_sum + d * o * o
        out[:, rows] = torch.clamp(q_sq - 2 * cross + dec_sq, min=0.0)
    return out


# --- int4 (8x) ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Int4Quantized:
    packed: torch.Tensor     # [N, ceil(D/2)] uint8, two nibbles a byte
    scale: torch.Tensor      # [N]
    offset: torch.Tensor     # [N]
    dim: int


def int4_quantize(x: torch.Tensor) -> Int4Quantized:
    n, d = x.shape
    lo = torch.amin(x, dim=-1, keepdim=True)
    hi = torch.amax(x, dim=-1, keepdim=True)
    scale = true_div(torch.clamp(hi - lo, min=1e-12), 15.0)
    codes = torch.clamp(torch.round((x - lo) / scale), 0, 15).to(torch.uint8)
    if d % 2:
        codes = F.pad(codes, (0, 1))
    packed = codes[:, 0::2] | (codes[:, 1::2] << 4)
    return Int4Quantized(packed, scale[..., 0], lo[..., 0], d)


def int4_dequantize(q: Int4Quantized) -> torch.Tensor:
    lo_nib = (q.packed & 0x0F).float()
    hi_nib = ((q.packed >> 4) & 0x0F).float()
    codes = torch.stack([lo_nib, hi_nib], dim=-1).reshape(q.packed.shape[0], -1)[:, :q.dim]
    return codes * q.scale[:, None] + q.offset[:, None]


# --- product quantization -----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PQCodebook:
    codebooks: torch.Tensor  # [S, K, d_sub]
    dim: int

    @property
    def subvectors(self) -> int:
        return self.codebooks.shape[0]

    @property
    def sub_dim(self) -> int:
        return self.codebooks.shape[2]


def squared_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_j (a_j - b_j)^2 over the last axis of two broadcastable tensors,
    summed in numpy's pairwise order (8 running sums for 8 <= n <= 128,
    halves above, a plain loop below 8). Every step is one rounded IEEE
    operation, so the result is numpy's `((a - b) ** 2).sum(-1)` bit for
    bit, on any device."""
    terms = [(a[..., j] - b[..., j]) ** 2 for j in range(a.shape[-1])]

    def pairwise(t):
        n = len(t)
        if n < 8:
            res = t[0]              # numpy adds to 0.0; the squares are never -0.0
            for x in t[1:]:
                res = res + x
            return res
        if n <= 128:
            r = list(t[:8])
            i = 8
            while i < n - n % 8:
                r = [r[j] + t[i + j] for j in range(8)]
                i += 8
            res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
            for x in t[i:]:
                res = res + x
            return res
        n2 = n // 2
        n2 -= n2 % 8
        return pairwise(t[:n2]) + pairwise(t[n2:])

    return pairwise(terms)


def pq_train(data, subvectors: int = 8, centroids: int = 256, iters: int = 10,
             seed: int = 0, device=None) -> PQCodebook:
    """Per-subspace k-means codebooks (quantization.rs:113-160): the JAX
    package's host k-means on numpy's default_rng(seed), step for step. The
    nearest-centroid assignment, the costly step, runs on `device` through
    squared_distances (numpy's summation order, so the same assignments);
    the initial draw and the centroid means stay numpy, so the codebooks
    are the JAX package's bit for bit."""
    dev = resolve_device(device)
    x = to_numpy(data).astype(np.float32, copy=False)
    n, d = x.shape
    if d % subvectors:
        raise ValueError("dim must divide into subvectors")
    ds = d // subvectors
    k = min(centroids, n)
    rng = np.random.default_rng(seed)
    books = np.zeros((subvectors, k, ds), np.float32)
    for s in range(subvectors):
        sub = x[:, s * ds:(s + 1) * ds]
        sub_t = torch.from_numpy(np.ascontiguousarray(sub)).to(dev)
        cent = sub[rng.choice(n, size=k, replace=False)].copy()
        for _ in range(iters):
            cent_t = torch.from_numpy(cent).to(dev)
            assign = torch.cat([
                torch.argmin(squared_distances(sub_t[rows, None, :], cent_t[None]), dim=1)
                for rows in _row_chunks(n, 4 * k * (ds + 3))]).cpu().numpy()
            # centroid c = the mean of its points in index order: a stable
            # sort groups them as `sub[assign == c]` would, in one pass
            order = np.argsort(assign, kind="stable")
            grouped = sub[order]
            bounds = np.searchsorted(assign[order], np.arange(k + 1))
            for c in range(k):
                if bounds[c + 1] > bounds[c]:
                    cent[c] = grouped[bounds[c]:bounds[c + 1]].mean(0)
        books[s] = cent
    return PQCodebook(torch.from_numpy(books).to(dev), d)


def pq_encode(cb: PQCodebook, x: torch.Tensor) -> torch.Tensor:
    """[N, D] -> [N, S] uint8 codes, the nearest centroid per subspace
    (the first on a tie, as argmin), over row chunks."""
    n, _ = x.shape
    s, k, ds = cb.codebooks.shape
    sub = x.reshape(n, s, ds)
    return torch.cat([
        torch.argmin(squared_distances(sub[rows, :, None, :], cb.codebooks[None]), dim=-1)
        for rows in _row_chunks(n, 4 * s * k * (ds + 3))]).to(torch.uint8)


def pq_decode(cb: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    s = cb.subvectors
    sub_idx = torch.arange(s, device=codes.device)[None, :]
    return cb.codebooks[sub_idx, codes.long()].reshape(codes.shape[0], cb.dim)


def pq_distance(cb: PQCodebook, query: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Asymmetric PQ distance (ADC), [B, N]: per-subspace query-to-centroid
    tables, summed over each row's codes. JAX contracts the tables with
    one-hot codes; a product with 0 or 1 is exact, so gathering the S
    table entries of a row sums the same terms, without the [N, S, K]
    one-hot."""
    b = query.shape[0]
    s, k, ds = cb.codebooks.shape
    tables = squared_distances(query.reshape(b, s, ds)[:, :, None, :], cb.codebooks[None])
    flat = tables.reshape(b, s * k)
    offsets = torch.arange(s, device=codes.device) * k
    n = codes.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=query.device)
    for rows in _row_chunks(n, 4 * b * s):
        idx = (codes[rows].long() + offsets).reshape(-1)
        out[:, rows] = flat.index_select(1, idx).reshape(b, -1, s).sum(-1)
    return out


# --- binary (32x) -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BinaryQuantized:
    bits: torch.Tensor       # [N, ceil(D/32)] int32 holding uint32 words
    dim: int


def binary_quantize(x: torch.Tensor, threshold: float = 0.0) -> BinaryQuantized:
    """Sign bits (x > threshold), bit j of word w = coordinate 32 w + j."""
    n, d = x.shape
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    packed = []
    for rows in _row_chunks(n, 16 * (d + 32)):
        b = (x[rows] > threshold).to(torch.int64)
        b = F.pad(b, (0, (-d) % 32))
        packed.append(words_from_u64((b.reshape(b.shape[0], -1, 32) << shifts).sum(-1)))
    return BinaryQuantized(torch.cat(packed), d)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of uint32 values held in int64 lanes (JAX's bit tricks on
    uint32, with the product's wrap made explicit)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _MASK32) >> 24


def hamming_distance(a: BinaryQuantized, b: BinaryQuantized) -> torch.Tensor:
    """[Na, W] x [Nb, W] words -> [Na, Nb] int32 popcount(xor) distances,
    over chunks of b's rows."""
    wa, wb = u64_from_words(a.bits), b.bits
    na, w = wa.shape
    nb = wb.shape[0]
    out = torch.empty((na, nb), dtype=torch.int32, device=wa.device)
    for rows in _row_chunks(nb, 8 * na * w * 2):
        x = wa[:, None, :] ^ u64_from_words(wb[rows])[None, :, :]
        out[:, rows] = popcount32(x).sum(-1).to(torch.int32)
    return out


def binary_similarity(a: BinaryQuantized, b: BinaryQuantized) -> torch.Tensor:
    """1 - hamming / dim (quantization.rs:378-383)."""
    return 1.0 - true_div(hamming_distance(a, b).float(), a.dim)
