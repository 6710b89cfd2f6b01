"""Sparse genotype-code transport: gap-coded uint16 entries + device decode.

The device analog of the reference's sparse genotype store (index lists
per variant, ``saige_store_sp_geno`` src/saige_fitnull.cpp:236-427) and of
its sparse score-test path (maf<0.05 variants touch only their nonzero
samples, src/saige_main.cpp:299-350), re-cast as a *transport* format that
cuts the host->device bytes of rare-variant blocks:

- every nonzero code (1, 2, or 3=missing) is ONE uint16 entry
  ``(gap << 2) | code`` where ``gap`` = distance-1 to the previous nonzero
  in the row (14 bits);
- a gap larger than 16383 is bridged by escape entries with ``code == 0``
  (they advance the cursor without writing — position collisions are
  impossible because positions are strictly increasing within a row);
- rows are concatenated into a flat stream with a ``row_ptr`` offset table
  (CSR-style, like the reference's ``[n1,n2,n3, idx...]`` records).

For a variant with nonzero fraction f the stream costs ``2*f`` bytes per
sample vs 0.25 for the 2-bit planar block — sparse wins below f = 1/8,
i.e. MAF below ~6%, mirroring the reference's 5% sparse/dense split.

``decode_codes`` reconstructs the exact int8 code block on device
(cumsum over gaps -> sorted unique 1D scatter), so every downstream
kernel (``ops/score_packed``, ``ops/score.spa_refine_binary``) sees
bit-identical inputs — this path is exact, not an accuracy tier.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

GAP_BITS = 14
MAX_GAP = (1 << GAP_BITS) - 1          # stored gap field (distance - 1)
ESC_STEP = MAX_GAP + 1                 # cursor advance of an escape entry

# sparse transport wins when 2 bytes/entry < 0.25 bytes/sample * N / nnz
SPARSE_NNZ_FRAC = 1.0 / 8.0


def encode_sparse_rows(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Encode an int8 code block [B, N] (0/1/2, 3=missing) into the flat
    uint16 entry stream + int32 row_ptr [B+1].

    The hot path is the SIMD C kernel (native/fastio.cpp
    sg_sparse_encode — zero runs skip 16 bytes per compare); the numpy
    body below is the fallback and the semantics reference (one nonzero
    pass; escape entries inserted by a repeat/cumsum expansion).
    """
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    B, N = codes.shape
    if B * N >= 1 << 31:
        # the device decoder cumsums cursor advances in int32; the total
        # advance is bounded by B * N (escapes never overshoot a row)
        raise ValueError(f"block {B}x{N} exceeds the int32 decode bound; "
                         "reduce the block size")
    from ..io import native
    enc = native.sparse_encode(codes)
    if enc is not None:
        return enc
    return _encode_sparse_rows_np(codes)


def _encode_sparse_rows_np(codes: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy encoder (fallback + semantics reference for tests)."""
    B, N = codes.shape
    rows, cols = np.nonzero(codes)
    vals = codes[rows, cols].astype(np.uint16)
    counts = np.bincount(rows, minlength=B).astype(np.int64)
    starts = np.zeros(B + 1, np.int64)
    np.cumsum(counts, out=starts[1:])

    L0 = len(cols)
    if L0 == 0:
        return np.zeros(0, np.uint16), np.zeros(B + 1, np.int32)
    prev = np.empty(L0, np.int64)
    prev[1:] = cols[:-1]
    prev[starts[:-1][counts > 0]] = -1
    dist = cols - prev                              # >= 1
    n_esc = (dist - 1) // ESC_STEP                  # escapes per real entry
    out_len = L0 + int(n_esc.sum())

    # expansion offsets: entry k lands at k + cumsum(n_esc before k) + n_esc[k]
    esc_before = np.zeros(L0, np.int64)
    np.cumsum(n_esc[:-1], out=esc_before[1:])
    pos_real = np.arange(L0) + esc_before + n_esc

    entries = np.full(out_len, (MAX_GAP << 2), np.uint16)  # escape template
    rem = (dist - 1) - n_esc * ESC_STEP                    # 0..MAX_GAP
    entries[pos_real] = (rem.astype(np.uint16) << 2) | vals

    row_ptr = np.zeros(B + 1, np.int64)
    # row r ends after its last real entry: starts[r+1]-1 -> pos_real + 1
    ends = np.zeros(B, np.int64)
    nz_rows = counts > 0
    ends[nz_rows] = pos_real[starts[1:][nz_rows] - 1] + 1
    # empty rows end where the previous row ends
    ends = np.maximum.accumulate(ends)
    row_ptr[1:] = ends
    return entries, row_ptr.astype(np.int32)


def pad_entries(entries: np.ndarray, bucket_min: int = 1 << 12
                ) -> np.ndarray:
    """Pad the entry stream to a quarter-pow2 bucket (1.0/1.25/1.5/1.75 x
    2^k), bounding both padding waste (<= 25%) and the number of distinct
    compiled decode shapes.  Padding entries are zeros; they fall beyond
    ``row_ptr[-1]`` and are dropped by the decoder."""
    cap = _quarter_bucket(len(entries), bucket_min)
    if cap == len(entries):
        return entries
    out = np.zeros(cap, np.uint16)
    out[: len(entries)] = entries
    return out


def _quarter_bucket(n: int, minimum: int) -> int:
    """Smallest value >= n from {1, 1.25, 1.5, 1.75} x 2^k (k chosen so
    2^k >= minimum): bounds padding waste to <= 25% with exactly four
    compiled shapes per octave."""
    n = max(n, 1)
    p = minimum
    while 2 * p < n:
        p *= 2
    for frac in (4, 5, 6, 7, 8):
        cap = p * frac // 4
        if cap >= n:
            return cap
    return 2 * p        # unreachable (frac == 8 is 2 * p)


@partial(jax.jit, static_argnames=("n_rows", "n_samples"))
def decode_codes(entries: jnp.ndarray, row_ptr: jnp.ndarray,
                 n_rows: int, n_samples: int) -> jnp.ndarray:
    """Device-side decode of the entry stream into int8 codes
    [n_rows, n_samples] (exact inverse of ``encode_sparse_rows``).

    Positions come from a cumsum over gap+1 steps re-based per row; the
    write is a sorted-unique 1D scatter (positions are strictly increasing
    in row-major order).  Escape and padding entries write nothing
    (code 0 / dropped out-of-range rows).
    """
    L = entries.shape[0]
    if L == 0:                         # an unpadded all-zero block
        return jnp.zeros((n_rows, n_samples), jnp.int8)
    e = entries.astype(jnp.int32)
    gap = e >> 2
    code = (e & 3).astype(jnp.int8)
    step = gap + 1
    csum = jnp.cumsum(step)            # int32: total advance <= B*N < 2^31
    starts = row_ptr[:-1]
    base = jnp.where(starts > 0, csum[jnp.maximum(starts - 1, 0)], 0)
    k = jnp.arange(L, dtype=row_ptr.dtype)
    row_of = jnp.searchsorted(row_ptr[1:], k, side="right")
    pos = csum - base[jnp.minimum(row_of, n_rows - 1)] - 1
    # int64 indices: pad entries all drop, but must keep DISTINCT
    # indices to honor the unique_indices promise (duplicate dropped
    # indices would be UB), and n_rows*n_samples + k can top int32
    flat = row_of.astype(jnp.int64) * n_samples + pos
    flat = jnp.where(row_of < n_rows, flat,
                     jnp.int64(n_rows) * n_samples + k)
    dense = jnp.zeros((n_rows * n_samples,), jnp.int8)
    dense = dense.at[flat].set(code, mode="drop",
                               indices_are_sorted=True, unique_indices=True)
    return dense.reshape(n_rows, n_samples)


def bucket_rows(n: int, cap: int, minimum: int = 64) -> int:
    """Quarter-pow2 row-count bucket in [minimum, cap] — bounds both the
    variant-axis padding waste (<= 25%) and the number of distinct
    compiled kernel shapes when blocks are split sparse/dense."""
    if n >= cap:
        return cap
    return min(_quarter_bucket(n, minimum), cap)


def sparse_row_mask(codes: np.ndarray) -> np.ndarray:
    """Rows whose sparse transport beats the 2-bit planar block: nonzero
    fraction below 1/8 (escapes are asymptotically negligible there)."""
    N = codes.shape[1]
    nnz = (codes != 0).sum(axis=1)
    return nnz < (N * SPARSE_NNZ_FRAC)


def sparse_beats_dense(codes: np.ndarray) -> bool:
    """Whole-batch decision: is the entry stream smaller than the 2-bit
    planar block for this batch of rows?"""
    B, N = codes.shape
    nnz = int((codes != 0).sum())
    return 2 * nnz < B * (N // 4)
