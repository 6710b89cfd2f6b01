"""Packed int8 genotype GRM operator with exact integer-sliced matvec.

The reference keeps genotypes packed 2-bit (4/byte) and decodes through a
per-variant standardized lookup inside its TBB hot loop
(``get_crossprod_b_grm``, src/saige_fitnull.cpp:432-536).  The device
equivalent stores one small-integer code per genotype (0/1/2, 3 = missing) — 8x less
HBM traffic than a materialized float64 ``G_std`` — and reconstructs the
standardized values *algebraically* instead of by table lookup:

    s(c) = (c - 2*af) * inv        for c in {0,1,2};  s(missing) = 0
    =>  G_std @ v = diag(inv) @ (Cm @ v - 2*af * (mask @ v))

with ``Cm = c * (c<3)`` and ``mask = (c<3)``.

**Exact integer slicing on bf16 matmuls** (the headline trick): the left
operand is an exact small integer (0/1/2, exactly representable in bf16),
and a float64 right-hand side decomposes into S signed-7-bit integer
slices ``v ~= scale * sum_s d_s / (64 * 128^s)`` with ``|d_s| <= 64`` —
also bf16-exact.  Each ``Cm @ d_s`` then runs as a bf16 x bf16 -> f32
tensor-core matmul whose accumulation is *exact* as long as partial sums stay below
2^24: every product is an integer <= 128, so a sample-chunk of 65,536
keeps |sum| <= 2^23.  Chunk partials are integers, combined in f64 without
rounding, so S = 8 slices reproduce the full float64 matvec to ~2^-53
relative — at bf16 bandwidth (2 B/genotype, 4x less than f64) and bf16
tensor-core throughput.  All slices go through ONE batched matmul by
folding them into the RHS columns ([N, R*S]), so the genotype matrix is
read from device memory exactly once per product (Ozaki-scheme exact GEMM
via fixed-point splitting).

Precision modes:
* ``"exact_i8"`` (default) — integer-sliced bf16 path, f64 accuracy.
* ``"f64"``   — everything in float64 (XLA; bit-matches ``ops/grm.py``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

N_SLICES = 8   # 7 bits/slice -> ~56-bit effective mantissa (full f64)
N_SLICES_F32 = 5   # 35 bits > f32's 24-bit mantissa: captures an f32
#                    operand fully (the mixed-precision PCG's inner solves)


class PackedGRM(NamedTuple):
    """Packed genotype GRM state (int8 codes + per-variant moments).

    ``codes`` stores missing as 0 (so ``codes @ v`` skips them exactly);
    the missing positions live in the padded sparse pair lists
    ``miss_var``/``miss_samp`` (pad entries point at row/col 0 with
    ``miss_pad`` marking real entries).
    """

    codes: jnp.ndarray      # [M, N] bfloat16 holding exact 0/1/2, 0 at missing
    af: jnp.ndarray         # [M] float64 allele frequency (non-missing)
    inv: jnp.ndarray        # [M] float64 1/sqrt(2 af (1-af)) (0 if degenerate)
    diag: jnp.ndarray       # [N] float64 diag(GRM)
    miss_var: jnp.ndarray   # [nnz_pad] int32 variant index of missing entry
    miss_samp: jnp.ndarray  # [nnz_pad] int32 sample index of missing entry
    miss_pad: jnp.ndarray   # [nnz_pad] float64 1.0 real / 0.0 padding
    samp_mask: jnp.ndarray  # [N] float64 1.0 real sample / 0.0 padded sample
    n_variants: int
    n_samples: int

    def matvec(self, b, precision: str = "exact_i8"):
        return packed_grm_matvec(self.codes, self.af, self.inv,
                                 self.miss_var, self.miss_samp, self.miss_pad,
                                 self.samp_mask, b, precision=precision)


def build_packed_grm(codes: np.ndarray, pad_multiple: int = 256) -> PackedGRM:
    """Build the packed operator from int8 codes [M, N] (3 = missing)."""
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    M, N = codes.shape
    af, inv, diag_part, mv, ms = _variant_moments(codes)
    miss_var, miss_samp, miss_pad = _pad_miss(mv, ms, pad_multiple)
    return PackedGRM(codes=jnp.asarray(_zeroed_codes(codes),
                                       dtype=jnp.bfloat16),
                     af=jnp.asarray(af), inv=jnp.asarray(inv),
                     diag=jnp.asarray(diag_part / M),
                     miss_var=jnp.asarray(miss_var),
                     miss_samp=jnp.asarray(miss_samp),
                     miss_pad=jnp.asarray(miss_pad),
                     samp_mask=jnp.ones(N, dtype=jnp.float64),
                     n_variants=M, n_samples=N)


def build_packed_grm_streamed(block_iter, n_samples: int,
                              pad_multiple: int = 256,
                              device_put=None) -> PackedGRM:
    """Build the packed operator from streamed (idx, int8 codes) blocks.

    Host peak memory is one block: per-block moments accumulate in numpy,
    code blocks are converted to bf16 and placed on device immediately
    (``device_put`` defaults to jnp.asarray; pass a sharded putter for
    multi-chip fits).  Mirrors :func:`build_packed_grm` exactly.
    """
    put = device_put or (lambda x: jnp.asarray(x))
    dev_blocks = []
    af_parts, inv_parts = [], []
    diag = np.zeros(n_samples, np.float64)
    miss_v, miss_s = [], []
    row0 = 0
    for _idx, codes in block_iter:
        codes = np.ascontiguousarray(codes, dtype=np.int8)
        af, inv, diag_part, mv, ms = _variant_moments(codes)
        diag += diag_part
        miss_v.append(mv.astype(np.int64) + row0)
        miss_s.append(ms.astype(np.int64))
        af_parts.append(af)
        inv_parts.append(inv)
        # the hook receives HOST bf16 (a sharded putter must place it
        # without a default-device stop-over)
        dev_blocks.append(put(_zeroed_codes(codes).astype(jnp.bfloat16)))
        row0 += codes.shape[0]

    M = row0
    codes_dev = jnp.concatenate(dev_blocks, axis=0) if len(dev_blocks) > 1 \
        else dev_blocks[0]
    mv = np.concatenate(miss_v) if miss_v else np.empty(0, np.int64)
    ms = np.concatenate(miss_s) if miss_s else np.empty(0, np.int64)
    miss_var, miss_samp, miss_pad = _pad_miss(mv, ms, pad_multiple)
    return PackedGRM(codes=codes_dev,
                     af=jnp.asarray(np.concatenate(af_parts)),
                     inv=jnp.asarray(np.concatenate(inv_parts)),
                     diag=jnp.asarray(diag / M),
                     miss_var=jnp.asarray(miss_var),
                     miss_samp=jnp.asarray(miss_samp),
                     miss_pad=jnp.asarray(miss_pad),
                     samp_mask=jnp.ones(n_samples, dtype=jnp.float64),
                     n_variants=M, n_samples=n_samples)


def _slice_i8(x, n_slices: int):
    """Decompose f64 [N, R] into signed-7-bit slices.

    x[:, r] ~= scale[r] * sum_s d[:, r, s] / (64 * 128**s), |d| <= 64,
    residual <= scale * 2**(-7*n_slices).
    """
    amax = jnp.max(jnp.abs(x), axis=0)
    scale = jnp.where(amax > 0, amax, 1.0)
    rem = x / scale
    ds = []
    for _ in range(n_slices):
        d = jnp.round(rem * 64.0)
        ds.append(d.astype(jnp.int8))
        rem = (rem - d / 64.0) * 128.0
    return jnp.stack(ds, axis=-1), scale           # [N, R, S], [R]


EXACT_CHUNK = 65536  # contraction chunk: |partial| <= 128 * 65536 = 2^23 < 2^24


def _i8_exact_dot(A_bf16, x, n_slices: int, contract_left: bool):
    """Exact (f64-grade) A @ x via integer-sliced bf16 matmuls.

    A_bf16: bf16 [M, N] holding exact integers |A| <= 2.  x: f64 [N, R]
    (contract_left=False, contracts A's axis 1) or f64 [M, R]
    (contract_left=True, contracts A's axis 0 — the transpose product,
    no materialized transpose).  The contraction axis is chunked so every
    f32 partial sum is an exact integer < 2^24; chunk partials combine
    in f64 exactly.
    """
    d, scale = _slice_i8(x, n_slices)               # [K, R, S]
    K, R, S = d.shape
    dmat = d.reshape(K, R * S).astype(jnp.bfloat16)

    A = A_bf16.T if contract_left else A_bf16       # [out_rows, K] view
    out_rows = A.shape[0]
    n_chunks = -(-K // EXACT_CHUNK)
    if n_chunks <= 1:
        acc = jnp.dot(A, dmat, preferred_element_type=jnp.float32)
    else:
        # column-slice dots (no pad/transpose copies): each partial is an
        # exact integer in f32, combined exactly in f64
        acc = None
        for c in range(n_chunks):
            s0, s1 = c * EXACT_CHUNK, min((c + 1) * EXACT_CHUNK, K)
            part = jnp.dot(A[:, s0:s1], dmat[s0:s1],
                           preferred_element_type=jnp.float32)
            part = part.astype(jnp.float64)
            acc = part if acc is None else acc + part
    acc = acc.reshape(out_rows, R, S).astype(jnp.float64)
    w = scale[None, :, None] / 64.0 \
        * (1.0 / 128.0) ** jnp.arange(S, dtype=jnp.float64)[None, None, :]
    return jnp.sum(acc * w, axis=-1)                # [out_rows, R]


# ---------------------------------------------------------------------------
# 2-bit planar device residency (the reference's 4-genotypes/byte store,
# src/saige_fitnull.cpp:118-230, decoded in its hot loop :480-517 — here the
# packed bytes live in device memory and are decoded chunk-wise on device)
# ---------------------------------------------------------------------------


class Packed2GRM(NamedTuple):
    """GRM operator over 2-bit planar-packed genotypes resident on device.

    ``packed`` is a TUPLE of row-block leaves, each leaf itself a TUPLE
    of column tiles ``[rows_i, cols_j]`` (variant blocks x byte-column
    blocks, concatenated order).  Each tile byte's bit-pair ``p`` holds
    the (zeroed-missing) code of sample ``p * N4 + (byte column)`` —
    four contiguous "planes" of the padded sample axis share a byte, so
    on-device decode is four shift-and-mask slices in natural sample
    order (no interleaving reshape).  0.25 B/genotype: 8x less device
    memory than the bf16 code store, matching the reference's
    4-genotypes/byte footprint.  The matvec reuses the exact integer-slice
    bf16 algebra and is bit-identical to :func:`packed_grm_matvec` (all
    partial sums are exact integers).

    Why tiles, not one [M, N] array: dim-1 slices of a monolithic store
    made XLA hoist a full transposed copy (2 x 6.56 GB at N=430K,
    M=64Ki), and arrays above 2^31 elements broke an earlier compiler.
    The rule is kept pending a check on the GPU (see _leaf_rows): row
    leaves are capped at ~16Ki rows and column tiles at _TILE_COLS
    bytes, so the matvec NEVER slices a device array (all tiling happens
    on host at build time) and each per-tile decode transient stays
    bounded.
    """

    packed: tuple           # tuple of leaves; leaf = tuple of u8 tiles
    af: jnp.ndarray         # [M] float64
    inv: jnp.ndarray        # [M] float64
    diag: jnp.ndarray       # [N] float64 diag(GRM)
    miss_var: jnp.ndarray   # [nnz_pad] int32
    miss_samp: jnp.ndarray  # [nnz_pad] int32
    miss_pad: jnp.ndarray   # [nnz_pad] float64
    samp_mask: jnp.ndarray  # [N] float64
    n_variants: int
    n_samples: int          # true N (the byte width pads to 4*N4 internally)

    def matvec(self, b, precision: str = "exact_i8"):
        if precision != "exact_i8":
            raise NotImplementedError(
                "Packed2GRM only implements the exact integer-sliced "
                "matvec; use PackedGRM/GRMOperator for the f64 debug path")
        return packed2_grm_matvec(self.packed, self.af, self.inv,
                                  self.miss_var, self.miss_samp,
                                  self.miss_pad, self.samp_mask, b)

    def matvec32(self, b32):
        """f32-grade GRM @ b for the mixed-precision PCG's inner solves
        (ops/pcg.pcg_solve_mixed): 5 integer slices instead of 8 and f32
        state arithmetic.  ~1e-7 relative accuracy; the outer refinement
        recombines residuals with the exact matvec, so solutions stay
        f64-grade."""
        return packed2_grm_matvec(self.packed, self.af, self.inv,
                                  self.miss_var, self.miss_samp,
                                  self.miss_pad, self.samp_mask, b32,
                                  prec="f32")


def pack_codes_2bit(codes: np.ndarray) -> np.ndarray:
    """Planar 2-bit pack: int8/uint8 [M, N] values 0..3 -> uint8 [M, N4].

    Byte column ``j`` holds samples ``j, N4+j, 2*N4+j, 3*N4+j`` in bit
    pairs 0/2/4/6 (N4 = ceil(N/4); the tail pads with 0), so the decode
    ``(packed >> 2p) & 3`` yields contiguous natural-order sample planes.
    """
    codes = np.asarray(codes)
    M, N = codes.shape
    N4 = -(-N // 4)
    c = np.zeros((M, 4 * N4), np.uint8)
    c[:, :N] = codes
    pl = c.reshape(M, 4, N4)
    return pl[:, 0] | (pl[:, 1] << 2) | (pl[:, 2] << 4) | (pl[:, 3] << 6)


def unpack_codes_2bit(packed: np.ndarray, n_samples: int) -> np.ndarray:
    """Inverse of :func:`pack_codes_2bit` (host-side, for tests/tools)."""
    M, N4 = packed.shape
    planes = np.stack([(packed >> (2 * p)) & 3 for p in range(4)], axis=1)
    return planes.reshape(M, 4 * N4)[:, :n_samples].astype(np.int8)


def _variant_moments(codes: np.ndarray):
    """Per-variant af / inv std / diag partials / missing pairs from int8
    codes [b, N] (>= 3 missing).

    Native threaded one-pass kernel when available (native/fastio.cpp
    ``sg_variant_moments``, the analog of the reference's standardized
    lookup + diag build, src/saige_fitnull.cpp:159-230); blockwise numpy
    otherwise.  A whole-matrix formulation would materialize f64 [M, N]
    standardized copies — 8 B/genotype of first-touch transient traffic
    that dominated biobank-scale GRM builds (minutes at N=100k, M=16k)."""
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    from ..io import native
    r = native.variant_moments(codes)
    if r is not None:
        return r
    M, N = codes.shape
    af = np.empty(M)
    inv = np.empty(M)
    diag = np.zeros(N)
    mvs, mss = [], []
    B = max(1, min(M, (1 << 28) // max(8 * N, 1)))   # ~256 MB f64 temps
    for i in range(0, M, B):
        c = codes[i:i + B]
        valid = c < 3
        n_valid = valid.sum(axis=1)
        s = np.where(valid, c, 0).sum(axis=1, dtype=np.int64)
        with np.errstate(divide="ignore", invalid="ignore"):
            a = s / (2.0 * n_valid)
            iv = 1.0 / np.sqrt(2.0 * a * (1.0 - a))
        bad = ~np.isfinite(a) | ~np.isfinite(iv)
        a = np.where(bad, 0.0, a)
        iv = np.where(bad, 0.0, iv)
        std = np.where(valid, (c - 2.0 * a[:, None]) * iv[:, None], 0.0)
        diag += (std * std).sum(axis=0)
        mv, ms = np.nonzero(~valid)
        mvs.append((mv + i).astype(np.int32))
        mss.append(ms.astype(np.int32))
        af[i:i + B] = a
        inv[i:i + B] = iv
    mv = np.concatenate(mvs) if mvs else np.empty(0, np.int32)
    ms = np.concatenate(mss) if mss else np.empty(0, np.int32)
    return af, inv, diag, mv, ms


def _zeroed_codes(codes: np.ndarray) -> np.ndarray:
    """Codes with missing (>= 3) zeroed, for the device genotype stores."""
    return np.where(codes < 3, codes, 0)


def _pack2_zeroed(codes: np.ndarray) -> np.ndarray:
    """Planar 2-bit pack with missing zeroed (native kernel or numpy)."""
    from ..io import native
    out = native.pack2_zeroed(codes)
    if out is not None:
        return out
    return pack_codes_2bit(_zeroed_codes(codes))


def _pad_miss(mv, ms, pad_multiple: int):
    nnz = len(mv)
    nnz_pad = max(-(-max(nnz, 1) // pad_multiple) * pad_multiple, pad_multiple)
    miss_var = np.zeros(nnz_pad, np.int32)
    miss_samp = np.zeros(nnz_pad, np.int32)
    miss_pad = np.zeros(nnz_pad, np.float64)
    miss_var[:nnz] = mv
    miss_samp[:nnz] = ms
    miss_pad[:nnz] = 1.0
    return miss_var, miss_samp, miss_pad


def build_packed2_grm(codes: np.ndarray,
                      pad_multiple: int = 256) -> Packed2GRM:
    """Build the 2-bit resident operator from int8 codes [M, N] (3=missing).

    Moments (af/inv/diag) and the sparse missing lists are identical to
    :func:`build_packed_grm`; only the device genotype store differs —
    0.25 B/genotype, never materializing a bf16 [M, N] array.
    """
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    M, N = codes.shape
    af, inv, diag, mv, ms = _variant_moments(codes)
    miss_var, miss_samp, miss_pad = _pad_miss(mv, ms, pad_multiple)
    cap = _leaf_rows((N + 3) // 4)
    leaves = tuple(
        tuple(jnp.asarray(t)
              for t in _split_tiles(_pack2_zeroed(codes[m0:m0 + cap])))
        for m0 in range(0, M, cap))
    return Packed2GRM(
        packed=leaves,
        af=jnp.asarray(af), inv=jnp.asarray(inv),
        diag=jnp.asarray(diag / M),
        miss_var=jnp.asarray(miss_var), miss_samp=jnp.asarray(miss_samp),
        miss_pad=jnp.asarray(miss_pad),
        samp_mask=jnp.ones(N, dtype=jnp.float64),
        n_variants=M, n_samples=N)


def build_packed2_grm_streamed(block_iter, n_samples: int,
                               pad_multiple: int = 256,
                               device_put=None,
                               n_variants: int = 0) -> Packed2GRM:
    """Streamed 2-bit build: host peak memory is one block; each block is
    planar-packed on host and placed on device immediately (async put —
    the next block's decode overlaps the upload).  Device blocks then
    coalesce into row-capped store LEAVES (see _leaf_rows); the
    coalescing concat touches one leaf's worth at a time, so device peak
    is the store plus ~one leaf.  ``n_variants``, when given, validates
    the iterator's total row count."""
    put = device_put or (lambda x: jnp.asarray(x))
    af_parts, inv_parts = [], []
    diag = np.zeros(n_samples, np.float64)
    miss_v, miss_s = [], []
    row0 = 0
    cap = _leaf_rows((n_samples + 3) // 4)
    leaves, group, group_rows = [], [], 0

    def _put_tiles(packed_np):
        return tuple(put(t) for t in _split_tiles(packed_np))

    def _seal():
        nonlocal group, group_rows
        if group:
            if len(group) == 1:
                leaves.append(group[0])
            else:           # concat per column tile (leading axis only)
                n_tiles = len(group[0])
                leaves.append(tuple(
                    jnp.concatenate([g[c] for g in group], axis=0)
                    for c in range(n_tiles)))
            group, group_rows = [], 0

    for _idx, codes in block_iter:
        codes = np.ascontiguousarray(codes, dtype=np.int8)
        af, inv, diag_part, mv, ms = _variant_moments(codes)
        diag += diag_part
        miss_v.append(mv.astype(np.int64) + row0)
        miss_s.append(ms.astype(np.int64))
        af_parts.append(af)
        inv_parts.append(inv)
        b = codes.shape[0]
        if group_rows + b > cap:
            _seal()
        if b >= cap:   # oversized incoming block: split into cap leaves
            packed_b = _pack2_zeroed(codes)
            for m0 in range(0, b, cap):
                leaves.append(_put_tiles(packed_b[m0:m0 + cap]))
        else:
            group.append(_put_tiles(_pack2_zeroed(codes)))
            group_rows += b
        row0 += b
    _seal()
    M = row0
    if n_variants and M != n_variants:
        raise ValueError(f"block iterator yielded {M} rows, "
                         f"n_variants={n_variants}")
    packed = tuple(leaves)
    mv = np.concatenate(miss_v) if miss_v else np.empty(0, np.int64)
    ms = np.concatenate(miss_s) if miss_s else np.empty(0, np.int64)
    miss_var, miss_samp, miss_pad = _pad_miss(mv, ms, pad_multiple)
    return Packed2GRM(packed=packed,
                      af=jnp.asarray(np.concatenate(af_parts)),
                      inv=jnp.asarray(np.concatenate(inv_parts)),
                      diag=jnp.asarray(diag / M),
                      miss_var=jnp.asarray(miss_var),
                      miss_samp=jnp.asarray(miss_samp),
                      miss_pad=jnp.asarray(miss_pad),
                      samp_mask=jnp.ones(n_samples, dtype=jnp.float64),
                      n_variants=M, n_samples=n_samples)


def _decode_plane(pc_i32, p):
    """int32 packed chunk -> bf16 codes of plane p."""
    return ((pc_i32 >> (2 * p)) & 3).astype(jnp.float32).astype(jnp.bfloat16)


# Column-tile width (bytes) of the 2-bit store: fixed at BUILD time so the
# matvec never slices a device array's minor axis (CLAUDE.md invariant 4).
# 16384 bytes x 16Ki-row leaves bounds every per-tile decode transient
# ([rows, _TILE_COLS] int32 = 1 GB, bf16 = 512 MB) and keeps each pass-1
# plane dot's contraction at 16384 <= 131072 terms (products <= 2*64, so
# f32 partials stay exact integers < 2^24).
_TILE_COLS = 16384


def _split_tiles(packed_np: np.ndarray):
    """Host-side column split of a packed [rows, N4] block into tiles."""
    N4 = packed_np.shape[1]
    return tuple(np.ascontiguousarray(packed_np[:, j0:j0 + _TILE_COLS])
                 for j0 in range(0, N4, _TILE_COLS))


def _leaf_rows(N4: int) -> int:
    """Row cap for one 2-bit store leaf.

    A leaf stays under 2^31 ELEMENTS, and the matvec slices leaves only
    on their LEADING axis (dim-1 slices of a big array made XLA hoist a
    full transposed copy — 2 x 6.56 GB at N=430K/M=64Ki).  Both limits
    are kept pending a check on the GPU with
    ``compiled.memory_analysis()``.  16Ki rows also bounds pass-1's
    per-dot decode transient ([rows, 16384-byte chunk] bf16 = 512 MB)."""
    return max(256, min(16384, ((1 << 31) - 1) // max(N4, 1)))


def _p1_tile(tile_u8, dmat, N4, j0, acc_dtype=jnp.float64):
    """One (row-leaf, column-tile) of pass 1: [mc, w] packed bytes x the
    tile's slice of the model columns -> exact f64 [mc, C].  Contraction
    per plane dot is w <= _TILE_COLS <= 131072 terms of exact integer
    products <= 128, so every f32 partial sum is an exact integer
    < 2^24; the dmat slice is leading-axis only.  (acc_dtype=f32: the
    mixed-precision tier — plane partials are still exact integers, only
    the cross-plane/tile combine rounds at f32.)"""
    w = tile_u8.shape[1]
    pc = tile_u8.astype(jnp.int32)
    acc = None
    for p in range(4):
        g = _decode_plane(pc, p)
        part = jnp.dot(g, dmat[p * N4 + j0: p * N4 + j0 + w],
                       preferred_element_type=jnp.float32)
        part = part.astype(acc_dtype)
        acc = part if acc is None else acc + part
    return acc


def _p2_tile(acc4, tile_u8, dm, acc_dtype=jnp.float64):
    """One (row-leaf, column-tile) of pass 2: accumulate the transpose
    product [4, w, C] += decode([mc, w])' @ dm[mc, C] per plane
    (contraction over <= 16Ki leaf rows: exact f32 integers, f64
    combine)."""
    pc = tile_u8.astype(jnp.int32)
    parts = []
    for p in range(4):
        g = _decode_plane(pc, p)
        part = jax.lax.dot_general(g, dm, (((0,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)
        parts.append(part.astype(acc_dtype))
    return acc4 + jnp.stack(parts)


@partial(jax.jit, static_argnames=("prec", "no_scale"))
def packed2_grm_matvec(packed, af, inv, miss_var, miss_samp, miss_pad,
                       samp_mask, b, prec: str = "f64",
                       no_scale: bool = False):
    """GRM @ b from 2-bit planar-packed codes; bit-identical to
    ``packed_grm_matvec(..., precision="exact_i8")``.

    Both passes decode per (row leaf, column tile, plane) into transient
    bf16 tiles and contract them in bf16 x bf16 -> f32 matmuls; every f32
    partial sum is an exact integer (products <= 2*64, contraction <=
    EXACT_CHUNK), combined exactly in f64, so tiling order cannot change
    the result.  ``prec="f32"``: the mixed-precision tier (5 slices, f32
    combine).  ``no_scale``: return M * (GRM @ b) for a leaf group, so
    :class:`SplitPacked2` can sum group contributions.
    """
    f32 = prec == "f32"
    acc_dtype = jnp.float32 if f32 else jnp.float64
    squeeze = b.ndim == 1
    B = b[:, None] if squeeze else b
    B = B.astype(acc_dtype)
    if f32:
        af = af.astype(jnp.float32)
        inv = inv.astype(jnp.float32)
        miss_pad = miss_pad.astype(jnp.float32)
        samp_mask = samp_mask.astype(jnp.float32)
    leaves = packed
    col_offs = []                 # byte-column offset of each tile
    j = 0
    for t in leaves[0]:
        col_offs.append(j)
        j += t.shape[1]
    N4 = j
    M = sum(lf[0].shape[0] for lf in leaves)
    Npad = 4 * N4
    N = B.shape[0]
    R = B.shape[1]
    S = N_SLICES_F32 if f32 else N_SLICES

    Bp = jnp.pad(B, ((0, Npad - N), (0, 0)))
    d, scale = _slice_i8(Bp, S)                       # [Npad, R, S]
    dmat = d.reshape(Npad, R * S).astype(jnp.bfloat16)
    w = scale[None, :, None] / 64.0 \
        * (1.0 / 128.0) ** jnp.arange(S, dtype=acc_dtype)[None, None, :]

    # pass 1: cv = Cm @ b, decoding per (row leaf, column tile, plane);
    # device arrays are never sliced — tiling happened at build time
    parts = []
    for lf in leaves:
        acc_l = None
        for t, j0 in zip(lf, col_offs):
            part = _p1_tile(t, dmat, N4, j0, acc_dtype)
            acc_l = part if acc_l is None else acc_l + part
        parts.append(acc_l)
    acc = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    cv = jnp.sum(acc.reshape(M, R, S) * w, axis=-1)   # [M, R]

    sum_b = jnp.sum(B, axis=0)
    corr1 = jax.ops.segment_sum(B[miss_samp] * miss_pad[:, None],
                                miss_var, num_segments=M)
    mv = sum_b[None, :] - corr1
    gv = inv[:, None] * (cv - 2.0 * af[:, None] * mv)  # [M, R]

    # pass 2: out = Cm' w1, decoding variant chunks x 4 planes
    w1 = inv[:, None] * gv
    w2 = 2.0 * af[:, None] * inv[:, None] * gv
    d2, scale2 = _slice_i8(w1, S)                     # [M, R, S]
    dmat2 = d2.reshape(M, R * S).astype(jnp.bfloat16)
    w2c = scale2[None, :, None] / 64.0 \
        * (1.0 / 128.0) ** jnp.arange(S, dtype=acc_dtype)[None, None, :]
    C2 = dmat2.shape[1]
    # per column tile: accumulate [4, w, C2] over the row leaves
    # (contraction per dot <= 16Ki leaf rows: exact f32 integers),
    # then apply the slice weights; dmat2 slices are leading-axis
    pl_tiles = []                                 # [n_tiles][4][w, R]
    for c, _j0 in enumerate(col_offs):
        w_c = leaves[0][c].shape[1]
        acc4 = jnp.zeros((4, w_c, C2), acc_dtype)
        off = 0
        for lf in leaves:
            rows = lf[c].shape[0]
            acc4 = _p2_tile(acc4, lf[c], dmat2[off: off + rows],
                            acc_dtype)
            off += rows
        pl_tiles.append([jnp.sum(a.reshape(w_c, R, S) * w2c, axis=-1)
                         for a in acc4])
    # natural order: plane-major, column tiles in offset order
    planes = [jnp.concatenate([pt[p] for pt in pl_tiles], axis=0)
              if len(pl_tiles) > 1 else pl_tiles[0][p]
              for p in range(4)]
    out = jnp.concatenate(planes, axis=0)[:N]     # natural order

    corr2 = jax.ops.segment_sum(w2[miss_var] * miss_pad[:, None],
                                miss_samp, num_segments=N)
    out = out - samp_mask[:, None] * (jnp.sum(w2, axis=0)[None, :] - corr2)
    if not no_scale:
        # no_scale: the SplitPacked2 handle sums group contributions and
        # divides by the FULL variant count itself (every term above is
        # linear in the group's variants, so contributions just add)
        out = out / M
    return out[:, 0] if squeeze else out


class SplitPacked2:
    """Bounded-program GRM handle over a :class:`Packed2GRM`'s leaves.

    Splits the MATVEC across per-leaf-group device programs: each group
    of row leaves compiles its own (cached, shape-shared) contribution
    program, and a host loop sums the contributions ON DEVICE — so the
    largest compiled program is one group, independent of total M.  The
    outer AI-REML/PCG iterations are then host-driven
    (models/fit_split.py, ops/pcg.pcg_host*) with all state device-
    resident; only scalars reach the host.  ``grm_impl="auto"`` picks
    it when the one-program fit's estimated peak would not fit in device
    memory (models/fitnull._packed2_engine).

    Groups share compiled executables when their shapes match (uniform
    leaves -> one compile).  ``group_leaves`` bounds a group's rows at
    group_leaves x _leaf_rows (1 leaf = the proven-compile size).
    """

    is_grm_handle = True

    def __init__(self, grm: Packed2GRM, group_leaves: int = 1,
                 pcg_tier: str = "exact"):
        # "exact" (default): all-f64 host-driven iteration; "mixed":
        # f32 inner solves + exact-f64 refinement (opt-in, ~1e-8
        # agreement per the tolPCG contract)
        self.pcg_tier = pcg_tier
        self.n_samples = grm.n_samples
        self.n_variants = grm.n_variants
        self.diag = grm.diag
        self.samp_mask = grm.samp_mask
        mv = np.asarray(grm.miss_var)
        ms = np.asarray(grm.miss_samp)
        mp = np.asarray(grm.miss_pad)
        nnz = int(mp.sum())
        mv, ms = mv[:nnz], ms[:nnz]          # real entries (sorted by row)
        self.groups = []
        row0 = 0
        leaves = grm.packed
        for g0 in range(0, len(leaves), group_leaves):
            grp = leaves[g0:g0 + group_leaves]
            rows = sum(lf[0].shape[0] for lf in grp)
            lo = np.searchsorted(mv, row0)
            hi = np.searchsorted(mv, row0 + rows)
            gmv, gms, gmp = _pad_miss(mv[lo:hi] - row0, ms[lo:hi], 256)
            self.groups.append((
                tuple(grp), grm.af[row0:row0 + rows],
                grm.inv[row0:row0 + rows], jnp.asarray(gmv),
                jnp.asarray(gms), jnp.asarray(gmp)))
            row0 += rows

    def mv(self, b, prec: str = "f64"):
        """GRM @ b as a sum of per-group device programs (device in/out).
        Identical algebra to ``Packed2GRM.matvec`` — every term is linear
        in the group's variants, so contributions add exactly."""
        out = None
        for grp, af, inv, gmv, gms, gmp in self.groups:
            c = packed2_grm_matvec(grp, af, inv, gmv, gms, gmp,
                                   self.samp_mask, b, prec=prec,
                                   no_scale=True)
            out = c if out is None else out + c
        return out / self.n_variants

    def matvec(self, b):                    # op-compatible alias (f64)
        return self.mv(b)

    def matvec32(self, b32):
        return self.mv(b32, prec="f32")

    def pcg(self, w, tau, B, tol, maxiter):
        """Host-driven batched PCG (numpy in/out) — the fitter-facing
        handle interface (models/fitnull._pcg)."""
        from .pcg import pcg_host, pcg_host_mixed
        if self.pcg_tier == "mixed":
            X, _iters, conv = pcg_host_mixed(
                self, jnp.asarray(w), jnp.asarray(tau), jnp.asarray(B),
                tol, maxiter)
        else:
            X, _iters, conv = pcg_host(
                self, jnp.asarray(w), jnp.asarray(tau), jnp.asarray(B),
                tol, maxiter, prec="f64")
        return np.asarray(X), np.asarray(conv)


@partial(jax.jit, static_argnames=("precision",))
def packed_grm_matvec(codes, af, inv, miss_var, miss_samp, miss_pad,
                      samp_mask, b, precision: str = "exact_i8"):
    """GRM @ b from packed codes; b [N] or [N, R] float64.

    Missing genotypes contribute s = 0; since they are stored as code 0,
    only the ``- 2 af`` centering term needs correcting, via the sparse
    (variant, sample) pair lists — O(nnz) segment-sums, exact.
    """
    squeeze = b.ndim == 1
    B = b[:, None] if squeeze else b
    M, N = codes.shape
    R = B.shape[1]

    # pass 1: gv = diag(inv) (Cm @ b - 2 af * (sum(b) - miss_corr))
    if precision == "exact_i8":
        cv = _i8_exact_dot(codes, B, N_SLICES, contract_left=False)
    elif precision == "f64":
        cv = codes.astype(jnp.float64) @ B
    else:
        raise ValueError(f"unknown precision {precision!r}")
    sum_b = jnp.sum(B, axis=0)                                  # [R]
    corr1 = jax.ops.segment_sum(B[miss_samp] * miss_pad[:, None],
                                miss_var, num_segments=M)       # [M, R]
    mv = sum_b[None, :] - corr1
    gv = inv[:, None] * (cv - 2.0 * af[:, None] * mv)           # [M, R]

    # pass 2: out = Cm' w1 - (sum(w2) - miss_corr_col)
    w1 = inv[:, None] * gv
    w2 = 2.0 * af[:, None] * inv[:, None] * gv
    if precision == "exact_i8":
        out = _i8_exact_dot(codes, w1, N_SLICES, contract_left=True)
    else:
        out = codes.astype(jnp.float64).T @ w1
    corr2 = jax.ops.segment_sum(w2[miss_var] * miss_pad[:, None],
                                miss_samp, num_segments=N)      # [N, R]
    # samp_mask zeroes the rank-1 centering term on padded sample columns
    # (a zero-padded sample would otherwise act like a real 0/0 genotype)
    out = out - samp_mask[:, None] * (jnp.sum(w2, axis=0)[None, :] - corr2)

    out = out / M
    return out[:, 0] if squeeze else out
