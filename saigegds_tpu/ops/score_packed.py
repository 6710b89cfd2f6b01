"""Exact packed-genotype score test: integer-sliced bf16 matmuls, f64 statistics.

The dense f64 score kernel (``ops/score.py``) materializes several [B, N]
float64 intermediates per block (imputed dosages, flips, the adjusted
genotype): 8 B per genotype of device-memory traffic each.  This module
reformulates phase 1 **algebraically** so the raw int8 genotype codes are
the only [B, N]-sized operand:

With per-variant missing mask ``m``, zero-filled dosages ``g0`` and
hom-ALT indicator ``g2`` (all exact small integers derived from the codes),
mean imputation and allele flip are affine maps ``g = s*(g0 + mean*m) + t``
and the covariate adjustment ``L(v) = v - XXVX_inv (XV v)`` is linear, so
(reference ``single_test_bin`` src/saige_main.cpp:279-407):

    S   = r' L(g)                    -> contractions  r'g0, r'm, XV g0, XV m
    var = sum W L(g)^2               -> adds  W'g0, W'm, W'g2, (X'W) g0,
                                        (X'W) m  and the constant K x K
                                        matrix  X'WX

i.e. phase 1 for a whole block is ONE exact integer matmul
``[G0; M; G2] @ V'`` where ``V`` stacks the 2K+3 model vectors
(ones, r, W, XV rows, (W XXVX_inv) rows), decomposed into signed-7-bit
slices exactly as in ``ops/packed_grm.py`` — bf16 tensor-core matmuls,
float64 results, bit-parity with the dense kernel.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .packed_grm import _slice_i8
from .score import (ScanModel, ScanParams, ScoreStats, score_stats_binary,
                    score_stats_quant, variant_var_ratio)
from .special import pchisq1_sf, qnorm

N_SLICES = 8

# burden-collapse batching target: bounds the transient bf16 indicator
# chunks in HBM (oversized units chunk the contraction at 65536 SNPs to
# keep every f32 partial exact: |partial| <= 64 * 2 * 65536 = 2^23)
BURDEN_S_CAP = 2048
_BURDEN_N_CHUNK = 65536


class PackedScanModel(NamedTuple):
    """Precomputed model-side state for the packed score kernel."""

    trait_binary: bool
    tau: jnp.ndarray       # [2]
    V: jnp.ndarray         # [2K+3, N] stacked model vectors (f64)
    XWX: jnp.ndarray       # [K, K] = XXVX_inv' W XXVX_inv
    wr: jnp.ndarray        # [K] = XXVX_inv' r
    u3: jnp.ndarray        # [K] = XV @ 1
    v3: jnp.ndarray        # [K] = XXVX_inv' W 1
    sum_r: jnp.ndarray     # [] r' 1
    sum_w: jnp.ndarray     # [] W' 1
    var_ratio: float
    n_cov: int             # K
    vs: jnp.ndarray        # [N, Cpad] bf16 sliced V (int8-block operand)
    vs4: jnp.ndarray       # [4, N4, Cpad] plane-split zero-padded vs for the
    #                        2-bit planar-packed block path (plane p rows are
    #                        natural samples p*N4 .. p*N4+N4-1).  Both vs and
    #                        vs4 stay resident (~bf16 N x Cpad each, ~0.5 GB
    #                        total at N=500k/K=10): the default scan uses vs4
    #                        for dense blocks AND vs for the sparse-decoded
    #                        ones in the same run; vs4 is derived on device
    #                        (no extra upload), and re-deriving it per block
    #                        would churn the same HBM every dispatch
    wts: jnp.ndarray       # [2K+3, S] f64 slice combine weights
    # for SPA phase 2 and quantitative stats the dense model is still needed
    dense: ScanModel


def pack_scan_model(model: ScanModel) -> PackedScanModel:
    """Build the packed-kernel state from a dense ScanModel."""
    XV = np.asarray(model.XV)             # [K, N]
    X = np.asarray(model.XXVX_inv)        # [N, K]
    r = np.asarray(model.y_mu)            # [N]
    W = np.asarray(model.mu2) if model.trait_binary \
        else np.ones_like(np.asarray(model.mu))
    K, N = XV.shape
    WX = X * W[:, None]                   # [N, K]
    V = np.concatenate([
        np.ones((1, N)),                  # row 0: ones  -> ac / n_missing
        r[None, :],                       # row 1
        W[None, :],                       # row 2
        XV,                               # rows 3 .. 3+K-1
        WX.T,                             # rows 3+K .. 3+2K-1
    ], axis=0)                            # [2K+3, N]
    # bake the signed-7-bit slice decomposition of the model vectors:
    # V' ~ scale * sum_s d_s / (64 * 128^s)   (ops/packed_grm._slice_i8)
    d, scale = _slice_i8(jnp.asarray(V.T), N_SLICES)      # [N, R, S], [R]
    R = V.shape[0]
    C = R * N_SLICES
    Cpad = -(-C // 128) * 128
    vs = jnp.asarray(d).reshape(N, C).astype(jnp.bfloat16)
    vs = jnp.pad(vs, ((0, 0), (0, Cpad - C)))
    # plane-split copy for 2-bit planar blocks: zero rows at padded samples
    # kill every contraction term there (the pad code is irrelevant)
    N4 = -(-N // 4)
    vs4 = jnp.pad(vs, ((0, 4 * N4 - N), (0, 0))).reshape(4, N4, Cpad)
    wts = np.asarray(scale)[:, None] / 64.0 \
        * (1.0 / 128.0) ** np.arange(N_SLICES)[None, :]
    return PackedScanModel(
        trait_binary=model.trait_binary,
        tau=jnp.asarray(model.tau),
        V=jnp.asarray(V),
        XWX=jnp.asarray(X.T @ WX),
        wr=jnp.asarray(X.T @ r),
        u3=jnp.asarray(XV @ np.ones(N)),
        v3=jnp.asarray(WX.T @ np.ones(N)),
        sum_r=jnp.asarray(r.sum()),
        sum_w=jnp.asarray(W.sum()),
        var_ratio=model.var_ratio,
        n_cov=K,
        vs=vs,
        vs4=vs4,
        wts=jnp.asarray(wts),
        dense=model,
    )


def _combine_slices(a, B, R, wts):
    """[B, Cpad] slice columns -> [B, R] with the baked f64 weights."""
    a = a[:, :R * N_SLICES].reshape(B, R, N_SLICES)
    return jnp.einsum("brs,rs->br", a, wts)


def _packed_phase1(pm: PackedScanModel, params: ScanParams, codes,
                   impl: str):
    """Shared contraction + per-variant moment algebra for both traits.

    ``codes`` is either int8 [B, N] (3 = missing) or, for the ``*2``
    impls, planar 2-bit packed uint8 [B, N4] (``pack_codes_2bit`` with
    missing retained as 3; byte j bit-pair p = sample p*N4+j) — 0.25
    B/genotype over the host->device link and in HBM.  Padded samples
    beyond N contribute nothing because their ``vs4`` rows are zero.

    ``impl="sparse"`` takes ``codes`` as the ``(entries, row_ptr)``
    gap-coded transport of ops/sparse_codes (2 B/nonzero over the link),
    decodes to the exact int8 block on device, and runs the ``xla``
    contraction — bit-parity with the dense paths by construction.
    """
    if impl == "sparse":
        from .sparse_codes import decode_codes
        entries, row_ptr = codes
        codes = decode_codes(entries, row_ptr, row_ptr.shape[0] - 1,
                             pm.V.shape[1])
        impl = "xla"
    B = codes.shape[0]
    N = pm.V.shape[1]               # true sample count
    K = (pm.V.shape[0] - 3) // 2    # static (from array shape, not the leaf)
    R = pm.V.shape[0]

    if impl == "xla":
        # chunk the contraction axis (exact-f32 bound, see packed_grm) and
        # build the bf16 indicators chunk-locally: no full-width [B, N]
        # bf16 materializations and no strided column slices of them
        from .packed_grm import EXACT_CHUNK
        acc = [None, None, None]
        for s0 in range(0, N, EXACT_CHUNK):
            c = codes[:, s0:s0 + EXACT_CHUNK]
            v = pm.vs[s0:s0 + EXACT_CHUNK]                      # [n, Cpad]
            g0 = jnp.where(c == 3, 0, c).astype(jnp.bfloat16)
            mm = (c == 3).astype(jnp.bfloat16)
            gg = (c == 2).astype(jnp.bfloat16)
            for i, ind in enumerate((g0, mm, gg)):
                part = jnp.dot(ind, v,
                               preferred_element_type=jnp.float32)
                part = part.astype(jnp.float64)
                acc[i] = part if acc[i] is None else acc[i] + part
        Y0, Ym, Y2 = (_combine_slices(a, B, R, pm.wts) for a in acc)
    elif impl == "xla2":
        # planar 2-bit blocks: decode byte-column chunks x 4 planes into
        # transient bf16 indicators; per-dot contraction <= 16384 keeps
        # every f32 partial an exact integer (products <= 2 * 64)
        N4 = pm.vs4.shape[1]
        CJ = 16384
        acc = [None, None, None]
        for j0 in range(0, N4, CJ):
            j1 = min(j0 + CJ, N4)
            pc = codes[:, j0:j1].astype(jnp.int32)
            for p in range(4):
                t = (pc >> (2 * p)) & 3
                tf = t.astype(jnp.float32)
                g0 = jnp.where(t == 3, 0.0, tf).astype(jnp.bfloat16)
                mm = (t == 3).astype(jnp.float32).astype(jnp.bfloat16)
                gg = (t == 2).astype(jnp.float32).astype(jnp.bfloat16)
                v = pm.vs4[p, j0:j1]
                for i, ind in enumerate((g0, mm, gg)):
                    part = jnp.dot(ind, v,
                                   preferred_element_type=jnp.float32)
                    part = part.astype(jnp.float64)
                    acc[i] = part if acc[i] is None else acc[i] + part
        Y0, Ym, Y2 = (_combine_slices(a, B, R, pm.wts) for a in acc)
    else:
        raise ValueError(f"unknown impl {impl!r}")

    ac = Y0[:, 0]
    n_miss = Ym[:, 0]
    a1, a2 = Y0[:, 1], Ym[:, 1]               # r' g0, r' m
    b3, b2 = Y0[:, 2], Ym[:, 2]               # W' g0, W' m
    bg2 = Y2[:, 2]                            # W' g2
    u1 = Y0[:, 3:3+K]                         # XV g0       [B, K]
    u2 = Ym[:, 3:3+K]                         # XV m
    v1 = Y0[:, 3+K:3+2*K]                     # (X'W) g0
    v2 = Ym[:, 3+K:3+2*K]                     # (X'W) m

    num = (N - n_miss)
    af = ac / (2.0 * num)
    mean = ac / num
    flip = af > 0.5
    mac = jnp.minimum(ac, 2.0 * num - ac)
    maf = jnp.minimum(af, 1.0 - af)
    miss_rate = n_miss / N
    valid = (num > 0) & (maf > 0) & (maf >= params.maf) & \
        (mac >= params.mac) & (miss_rate <= params.missing)

    # affine map g = s*(g0 + mean*m) + t;  unflipped (1, 0), flipped (-1, 2)
    s = jnp.where(flip, -1.0, 1.0)
    t = jnp.where(flip, 2.0, 0.0)
    tau_c = t / s                                        # 0 or -2

    # S = r' L(g) = s*[ (a1 - wr.u1) + mean*(a2 - wr.u2) ] + t*(sum_r - wr.u3)
    wr_u1 = u1 @ pm.wr
    wr_u2 = u2 @ pm.wr
    wr_u3 = jnp.dot(pm.u3, pm.wr)
    S = s * ((a1 - wr_u1) + mean * (a2 - wr_u2)) + t * (pm.sum_r - wr_u3)

    # var = sum W (q - X c)^2, q = g0 + mean*m + tau_c, c = u1+mean*u2+tau_c*u3
    c = u1 + mean[:, None] * u2 + tau_c[:, None] * pm.u3[None, :]  # [B, K]
    Wq2 = (b3 + 2.0 * bg2) + mean**2 * b2 + tau_c**2 * pm.sum_w \
        + 2.0 * tau_c * b3 + 2.0 * tau_c * mean * b2
    XWq = v1 + mean[:, None] * v2 + tau_c[:, None] * pm.v3[None, :]
    var = Wq2 - 2.0 * jnp.sum(c * XWq, axis=1) \
        + jnp.sum(c * (c @ pm.XWX.T), axis=1)

    return dict(valid=valid, af=af, mac=mac, num=num, flip=flip,
                S=S, var=var)


@partial(jax.jit, static_argnames=("params", "impl"))
def score_stats_binary_packed(pm: PackedScanModel, params: ScanParams, codes,
                              impl: str = "xla"):
    """Phase-1 binary score test from int8 codes [B, N] (3 = missing).

    Bit-parity with ``score_stats_binary`` on integer-dosage data, at
    integer-matmul cost.  ``impl``: ``"xla"`` for int8 codes, ``"xla2"``
    for 2-bit planar blocks, ``"sparse"`` for the gap-coded stream.
    """
    m = _packed_phase1(pm, params, codes, impl)
    S, var, flip = m["S"], m["var"], m["flip"]
    var1 = var * variant_var_ratio(pm.dense, m["mac"])
    pval_noadj = pchisq1_sf(S * S / var1)
    beta = S / var1
    beta = jnp.where(flip, -beta, beta)
    se = jnp.abs(beta / qnorm(pval_noadj / 2.0))
    need_spa = m["valid"] & jnp.isfinite(pval_noadj) & \
        (pval_noadj <= params.spa_pval)
    return ScoreStats(valid=m["valid"], af=m["af"], mac=m["mac"],
                      num=m["num"], beta=beta, se=se,
                      pval=pval_noadj, need_spa=need_spa)


@partial(jax.jit, static_argnames=("params", "impl"))
def score_stats_quant_packed(pm: PackedScanModel, params: ScanParams, codes,
                             impl: str = "xla"):
    """Phase-1 quantitative score test from int8 codes (no SPA).

    ``pack_scan_model`` uses W = 1 for quantitative models, so ``var`` is
    sum g_tilde^2 (single_test_quant, src/saige_main.cpp:189-276)."""
    m = _packed_phase1(pm, params, codes, impl)
    S, var, flip, mac = m["S"], m["var"], m["flip"], m["mac"]
    inv_mac = 1.0 / mac
    inv_sqrt_mac = jnp.sqrt(inv_mac)
    var1 = var * inv_mac * variant_var_ratio(pm.dense, mac)
    Tstat = S * inv_sqrt_mac / pm.tau[0]
    pval = pchisq1_sf(Tstat * Tstat / var1)
    beta = Tstat / var1 * inv_sqrt_mac
    beta = jnp.where(flip, -beta, beta)
    se = jnp.abs(beta / qnorm(pval / 2.0))
    return ScoreStats(valid=m["valid"], af=m["af"], mac=mac, num=m["num"],
                      beta=beta, se=se, pval=pval,
                      need_spa=jnp.zeros_like(m["valid"]))


# ---------------------------------------------------------------------------
# Device-side burden collapse: unit codes ship once (sparse/2-bit/int8),
# the weighted burden rows are built ON DEVICE and scored in the same
# dispatch — the host never materializes or uploads [rows, N] f64.
# ---------------------------------------------------------------------------


def _burden_rows(codes, A, Bm, C):
    """Exact weighted burden rows from int8 codes.

    codes: int8 [S, N] (3 = missing); A, Bm: f64 [R, S] per-row SNP
    coefficients (A on the zero-filled dosage, Bm on the missing
    indicator); C: f64 [R] constants.  Row r = A[r] @ G0 + Bm[r] @ M +
    C[r] — the affine form of the reference's per-SNP mean-impute +
    minor-flip + weight collapse (``ds_mat_burden``,
    /root/reference/src/saige_main.cpp:526-610).

    The f64 coefficients decompose into signed-7-bit slices
    (ops/packed_grm._slice_i8) so every bf16 matmul accumulates exact
    integers (|d| <= 64, |g| <= 2, S <= 65536 => partials < 2^24);
    sample columns are chunked to bound the transient bf16 indicators.
    """
    S, N = codes.shape
    R = A.shape[0]
    dA, sA = _slice_i8(A.T, N_SLICES)            # [S, R, 8], [R]
    dB, sB = _slice_i8(Bm.T, N_SLICES)
    a2 = dA.reshape(S, R * N_SLICES).astype(jnp.bfloat16).T   # [R*8, S]
    b2 = dB.reshape(S, R * N_SLICES).astype(jnp.bfloat16).T
    pw = (1.0 / 128.0) ** jnp.arange(N_SLICES, dtype=jnp.float64)
    wA = sA[:, None] / 64.0 * pw[None, :]        # [R, 8]
    wB = sB[:, None] / 64.0 * pw[None, :]
    SC = 65536     # exact-f32 contraction bound per dot
    outs = []
    for j0 in range(0, N, _BURDEN_N_CHUNK):
        c = codes[:, j0 : j0 + _BURDEN_N_CHUNK]
        g0 = jnp.where(c == 3, 0, c).astype(jnp.bfloat16)
        mm = (c == 3).astype(jnp.bfloat16)
        pA = pB = None
        for s0 in range(0, S, SC):   # exact partials, combined in f64
            qA = jnp.dot(a2[:, s0:s0 + SC], g0[s0:s0 + SC],
                         preferred_element_type=jnp.float32)
            qB = jnp.dot(b2[:, s0:s0 + SC], mm[s0:s0 + SC],
                         preferred_element_type=jnp.float32)
            qA = qA.astype(jnp.float64)
            qB = qB.astype(jnp.float64)
            pA = qA if pA is None else pA + qA
            pB = qB if pB is None else pB + qB
        pA = pA.reshape(R, N_SLICES, -1)
        pB = pB.reshape(R, N_SLICES, -1)
        outs.append(jnp.einsum("rsn,rs->rn", pA, wA) +
                    jnp.einsum("rsn,rs->rn", pB, wB))
    rows = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=1)
    return rows + C[:, None]


@partial(jax.jit, static_argnames=("params", "binary"))
def burden_score_packed(model: ScanModel, params: ScanParams, payload,
                        A, Bm, C, binary: bool = True):
    """Collapse + score burden rows entirely on device.

    ``payload`` is the unit batch's codes: int8 [S, N], the 2-bit planar
    uint8 [S, ceil(N/4)] (shape identifies it), or the gap-coded
    ``(entries, row_ptr)`` transport — decoded on device.  The resulting
    [R, N] f64 burden rows feed the dense score test in the same
    dispatch, so the host never ships 8 B/sample row vectors
    (the reference re-runs ``single_test_bin`` on each collapsed vector,
    src/saige_main.cpp:872-897 — same here, just without the transport).
    """
    N = model.XV.shape[1]
    if isinstance(payload, tuple):
        from .sparse_codes import decode_codes
        entries, row_ptr = payload
        codes = decode_codes(entries, row_ptr, row_ptr.shape[0] - 1, N)
    elif payload.shape[1] != N:                    # 2-bit planar
        pi = payload.astype(jnp.int32)
        planes = jnp.concatenate([(pi >> (2 * p)) & 3 for p in range(4)],
                                 axis=1)
        codes = planes[:, :N].astype(jnp.int8)
    else:
        codes = payload
    rows = _burden_rows(codes, A, Bm, C)
    fn = score_stats_binary if binary else score_stats_quant
    return fn(model, params, rows)
