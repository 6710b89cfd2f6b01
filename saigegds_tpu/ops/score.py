"""Batched single-variant score tests (binary + quantitative traits).

Device re-design of the reference's per-variant scalar loops
(``single_test_bin`` / ``single_test_quant``, ``src/saige_main.cpp:189-407``):
a whole block of B variants is tested at once.  The covariate projections
``coeff = XV @ g`` and ``g_tilde = g - XXVX_inv' @ coeff`` become ``[B, N] x
[N, K]`` matmuls, the score/variance contractions are fused reductions.  The reference's sparse (maf < 0.05) path is an arithmetic
re-association of the same quantities, so a single dense path reproduces
both to fp64 rounding.

SPA refinement is *two-phase*: the main kernel only flags variants with
``p_noadj <= spa.pval`` (~5% under the null); flagged variants are gathered
into compact batches and refined by ``spa_refine_binary``.  This keeps the
divergent Newton iteration off the hot streaming path — the device analog of
the reference's "only escalate to SPA when needed" control flow
(src/saige_main.cpp:355-395).

The model state mirrors ``saige_score_test_init`` (src/saige_main.cpp:103-150)
and ``.init_nullmod`` (R/assoc_single.r:17-67).
"""

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .special import pchisq1_sf, qnorm
from .spa import saddle_prob_batch


class ScanModel(NamedTuple):
    """Null-model state needed by the variant scan (all float64).

    Replicated across devices: score tests are embarrassingly parallel over
    variants (SURVEY.md §2.3)."""

    trait_binary: bool
    tau: jnp.ndarray          # [2]
    y: jnp.ndarray            # [N]
    mu: jnp.ndarray           # [N]
    y_mu: jnp.ndarray         # [N] y - mu
    mu2: jnp.ndarray          # [N] mu*(1-mu)
    XV: jnp.ndarray           # [K, N]
    XXVX_inv: jnp.ndarray     # [N, K]
    var_ratio: float
    # MAC-categorized variance ratios (opt-in; newer-than-v1.12.5 SAIGEgds
    # feature — the reference applies ONE mean ratio to every variant,
    # R/assoc_single.r:156-157).  When set, category c spans MAC in
    # (vr_edges[c-1], vr_edges[c]] with a trailing open category, and the
    # kernels look each variant's ratio up by its minor allele count.
    vr_edges: Optional[jnp.ndarray] = None    # [C-1] ascending MAC bounds
    vr_ratios: Optional[jnp.ndarray] = None   # [C] per-category ratios


def variant_var_ratio(model: ScanModel, mac):
    """Per-variant variance ratio: the model's scalar, or a MAC-category
    lookup when the model carries categorized ratios."""
    if model.vr_edges is None:
        return model.var_ratio
    return jnp.take(model.vr_ratios,
                    jnp.searchsorted(model.vr_edges, mac, side="left"))


class ScanParams(NamedTuple):
    maf: float
    mac: float
    missing: float
    spa_pval: float


class ScoreStats(NamedTuple):
    valid: jnp.ndarray       # [B] passed filters
    af: jnp.ndarray          # [B] ALT allele frequency
    mac: jnp.ndarray         # [B] minor allele count
    num: jnp.ndarray         # [B] non-missing samples
    beta: jnp.ndarray        # [B]
    se: jnp.ndarray          # [B]
    pval: jnp.ndarray        # [B] (chi-square, pre-SPA for binary)
    need_spa: jnp.ndarray    # [B] flagged for SPA refinement


@jax.jit
def stack_stats(res: ScoreStats) -> jnp.ndarray:
    """Pack a ScoreStats into one [8, B] f64 array on device, so drains
    read results back in a single transfer (each device->host fetch pays
    a fixed round-trip; 8 small fetches per block were measurable)."""
    return jnp.stack([res.valid.astype(jnp.float64), res.af, res.mac,
                      res.num.astype(jnp.float64), res.beta, res.se,
                      res.pval, res.need_spa.astype(jnp.float64)])


def unstack_stats(arr: np.ndarray) -> ScoreStats:
    """Host-side inverse of :func:`stack_stats` (numpy fields)."""
    a = np.asarray(arr)
    return ScoreStats(valid=a[0] != 0, af=a[1], mac=a[2], num=a[3],
                      beta=a[4], se=a[5], pval=a[6], need_spa=a[7] != 0)


def prep_dosage(G):
    """Per-variant AF/AC/missing + mean imputation + minor-allele flip.

    G: [B, N] raw ALT dosages with NaN for missing.  An f32 block is
    widened here (exact): callers ship f32 over the host->device link
    when the dosages are exactly f32-representable — always true for
    dFloat32/dPackedReal GDS source nodes — halving the transport of
    DS-dosage scans.
    Mirrors ``f64_af_ac_impute`` + flip (src/vectorization.cpp:303-354,
    src/saige_main.cpp:291-299).
    """
    G = G.astype(jnp.float64)
    isnan = jnp.isnan(G)
    num = jnp.sum(~isnan, axis=1)
    ac = jnp.where(isnan, 0.0, G).sum(axis=1)
    af = ac / (2.0 * num)
    mean = ac / num
    g = jnp.where(isnan, mean[:, None], G)
    flip = af > 0.5
    g = jnp.where(flip[:, None], 2.0 - g, g)
    mac = jnp.minimum(ac, 2.0 * num - ac)
    maf = jnp.minimum(af, 1.0 - af)
    miss = (G.shape[1] - num) / G.shape[1]
    return g, af, ac, num, mac, maf, miss, flip


def _valid_mask(params, num, maf, mac, miss):
    return (num > 0) & (maf > 0) & (maf >= params.maf) & \
        (mac >= params.mac) & (miss <= params.missing)


def _adjusted_genotype(model: ScanModel, g):
    """coeff = XV @ g; g_tilde = g - XXVX_inv @ coeff (dense f64 path)."""
    coeff = g @ model.XV.T                     # [B, K]
    g_tilde = g - coeff @ model.XXVX_inv.T     # [B, N]
    return g_tilde


@partial(jax.jit, static_argnames=("params",))
def score_stats_binary(model: ScanModel, params: ScanParams, G):
    """Phase-1 binary score test: chi-square p-values + SPA flags."""
    g, af, ac, num, mac, maf, miss, flip = prep_dosage(G)
    valid = _valid_mask(params, num, maf, mac, miss)

    g_tilde = _adjusted_genotype(model, g)
    S = jnp.sum(model.y_mu[None, :] * g_tilde, axis=1)
    var = jnp.sum(model.mu2[None, :] * g_tilde * g_tilde, axis=1)
    var1 = var * variant_var_ratio(model, mac)
    pval_noadj = pchisq1_sf(S * S / var1)
    beta = S / var1
    beta = jnp.where(flip, -beta, beta)
    se = jnp.abs(beta / qnorm(pval_noadj / 2.0))
    need_spa = valid & jnp.isfinite(pval_noadj) & (pval_noadj <= params.spa_pval)

    return ScoreStats(valid=valid, af=af, mac=mac, num=num, beta=beta, se=se,
                      pval=pval_noadj, need_spa=need_spa)


def unpack_codes_2bit_f64(packed, n_samples: int):
    """Device-side inverse of ``ops.packed_grm.pack_codes_2bit``:
    uint8 [B, N4] planar bytes -> f64 [B, n] dosages with NaN missing.

    Phase-2 SPA batches ship 2-bit packed (N/4 bytes per variant instead
    of 8N for dense f64, to cut the host->device bytes)."""
    pi = packed.astype(jnp.int32)
    planes = jnp.concatenate([(pi >> (2 * p)) & 3 for p in range(4)],
                             axis=1)[:, :n_samples]
    return jnp.where(planes == 3, jnp.nan, planes.astype(jnp.float64))


@partial(jax.jit, static_argnames=("mixed", "cap", "packed_n"))
def spa_refine_binary(model: ScanModel, G, mixed: bool = False,
                      cap: int = 0, packed_n: int = 0):
    """Phase-2 SPA refinement for a compact batch of flagged variants.

    G: [Bs, N] raw dosages (NaN = missing) of variants that passed filters
    and had p_noadj <= spa.pval — or, with ``packed_n`` = N, planar 2-bit
    packed uint8 [Bs, ceil(N/4)] codes, or the ``(entries, row_ptr)``
    gap-coded stream of ops/sparse_codes (both decoded on device;
    bit-identical dosages).  Returns (pval, converged, beta, se).
    Mirrors src/saige_main.cpp:355-400.
    """
    if packed_n and isinstance(G, tuple):
        from .sparse_codes import decode_codes
        entries, row_ptr = G
        codes = decode_codes(entries, row_ptr, row_ptr.shape[0] - 1,
                             packed_n)
        G = jnp.where(codes == 3, jnp.nan, codes.astype(jnp.float64))
    elif packed_n:
        G = unpack_codes_2bit_f64(G, packed_n)
    g, af, ac, num, mac, maf, miss, flip = prep_dosage(G)
    g_tilde = _adjusted_genotype(model, g)
    ac2 = jnp.where(flip, 2.0 * num - ac, ac)   # minor allele count
    g_norm = g_tilde / jnp.sqrt(ac2)[:, None]
    q = jnp.sum(model.y[None, :] * g_norm, axis=1)
    m1 = jnp.sum(model.mu[None, :] * g_norm, axis=1)
    var2 = jnp.sum(model.mu2[None, :] * g_norm * g_norm, axis=1)
    var1 = var2 * variant_var_ratio(model, ac2)
    Tstat = q - m1
    qtilde = Tstat / jnp.sqrt(var1) * jnp.sqrt(var2) + m1

    live = num > 0  # padding lanes are all-NaN -> num == 0
    nzmask = (g != 0.0) & live[:, None]
    q_ = jnp.where(live, qtilde, 0.0)
    m1_ = jnp.where(live, m1, 0.0)
    v2_ = jnp.where(live, var2, 1.0)
    gn_ = jnp.where(live[:, None], g_norm, 0.0)
    if cap and cap < G.shape[1]:
        # rare-variant compaction (the device analog of Saddle_Prob_Fast's
        # nonzero-index gather, src/SPATest.cpp:299-374): the CGF loops run
        # over the top-`cap` nonzero lanes only.  Exact when cap >= max nnz
        # of the batch (the caller buckets cap accordingly); lanes beyond
        # cap would fold into the Gaussian remainder.
        keys = jnp.where(nzmask, jnp.abs(gn_), 0.0).astype(jnp.float32)
        _, idx = jax.lax.top_k(keys, cap)                    # [Bs, cap]
        gl = jnp.take_along_axis(gn_, idx, axis=1)
        ml = jnp.take_along_axis(nzmask, idx, axis=1)
        mul = jnp.broadcast_to(model.mu[None, :], gn_.shape)
        mul = jnp.take_along_axis(mul, idx, axis=1)
        # range bounds must still use the FULL vector
        pval, conv = saddle_prob_batch(
            q_, m1_, v2_, gl, mul, ml, cutoff=2.0, mixed=mixed,
            g_bounds=(jnp.sum(jnp.where(gn_ > 0, gn_, 0.0), axis=1),
                      jnp.sum(jnp.where(gn_ < 0, gn_, 0.0), axis=1)))
    else:
        pval, conv = saddle_prob_batch(
            q_, m1_, v2_, gn_, model.mu, nzmask, cutoff=2.0, mixed=mixed)

    beta = (Tstat / var1) / jnp.sqrt(ac2)
    beta = jnp.where(flip, -beta, beta)
    se = jnp.abs(beta / qnorm(pval / 2.0))
    return pval, conv, beta, se


@partial(jax.jit, static_argnames=("params",))
def score_stats_quant(model: ScanModel, params: ScanParams, G):
    """Quantitative-trait score test (no SPA).

    Mirrors ``single_test_quant`` (src/saige_main.cpp:189-276)."""
    g, af, ac, num, mac, maf, miss, flip = prep_dosage(G)
    valid = _valid_mask(params, num, maf, mac, miss)

    g_tilde = _adjusted_genotype(model, g)
    S = jnp.sum(model.y_mu[None, :] * g_tilde, axis=1)
    var2 = jnp.sum(g_tilde * g_tilde, axis=1)
    inv_mac = 1.0 / mac
    inv_sqrt_mac = jnp.sqrt(inv_mac)
    var1 = var2 * inv_mac * variant_var_ratio(model, mac)
    Tstat = S * inv_sqrt_mac / model.tau[0]
    pval = pchisq1_sf(Tstat * Tstat / var1)
    beta = Tstat / var1 * inv_sqrt_mac
    beta = jnp.where(flip, -beta, beta)
    se = jnp.abs(beta / qnorm(pval / 2.0))

    return ScoreStats(valid=valid, af=af, mac=mac, num=num, beta=beta, se=se,
                      pval=pval, need_spa=jnp.zeros_like(valid))
