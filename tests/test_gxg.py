"""GxG interaction test checks (no reference fixture exists; validated by
internal consistency with the fitting machinery)."""

import numpy as np
import pandas as pd
import pytest

from saigegds_tpu.assoc.gxg import gxg_spa, _minor_allele_geno
from saigegds_tpu.config import NullModelConfig

GDS = "/root/reference/inst/extdata/grm1k_10k_snp.gds"


@pytest.fixture(scope="module")
def pheno():
    return pd.read_csv("/root/reference/inst/extdata/pheno.txt.gz", sep="\t")


def test_minor_allele_geno():
    g = np.array([2.0, 2.0, 1.0, np.nan])
    out = _minor_allele_geno(g)
    # mean-impute (5/3), then af > 1 -> flip
    assert out[3] == pytest.approx(2 - 5 / 3)
    assert out[0] == 0.0 and out[2] == 1.0


@pytest.fixture(scope="module")
def result(pheno):
    pairs = pd.DataFrame({"snp1": [100], "snp2": [200]})
    return gxg_spa("y ~ x1 + x2", pheno, GDS, pairs)


def test_gxg_columns(result):
    assert list(result.columns) == ["id1", "snp1", "maf1", "id2", "snp2",
                                    "maf2", "beta", "SE", "n_nonzero", "pval",
                                    "p.norm", "converged", "tau_G"]


def test_gxg_values_sane(result):
    row = result.iloc[0]
    assert 0 < row["pval"] <= 1
    assert row["n_nonzero"] > 0
    assert 0 < row["tau_G"] < 1
    assert row["converged"]


def test_gxg_approx_tau_uses_global_tau(pheno):
    pairs = pd.DataFrame({"snp1": [100], "snp2": [200]})
    out = gxg_spa("y ~ x1 + x2", pheno, GDS, pairs, use_approx_tau=True)
    # the pre-fitted null tau_G on this data is 0.3322 (reference fixture)
    assert out["tau_G"].iloc[0] == pytest.approx(0.33220629, abs=1e-6)


def test_gxg_quant_unimplemented(pheno):
    pairs = pd.DataFrame({"snp1": [100], "snp2": [200]})
    with pytest.raises(NotImplementedError):
        gxg_spa("yy ~ x1 + x2", pheno, GDS, pairs,
                config=NullModelConfig(trait_type="quantitative"))


def test_gxg_glm_threshold_screen(pheno):
    """glm_threshold screens pairs with a plain-GLM p-value first
    (R/saige_interaction.r:496-516): p.glm columns appear, and pairs
    failing the screen skip the GLMM refit (pval == NaN or from GLM)."""
    pairs = pd.DataFrame({"id1": [1, 3], "id2": [2, 4]})
    out = gxg_spa("y ~ x1 + x2", pheno, GDS, pairs, glm_threshold=0.99)
    assert "p.glm" in out.columns and "p.glm.norm" in out.columns
    assert len(out) == 2
    assert np.isfinite(out["p.glm"]).all()
    # with an impossible threshold no pair runs the GLMM
    out2 = gxg_spa("y ~ x1 + x2", pheno, GDS, pairs, glm_threshold=1e-30)
    assert not np.isfinite(out2["pval"]).any() or \
        (out2["pval"] == out2["p.glm"]).all()


@pytest.fixture(scope="module")
def pair_df():
    """Pairs of common SNPs (the serial reference path divides by zero on
    degenerate all-zero interactions, so pick maf > 0.2 variants)."""
    from saigegds_tpu.io.seqarray import SeqData

    seq = SeqData(GDS)
    codes = seq.code_matrix()[:3000].astype(float)
    codes[codes == 3] = np.nan
    af = np.nanmean(codes, axis=1) / 2.0
    maf = np.minimum(af, 1 - af)
    common = seq.variant_id[:3000][maf > 0.2]
    rng = np.random.default_rng(5)
    pick = rng.choice(common, size=16, replace=False)
    return pd.DataFrame({"snp1": pick[:8], "snp2": pick[8:]})


def test_gxg_batched_approx_tau_equals_serial(pheno, pair_df):
    """pair_batch with use_approx_tau: identical numbers to the serial
    per-pair loop (one shared per-column-weight PCG + one batched SPA)."""
    cfg = NullModelConfig(trait_type="binary", max_num_snp=2000)
    serial = gxg_spa("y ~ x1 + x2", pheno, GDS, pair_df, config=cfg,
                     use_approx_tau=True)
    batched = gxg_spa("y ~ x1 + x2", pheno, GDS, pair_df, config=cfg,
                      use_approx_tau=True, pair_batch=8)
    assert list(batched.columns) == list(serial.columns)
    for c in ("beta", "SE", "pval", "p.norm", "tau_G", "maf1", "maf2"):
        np.testing.assert_allclose(batched[c].to_numpy(),
                                   serial[c].to_numpy(), rtol=1e-9,
                                   err_msg=c)
    np.testing.assert_array_equal(batched["n_nonzero"], serial["n_nonzero"])


def test_gxg_batched_glm_screen_equals_serial(pheno, pair_df):
    cfg = NullModelConfig(trait_type="binary", max_num_snp=2000)
    serial = gxg_spa("y ~ x1 + x2", pheno, GDS, pair_df, config=cfg,
                     use_approx_tau=True, glm_threshold=0.5)
    batched = gxg_spa("y ~ x1 + x2", pheno, GDS, pair_df, config=cfg,
                      use_approx_tau=True, glm_threshold=0.5, pair_batch=4)
    assert list(batched.columns) == list(serial.columns)
    for c in ("p.glm", "p.glm.norm", "pval", "beta"):
        a = batched[c].to_numpy()
        s = serial[c].to_numpy()
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(s))
        m = np.isfinite(a)
        np.testing.assert_allclose(a[m], s[m], rtol=1e-9, err_msg=c)


def test_gxg_batched_full_refit_close(pheno, pair_df):
    """Full per-pair refit: batched (vmapped device fit) tracks the serial
    host refit within the AI-REML stopping tolerance."""
    # dense operator: the vmapped device fit's batched f64 dots run on
    # every backend (the CPU takes the per-pair fallback for the packed
    # bf16 operator, covered implicitly)
    cfg = NullModelConfig(trait_type="binary", max_num_snp=2000,
                          grm_impl="dense")
    pairs = pair_df.iloc[:3]
    serial = gxg_spa("y ~ x1 + x2", pheno, GDS, pairs, config=cfg)
    batched = gxg_spa("y ~ x1 + x2", pheno, GDS, pairs, config=cfg,
                      pair_batch=4)
    for a, s in zip(batched["tau_G"], serial["tau_G"]):
        # each run stops within tol=0.02 of the optimum, so two
        # independent runs can differ by up to ~2x tol
        assert abs(a - s) / (abs(a) + abs(s) + 0.02) < 0.04, (a, s)
    # p-values respond smoothly to tau near the optimum
    np.testing.assert_allclose(batched["pval"].to_numpy(),
                               serial["pval"].to_numpy(), rtol=0.1)


# ---------------------------------------------------------------------------
# Independent oracles: the GxG statistic is pinned
# against from-scratch dense linear algebra + a scipy-brentq saddlepoint,
# not just internal consistency.

def _oracle_spa_pval(q, m1, var2, g, mu):
    """From-scratch two-sided SPA (Kuonen/BN formula, brentq root-find) —
    shares NO code with ops/spa.py."""
    from scipy.optimize import brentq
    from scipy.stats import norm

    stat = abs(q - m1) / np.sqrt(var2)
    if stat < 2.0:
        from scipy.stats import chi2
        return chi2.sf(stat * stat, 1)

    def K(t):
        return np.log1p(mu * np.expm1(g * t)).sum()

    def K1(t):
        e = np.exp(-g * t)
        return (mu * g / ((1 - mu) * e + mu)).sum()

    def K2(t):
        e = np.exp(-g * t)
        d = (1 - mu) * e + mu
        return ((1 - mu) * mu * g * g * e / (d * d)).sum()

    def one_side(qq):
        lo, hi = -1.0, 1.0
        while K1(lo) > qq:
            lo *= 2
        while K1(hi) < qq:
            hi *= 2
        t = brentq(lambda t: K1(t) - qq, lo, hi, xtol=1e-14)
        if abs(t) < 1e-12:
            return 0.5
        w = np.sign(t) * np.sqrt(2 * (t * qq - K(t)))
        v = t * np.sqrt(K2(t))
        z = w + np.log(v / w) / w
        return abs(norm.sf(z) if z > 0 else -norm.sf(-z))

    return one_side(q) + one_side(2 * m1 - q)


def _oracle_irls(X, y, maxit=50):
    """Plain-numpy logistic IRLS (no repo code, no statsmodels)."""
    beta = np.zeros(X.shape[1])
    for _ in range(maxit):
        eta = X @ beta
        mu = 1.0 / (1.0 + np.exp(-eta))
        W = mu * (1.0 - mu)
        z = eta + (y - mu) / W
        beta_new = np.linalg.solve(X.T @ (X * W[:, None]), X.T @ (W * z))
        if np.max(np.abs(beta_new - beta)) < 1e-12:
            beta = beta_new
            break
        beta = beta_new
    mu = 1.0 / (1.0 + np.exp(-(X @ beta)))
    return mu


def _gxg_inputs(pheno, i1=100, i2=200):
    from saigegds_tpu.io.seqarray import SeqData
    from saigegds_tpu.models.glm import (glm_binomial, obj_nok_binary,
                                         qr_transform)

    seq = SeqData(GDS)
    y = pheno["y"].to_numpy(float)
    g1 = _minor_allele_geno(seq.dosage_block(i1, i1 + 1)[0])
    g2 = _minor_allele_geno(seq.dosage_block(i2, i2 + 1)[0])
    X = np.column_stack([np.ones(len(y)), pheno["x1"], pheno["x2"], g1, g2])
    X_new, _, _ = qr_transform(X)
    fit0 = glm_binomial(X_new, y)
    nok = obj_nok_binary(X_new, y)
    return X, X_new, y, g1, g2, fit0, nok


def test_gxg_glm_limit_matches_classic_score(pheno):
    """tau=(1,0): the GxG statistic must equal the classic logistic score
    test of g1*g2 given covariates [1,x1,x2,g1,g2], computed from scratch
    (IRLS + dense score variance; the GRM drops out entirely)."""
    import types

    from scipy.stats import chi2

    from saigegds_tpu.assoc.gxg import _gxg_stat
    from saigegds_tpu.io.seqarray import SeqData
    from saigegds_tpu.ops.grm import build_grm

    X, X_new, y, g1, g2, fit0, nok = _gxg_inputs(pheno)
    seq = SeqData(GDS)
    codes = seq.code_matrix()[:512]
    grm = build_grm(np.asarray(codes, np.int8))
    cfg = NullModelConfig(trait_type="binary")
    out = _gxg_stat(grm, fit0, types.SimpleNamespace(tau=np.array([1.0, 0.0])),
                    nok, g1 * g2, cfg)

    # oracle: from-scratch IRLS + classic score test U^2 / V
    mu = _oracle_irls(X, y)
    G0 = g1 * g2
    W = mu * (1 - mu)
    U = G0 @ (y - mu)
    WX = X * W[:, None]
    V = G0 @ (W * G0) - (G0 @ WX) @ np.linalg.solve(X.T @ WX, WX.T @ G0)
    np.testing.assert_allclose(out["p.norm"], chi2.sf(U * U / V, 1),
                               rtol=2e-4)
    np.testing.assert_allclose(out["beta"], U / V, rtol=2e-4)


def test_gxg_stat_dense_sigma_oracle(pheno):
    """tau with a genetic component: var1 from the PCG solves must match a
    dense Sigma^{-1} computation (np.linalg.solve), and the SPA p-value a
    scipy-brentq saddlepoint."""
    import types

    from saigegds_tpu.assoc.gxg import _gxg_stat
    from saigegds_tpu.io.seqarray import SeqData
    from saigegds_tpu.ops.grm import build_grm

    X, X_new, y, g1, g2, fit0, nok = _gxg_inputs(pheno)
    seq = SeqData(GDS)
    codes = seq.code_matrix()[:512]
    grm = build_grm(np.asarray(codes, np.int8))
    tau = np.array([0.8, 0.4])
    cfg = NullModelConfig(trait_type="binary", tol_pcg=1e-7)
    out = _gxg_stat(grm, fit0, types.SimpleNamespace(tau=tau), nok,
                    g1 * g2, cfg)

    import jax.numpy as jnp
    N = len(y)
    GRM = np.asarray(grm.matmat(jnp.eye(N)))
    mu = fit0.fitted_values
    W = mu * (1 - mu)
    Sigma = tau[0] * np.diag(1.0 / W) + tau[1] * GRM
    G0 = g1 * g2
    G = G0 - nok.XXVX_inv @ (nok.XV @ G0)
    X1 = nok.X1
    Si_G = np.linalg.solve(Sigma, G)
    Si_X = np.linalg.solve(Sigma, X1)
    var1 = G @ Si_G - (G @ Si_X) @ np.linalg.solve(X1.T @ Si_X, X1.T @ Si_G)
    S = (y - mu) @ G
    np.testing.assert_allclose(S / var1, out["beta"], rtol=1e-5)

    var2 = (mu * (1 - mu)) @ (G * G)
    q = y @ G
    m1 = mu @ G
    qtilde = (q - m1) / np.sqrt(var1) * np.sqrt(var2) + m1
    p_oracle = _oracle_spa_pval(qtilde, m1, var2, G, mu)
    np.testing.assert_allclose(out["pval"], p_oracle, rtol=1e-5)
