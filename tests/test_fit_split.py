"""Bounded-program split fit: SplitPacked2 handle + host-driven PCG +
fit_glmm_binary_split vs the one-dispatch device fit.

The largest compiled program is one leaf group, independent of total M,
so results must match the monolithic paths wherever both run.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from saigegds_tpu.ops.packed_grm import (SplitPacked2, build_packed2_grm)
from saigegds_tpu.ops.pcg import (pcg_host, pcg_host_mixed, pcg_solve_op)


@pytest.fixture(scope="module")
def problem():
    import saigegds_tpu.ops.packed_grm as m
    rng = np.random.default_rng(21)
    M, N = 600, 1800
    codes = rng.binomial(2, rng.uniform(0.05, 0.5, (M, 1)),
                         size=(M, N)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.01] = 3
    orig_rows, orig_tile = m._leaf_rows, m._TILE_COLS
    try:
        m._leaf_rows = lambda N4: 128      # 600 rows -> 5 leaves
        m._TILE_COLS = 256                 # 450 bytes -> 2 column tiles
        grm = m.build_packed2_grm(codes)
    finally:
        m._leaf_rows, m._TILE_COLS = orig_rows, orig_tile
    W = rng.uniform(0.05, 0.25, N)
    tau = np.array([1.0, 0.4])
    B = rng.normal(size=(N, 5))
    return codes, grm, W, tau, B


def test_split_mv_matches_monolithic(problem):
    codes, grm, _W, _tau, B = problem
    want = np.asarray(grm.matvec(jnp.asarray(B)))
    for gl in (1, 2, 5):
        h = SplitPacked2(grm, group_leaves=gl)
        assert len(h.groups) == -(-5 // gl)
        got = np.asarray(h.mv(jnp.asarray(B)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=f"group_leaves={gl}")
    # f32 tier
    h = SplitPacked2(grm, group_leaves=2)
    g32 = np.asarray(h.mv(jnp.asarray(B, jnp.float32), prec="f32"))
    rel = np.abs(g32 - want) / (np.abs(want).max(axis=0) + 1e-30)
    assert rel.max() < 1e-5


def test_pcg_host_matches_batched(problem):
    _codes, grm, W, tau, B = problem
    h = SplitPacked2(grm, group_leaves=2)
    tol = 1e-5
    Xe, _i, ce = pcg_solve_op(grm, jnp.asarray(W), jnp.asarray(tau),
                              jnp.asarray(B), tol, 500)
    Xh, _ih, ch = pcg_host(h, jnp.asarray(W), jnp.asarray(tau),
                           jnp.asarray(B), tol, 500, prec="f64",
                           check_every=8)
    Xm, _im, cm = pcg_host_mixed(h, jnp.asarray(W), jnp.asarray(tau),
                                 jnp.asarray(B), tol, 500)
    assert bool(np.asarray(ce).all()) and bool(np.asarray(ch).all()) \
        and bool(np.asarray(cm).all())
    Xe = np.asarray(Xe)
    scale = np.abs(Xe).max(axis=0) + 1e-30
    assert (np.abs(np.asarray(Xh) - Xe) / scale).max() < 1e-8
    assert (np.abs(np.asarray(Xm) - Xe) / scale).max() < 1e-5


def test_split_fit_matches_device_fit(problem):
    from saigegds_tpu.models.fit_device import fit_glmm_binary_device
    from saigegds_tpu.models.fit_split import fit_glmm_binary_split

    _codes, grm, _W, _tau, _B = problem
    N = grm.n_samples
    rng = np.random.default_rng(9)
    X = np.column_stack([np.ones(N), rng.normal(size=(N, 2))])
    eta_true = X @ np.array([-0.8, 0.25, -0.15])
    y = (rng.random(N) < 1 / (1 + np.exp(-eta_true))).astype(np.float64)
    U = rng.choice([-1.0, 1.0], size=(N, 40))
    fd = fit_glmm_binary_device(
        grm, jnp.asarray(y), jnp.asarray(X), jnp.asarray([1.0, 0.5]),
        jnp.asarray(eta_true), jnp.asarray(U), 0.02, 1e-5)
    h = SplitPacked2(grm, group_leaves=2)
    for pcg in ("exact", "mixed"):
        fs = fit_glmm_binary_split(
            h, y, X, np.array([1.0, 0.5]), eta_true, U,
            tol=0.02, tol_pcg=1e-5, pcg=pcg)
        assert fs.converged and bool(fd.converged)
        np.testing.assert_allclose(fs.tau, np.asarray(fd.tau),
                                   rtol=0, atol=1e-6, err_msg=pcg)
        np.testing.assert_allclose(fs.coefficients,
                                   np.asarray(fd.coefficients),
                                   rtol=0, atol=1e-6, err_msg=pcg)


def test_handle_pcg_interface(problem):
    """The fitter-facing numpy interface (fitnull._pcg duck-typing)."""
    _codes, grm, W, tau, B = problem
    h = SplitPacked2(grm, group_leaves=3)
    assert h.is_grm_handle
    X, conv = h.pcg(W, tau, B, 1e-5, 500)
    assert isinstance(X, np.ndarray) and bool(np.asarray(conv).all())
    from saigegds_tpu.models.fitnull import _grm_mv, _pcg
    mv = _grm_mv(h, B[:, 0])
    np.testing.assert_allclose(
        mv, np.asarray(grm.matvec(jnp.asarray(B[:, 0]))), atol=1e-10)
    Xf = _pcg(h, W, tau, B, 1e-5, 500)
    np.testing.assert_allclose(Xf, X, atol=1e-12)


def test_fit_null_glmm_packed2_split_golden():
    """The production driver with grm_impl="packed2_split" reproduces the
    reference's golden model within the fixture contract (1e-4): the
    host fitter + variance ratio dispatch through the bounded-program
    handle duck-typed."""
    import pandas as pd

    from saigegds_tpu import fit_null_glmm
    from saigegds_tpu.config import NullModelConfig
    from saigegds_tpu.models.nullmodel import NullModel

    data = pd.read_csv("/root/reference/inst/extdata/pheno.txt.gz",
                       sep="\t")
    gold = NullModel.load(
        "/root/reference/inst/unitTests/saige_model.rds")
    m = fit_null_glmm("y ~ x1 + x2", data,
                      "/root/reference/inst/extdata/grm1k_10k_snp.gds",
                      NullModelConfig(grm_impl="packed2_split"))
    np.testing.assert_allclose(np.asarray(m.tau), np.asarray(gold.tau),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(m.coefficients),
                               np.asarray(gold.coefficients),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(m.var_ratio["ratio"]),
                               np.asarray(gold.var_ratio["ratio"]),
                               rtol=0, atol=1e-4)


def test_quant_split_fit_matches_device_fit(problem):
    from saigegds_tpu.models.fit_device import fit_glmm_quant_device
    from saigegds_tpu.models.fit_split import fit_glmm_quant_split

    _codes, grm, _W, _tau, _B = problem
    N = grm.n_samples
    rng = np.random.default_rng(13)
    X = np.column_stack([np.ones(N), rng.normal(size=(N, 2))])
    y = X @ np.array([0.4, -0.2, 0.1]) + rng.normal(size=N)
    U = rng.choice([-1.0, 1.0], size=(N, 40))
    fd = fit_glmm_quant_device(
        grm, jnp.asarray(y), jnp.asarray(X),
        jnp.asarray([0.5, 0.5]), jnp.asarray(U), 0.02, 1e-5)
    h = SplitPacked2(grm, group_leaves=2)
    for pcg in ("exact", "mixed"):
        fs = fit_glmm_quant_split(h, y, X, np.array([0.5, 0.5]), U,
                                  tol=0.02, tol_pcg=1e-5, pcg=pcg)
        assert fs.converged and bool(fd.converged)
        np.testing.assert_allclose(fs.tau, np.asarray(fd.tau),
                                   rtol=0, atol=1e-6, err_msg=pcg)
        np.testing.assert_allclose(fs.coefficients,
                                   np.asarray(fd.coefficients),
                                   rtol=0, atol=1e-6, err_msg=pcg)


def test_fit_null_glmm_multi_split_fallback():
    """PheWAS multi-fit with grm_impl="packed2_split": the one-dispatch
    batched program cannot take a handle, so the driver runs the split
    fitters per phenotype over the shared resident store; lanes must
    stay within the 2%-stopping semantics of the golden model."""
    import pandas as pd

    from saigegds_tpu import fit_null_glmm_multi
    from saigegds_tpu.config import NullModelConfig
    from saigegds_tpu.models.nullmodel import NullModel

    data = pd.read_csv("/root/reference/inst/extdata/pheno.txt.gz",
                       sep="\t")
    data["y2"] = (data["yy"] > data["yy"].median()).astype(float)
    gold = NullModel.load(
        "/root/reference/inst/unitTests/saige_model.rds")
    ms = fit_null_glmm_multi(
        ["y ~ x1 + x2", "y2 ~ x1 + x2"], data,
        "/root/reference/inst/extdata/grm1k_10k_snp.gds",
        NullModelConfig(grm_impl="packed2_split"))
    assert all(m.converged for m in ms)
    d = np.max(np.abs(np.asarray(ms[0].tau) - np.asarray(gold.tau)))
    assert d < 4e-2, d     # device-fit probe-stream semantics
