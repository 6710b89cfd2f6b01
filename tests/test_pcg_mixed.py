"""Mixed-precision PCG (f32 inner state + exact-f64 refinement).

The opt-in tier for the 2%-stopping device fit, for devices where f64
elementwise state updates cost far more than f32 ones.  Solutions must
stay f64-grade (the refinement
recombines true residuals with the exact matvec), so the tier is a
drop-in for ``pcg_solve_op`` wherever bit-replay is not required.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from saigegds_tpu.ops.packed_grm import build_packed2_grm, build_packed_grm
from saigegds_tpu.ops.pcg import pcg_solve_mixed, pcg_solve_op


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    M, N = 512, 1500
    codes = rng.binomial(2, rng.uniform(0.05, 0.5, (M, 1)),
                         size=(M, N)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.01] = 3
    grm = build_packed2_grm(codes)
    W = rng.uniform(0.05, 0.25, N)
    tau = np.array([1.0, 0.4])
    B = rng.normal(size=(N, 7)) * np.array([1.0, 1e3, 1e-3, 1, 1, 1, 1])
    return grm, W, tau, B


def test_matvec32_accuracy(problem):
    grm, _W, _tau, B = problem
    want = np.asarray(grm.matvec(jnp.asarray(B)))
    got = np.asarray(grm.matvec32(jnp.asarray(B, jnp.float32)))
    rel = np.abs(got - want) / (np.abs(want).max(axis=0) + 1e-30)
    assert rel.max() < 1e-5, rel.max()
    assert got.dtype == np.float32


def test_mixed_matches_exact_solution(problem):
    grm, W, tau, B = problem
    tol = 1e-5
    Xe, _it, conv_e = pcg_solve_op(grm, jnp.asarray(W), jnp.asarray(tau),
                                   jnp.asarray(B), tol, 500)
    Xm, _itm, conv_m = pcg_solve_mixed(grm, jnp.asarray(W),
                                       jnp.asarray(tau), jnp.asarray(B),
                                       tol, 500)
    assert bool(np.asarray(conv_e).all()) and bool(np.asarray(conv_m).all())
    Xe, Xm = np.asarray(Xe), np.asarray(Xm)
    # both satisfy the same absolute residual stop; solutions agree to
    # solver precision relative to each column's scale
    rel = np.abs(Xm - Xe) / (np.abs(Xe).max(axis=0) + 1e-30)
    assert rel.max() < 1e-5, rel.max()
    # and the mixed solution's TRUE f64 residual meets the contract
    inv_w = 1.0 / W
    r = B - (tau[0] * inv_w[:, None] * Xm +
             tau[1] * np.asarray(grm.matvec(jnp.asarray(Xm))))
    assert (np.sum(r * r, axis=0) <= tol * 1.0001).all()


def test_mixed_1d_and_generic_op(problem):
    """1-D RHS squeeze + the cast fallback for ops without matvec32."""
    grm, W, tau, B = problem
    x1, _, c1 = pcg_solve_mixed(grm, jnp.asarray(W), jnp.asarray(tau),
                                jnp.asarray(B[:, 0]), 1e-5, 500)
    assert x1.ndim == 1 and bool(c1)

    rng = np.random.default_rng(0)
    codes = rng.binomial(2, 0.3, size=(128, B.shape[0])).astype(np.int8)
    pg = build_packed_grm(codes)        # bf16 store: no matvec32 attr
    xg, _, cg = pcg_solve_mixed(pg, jnp.asarray(W), jnp.asarray(tau),
                                jnp.asarray(B), 1e-5, 500)
    xe, _, ce = pcg_solve_op(pg, jnp.asarray(W), jnp.asarray(tau),
                             jnp.asarray(B), 1e-5, 500)
    rel = np.abs(np.asarray(xg) - np.asarray(xe)) / \
        (np.abs(np.asarray(xe)).max(axis=0) + 1e-30)
    assert bool(np.asarray(cg).all()) and rel.max() < 1e-5


def test_device_fit_mixed_parity(problem):
    """fit_glmm_binary_device(pcg="mixed") ~ the exact fit at ~1e-6."""
    from saigegds_tpu.models.fit_device import fit_glmm_binary_device

    grm, _W, _tau, _B = problem
    N = grm.n_samples
    rng = np.random.default_rng(5)
    X = np.column_stack([np.ones(N), rng.normal(size=(N, 2))])
    eta_true = X @ np.array([-0.7, 0.3, -0.2])
    y = (rng.random(N) < 1 / (1 + np.exp(-eta_true))).astype(np.float64)
    U = rng.choice([-1.0, 1.0], size=(N, 40))
    args = (grm, jnp.asarray(y), jnp.asarray(X), jnp.asarray([1.0, 0.5]),
            jnp.asarray(eta_true), jnp.asarray(U), 0.02, 1e-5)
    fe = fit_glmm_binary_device(*args)
    fm = fit_glmm_binary_device(*args, pcg="mixed")
    assert bool(fe.converged) and bool(fm.converged)
    np.testing.assert_allclose(np.asarray(fm.tau), np.asarray(fe.tau),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(fm.coefficients),
                               np.asarray(fe.coefficients),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(fm.eta), np.asarray(fe.eta),
                               rtol=0, atol=1e-5)
