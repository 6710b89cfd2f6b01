"""PheWAS-mode batched device fit: P phenotypes over one resident GRM.

Contract: each lane of the batched fit matches its
serial `fit_glmm_binary_device` to 1e-10 — the batching stacks RHS columns
into one PCG (per-column weights/tau, ops/pcg.py) so lane arithmetic is
the serial fit's.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from saigegds_tpu.models.fit_device import (fit_glmm_binary_device,
                                            fit_glmm_binary_device_multi)
from saigegds_tpu.models.glm import glm_binomial
from saigegds_tpu.ops.packed_grm import build_packed_grm


def _make_problem(P=3, n=400, m=150, seed=5):
    rng = np.random.default_rng(seed)
    af = rng.uniform(0.1, 0.5, size=(m, 1))
    codes = rng.binomial(2, af, size=(m, n)).astype(np.int8)
    grm = build_packed_grm(codes)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, 2))])
    U = rng.choice([-1.0, 1.0], size=(n, 40))
    Ys, etas = [], []
    for _ in range(P):
        eta_t = X @ (rng.normal(size=3) * 0.4) - 1.0
        y = (rng.random(n) < 1 / (1 + np.exp(-eta_t))).astype(np.float64)
        f0 = glm_binomial(X, y)
        Ys.append(y)
        etas.append(f0.linear_predictors)
    return grm, X, U, np.stack(Ys), np.stack(etas)


def test_multi_matches_serial_1e10():
    grm, X, U, Y, E = _make_problem()
    P = Y.shape[0]
    tau0 = jnp.broadcast_to(jnp.asarray([1.0, 0.5]), (P, 2))
    multi = fit_glmm_binary_device_multi(
        grm, jnp.asarray(Y), jnp.asarray(X), tau0, jnp.asarray(E),
        jnp.asarray(U), 0.02, 1e-5)
    assert multi.tau.shape == (P, 2)
    assert multi.converged.shape == (P,)
    for p in range(P):
        s = fit_glmm_binary_device(
            grm, jnp.asarray(Y[p]), jnp.asarray(X),
            jnp.asarray([1.0, 0.5]), jnp.asarray(E[p]), jnp.asarray(U),
            0.02, 1e-5)
        assert bool(multi.converged[p]) == bool(s.converged)
        assert int(multi.iterations[p]) == int(s.iterations)
        np.testing.assert_allclose(np.asarray(multi.tau[p]),
                                   np.asarray(s.tau), atol=1e-10, rtol=0)
        np.testing.assert_allclose(np.asarray(multi.mu[p]),
                                   np.asarray(s.mu), atol=1e-10, rtol=0)
        np.testing.assert_allclose(np.asarray(multi.coefficients[p]),
                                   np.asarray(s.coefficients),
                                   atol=1e-10, rtol=0)
        np.testing.assert_allclose(np.asarray(multi.cov[p]),
                                   np.asarray(s.cov), atol=1e-10, rtol=0)


def test_multi_heterogeneous_tau_init():
    """Per-lane tau_init: lanes follow their own trajectory."""
    grm, X, U, Y, E = _make_problem(P=2, seed=9)
    tau0 = jnp.asarray([[1.0, 0.5], [1.0, 0.1]])
    multi = fit_glmm_binary_device_multi(
        grm, jnp.asarray(Y), jnp.asarray(X), tau0, jnp.asarray(E),
        jnp.asarray(U), 0.02, 1e-5)
    for p, t1 in enumerate([0.5, 0.1]):
        s = fit_glmm_binary_device(
            grm, jnp.asarray(Y[p]), jnp.asarray(X),
            jnp.asarray([1.0, t1]), jnp.asarray(E[p]), jnp.asarray(U),
            0.02, 1e-5)
        np.testing.assert_allclose(np.asarray(multi.tau[p]),
                                   np.asarray(s.tau), atol=1e-10, rtol=0)


def test_trace_capped_flag():
    """A tiny probe pool with an unreachable CV cutoff must set
    trace_capped;
    a loose cutoff must leave it unset."""
    grm, X, U, Y, E = _make_problem(P=1, seed=11)
    tiny = fit_glmm_binary_device(
        grm, jnp.asarray(Y[0]), jnp.asarray(X), jnp.asarray([1.0, 0.5]),
        jnp.asarray(E[0]), jnp.asarray(U[:, :12]), 0.02, 1e-5,
        nrun=10, trace_cv_cutoff=1e-12)
    assert bool(tiny.trace_capped)
    loose = fit_glmm_binary_device(
        grm, jnp.asarray(Y[0]), jnp.asarray(X), jnp.asarray([1.0, 0.5]),
        jnp.asarray(E[0]), jnp.asarray(U), 0.02, 1e-5,
        nrun=30, trace_cv_cutoff=1e9)
    assert not bool(loose.trace_capped)
    # the multi fit carries the flag per lane
    multi = fit_glmm_binary_device_multi(
        grm, jnp.asarray(Y), jnp.asarray(X),
        jnp.asarray([[1.0, 0.5]]), jnp.asarray(E),
        jnp.asarray(U[:, :12]), 0.02, 1e-5,
        nrun=10, trace_cv_cutoff=1e-12)
    assert multi.trace_capped.shape == (1,)
    assert bool(multi.trace_capped[0])


def test_quant_trace_capped_flag():
    from saigegds_tpu.models.fit_device import fit_glmm_quant_device
    rng = np.random.default_rng(3)
    n, m = 300, 100
    codes = rng.binomial(2, rng.uniform(0.1, 0.5, size=(m, 1)),
                         size=(m, n)).astype(np.int8)
    grm = build_packed_grm(codes)
    X = np.column_stack([np.ones(n), rng.normal(size=n)])
    y = rng.normal(size=n)
    U = rng.choice([-1.0, 1.0], size=(n, 12))
    tau0 = np.var(y, ddof=1) * np.array([0.5, 0.5])
    out = fit_glmm_quant_device(grm, jnp.asarray(y), jnp.asarray(X),
                                jnp.asarray(tau0), jnp.asarray(U),
                                0.02, 1e-5, nrun=10,
                                trace_cv_cutoff=1e-12)
    assert bool(out.trace_capped)


def test_quant_multi_matches_serial():
    """Quantitative PheWAS fit: each lane matches its serial
    fit_glmm_quant_device to 1e-10."""
    from saigegds_tpu.models.fit_device import (fit_glmm_quant_device,
                                                fit_glmm_quant_device_multi)
    rng = np.random.default_rng(17)
    n, m, P = 400, 150, 3
    codes = rng.binomial(2, rng.uniform(0.1, 0.5, size=(m, 1)),
                         size=(m, n)).astype(np.int8)
    grm = build_packed_grm(codes)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, 2))])
    U = rng.choice([-1.0, 1.0], size=(n, 40))
    Y = np.stack([X @ (rng.normal(size=3) * 0.4) + rng.normal(size=n)
                  for _ in range(P)])
    tau0 = np.stack([np.var(Y[p], ddof=1) * np.array([0.5, 0.5])
                     for p in range(P)])
    multi = fit_glmm_quant_device_multi(
        grm, jnp.asarray(Y), jnp.asarray(X), jnp.asarray(tau0),
        jnp.asarray(U), 0.02, 1e-5)
    assert multi.tau.shape == (P, 2)
    for p in range(P):
        s = fit_glmm_quant_device(
            grm, jnp.asarray(Y[p]), jnp.asarray(X), jnp.asarray(tau0[p]),
            jnp.asarray(U), 0.02, 1e-5)
        assert bool(multi.converged[p]) == bool(s.converged)
        np.testing.assert_allclose(np.asarray(multi.tau[p]),
                                   np.asarray(s.tau), atol=1e-10, rtol=0)
        np.testing.assert_allclose(np.asarray(multi.eta[p]),
                                   np.asarray(s.eta), atol=1e-10, rtol=0)
        np.testing.assert_allclose(np.asarray(multi.coefficients[p]),
                                   np.asarray(s.coefficients),
                                   atol=1e-10, rtol=0)
