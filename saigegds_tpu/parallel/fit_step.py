"""One fully-jitted, sample-sharded GLMM training step.

The host-driven fitter (``models/fitnull.py``) dispatches one device kernel
per PCG solve — fine for the latency-tolerant outer loop on one chip.  This
module demonstrates one outer iteration (a SINGLE damped inner-IRLS step +
Hutchinson trace + AI-REML tau update) as one jitted program over a
``jax.sharding.Mesh``.  NOTE: the faithful whole-fit device program —
inner IRLS iterated to tolerance, AI score from the converged working
response, per-iteration retry semantics — is ``models/fit_device.py``;
this step trades those for a minimal sharding blueprint:

* ``std_geno [M, N]``, working vectors ``[N]``, design ``X [N, K]`` and
  probes ``U [N, R]`` are sharded on the sample axis;
* every ``G_std @ v`` contraction produces variant-local partials and XLA
  inserts one ``psum`` over the mesh axis per GRM product — the collective
  equivalent of the reference's per-thread accumulator + tree reduce
  (src/saige_fitnull.cpp:521-535);
* scalars (tau, alpha, AI score) come out replicated.

Rademacher probes are an *input* (drawn host-side so the R-RNG replay of
``models/fitnull.py`` stays available), keeping the step a pure function.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.pcg import pcg_solve


class FitStepOut(NamedTuple):
    alpha: jnp.ndarray    # [K] coefficients
    tau: jnp.ndarray      # [2] updated variance components
    eta: jnp.ndarray      # [N] linear predictor (sample-sharded)
    mu: jnp.ndarray       # [N] fitted values
    yapy: jnp.ndarray     # [] YPAPY
    trace: jnp.ndarray    # [] trace(P*GRM) estimate
    ai: jnp.ndarray       # [] average information


def _sym_inv(m):
    """inv via Cholesky of the symmetrized matrix (src/saige_fitnull.cpp:721).

    Triangular solve instead of jnp.linalg.inv, like the reference."""
    ms = (m + m.T) / 2.0
    c = jnp.linalg.cholesky(ms)
    inv_c = jax.scipy.linalg.solve_triangular(
        c, jnp.eye(m.shape[0], dtype=m.dtype), lower=True)
    return inv_c.T @ inv_c


@partial(jax.jit, static_argnames=("maxiter_pcg",), donate_argnums=())
def glmm_fit_step_binary(std_geno, diag_grm, y, X, tau, eta, U,
                         tol_pcg, maxiter_pcg: int):
    """One outer AI-REML iteration for the binary-trait null GLMM.

    std_geno [M, N], diag_grm [N], y [N], X [N, K], tau [2], eta [N],
    U [N, R] Rademacher probes.  Returns FitStepOut.
    """
    M = std_geno.shape[0]
    tau0 = tau

    # -- inner IRLS step (get_coeff, src/saige_fitnull.cpp:766-813) --
    mu = jax.nn.sigmoid(eta)
    mu2 = mu * (1.0 - mu)
    Y = eta + (y - mu) / mu2
    W = mu2

    K = X.shape[1]
    B = jnp.concatenate([Y[:, None], X, U], axis=1)
    sol, _, _ = pcg_solve(std_geno, diag_grm, W, tau0, B, tol_pcg, maxiter_pcg)
    Si_Y, Si_X, Si_U = sol[:, 0], sol[:, 1:1 + K], sol[:, 1 + K:]

    cov = _sym_inv(X.T @ Si_X)
    alpha = cov @ (Si_X.T @ Y)
    eta1 = Y - tau0[0] * (Si_Y - Si_X @ alpha) / W
    mu1 = jax.nn.sigmoid(eta1)

    # -- AI score (get_AI_score, src/saige_fitnull.cpp:816-857) --
    PY = Si_Y - Si_X @ (cov @ (Si_X.T @ Y))
    APY = (std_geno.T @ (std_geno @ PY)) / M
    YPAPY = PY @ APY

    # Hutchinson trace over the R probes
    PU = Si_U - Si_X @ (cov @ (Si_X.T @ U))
    AU = (std_geno.T @ (std_geno @ U)) / M
    trace = jnp.mean(jnp.sum(AU * PU, axis=0))

    Si_APY, _, _ = pcg_solve(std_geno, diag_grm, W, tau0, APY[:, None],
                             tol_pcg, maxiter_pcg)
    PAPY = Si_APY[:, 0] - Si_X @ (cov @ (Si_X.T @ Si_APY[:, 0]))
    AI = APY @ PAPY

    # -- tau Newton step with non-negativity (fitglmmaiRPCG, :860-890);
    # sub-tol values clamp to 0 like the reference (:877-885) --
    score = YPAPY - trace
    dtau = score / AI
    tau1 = jnp.maximum(tau0[1] + dtau, 0.0)
    tau1 = jnp.where(tau1 < 0.02, 0.0, tau1)
    tau_new = jnp.stack([tau0[0], tau1])

    return FitStepOut(alpha=alpha, tau=tau_new, eta=eta1, mu=mu1,
                      yapy=YPAPY, trace=trace, ai=AI)


def shard_fit_step(mesh: Mesh, axis: str = "data"):
    """Jit the training step with explicit sample-axis shardings over mesh.

    Returns (step_fn, put) where ``put(std_geno, diag, y, X, tau, eta, U)``
    places the operands with their shardings and ``step_fn(...)`` runs one
    sharded iteration.
    """
    samp_mat = NamedSharding(mesh, P(None, axis))   # [M, N]
    samp_vec = NamedSharding(mesh, P(axis))         # [N]
    samp_cols = NamedSharding(mesh, P(axis, None))  # [N, K] / [N, R]
    repl = NamedSharding(mesh, P())

    def put(std_geno, diag_grm, y, X, tau, eta, U):
        return (jax.device_put(std_geno, samp_mat),
                jax.device_put(diag_grm, samp_vec),
                jax.device_put(y, samp_vec),
                jax.device_put(X, samp_cols),
                jax.device_put(tau, repl),
                jax.device_put(eta, samp_vec),
                jax.device_put(U, samp_cols))

    return glmm_fit_step_binary, put
