"""Fully-on-device null-GLMM fit: the whole AI-REML loop in one program.

The host-driven fitter (``fitnull.py``) replays the reference bit-for-bit
but dispatches one device program per PCG solve — on a far-away accelerator
(or a many-host pod where every dispatch synchronizes the fleet) the round
trips dominate.  This module compiles the ENTIRE outer loop — inner IRLS
coefficient iteration, Hutchinson trace, AI-REML tau update, convergence
test — into a single ``lax.while_loop`` program: one dispatch per fit.

Host-path semantics carried over (src/saige_fitnull.cpp):
* first moment-based tau update before the Newton loop (:1024);
* trace-CV escalation (:644-665): the caller passes a probe POOL
  ``U [N, R]``; every probe is solved in the batched PCG (the marginal
  cost of extra RHS columns is negligible next to the GRM stream), and
  the trace estimate uses the first ``r`` probes, escalating ``r += 10``
  until the CV is below ``trace_cv_cutoff`` or the pool is exhausted —
  identical to the host's escalation whenever the pool is big enough;
* tau-blow-up retry (:1039-1066): on ``max(tau) > 1/tol^2`` the
  iteration restarts from its starting state with tau[1] halved, up to
  10 times; the 11th failure sets ``converged=False`` (the host raises).

Remaining deliberate difference: probes come from the caller (replay R's
stream via utils.rrandom for host parity, or use jax.random).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.pcg import pcg_solve_op


class DeviceFit(NamedTuple):
    coefficients: jnp.ndarray   # [K]
    tau: jnp.ndarray            # [2]
    eta: jnp.ndarray            # [N] linear predictor
    mu: jnp.ndarray             # [N] fitted values
    cov: jnp.ndarray            # [K, K]
    iterations: jnp.ndarray     # [] outer iterations taken
    converged: jnp.ndarray      # [] bool
    # True when ANY Hutchinson trace during the fit exhausted the caller's
    # probe pool with its CV still above trace_cv_cutoff — the host path
    # escalates unboundedly (src/saige_fitnull.cpp:644-665) or warns at
    # its opt-in cap (fitnull._get_trace); this flag is the device fit's
    # equivalent signal (a higher-variance trace was used silently before)
    trace_capped: jnp.ndarray = False  # [] bool


def _sym_inv(m):
    # Cholesky + triangular solve, like the reference (saige_fitnull.cpp:721)
    c = jnp.linalg.cholesky((m + m.T) / 2.0)
    ic = jax.scipy.linalg.solve_triangular(
        c, jnp.eye(m.shape[0], dtype=m.dtype), lower=True)
    return ic.T @ ic


def _masked_trace(t_all, nrun, cutoff):
    """Mean of the first r probe estimates, escalating r += 10 while the
    CV (= sd / (mean * r), the reference's calcCV :618-623) exceeds
    ``cutoff`` and the pool has more probes.

    Returns ``(mean, capped)``: ``capped`` is True when the pool ran out
    with the CV still above ``cutoff`` (the estimate is higher-variance
    than the cutoff asked for — surfaced as ``DeviceFit.trace_capped``)."""
    R = t_all.shape[0]
    idx = jnp.arange(R)

    def stats(r):
        mask = (idx < r).astype(t_all.dtype)
        m = jnp.sum(t_all * mask) / r
        var = jnp.sum(((t_all - m) * mask) ** 2) / (r - 1)
        cv = jnp.sqrt(var) / (m * r)
        return m, cv

    def cond(r):
        _, cv = stats(r)
        return (cv > cutoff) & (r + 10 <= R)

    r_fin = jax.lax.while_loop(cond, lambda r: r + 10,
                               jnp.minimum(jnp.asarray(nrun), R))
    mean, cv_fin = stats(r_fin)
    return mean, cv_fin > cutoff


@partial(jax.jit, static_argnames=("maxiter", "maxiter_pcg", "maxiter_coef",
                                   "pcg"))
def fit_glmm_binary_device(op, y, X, tau_init, eta_init, U,
                           tol, tol_pcg,
                           maxiter: int = 20, maxiter_pcg: int = 500,
                           maxiter_coef: int = 20, nrun=30,
                           trace_cv_cutoff=0.0025,
                           pcg: str = "exact") -> DeviceFit:
    """Binary-trait null GLMM fit as one device program.

    op: GRM operator pytree (.matvec/.diag); y [N]; X [N, K]; U [N, R]
    Rademacher probe pool (R >= nrun; extra columns feed the trace-CV
    escalation); tau_init [2]; eta_init [N].

    ``pcg``: "exact" = the f64 batched solver (default); "mixed" = the
    opt-in f32-state + f64-refinement tier (ops/pcg.pcg_solve_mixed) —
    f64-grade solutions with f32 elementwise work per iteration; fit
    agreement with "exact" is ~1e-6 on tau/coefficients
    (the 2%-stopping device-fit semantics, CLAUDE.md invariant 1).
    """
    from ..ops.pcg import pcg_solve_mixed
    solve = pcg_solve_op if pcg == "exact" else pcg_solve_mixed
    N, K = X.shape
    tol_inv_2 = 1.0 / (tol * tol)

    def get_coeff(tau, eta, alpha0):
        """Inner IRLS to coefficient rel-tol 0.1 (get_coeff, :766-813)."""
        def step(carry):
            eta, alpha_prev, _, it = carry
            mu = jax.nn.sigmoid(eta)
            W = mu * (1.0 - mu)
            Y = eta + (y - mu) / W
            B = jnp.concatenate([Y[:, None], X], axis=1)
            sol, _, _ = solve(op, W, tau, B, tol_pcg, maxiter_pcg)
            Si_Y, Si_X = sol[:, 0], sol[:, 1:]
            cov = _sym_inv(X.T @ Si_X)
            alpha = cov @ (Si_X.T @ Y)
            eta1 = Y - tau[0] * (Si_Y - Si_X @ alpha) / W
            return eta1, alpha, (Y, W, cov, Si_Y, Si_X), it + 1

        # fori-style loop with early-exit mask on alpha change
        def body(carry):
            eta, alpha, aux, it, done = carry
            eta1, alpha1, aux1, _ = step((eta, alpha, aux, it))
            delta = jnp.max(jnp.abs(alpha1 - alpha) /
                            (jnp.abs(alpha1) + jnp.abs(alpha) + 0.1))
            done1 = done | (delta < 0.1)
            keep = ~done
            eta_o = jnp.where(keep, eta1, eta)
            alpha_o = jnp.where(keep, alpha1, alpha)
            aux_o = jax.tree_util.tree_map(
                lambda a, b: jnp.where(keep, b, a), aux, aux1)
            return eta_o, alpha_o, aux_o, it + 1, done1

        def wcond(carry):
            *_, it, done = carry
            return (~done) & (it < maxiter_coef)

        mu0 = jax.nn.sigmoid(eta)
        W0 = mu0 * (1.0 - mu0)
        aux0 = (eta, W0, jnp.eye(K), eta, jnp.zeros((N, K)))
        eta1, alpha1, aux, _, _ = jax.lax.while_loop(
            wcond, body, (eta, alpha0, aux0, jnp.zeros((), jnp.int32),
                          jnp.zeros((), bool)))
        Y, W, cov, Si_Y, Si_X = aux
        return eta1, alpha1, Y, W, cov, Si_Y, Si_X

    # GRM @ probes is tau-invariant: stream the GRM over the probe pool
    # ONCE, not per outer iteration (XLA hoists the loop constant)
    AU_const = op.matvec(U)

    def ai_update(tau, Y, W, cov, Si_Y, Si_X, moment):
        """AI-REML tau step with CV-escalated Hutchinson trace (:816-890).

        ``moment=True`` applies the first moment-based update
        tau1 <- max(0, tau1 + tau1^2 (YPAPY - tr)/n) (:1024) instead of
        the Newton step score/AI."""
        proj = lambda v, Siv: Siv - Si_X @ (cov @ (Si_X.T @ v))
        PY = proj(Y, Si_Y)
        APY = op.matvec(PY)
        YPAPY = PY @ APY
        B = jnp.concatenate([APY[:, None], U], axis=1)
        sol, _, _ = solve(op, W, tau, B, tol_pcg, maxiter_pcg)
        PAPY = proj(sol[:, 0], sol[:, 0])
        AI = APY @ PAPY
        Si_U = sol[:, 1:]
        PU = Si_U - Si_X @ (cov @ (Si_X.T @ U))
        trace, capped = _masked_trace(jnp.sum(AU_const * PU, axis=0), nrun,
                                      trace_cv_cutoff)
        score = YPAPY - trace
        # Newton step; sub-tol values clamp to 0 (fitglmmaiRPCG, :860-890)
        t1n = tau[1] + score / AI
        t1n = jnp.where(t1n < tol, 0.0, t1n)
        # moment step (:1024)
        t1m = jnp.maximum(tau[1] + tau[1] ** 2 * score / N, 0.0)
        return jnp.stack([tau[0], jnp.where(moment, t1m, t1n)]), capped

    def outer_body(state):
        tau, eta, alpha, it, retries, done, failed, capped = state
        eta1, alpha1, Y, W, cov, Si_Y, Si_X = get_coeff(tau, eta, alpha)
        tau1, cap1 = ai_update(tau, Y, W, cov, Si_Y, Si_X,
                               jnp.zeros((), bool))
        blow = jnp.max(tau1) > tol_inv_2
        can_retry = blow & (retries < 10)
        fail = blow & (retries >= 10)
        delta = jnp.max(jnp.abs(tau1 - tau) /
                        (jnp.abs(tau1) + jnp.abs(tau) + tol))
        done1 = done | (~blow & ((delta < tol) | (tau1[1] == 0.0))) | fail
        keep = ~done
        # retry restarts the iteration from its starting eta/alpha with
        # tau[1] halved (the host's itry loop, :1039-1066)
        tau_n = jnp.where(can_retry, jnp.stack([tau[0], tau[1] * 0.5]),
                          tau1)
        eta_n = jnp.where(can_retry, eta, eta1)
        alpha_n = jnp.where(can_retry, alpha, alpha1)
        return (jnp.where(keep, tau_n, tau), jnp.where(keep, eta_n, eta),
                jnp.where(keep, alpha_n, alpha),
                it + jnp.where(can_retry, 0, 1),
                # the reference's itry budget is PER ITERATION
                # (src/saige_fitnull.cpp:1039-1066: itry resets each
                # outer iteration); reset once the iteration completes
                jnp.where(can_retry, retries + 1, 0),
                done1, failed | fail, capped | (keep & cap1))

    def outer_cond(state):
        _, _, _, it, _, done, _, _ = state
        return (~done) & (it < maxiter)

    # pre-loop: coefficient solve at tau_init + first moment update (:1024)
    alpha0 = jnp.zeros(K, X.dtype)
    _eta_i, alpha_i, Y, W, cov, Si_Y, Si_X = get_coeff(tau_init, eta_init,
                                                       alpha0)
    tau_m, cap0 = ai_update(tau_init, Y, W, cov, Si_Y, Si_X,
                            jnp.ones((), bool))

    state = (tau_m, eta_init, alpha_i, jnp.zeros((), jnp.int32),
             jnp.zeros((), jnp.int32), jnp.zeros((), bool),
             jnp.zeros((), bool), cap0)
    tau, eta, alpha, iters, _retries, done, failed, capped = \
        jax.lax.while_loop(outer_cond, outer_body, state)

    # final coefficient solve at the converged tau
    eta_f, alpha_f, Y, W, cov, Si_Y, Si_X = get_coeff(tau, eta, alpha)
    mu_f = jax.nn.sigmoid(eta_f)
    return DeviceFit(coefficients=alpha_f, tau=tau, eta=eta_f, mu=mu_f,
                     cov=cov, iterations=iters,
                     converged=done & ~failed, trace_capped=capped)


@partial(jax.jit, static_argnames=("maxiter", "maxiter_pcg"))
def fit_glmm_quant_device(op, y, X, tau_init, U,
                          tol, tol_pcg,
                          maxiter: int = 20,
                          maxiter_pcg: int = 500, nrun=30,
                          trace_cv_cutoff=0.0025) -> DeviceFit:
    """Quantitative-trait (gaussian identity-link) device fit.

    Both variance components are free; the 2x2 average-information system
    mirrors ``get_AI_score_q``/``fitglmmaiRPCG_q``
    (src/saige_fitnull.cpp:893-928).  The gaussian working response equals
    y, so the inner IRLS collapses to a single solve per outer iteration.
    Stops at the reference's 2% relative-change rule — no extra polish,
    so the fit agrees with the host/golden path's stopping point.
    """
    N, K = X.shape

    def coeff(tau):
        W = jnp.ones(N, y.dtype)
        B = jnp.concatenate([y[:, None], X, U], axis=1)
        sol, _, _ = pcg_solve_op(op, W, tau, B, tol_pcg, maxiter_pcg)
        Si_Y, Si_X, Si_U = sol[:, 0], sol[:, 1:1 + K], sol[:, 1 + K:]
        cov = _sym_inv(X.T @ Si_X)
        alpha = cov @ (Si_X.T @ y)
        eta = y - tau[0] * (Si_Y - Si_X @ alpha)
        return alpha, eta, cov, Si_Y, Si_X, Si_U

    AU_const = op.matvec(U)    # tau-invariant: one GRM stream, not per iter

    def traces(Si_X, cov, Si_U):
        """CV-escalated trace(P*GRM) and trace(P) from the probe pool."""
        PU = Si_U - Si_X @ (cov @ (Si_X.T @ U))
        t1 = jnp.sum(AU_const * PU, axis=0)
        t0 = jnp.sum(U * PU, axis=0)
        # shared escalation count: escalate while EITHER CV is above the
        # cutoff (the host loop checks both, fitnull._get_trace)
        R = t1.shape[0]
        idx = jnp.arange(R)

        def stats(t, r):
            mask = (idx < r).astype(t.dtype)
            m = jnp.sum(t * mask) / r
            var = jnp.sum(((t - m) * mask) ** 2) / (r - 1)
            return m, jnp.sqrt(var) / (m * r)

        def cond(r):
            _, cv1 = stats(t1, r)
            _, cv0 = stats(t0, r)
            return (jnp.maximum(cv0, cv1) > trace_cv_cutoff) & (r + 10 <= R)

        r_fin = jax.lax.while_loop(cond, lambda r: r + 10,
                                   jnp.minimum(jnp.asarray(nrun), R))
        m0, cv0 = stats(t0, r_fin)
        m1, cv1 = stats(t1, r_fin)
        return m0, m1, jnp.maximum(cv0, cv1) > trace_cv_cutoff

    def ai_step(tau):
        alpha, eta, cov, Si_Y, Si_X, Si_U = coeff(tau)
        proj = lambda v, Siv: Siv - Si_X @ (cov @ (Si_X.T @ v))
        PY = proj(y, Si_Y)
        APY = op.matvec(PY)
        YPAPY = PY @ APY
        YPA0PY = PY @ PY
        trace0, trace1, capped = traces(Si_X, cov, Si_U)
        B2 = jnp.stack([PY, APY], axis=1)
        sol2, _, _ = pcg_solve_op(op, jnp.ones(N, y.dtype), tau, B2,
                                  tol_pcg, maxiter_pcg)
        PA0PY = proj(sol2[:, 0], sol2[:, 0])
        PAPY = proj(sol2[:, 1], sol2[:, 1])
        AI = jnp.array([[PY @ PA0PY, PY @ PAPY],
                        [APY @ PA0PY, APY @ PAPY]])
        AI = (AI + AI.T) / 2.0
        score = jnp.array([YPA0PY - trace0, YPAPY - trace1])
        # closed-form 2x2 solve
        det = AI[0, 0] * AI[1, 1] - AI[0, 1] * AI[1, 0]
        dtau = jnp.array([
            (AI[1, 1] * score[0] - AI[0, 1] * score[1]) / det,
            (AI[0, 0] * score[1] - AI[1, 0] * score[0]) / det,
        ])
        # fitglmmaiRPCG_q (:893-928): components that entered at ~0 clamp
        # back to 0 (zero_v) so they never drive the halving loop; genuine
        # negativity of live components step-halves until non-negative
        zero_v = tau < tol
        def clamp(t):
            return jnp.where(zero_v & (t < tol), 0.0, t)
        def halve(carry):
            _, step = carry
            step = step * 0.5
            return clamp(tau + step * dtau), step
        def neg(carry):
            return jnp.any(carry[0] < 0.0)
        t1, _ = jax.lax.while_loop(neg, halve, (clamp(tau + dtau), 1.0))
        t1 = jnp.where(t1 < tol, 0.0, t1)
        return t1, alpha, eta, cov, capped

    def body(state):
        tau, alpha, eta, cov, it, done, capped = state
        tau1, alpha1, eta1, cov1, cap1 = ai_step(tau)
        delta = jnp.max(jnp.abs(tau1 - tau) /
                        (jnp.abs(tau1) + jnp.abs(tau) + tol))
        done1 = done | (delta < tol)
        keep = ~done
        sel = lambda a, b: jnp.where(keep, b, a)
        return (sel(tau, tau1), sel(alpha, alpha1), sel(eta, eta1),
                sel(cov, cov1), it + 1, done1, capped | (keep & cap1))

    def cond(state):
        *_, it, done, _capped = state
        return (~done) & (it < maxiter)

    # initial moment-based update (reference saige_fit_AI_PCG_quant
    # :1160-1170): tau_k <- max(0, tau_k + tau_k^2 (YP A_k PY - tr) / n)
    def moment_update(tau):
        _, _, cov, Si_Y, Si_X, Si_U = coeff(tau)
        proj = lambda v, Siv: Siv - Si_X @ (cov @ (Si_X.T @ v))
        PY = proj(y, Si_Y)
        APY = op.matvec(PY)
        trace0, trace1, capped = traces(Si_X, cov, Si_U)
        s0 = PY @ PY - trace0
        s1 = PY @ APY - trace1
        return jnp.maximum(
            tau + tau ** 2 * jnp.stack([s0, s1]) / N, 0.0), capped

    tau1, cap0 = moment_update(tau_init)
    state = (tau1, jnp.zeros(K, X.dtype), y, jnp.eye(K, dtype=X.dtype),
             jnp.zeros((), jnp.int32), jnp.zeros((), bool), cap0)
    tau, alpha, eta, cov, iters, done, capped = jax.lax.while_loop(
        cond, body, state)
    alpha_f, eta_f, cov_f, *_ = coeff(tau)
    return DeviceFit(coefficients=alpha_f, tau=tau, eta=eta_f, mu=eta_f,
                     cov=cov_f, iterations=iters, converged=done,
                     trace_capped=capped)


# ---------------------------------------------------------------------------
# PheWAS-mode batched fit: P phenotypes over ONE resident GRM

def _stack_cols(A):
    """[P, N, C] per-phenotype RHS blocks -> [N, P*C] stacked columns."""
    P, N, C = A.shape
    return jnp.transpose(A, (1, 0, 2)).reshape(N, P * C)


def _unstack_cols(S, P, C):
    """[N, P*C] -> [P, N, C]."""
    N = S.shape[0]
    return jnp.transpose(S.reshape(N, P, C), (1, 0, 2))


def _pcg_multi(op, W, tau, B, tol_pcg, maxiter_pcg):
    """Solve P phenotypes' systems in ONE batched PCG sharing the GRM
    stream: ``W [P, N]``, ``tau [P, 2]``, ``B [P, N, C]``.  The PCG's
    per-column (weights, tau) form (ops/pcg.py:_pcg_body) makes each
    column's arithmetic identical to its own solve; the GRM matvec is
    linear, so all P*C columns ride one matmul per iteration."""
    P, N, C = B.shape
    Wc = jnp.repeat(W.T, C, axis=1)         # [N, P*C]
    tc = jnp.repeat(tau.T, C, axis=1)       # [2, P*C]
    sol, _, _ = pcg_solve_op(op, Wc, tc, _stack_cols(B), tol_pcg,
                             maxiter_pcg)
    return _unstack_cols(sol, P, C)


@partial(jax.jit, static_argnames=("maxiter", "maxiter_pcg", "maxiter_coef"))
def fit_glmm_binary_device_multi(op, Y, X, tau_init, eta_init, U,
                                 tol, tol_pcg,
                                 maxiter: int = 20, maxiter_pcg: int = 500,
                                 maxiter_coef: int = 20, nrun=30,
                                 trace_cv_cutoff=0.0025) -> DeviceFit:
    """Fit P binary null GLMMs sharing ONE GRM, as one device program.

    ``Y [P, N]`` phenotypes; ``tau_init [P, 2]``; ``eta_init [P, N]``;
    ``X [N, K]`` covariates and ``U [N, R]`` probe pool are SHARED.
    Returns a :class:`DeviceFit` whose every field carries a leading
    ``P`` axis.

    Design: the expensive resource is streaming the GRM (2-bit decode +
    integer-sliced bf16 matmuls); every stage here stacks all phenotypes'
    right-hand sides into one batched PCG / one ``op.matvec`` call, so the
    GRM is read once per iteration for ALL phenotypes — P fits cost about
    one fit.  Per-phenotype control flow (inner-IRLS convergence, tau
    blow-up retries, outer stopping, the reference's exact update order,
    src/saige_fitnull.cpp:948-1110) runs lock-step with per-lane masks:
    each lane performs exactly the arithmetic its serial fit would (the
    PCG freezes columns per-column), so lane p reproduces
    :func:`fit_glmm_binary_device` on phenotype p to float tolerance.
    The reference fits strictly one phenotype per call
    (R/saige_main.r:223); at biobank N each call re-streams its GRM.
    """
    P, N = Y.shape
    K = X.shape[1]
    tol_inv_2 = 1.0 / (tol * tol)
    Xb = jnp.broadcast_to(X, (P, N, K))

    def bsel(keep, old, new):
        """Per-lane select with leading-P broadcast."""
        k = keep.reshape((P,) + (1,) * (old.ndim - 1))
        return jnp.where(k, new, old)

    def get_coeff(tau, eta, alpha0):
        """Per-lane inner IRLS (get_coeff, :766-813), lock-step."""
        def step(eta, alpha_prev):
            mu = jax.nn.sigmoid(eta)
            W = mu * (1.0 - mu)
            Yw = eta + (Y - mu) / W
            B = jnp.concatenate([Yw[:, :, None], Xb], axis=2)
            sol = _pcg_multi(op, W, tau, B, tol_pcg, maxiter_pcg)
            Si_Y, Si_X = sol[:, :, 0], sol[:, :, 1:]
            cov = jax.vmap(_sym_inv)(jnp.einsum("nk,pnj->pkj", X, Si_X))
            alpha = jnp.einsum("pkj,pj->pk", cov,
                               jnp.einsum("pnk,pn->pk", Si_X, Yw))
            eta1 = Yw - tau[:, 0:1] * \
                (Si_Y - jnp.einsum("pnk,pk->pn", Si_X, alpha)) / W
            return eta1, alpha, (Yw, W, cov, Si_Y, Si_X)

        def body(carry):
            eta, alpha, aux, it, done = carry
            eta1, alpha1, aux1 = step(eta, alpha)
            delta = jnp.max(jnp.abs(alpha1 - alpha) /
                            (jnp.abs(alpha1) + jnp.abs(alpha) + 0.1),
                            axis=1)
            done1 = done | (delta < 0.1)
            keep = ~done
            aux_o = jax.tree_util.tree_map(
                lambda a, b: bsel(keep, a, b), aux, aux1)
            return (bsel(keep, eta, eta1), bsel(keep, alpha, alpha1),
                    aux_o, it + 1, done1)

        def wcond(carry):
            *_, it, done = carry
            return jnp.any(~done) & (it < maxiter_coef)

        mu0 = jax.nn.sigmoid(eta)
        W0 = mu0 * (1.0 - mu0)
        aux0 = (eta, W0, jnp.broadcast_to(jnp.eye(K, dtype=X.dtype),
                                          (P, K, K)),
                eta, jnp.zeros((P, N, K), X.dtype))
        eta1, alpha1, aux, _, _ = jax.lax.while_loop(
            wcond, body, (eta, alpha0, aux0, jnp.zeros((), jnp.int32),
                          jnp.zeros(P, bool)))
        Yw, W, cov, Si_Y, Si_X = aux
        return eta1, alpha1, Yw, W, cov, Si_Y, Si_X

    # GRM @ probes is tau- and phenotype-invariant: ONE stream for the fit
    AU_const = op.matvec(U)

    def proj_multi(Si_X, cov, v, Siv):
        return Siv - jnp.einsum(
            "pnk,pk->pn", Si_X,
            jnp.einsum("pkj,pj->pk", cov,
                       jnp.einsum("pnj,pn->pj", Si_X, v)))

    def ai_update(tau, Yw, W, cov, Si_Y, Si_X, moment):
        """AI-REML tau step (:816-890) for all lanes, one batched PCG."""
        PY = proj_multi(Si_X, cov, Yw, Si_Y)
        APY = op.matvec(PY.T).T                 # [P, N], one GRM stream
        YPAPY = jnp.sum(PY * APY, axis=1)
        R = U.shape[1]
        B = jnp.concatenate([APY[:, :, None],
                             jnp.broadcast_to(U, (P, N, R))], axis=2)
        sol = _pcg_multi(op, W, tau, B, tol_pcg, maxiter_pcg)
        PAPY = proj_multi(Si_X, cov, sol[:, :, 0], sol[:, :, 0])
        AI = jnp.sum(APY * PAPY, axis=1)
        Si_U = sol[:, :, 1:]                    # [P, N, R]
        PU = Si_U - jnp.einsum(
            "pnk,pkr->pnr", Si_X,
            jnp.einsum("pkj,pjr->pkr", cov,
                       jnp.einsum("pnj,nr->pjr", Si_X, U)))
        t_all = jnp.einsum("nr,pnr->pr", AU_const, PU)
        trace, capped = jax.vmap(_masked_trace, in_axes=(0, None, None))(
            t_all, nrun, trace_cv_cutoff)
        score = YPAPY - trace
        t1n = tau[:, 1] + score / AI
        t1n = jnp.where(t1n < tol, 0.0, t1n)
        t1m = jnp.maximum(tau[:, 1] + tau[:, 1] ** 2 * score / N, 0.0)
        tau1 = jnp.stack([tau[:, 0], jnp.where(moment, t1m, t1n)], axis=1)
        return tau1, capped

    def outer_body(state):
        tau, eta, alpha, it, retries, done, failed, capped = state
        eta1, alpha1, Yw, W, cov, Si_Y, Si_X = get_coeff(tau, eta, alpha)
        tau1, cap1 = ai_update(tau, Yw, W, cov, Si_Y, Si_X,
                               jnp.zeros((), bool))
        blow = jnp.max(tau1, axis=1) > tol_inv_2
        can_retry = blow & (retries < 10)
        fail = blow & (retries >= 10)
        delta = jnp.max(jnp.abs(tau1 - tau) /
                        (jnp.abs(tau1) + jnp.abs(tau) + tol), axis=1)
        done1 = done | (~blow & ((delta < tol) | (tau1[:, 1] == 0.0))) | fail
        # lanes at their iteration cap freeze too (serial loop would have
        # exited); they finish converged=False like the serial fit
        keep = (~done) & (it < maxiter)
        tau_n = jnp.where(can_retry[:, None],
                          jnp.stack([tau[:, 0], tau[:, 1] * 0.5], axis=1),
                          tau1)
        eta_n = jnp.where(can_retry[:, None], eta, eta1)
        alpha_n = jnp.where(can_retry[:, None], alpha, alpha1)
        return (bsel(keep, tau, tau_n), bsel(keep, eta, eta_n),
                bsel(keep, alpha, alpha_n),
                it + jnp.where(keep & ~can_retry, 1, 0),
                jnp.where(keep, jnp.where(can_retry, retries + 1, 0),
                          retries),
                jnp.where(keep, done1, done), failed | (keep & fail),
                capped | (keep & cap1))

    def outer_cond(state):
        _, _, _, it, _, done, _, _ = state
        return jnp.any((~done) & (it < maxiter))

    alpha0 = jnp.zeros((P, K), X.dtype)
    _eta_i, alpha_i, Yw, W, cov, Si_Y, Si_X = get_coeff(tau_init, eta_init,
                                                        alpha0)
    tau_m, cap0 = ai_update(tau_init, Yw, W, cov, Si_Y, Si_X,
                            jnp.ones((), bool))

    state = (tau_m, eta_init, alpha_i, jnp.zeros(P, jnp.int32),
             jnp.zeros(P, jnp.int32), jnp.zeros(P, bool),
             jnp.zeros(P, bool), cap0)
    tau, eta, alpha, iters, _retries, done, failed, capped = \
        jax.lax.while_loop(outer_cond, outer_body, state)

    eta_f, alpha_f, Yw, W, cov, Si_Y, Si_X = get_coeff(tau, eta, alpha)
    mu_f = jax.nn.sigmoid(eta_f)
    return DeviceFit(coefficients=alpha_f, tau=tau, eta=eta_f, mu=mu_f,
                     cov=cov, iterations=iters,
                     converged=done & ~failed, trace_capped=capped)


@partial(jax.jit, static_argnames=("maxiter", "maxiter_pcg"))
def fit_glmm_quant_device_multi(op, Y, X, tau_init, U,
                                tol, tol_pcg,
                                maxiter: int = 20,
                                maxiter_pcg: int = 500, nrun=30,
                                trace_cv_cutoff=0.0025) -> DeviceFit:
    """Fit P quantitative null GLMMs sharing ONE GRM, as one program.

    The quantitative sibling of :func:`fit_glmm_binary_device_multi`:
    ``Y [P, N]`` phenotypes, ``tau_init [P, 2]``, shared ``X [N, K]`` /
    ``U [N, R]``.  Every stage stacks all phenotypes' right-hand sides
    into one batched PCG (per-column tau; gaussian weights are ones), so
    the GRM streams once per iteration for all P; per-lane control flow
    (2x2 AI step-halving with zero_v clamps, the 2% stopping rule —
    src/saige_fitnull.cpp:893-928, 1160-1170) runs lock-step with masks,
    reproducing each serial :func:`fit_glmm_quant_device` lane.
    """
    P, N = Y.shape
    K = X.shape[1]
    R = U.shape[1]
    ones = jnp.ones(N, Y.dtype)

    def bsel(keep, old, new):
        k = keep.reshape((P,) + (1,) * (old.ndim - 1))
        return jnp.where(k, new, old)

    def coeff(tau):
        B = jnp.concatenate(
            [Y[:, :, None], jnp.broadcast_to(X, (P, N, K)),
             jnp.broadcast_to(U, (P, N, R))], axis=2)
        sol = _pcg_multi(op, jnp.broadcast_to(ones, (P, N)), tau, B,
                         tol_pcg, maxiter_pcg)
        Si_Y, Si_X, Si_U = sol[:, :, 0], sol[:, :, 1:1 + K], \
            sol[:, :, 1 + K:]
        cov = jax.vmap(_sym_inv)(jnp.einsum("nk,pnj->pkj", X, Si_X))
        alpha = jnp.einsum("pkj,pj->pk", cov,
                           jnp.einsum("pnk,pn->pk", Si_X, Y))
        eta = Y - tau[:, 0:1] * \
            (Si_Y - jnp.einsum("pnk,pk->pn", Si_X, alpha))
        return alpha, eta, cov, Si_Y, Si_X, Si_U

    AU_const = op.matvec(U)    # tau/phenotype-invariant: one GRM stream

    def proj(Si_X, cov, v, Siv):
        return Siv - jnp.einsum(
            "pnk,pk->pn", Si_X,
            jnp.einsum("pkj,pj->pk", cov,
                       jnp.einsum("pnj,pn->pj", Si_X, v)))

    def traces(Si_X, cov, Si_U):
        PU = Si_U - jnp.einsum(
            "pnk,pkr->pnr", Si_X,
            jnp.einsum("pkj,pjr->pkr", cov,
                       jnp.einsum("pnj,nr->pjr", Si_X, U)))
        t1 = jnp.einsum("nr,pnr->pr", AU_const, PU)
        t0 = jnp.einsum("nr,pnr->pr", U, PU)

        def one(t1p, t0p):
            idx = jnp.arange(R)

            def stats(t, r):
                mask = (idx < r).astype(t.dtype)
                m = jnp.sum(t * mask) / r
                var = jnp.sum(((t - m) * mask) ** 2) / (r - 1)
                return m, jnp.sqrt(var) / (m * r)

            def cond(r):
                _, cv1 = stats(t1p, r)
                _, cv0 = stats(t0p, r)
                return (jnp.maximum(cv0, cv1) > trace_cv_cutoff) & \
                    (r + 10 <= R)

            r_fin = jax.lax.while_loop(cond, lambda r: r + 10,
                                       jnp.minimum(jnp.asarray(nrun), R))
            m0, cv0 = stats(t0p, r_fin)
            m1, cv1 = stats(t1p, r_fin)
            return m0, m1, jnp.maximum(cv0, cv1) > trace_cv_cutoff

        return jax.vmap(one)(t1, t0)

    def ai_step(tau):
        alpha, eta, cov, Si_Y, Si_X, Si_U = coeff(tau)
        PY = proj(Si_X, cov, Y, Si_Y)
        APY = op.matvec(PY.T).T
        YPAPY = jnp.sum(PY * APY, axis=1)
        YPA0PY = jnp.sum(PY * PY, axis=1)
        trace0, trace1, capped = traces(Si_X, cov, Si_U)
        B2 = jnp.stack([PY, APY], axis=2)               # [P, N, 2]
        sol2 = _pcg_multi(op, jnp.broadcast_to(ones, (P, N)), tau, B2,
                          tol_pcg, maxiter_pcg)
        PA0PY = proj(Si_X, cov, sol2[:, :, 0], sol2[:, :, 0])
        PAPY = proj(Si_X, cov, sol2[:, :, 1], sol2[:, :, 1])
        a00 = jnp.sum(PY * PA0PY, axis=1)
        a01 = jnp.sum(PY * PAPY, axis=1)
        a10 = jnp.sum(APY * PA0PY, axis=1)
        a11 = jnp.sum(APY * PAPY, axis=1)
        # symmetrize like the serial fit's (AI + AI.T)/2
        s01 = (a01 + a10) / 2.0
        det = a00 * a11 - s01 * s01
        sc0 = YPA0PY - trace0
        sc1 = YPAPY - trace1
        dtau = jnp.stack([(a11 * sc0 - s01 * sc1) / det,
                          (a00 * sc1 - s01 * sc0) / det], axis=1)
        zero_v = tau < tol

        def clamp(t):
            return jnp.where(zero_v & (t < tol), 0.0, t)

        def halve(carry):
            t1, step = carry
            neg = jnp.any(t1 < 0.0, axis=1)             # [P]
            step = jnp.where(neg, step * 0.5, step)
            t1n = clamp(tau + step[:, None] * dtau)
            return jnp.where(neg[:, None], t1n, t1), step

        def anyneg(carry):
            return jnp.any(carry[0] < 0.0)

        t1, _ = jax.lax.while_loop(anyneg, halve,
                                   (clamp(tau + dtau), jnp.ones(P)))
        t1 = jnp.where(t1 < tol, 0.0, t1)
        return t1, alpha, eta, cov, capped

    def body(state):
        tau, alpha, eta, cov, it, done, capped = state
        tau1, alpha1, eta1, cov1, cap1 = ai_step(tau)
        delta = jnp.max(jnp.abs(tau1 - tau) /
                        (jnp.abs(tau1) + jnp.abs(tau) + tol), axis=1)
        done1 = done | (delta < tol)
        keep = (~done) & (it < maxiter)
        return (bsel(keep, tau, tau1), bsel(keep, alpha, alpha1),
                bsel(keep, eta, eta1), bsel(keep, cov, cov1),
                it + jnp.where(keep, 1, 0), jnp.where(keep, done1, done),
                capped | (keep & cap1))

    def cond(state):
        _, _, _, _, it, done, _ = state
        return jnp.any((~done) & (it < maxiter))

    def moment_update(tau):
        _, _, cov, Si_Y, Si_X, Si_U = coeff(tau)
        PY = proj(Si_X, cov, Y, Si_Y)
        APY = op.matvec(PY.T).T
        trace0, trace1, capped = traces(Si_X, cov, Si_U)
        s0 = jnp.sum(PY * PY, axis=1) - trace0
        s1 = jnp.sum(PY * APY, axis=1) - trace1
        return jnp.maximum(
            tau + tau ** 2 * jnp.stack([s0, s1], axis=1) / N, 0.0), capped

    tau1, cap0 = moment_update(tau_init)
    state = (tau1, jnp.zeros((P, K), X.dtype), Y,
             jnp.broadcast_to(jnp.eye(K, dtype=X.dtype), (P, K, K)),
             jnp.zeros(P, jnp.int32), jnp.zeros(P, bool), cap0)
    tau, alpha, eta, cov, iters, done, capped = jax.lax.while_loop(
        cond, body, state)
    alpha_f, eta_f, cov_f, *_ = coeff(tau)
    return DeviceFit(coefficients=alpha_f, tau=tau, eta=eta_f, mu=eta_f,
                     cov=cov_f, iterations=iters, converged=done,
                     trace_capped=capped)
