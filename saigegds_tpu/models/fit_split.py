"""Host-driven AI-REML null fit over a bounded-program GRM handle.

For a 2-bit store whose one-dispatch device fit (``fit_device.py``)
would not fit in device memory (``fitnull._packed2_engine``) — the
reference fits up to max.num.snp=1e6 GRM SNPs
(R/saige_main.r:328-333).  Here the outer AI-REML loop runs in PYTHON,
dispatching small cached device programs:

* every GRM product goes through :class:`ops.packed_grm.SplitPacked2`
  (per-leaf-group contribution programs — the largest compile is one
  group, independent of total M);
* PCG is the host-driven driver (``ops/pcg.pcg_host``, all-f64 by
  default; the opt-in mixed tier trades f32 iteration state against
  refinement overhead);
* ALL array state stays device-resident; only scalars (tau, deltas,
  trace probes, convergence flags) are read back to the host.

The algorithm mirrors ``fit_glmm_binary_device`` step for step (moment
init, inner-IRLS rel-tol 0.1, CV-escalated Hutchinson trace over the
caller's probe pool, tau blow-up retries, the 2% stopping rule —
src/saige_fitnull.cpp:948-1099), so results agree with the one-dispatch
fit to solver precision wherever both compile.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.pcg import pcg_host, pcg_host_mixed
from .fit_device import DeviceFit, _sym_inv


@jax.jit
def _irls_prep(y, X, eta):
    mu = jax.nn.sigmoid(eta)
    W = mu * (1.0 - mu)
    Yw = eta + (y - mu) / W
    return W, Yw, jnp.concatenate([Yw[:, None], X], axis=1)


@jax.jit
def _coeff_post(X, Yw, W, tau0, sol):
    Si_Y, Si_X = sol[:, 0], sol[:, 1:]
    cov = _sym_inv(X.T @ Si_X)
    alpha = cov @ (Si_X.T @ Yw)
    eta1 = Yw - tau0 * (Si_Y - Si_X @ alpha) / W
    return alpha, eta1, cov, Si_Y, Si_X


@jax.jit
def _alpha_delta(a1, a0):
    return jnp.max(jnp.abs(a1 - a0) / (jnp.abs(a1) + jnp.abs(a0) + 0.1))


@jax.jit
def _proj_py(Yw, Si_Y, Si_X, cov):
    return Si_Y - Si_X @ (cov @ (Si_X.T @ Yw))


@jax.jit
def _ai_reduce(PY, APY, sol, Si_X, cov, U, AU):
    """Scalar/probe reductions of one AI step: YPAPY, AI, t_all [R]."""
    PAPY = sol[:, 0] - Si_X @ (cov @ (Si_X.T @ sol[:, 0]))
    YPAPY = PY @ APY
    AI = APY @ PAPY
    Si_U = sol[:, 1:]
    PU = Si_U - Si_X @ (cov @ (Si_X.T @ U))
    t_all = jnp.sum(AU * PU, axis=0)
    return YPAPY, AI, t_all


def _host_trace(t_all: np.ndarray, nrun: int, cutoff: float):
    """The reference's CV-escalated trace over a fixed probe pool
    (calcCV + nrun += 10, src/saige_fitnull.cpp:618-665) on host floats;
    returns (mean, capped)."""
    R = len(t_all)
    r = min(nrun, R)
    while True:
        m = t_all[:r].mean()
        cv = t_all[:r].std(ddof=1) / (m * r)
        if cv <= cutoff or r + 10 > R:
            return float(m), bool(cv > cutoff)
        r += 10


@jax.jit
def _q_coeff_post(y, X, U, tau0, sol):
    K = X.shape[1]
    Si_Y, Si_X, Si_U = sol[:, 0], sol[:, 1:1 + K], sol[:, 1 + K:]
    cov = _sym_inv(X.T @ Si_X)
    alpha = cov @ (Si_X.T @ y)
    eta = y - tau0 * (Si_Y - Si_X @ alpha)
    return alpha, eta, cov, Si_Y, Si_X, Si_U


@jax.jit
def _q_traces(U, AU, Si_X, cov, Si_U):
    PU = Si_U - Si_X @ (cov @ (Si_X.T @ U))
    return jnp.sum(AU * PU, axis=0), jnp.sum(U * PU, axis=0)


@jax.jit
def _q_ai_reduce(y, PY, APY, sol2, Si_X, cov):
    PA0PY = sol2[:, 0] - Si_X @ (cov @ (Si_X.T @ sol2[:, 0]))
    PAPY = sol2[:, 1] - Si_X @ (cov @ (Si_X.T @ sol2[:, 1]))
    return (PY @ PY, PY @ APY,
            PY @ PA0PY, PY @ PAPY, APY @ PA0PY, APY @ PAPY)


def fit_glmm_quant_split(handle, y, X, tau_init, U,
                         tol=0.02, tol_pcg=1e-5,
                         maxiter: int = 20, maxiter_pcg: int = 500,
                         nrun: int = 30, trace_cv_cutoff: float = 0.0025,
                         pcg: str = "exact",
                         verbose: bool = False) -> DeviceFit:
    """Quantitative-trait split fit: the host-driven twin of
    ``fit_glmm_quant_device`` (both variance components free, 2x2 AI
    with step-halving and zero_v clamps — src/saige_fitnull.cpp:893-928,
    1102-1248) over a bounded-program handle."""
    y = jnp.asarray(y, jnp.float64)
    X = jnp.asarray(X, jnp.float64)
    U = jnp.asarray(U, jnp.float64)
    N, K = X.shape
    ones = jnp.ones(N, jnp.float64)
    AU = handle.mv(U, prec="f64")

    def solve(tau_np, B):
        tau_d = jnp.asarray(tau_np, jnp.float64)
        if pcg == "mixed":
            sol, _i, conv = pcg_host_mixed(handle, ones, tau_d, B,
                                           tol_pcg, maxiter_pcg)
        else:
            sol, _i, conv = pcg_host(handle, ones, tau_d, B, tol_pcg,
                                     maxiter_pcg, prec="f64")
        return sol, conv

    def _host_trace2(t1, t0, nrun, cutoff):
        """Shared escalation over BOTH traces (fitnull._get_trace)."""
        R = len(t1)
        r = min(nrun, R)
        while True:
            m1, m0 = t1[:r].mean(), t0[:r].mean()
            cv1 = t1[:r].std(ddof=1) / (m1 * r)
            cv0 = t0[:r].std(ddof=1) / (m0 * r)
            if max(cv0, cv1) <= cutoff or r + 10 > R:
                return float(m0), float(m1), bool(max(cv0, cv1) > cutoff)
            r += 10

    B_coeff = jnp.concatenate([y[:, None], X, U], axis=1)

    def ai_step(tau_np, moment: bool):
        sol, _c = solve(tau_np, B_coeff)
        alpha, eta, cov, Si_Y, Si_X, Si_U = _q_coeff_post(
            y, X, U, tau_np[0], sol)
        PY = _proj_py(y, Si_Y, Si_X, cov)
        APY = handle.mv(PY[:, None], prec="f64")[:, 0]
        t1_all, t0_all = _q_traces(U, AU, Si_X, cov, Si_U)
        trace0, trace1, capped = _host_trace2(np.asarray(t1_all),
                                              np.asarray(t0_all),
                                              nrun, trace_cv_cutoff)
        B2 = jnp.stack([PY, APY], axis=1)
        sol2, _c2 = solve(tau_np, B2)
        YPA0PY, YPAPY, a00, a01, a10, a11 = [
            float(v) for v in _q_ai_reduce(y, PY, APY, sol2, Si_X, cov)]
        sc = np.array([YPA0PY - trace0, YPAPY - trace1])
        if moment:
            t1n = np.maximum(tau_np + tau_np ** 2 * sc / N, 0.0)
            return t1n, alpha, eta, cov, capped
        s01 = (a01 + a10) / 2.0
        AI = np.array([[a00, s01], [s01, a11]])
        dtau = np.linalg.solve(AI, sc)
        zero_v = tau_np < tol
        t1n = tau_np + dtau
        t1n[zero_v & (t1n < tol)] = 0.0
        step = 1.0
        while (t1n < 0.0).any():
            step *= 0.5
            t1n = tau_np + step * dtau
            t1n[zero_v & (t1n < tol)] = 0.0
        t1n[t1n < tol] = 0.0
        return t1n, alpha, eta, cov, capped

    tau = np.asarray(tau_init, np.float64).copy()
    capped_any = False
    tau, alpha, eta, cov, cap0 = ai_step(tau, moment=True)
    capped_any |= cap0
    converged = False
    it = 0
    while it < maxiter and not converged:
        tau1, alpha, eta, cov, cap1 = ai_step(tau, moment=False)
        capped_any |= cap1
        delta = np.max(np.abs(tau1 - tau) /
                       (np.abs(tau1) + np.abs(tau) + tol))
        if verbose:
            print(f"    quant split-fit iter {it + 1}: tau = {tau1} "
                  f"(delta {delta:.4f})")
        tau = tau1
        it += 1
        converged = delta < tol
    sol, _c = solve(tau, B_coeff)
    alpha_f, eta_f, cov_f, *_ = _q_coeff_post(y, X, U, tau[0], sol)
    return DeviceFit(
        coefficients=np.asarray(alpha_f), tau=tau, eta=np.asarray(eta_f),
        mu=np.asarray(eta_f), cov=np.asarray(cov_f),
        iterations=np.int32(it), converged=bool(converged),
        trace_capped=bool(capped_any))


def fit_glmm_binary_split(handle, y, X, tau_init, eta_init, U,
                          tol=0.02, tol_pcg=1e-5,
                          maxiter: int = 20, maxiter_pcg: int = 500,
                          maxiter_coef: int = 20, nrun: int = 30,
                          trace_cv_cutoff: float = 0.0025,
                          pcg: str = "exact",
                          verbose: bool = False) -> DeviceFit:
    """Binary-trait null GLMM fit, host-driven over ``handle``.

    ``handle``: a :class:`SplitPacked2` (or anything with ``.mv(P, prec)``
    and ``.diag``).  ``pcg``: "exact" (default — all-f64 host-driven) or
    "mixed" (f32 inner state, f64 refinement; opt-in).  Returns a
    :class:`DeviceFit` of host numpy arrays.
    """
    y = jnp.asarray(y, jnp.float64)
    X = jnp.asarray(X, jnp.float64)
    U = jnp.asarray(U, jnp.float64)
    eta0_dev = jnp.asarray(eta_init, jnp.float64)
    N, K = X.shape
    tol_inv_2 = 1.0 / (tol * tol)
    AU = handle.mv(U, prec="f64")          # tau-invariant: one stream

    def solve(W, tau_np, B):
        tau_d = jnp.asarray(tau_np, jnp.float64)
        if pcg == "mixed":
            sol, _its, conv = pcg_host_mixed(handle, W, tau_d, B,
                                             tol_pcg, maxiter_pcg)
        else:
            sol, _its, conv = pcg_host(handle, W, tau_d, B, tol_pcg,
                                       maxiter_pcg, prec="f64")
        return sol, conv

    warned = [False]

    def _warn_conv(conv):
        if not warned[0] and not bool(np.asarray(conv).all()):
            print("PCG does not converge (may need to increase "
                  "'maxiter').")
            warned[0] = True

    def get_coeff(tau_np, eta, alpha0):
        alpha_prev = alpha0
        for _ in range(maxiter_coef):
            W, Yw, B = _irls_prep(y, X, eta)
            sol, conv = solve(W, tau_np, B)
            _warn_conv(conv)
            alpha, eta1, cov, Si_Y, Si_X = _coeff_post(X, Yw, W,
                                                       tau_np[0], sol)
            delta = float(_alpha_delta(alpha, alpha_prev))
            alpha_prev, eta = alpha, eta1
            if delta < 0.1:
                break
        return eta, alpha, Yw, W, cov, Si_Y, Si_X

    def ai_update(tau_np, Yw, W, cov, Si_Y, Si_X, moment: bool):
        PY = _proj_py(Yw, Si_Y, Si_X, cov)
        APY = handle.mv(PY[:, None], prec="f64")[:, 0]
        B = jnp.concatenate([APY[:, None], U], axis=1)
        sol, conv = solve(W, tau_np, B)
        _warn_conv(conv)
        YPAPY, AI, t_all = _ai_reduce(PY, APY, sol, Si_X, cov, U, AU)
        YPAPY, AI = float(YPAPY), float(AI)
        trace, capped = _host_trace(np.asarray(t_all), nrun,
                                    trace_cv_cutoff)
        score = YPAPY - trace
        if moment:                          # first moment step (:1024)
            t1 = max(tau_np[1] + tau_np[1] ** 2 * score / N, 0.0)
        else:
            t1 = tau_np[1] + score / AI
            t1 = 0.0 if t1 < tol else t1
            step = 1.0
            while t1 < 0.0:                 # step-halving (:860-890)
                step *= 0.5
                t1 = tau_np[1] + step * score / AI
            t1 = 0.0 if t1 < tol else t1
        return np.array([tau_np[0], t1]), capped

    tau = np.asarray(tau_init, np.float64).copy()
    eta = eta0_dev
    alpha = jnp.zeros(K, jnp.float64)
    capped_any = False

    # pre-loop: coefficient solve at tau_init + moment update
    eta_i, alpha_i, Yw, W, cov, Si_Y, Si_X = get_coeff(tau, eta, alpha)
    tau, cap0 = ai_update(tau, Yw, W, cov, Si_Y, Si_X, moment=True)
    capped_any |= cap0
    alpha = alpha_i

    converged = False
    failed = False
    it = 0
    while it < maxiter and not converged and not failed:
        tau0 = tau.copy()
        eta_start, alpha_start = eta, alpha
        retries = 0
        while True:
            eta1, alpha1, Yw, W, cov, Si_Y, Si_X = get_coeff(
                tau0, eta_start, alpha_start)
            tau1, cap1 = ai_update(tau0, Yw, W, cov, Si_Y, Si_X,
                                   moment=False)
            capped_any |= cap1
            if np.max(tau1) > tol_inv_2:
                if retries < 10:            # halved-tau retry (:1039-1066)
                    retries += 1
                    tau0 = np.array([tau0[0], tau0[1] * 0.5])
                    continue
                failed = True
            break
        if failed:
            break
        delta = np.max(np.abs(tau1 - tau0) /
                       (np.abs(tau1) + np.abs(tau0) + tol))
        if verbose:
            print(f"    split-fit iter {it + 1}: tau = {tau1} "
                  f"(delta {delta:.4f})")
        eta, alpha, tau = eta1, alpha1, tau1
        it += 1
        converged = (delta < tol) or (tau1[1] == 0.0)

    # final coefficient solve at the converged tau
    eta_f, alpha_f, Yw, W, cov, _Si_Y, _Si_X = get_coeff(tau, eta, alpha)
    mu_f = jax.nn.sigmoid(eta_f)
    return DeviceFit(
        coefficients=np.asarray(alpha_f), tau=tau, eta=np.asarray(eta_f),
        mu=np.asarray(mu_f), cov=np.asarray(cov),
        iterations=np.int32(it), converged=bool(converged and not failed),
        trace_capped=bool(capped_any))
