"""Null GLMM fitting: penalized IRLS + AI-REML with PCG solves on device.

Device re-build of the reference fit pipeline (R driver
``seqFitNullGLMM_SPA`` R/saige_main.r:223-658; C engines
src/saige_fitnull.cpp:736-1248 and 1255-1474):

* the GRM is never materialised — every ``Sigma^{-1} x`` runs a batched
  Jacobi-PCG (``ops/pcg.py``) whose hot op is the standardized-genotype
  crossprod as device matmuls (``ops/grm.py``, ``ops/packed_grm.py``);
* the outer AI-REML / IRLS loops stay on the host (latency-tolerant,
  data-dependent control flow), each step dispatching fused device kernels;
* Hutchinson trace probes and variance-ratio marker order replay R's RNG
  streams exactly (``utils/rrandom.py``), so fitted models match the
  reference fixtures to solver precision.
"""

from __future__ import annotations

import math
import os
import warnings
from dataclasses import dataclass
from functools import partial

import numpy as np

from ..config import NullModelConfig
from ..io.seqarray import SeqData
from ..ops.grm import GRMOperator, build_grm
from ..ops.packed_grm import build_packed_grm, build_packed_grm_streamed
from ..ops.pcg import pcg_solve_op
from ..utils.rrandom import RRandom
from ..utils import telemetry
from .glm import (GlmFit, ObjNoK, glm_binomial, glm_gaussian, obj_nok_binary,
                  obj_nok_quant, qr_transform, rank_norm)
from .nullmodel import NullModel

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# family callbacks (R family objects: linkinv, mu.eta, variance)

class _Binomial:
    name = "binomial"

    @staticmethod
    def linkinv(eta):
        return 1.0 / (1.0 + np.exp(-eta))

    @staticmethod
    def mu_eta(eta):
        m = 1.0 / (1.0 + np.exp(-eta))
        # R's make.link("logit")$mu.eta floors at .Machine$double.eps
        return np.maximum(m * (1.0 - m), np.finfo(float).eps)

    @staticmethod
    def variance(mu):
        return mu * (1.0 - mu)


class _Gaussian:
    name = "gaussian"

    @staticmethod
    def linkinv(eta):
        return eta

    @staticmethod
    def mu_eta(eta):
        return np.ones_like(eta)

    @staticmethod
    def variance(mu):
        return np.ones_like(mu)


# ---------------------------------------------------------------------------
# device helpers


def _pcg(grm, w, tau, B, tol, maxiter):
    """Solve Sigma X = B on device; B [N, R] numpy -> numpy.

    ``grm`` is a dense-f64 GRMOperator, a bf16-exact PackedGRM, or a
    handle (mesh-sharded ShardedGrmHandle / bounded-program
    SplitPacked2) — all give f64-grade solutions."""
    if getattr(grm, "is_grm_handle", False):
        X, conv = grm.pcg(w, tau, B, tol, maxiter)
    else:
        X, iters, conv = pcg_solve_op(grm, jnp.asarray(w), jnp.asarray(tau),
                                      jnp.asarray(B), tol, maxiter)
        X = np.asarray(X)
        telemetry.emit("pcg", iters=np.asarray(iters))
    if not bool(conv.all()):
        print("PCG does not converge (may need to increase 'maxiter').")
    return X


@partial(jax.jit, static_argnames=("maxiter",))
def _pcg_grouped_j(op, Wp, taup, col_map, B, tol, maxiter):
    from ..ops.pcg import _pcg_body
    return _pcg_body(op.matvec, op.diag, Wp[:, col_map], taup[:, col_map],
                     B, tol, maxiter)


def _grm_mv(grm, b):
    if getattr(grm, "is_grm_handle", False):
        return np.asarray(grm.mv(jnp.asarray(b)))
    return np.asarray(grm.matvec(jnp.asarray(b)))


def _mat_inv(m):
    """inv_sympd with inv() fallback (src/saige_fitnull.cpp:721-733)."""
    ms = np.triu(m) + np.triu(m, 1).T  # symmatu
    try:
        c = np.linalg.cholesky(ms)
        inv_c = np.linalg.inv(c)
        return inv_c.T @ inv_c
    except np.linalg.LinAlgError:
        print("Warning: matrix is singular or not positive definite, "
              "using general inverse instead.")
        return np.linalg.inv(ms)


def _calc_cv(x):
    """stddev / (mean * n) — the reference's calcCV (src/saige_fitnull.cpp:618)."""
    x = np.asarray(x, float)
    return np.std(x, ddof=1) / (np.mean(x) * len(x))


# ---------------------------------------------------------------------------
# inner IRLS (get_coeff / get_coeff_w)


@dataclass
class _CoeffState:
    Y: np.ndarray
    mu: np.ndarray
    alpha: np.ndarray
    eta: np.ndarray
    W: np.ndarray
    cov: np.ndarray
    Sigma_iY: np.ndarray
    Sigma_iX: np.ndarray


def _get_coeff(grm, y, X, tau, family, alpha0, eta0, offset, maxiter_pcg,
               maxiter, tol_pcg) -> _CoeffState:
    """Inner IRLS (src/saige_fitnull.cpp:766-813): iterate working response
    and coefficients to rel-tol 0.1, every solve via one batched PCG."""
    tol_coef = 0.1
    mu = family.linkinv(eta0)
    mu_eta = family.mu_eta(eta0)
    Y = eta0 - offset + (y - mu) / mu_eta
    W = (mu_eta * mu_eta) / family.variance(mu)

    a0 = alpha0.copy()
    st = None
    for _ in range(maxiter):
        # one batched PCG for [Y | X]  (reference solves them sequentially)
        B = np.column_stack([Y, X])
        sol = _pcg(grm, W, tau, B, tol_pcg, maxiter_pcg)
        Sigma_iY = sol[:, 0]
        Sigma_iX = sol[:, 1:]
        cov = _mat_inv(X.T @ Sigma_iX)
        alpha = cov @ (Sigma_iX.T @ Y)
        eta = Y - tau[0] * (Sigma_iY - Sigma_iX @ alpha) / W + offset

        mu = family.linkinv(eta)
        mu_eta = family.mu_eta(eta)
        Y = eta - offset + (y - mu) / mu_eta
        W = (mu_eta * mu_eta) / family.variance(mu)

        st = _CoeffState(Y=Y, mu=mu, alpha=alpha, eta=eta, W=W, cov=cov,
                         Sigma_iY=Sigma_iY, Sigma_iX=Sigma_iX)
        if np.max(np.abs(alpha - a0) / (np.abs(alpha) + np.abs(a0) + tol_coef)) \
                < tol_coef:
            break
        a0 = alpha
    return st


# ---------------------------------------------------------------------------
# Hutchinson trace estimators


def _get_trace(grm, st: _CoeffState, tau, cfg: NullModelConfig, quant: bool):
    """trace(P*GRM) (and trace(P) for quantitative) via Rademacher probes.

    Probes replay R's ``set.seed(seed); rbinom(n,1,0.5)`` stream and the
    +10 escalation continues the same stream (src/saige_fitnull.cpp:627-718).
    """
    rng = RRandom(cfg.seed)
    SiX, cov = st.Sigma_iX, st.cov
    n = grm.n_samples
    buf, buf0 = [], []
    n_runs = cfg.nrun
    while True:
        need = n_runs - len(buf)
        U = np.stack([rng.rademacher(n).astype(np.float64) for _ in range(need)],
                     axis=1)  # [N, need]
        SiU = _pcg(grm, st.W, tau, U, cfg.tol_pcg, cfg.maxiter_pcg)
        PU = SiU - SiX @ (cov @ (SiX.T @ U))
        AU = _grm_mv(grm, U)
        buf.extend(np.sum(AU * PU, axis=0).tolist())
        if quant:
            buf0.extend(np.sum(U * PU, axis=0).tolist())
        cv = _calc_cv(buf)
        cv0 = _calc_cv(buf0) if quant else 0.0
        if cv <= cfg.trace_cv_cutoff and cv0 <= cfg.trace_cv_cutoff:
            break
        if cfg.nrun_max and n_runs + 10 > cfg.nrun_max:
            # the reference escalates unboundedly (src/saige_fitnull.cpp:
            # 644-663); an optional cap trades trace variance for progress
            warnings.warn(
                f"trace CV {max(cv, cv0):.3g} > {cfg.trace_cv_cutoff:.3g} "
                f"at the nrun_max={cfg.nrun_max} probe cap; proceeding")
            telemetry.emit("trace_capped", n_runs=n_runs,
                           cv=max(cv, cv0), cutoff=cfg.trace_cv_cutoff)
            break
        n_runs += 10
        # reference: "CV for trace ... escalate nrun" (:661-663)
        telemetry.emit("trace_escalation", n_runs=n_runs,
                       cv=max(cv, cv0), cutoff=cfg.trace_cv_cutoff)
    if quant:
        return float(np.mean(buf0)), float(np.mean(buf))
    return float(np.mean(buf))


# ---------------------------------------------------------------------------
# AI-REML updates


def _get_ai_score_binary(grm, st, tau, cfg):
    SiX, cov, Y = st.Sigma_iX, st.cov, st.Y
    PY = st.Sigma_iY - SiX @ (cov @ (SiX.T @ Y))
    APY = _grm_mv(grm, PY)
    YPAPY = float(PY @ APY)
    trace = _get_trace(grm, st, tau, cfg, quant=False)
    PAPY_1 = _pcg(grm, st.W, tau, APY[:, None], cfg.tol_pcg, cfg.maxiter_pcg)[:, 0]
    PAPY = PAPY_1 - SiX @ (cov @ (SiX.T @ PAPY_1))
    AI = float(APY @ PAPY)
    return YPAPY, trace, AI


def _get_ai_score_quant(grm, st, tau, cfg):
    SiX, cov, Y = st.Sigma_iX, st.cov, st.Y
    PY = st.Sigma_iY - SiX @ (cov @ (SiX.T @ Y))
    A0PY = PY
    APY = _grm_mv(grm, PY)
    YPAPY = float(PY @ APY)
    YPA0PY = float(PY @ A0PY)
    trace0, trace1 = _get_trace(grm, st, tau, cfg, quant=True)
    B = np.column_stack([A0PY, APY])
    sol = _pcg(grm, st.W, tau, B, cfg.tol_pcg, cfg.maxiter_pcg)
    PA0PY = sol[:, 0] - SiX @ (cov @ (SiX.T @ sol[:, 0]))
    PAPY = sol[:, 1] - SiX @ (cov @ (SiX.T @ sol[:, 1]))
    AI = np.empty((2, 2))
    AI[0, 0] = A0PY @ PA0PY
    AI[1, 1] = APY @ PAPY
    AI[0, 1] = AI[1, 0] = A0PY @ PAPY
    return (YPAPY, YPA0PY), (trace0, trace1), AI


def _fit_tau_binary(grm, st, tau0, cfg):
    """fitglmmaiRPCG (src/saige_fitnull.cpp:860-890)."""
    YPAPY, trace, AI = _get_ai_score_binary(grm, st, tau0, cfg)
    score = YPAPY - trace
    Dtau = score / AI
    tau = tau0.copy()
    tau[1] = tau0[1] + Dtau
    tau[tau < cfg.tol] = 0.0
    step = 1.0
    while tau[1] < 0.0:
        step *= 0.5
        tau[1] = tau0[1] + step * Dtau
    tau[tau < cfg.tol] = 0.0
    return tau


def _fit_tau_quant(grm, st, tau0, cfg):
    """fitglmmaiRPCG_q (src/saige_fitnull.cpp:893-928)."""
    zero_v = tau0 < cfg.tol
    (YPAPY, YPA0PY), (trace0, trace1), AI = _get_ai_score_quant(grm, st, tau0, cfg)
    score = np.array([YPA0PY - trace0, YPAPY - trace1])
    Dtau = np.linalg.solve(AI, score)
    tau = tau0 + Dtau
    tau[zero_v & (tau < cfg.tol)] = 0.0
    step = 1.0
    while tau[0] < 0.0 or tau[1] < 0.0:
        step *= 0.5
        tau = tau0 + step * Dtau
        tau[zero_v & (tau < cfg.tol)] = 0.0
    tau[tau < cfg.tol] = 0.0
    return tau


# ---------------------------------------------------------------------------
# outer drivers (saige_fit_AI_PCG_{binary,quant})


def _ck_path(cfg: NullModelConfig, tag: str) -> str:
    return f"{cfg.checkpoint}.{tag}.npz" if cfg.checkpoint else ""


def _ck_save(path: str, **arrs):
    """Atomic checkpoint write (tmp + rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def _ck_load(path: str):
    if path and os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    return None


def clear_checkpoint(cfg: NullModelConfig):
    """Remove fit/var-ratio checkpoint files (called on completion)."""
    for tag in ("fit", "vr"):
        p = _ck_path(cfg, tag)
        if p and os.path.exists(p):
            os.remove(p)


@dataclass
class GlmmFit:
    coefficients: np.ndarray
    tau: np.ndarray
    linear_predictors: np.ndarray
    fitted_values: np.ndarray
    residuals: np.ndarray
    cov: np.ndarray
    converged: bool


def fit_ai_pcg(grm: GRMOperator, fit0: GlmFit, X: np.ndarray, tau: np.ndarray,
               cfg: NullModelConfig, binary: bool,
               no_iteration: bool = False, verbose=False) -> GlmmFit:
    """The saige_fit_AI_PCG_{binary,quant} outer loop
    (src/saige_fitnull.cpp:948-1099, 1102-1248)."""
    family = _Binomial() if binary else _Gaussian()
    y = fit0.y.astype(np.float64)
    n = len(y)
    offset = np.zeros(n)
    tol_inv_2 = 1.0 / (cfg.tol * cfg.tol)

    eta = eta0 = fit0.linear_predictors.copy()
    mu = fit0.fitted_values.copy()
    alpha0 = fit0.coefficients.copy()
    alpha = alpha0.copy()
    tau = np.asarray(tau, np.float64).copy()
    tau0 = tau.copy()

    # mid-fit checkpoint (exact replay: each iteration is Markov in
    # (tau, alpha, eta) because _get_trace restarts its R-RNG stream)
    ckp = _ck_path(cfg, "fit") if not no_iteration else ""
    state = _ck_load(ckp)
    if state is not None and (int(state["n"]) != n
                              or int(state["k"]) != X.shape[1]
                              or bool(state["binary"]) != binary):
        warnings.warn(f"ignoring checkpoint {ckp}: model shape mismatch")
        state = None
    if state is not None and str(state["phase"]) == "done":
        telemetry.emit("checkpoint_resume", phase="done")
        mu_d = state["mu"]
        return GlmmFit(coefficients=state["alpha"], tau=state["tau"],
                       linear_predictors=state["eta"], fitted_values=mu_d,
                       residuals=y - mu_d, cov=state["cov"],
                       converged=bool(state["converged"]))
    start_it = 1
    resume_alpha = None
    it = 1
    brk = False
    if state is not None:
        tau = state["tau"].copy()
        eta = state["eta"].copy()
        alpha = resume_alpha = state["alpha"].copy()
        it = int(state["it"])
        brk = bool(state["brk"])
        if brk or it >= cfg.maxiter:
            # crashed between the last saved iteration and the final
            # solve: skip the loop and restore the final solve's warm
            # start exactly as the uninterrupted run would have it
            start_it = cfg.maxiter + 1
            alpha0 = state["alpha0"].copy()
            eta0 = state["eta0"].copy()
        else:
            start_it = it + 1
        telemetry.emit("checkpoint_resume", it=it)
        st = Y = cov = None
    else:
        st = _get_coeff(grm, y, X, tau, family, alpha0, eta0, offset,
                        cfg.maxiter_pcg, cfg.maxiter, cfg.tol_pcg)

        if no_iteration:
            return GlmmFit(coefficients=st.alpha, tau=tau,
                           linear_predictors=st.eta, fitted_values=st.mu,
                           residuals=y - st.mu, cov=st.cov, converged=True)

        # first moment-based update of tau
        if binary:
            YPAPY, trace, _ = _get_ai_score_binary(grm, st, tau, cfg)
            tau[1] = max(0.0, tau0[1] + tau0[1] ** 2 * (YPAPY - trace) / n)
        else:
            (YPAPY, YPA0PY), (trace0, trace1), _ = _get_ai_score_quant(
                grm, st, tau, cfg)
            tau[0] = max(0.0, tau0[0] + tau0[0] ** 2 * (YPA0PY - trace0) / n)
            tau[1] = max(0.0, tau0[1] + tau0[1] ** 2 * (YPAPY - trace1) / n)

        Y = st.Y
        cov = st.cov
    for it in range(start_it, cfg.maxiter + 1):
        alpha0 = resume_alpha if st is None else st.alpha
        # reference prints tau + coefficients per iteration (:1027-1031)
        telemetry.emit("iteration", iter=it, tau=tau, coef=alpha0)
        if verbose:
            print(f"    Iteration {it}: tau = {tau}, coeff = {alpha}")
        tau0 = tau.copy()
        eta0 = eta.copy()

        for itry in range(1, 12):
            st = _get_coeff(grm, y, X, tau0, family, alpha0, eta0, offset,
                            cfg.maxiter_pcg, cfg.maxiter, cfg.tol_pcg)
            tau = (_fit_tau_binary if binary else _fit_tau_quant)(
                grm, st, tau0, cfg)
            if np.max(tau) > tol_inv_2:
                if itry <= 10:
                    tau0[1] *= 0.5
                    telemetry.emit("tau_retry", iter=it, itry=itry,
                                   tau0=tau0)
                    continue
                raise OverflowError(
                    "Large variance estimate observed in the iterations, "
                    "model not converged!")
            break

        cov = st.cov
        alpha = st.alpha
        eta = st.eta
        Y = st.Y
        mu = st.mu

        if not binary and tau[0] <= 0:
            raise OverflowError("Sigma_E = 0, model not converged!")
        brk = (binary and tau[1] == 0) or bool(
            np.max(np.abs(tau - tau0) / (np.abs(tau) + np.abs(tau0)
                                         + cfg.tol)) < cfg.tol)
        if ckp:
            _ck_save(ckp, phase="iter", it=it, brk=brk, n=n, k=X.shape[1],
                     binary=binary, tau=tau, alpha=alpha, eta=eta,
                     alpha0=alpha0, eta0=eta0)
        if brk:
            break

    st = _get_coeff(grm, y, X, tau, family, alpha0, eta0, offset,
                    cfg.maxiter_pcg, cfg.maxiter, cfg.tol_pcg)
    # converged iff the tau loop broke on its tolerance (the reference's
    # `iter <= maxiter` works because its C loop leaves iter = maxiter+1
    # on exhaustion; Python's range leaves it = maxiter)
    fit = GlmmFit(coefficients=st.alpha, tau=tau, linear_predictors=st.eta,
                  fitted_values=st.mu, residuals=y - st.mu, cov=st.cov,
                  converged=bool(brk))
    if ckp:
        _ck_save(ckp, phase="done", n=n, k=X.shape[1], binary=binary,
                 tau=tau, alpha=st.alpha, eta=st.eta, mu=st.mu,
                 cov=st.cov, converged=fit.converged)
    return fit


# ---------------------------------------------------------------------------
# variance ratio (saige_calc_var_ratio_{binary,quant})


def calc_var_ratio(grm: GRMOperator, codes: np.ndarray, fit0: GlmFit,
                   glmm: GlmmFit, nok: ObjNoK, cfg: NullModelConfig,
                   marker_order: np.ndarray, binary: bool, verbose=False):
    """Estimate var1/var2 on random markers with MAC>20, adaptively adding
    10 until CV <= ratioCVcutoff (src/saige_fitnull.cpp:1255-1474)."""
    family = _Binomial() if binary else _Gaussian()
    eta = fit0.linear_predictors
    mu = fit0.fitted_values
    mu_eta = family.mu_eta(eta)
    W = (mu_eta * mu_eta) / family.variance(mu)
    tau = glmm.tau
    X1 = nok.X1
    Sigma_iX = _pcg(grm, W, tau, X1, cfg.tol_pcg, cfg.maxiter_pcg)
    xsx_inv = _mat_inv(X1.T @ Sigma_iX)

    rows = dict(id=[], maf=[], mac=[], var1=[], var2=[], ratio=[])
    num_marker = cfg.num_marker
    snp_pos = 0
    num_tested = 0
    n_rand = len(marker_order)
    # resumable marker-chunk checkpoint (replay is exact: the marker order
    # is fixed and Sigma_iX/xsx_inv above are deterministic)
    ckp = _ck_path(cfg, "vr")
    state = _ck_load(ckp)
    if state is not None and int(state["n_rand"]) != n_rand:
        warnings.warn(f"ignoring checkpoint {ckp}: marker-set mismatch")
        state = None
    if state is not None:
        rows = {k: list(state["r_" + k]) for k in rows}
        snp_pos = int(state["snp_pos"])
        num_tested = int(state["num_tested"])
        num_marker = int(state["num_marker"])
        telemetry.emit("checkpoint_resume", phase="vr", snp_pos=snp_pos)
    while snp_pos < n_rand:
        # gather the next chunk of markers passing the MAC filter
        pending = []
        while num_tested + len(pending) < num_marker and snp_pos < n_rand:
            i_snp = int(marker_order[snp_pos])  # 1-based
            snp_pos += 1
            g = codes[i_snp - 1].astype(np.float64)
            isnan = g >= 3
            num = int((~isnan).sum())
            if num == 0:          # all-missing marker (explicit variant_id
                continue          # panels bypass the missing-rate filter)
            ac = float(np.where(isnan, 0, g).sum())
            af = ac / (2 * num)
            g = np.where(isnan, ac / num, g)  # mean impute
            if af > 0.5:
                g = 2.0 - g
                ac = 2 * num - ac
                af = 1 - af
            if ac <= 20:  # suggested by the paper
                continue
            pending.append((i_snp, af, ac, g))
        if pending:
            G0 = np.stack([p[3] for p in pending], axis=1)   # [N, B]
            G = G0 - nok.XXVX_inv @ (nok.XV @ G0)
            SiG = _pcg(grm, W, tau, G, cfg.tol_pcg, cfg.maxiter_pcg)
            adj = Sigma_iX @ (xsx_inv @ (X1.T @ SiG))
            for k, (i_snp, af, ac, _) in enumerate(pending):
                var1 = (float(G[:, k] @ SiG[:, k]) -
                        float(G[:, k] @ adj[:, k])) / ac
                gn = G[:, k] / math.sqrt(ac)
                if binary:
                    var2 = float(np.sum(mu * (1 - mu) * gn * gn))
                else:
                    var2 = float(gn @ gn)
                rows["id"].append(i_snp)
                rows["maf"].append(af)
                rows["mac"].append(ac)
                rows["var1"].append(var1)
                rows["var2"].append(var2)
                rows["ratio"].append(var1 / var2)
                num_tested += 1
                # reference prints each marker's ratio (:1335-1339)
                telemetry.emit("var_ratio_marker", id=i_snp, maf=af,
                               mac=ac, var1=var1, var2=var2,
                               ratio=var1 / var2)
            if ckp:
                _ck_save(ckp, n_rand=n_rand, snp_pos=snp_pos,
                         num_tested=num_tested, num_marker=num_marker,
                         **{"r_" + k: np.asarray(v)
                            for k, v in rows.items()})
        if num_tested >= num_marker:
            cv = _calc_cv(rows["ratio"])
            if cv > cfg.ratio_cv_cutoff:
                num_marker += 10
                telemetry.emit("ratio_escalation", num_marker=num_marker,
                               cv=cv, cutoff=cfg.ratio_cv_cutoff)
            else:
                break
        elif snp_pos >= n_rand:
            break
    return rows


@partial(jax.jit, static_argnames=("maxiter", "binary"))
def _vr_chunk_multi_j(op, G0, XXVX_inv_s, XV_s, X1_s, SiX_s, xsx_inv_s,
                      Wp, taup, mu2_s, ac, tol, maxiter, binary):
    """One fused variance-ratio marker chunk for P phenotypes: project,
    solve (grouped PCG), and reduce to (var1, var2) [P, B] ON DEVICE.

    The host ships the raw marker block ``G0 [N, B]`` ONCE (not one
    projected copy per phenotype) and reads back only the per-marker
    scalars — over a slow link the [N, P*B] f64 solution readback would
    otherwise dominate the whole phase."""
    from ..ops.pcg import _pcg_body
    P = XXVX_inv_s.shape[0]
    N, B = G0.shape
    # per-phenotype covariate projection (calc_var_ratio's G line)
    Gp = G0[None] - jnp.einsum(
        "pnk,pkb->pnb", XXVX_inv_s,
        jnp.einsum("pkn,nb->pkb", XV_s, G0))        # [P, N, B]
    cols = jnp.transpose(Gp, (1, 0, 2)).reshape(N, P * B)
    cmap = jnp.repeat(jnp.arange(P), B)
    sol, _, conv = _pcg_body(op.matvec, op.diag, Wp[:, cmap], taup[:, cmap],
                             cols, tol, maxiter)
    SiG = jnp.transpose(sol.reshape(N, P, B), (1, 0, 2))   # [P, N, B]
    adj = jnp.einsum("pnk,pkb->pnb", SiX_s,
                     jnp.einsum("pkj,pjb->pkb", xsx_inv_s,
                                jnp.einsum("pnj,pnb->pjb", X1_s, SiG)))
    var1 = (jnp.sum(Gp * SiG, axis=1) - jnp.sum(Gp * adj, axis=1)) / ac
    if binary:
        var2 = jnp.einsum("pn,pnb->pb", mu2_s, Gp * Gp) / ac
    else:
        var2 = jnp.sum(Gp * Gp, axis=1) / ac
    return var1, var2, conv


def calc_var_ratio_multi(grm, codes, fit0s, glmms, noks,
                         cfg: NullModelConfig, marker_order: np.ndarray,
                         binary: bool = True, verbose=False):
    """P phenotypes' variance ratios over ONE resident GRM, batched.

    Lane-for-lane the same arithmetic as P separate :func:`calc_var_ratio`
    calls: the marker pass (MAC>20 filter, random order, escalation by 10
    while CV > ratioCVcutoff, src/saige_fitnull.cpp:1255-1474) is genotype
    -driven and thus shared; every marker chunk runs ONE fused device
    program (:func:`_vr_chunk_multi_j`) that projects per phenotype,
    solves all lanes' systems in one grouped PCG (per-column weights/tau
    expanded on device), and reduces to the per-marker scalars — the GRM
    streams once per chunk for all P, the raw markers upload once, and
    only [P, B] scalars come back.  Phenotypes whose ratio CV has
    converged stop consuming chunks (their serial loop would have
    exited).  No checkpointing (the PheWAS fit is a single-session path).

    Requires equal covariate widths across phenotypes (the
    `fit_null_glmm_multi` contract); returns a list of P row-dicts shaped
    like :func:`calc_var_ratio`'s.
    """
    from dataclasses import replace as _dc_replace

    if getattr(grm, "is_grm_handle", False):
        # handle path: per-phenotype serial (the fused kernel closes over
        # a single-device operator; the mesh fit is not the PheWAS path).
        # Checkpoints get a per-phenotype tag — with the shared cfg,
        # phenotype 0's completed vr checkpoint would otherwise be
        # resumed by every later phenotype (same n_rand passes the
        # mismatch guard) and silently duplicate its rows.
        cfgs = [_dc_replace(cfg, checkpoint=f"{cfg.checkpoint}.p{p}")
                if cfg.checkpoint else cfg for p in range(len(glmms))]
        out = [calc_var_ratio(grm, codes, fit0s[p], glmms[p], noks[p],
                              cfgs[p], marker_order, binary, verbose)
               for p in range(len(glmms))]
        for c in cfgs:          # all lanes done: drop per-lane resume state
            if c.checkpoint:
                clear_checkpoint(c)
        return out
    P = len(glmms)
    family = _Binomial() if binary else _Gaussian()
    Ws, mus = [], []
    for p in range(P):
        eta = fit0s[p].linear_predictors
        mu = fit0s[p].fitted_values
        mu_eta = family.mu_eta(eta)
        Ws.append((mu_eta * mu_eta) / family.variance(mu))
        mus.append(mu)
    if len({noks[p].X1.shape[1] for p in range(P)}) != 1:
        raise ValueError("calc_var_ratio_multi requires equal covariate "
                         "widths; run calc_var_ratio per phenotype")
    Wp = jnp.asarray(np.stack(Ws, axis=1))                   # [N, P]
    taup = jnp.asarray(np.stack([g.tau for g in glmms], axis=1))  # [2, P]
    X1_s = jnp.asarray(np.stack([noks[p].X1 for p in range(P)]))
    XXVX_inv_s = jnp.asarray(np.stack([noks[p].XXVX_inv for p in range(P)]))
    XV_s = jnp.asarray(np.stack([noks[p].XV for p in range(P)]))
    mu2_s = jnp.asarray(np.stack([m * (1 - m) for m in mus]))
    # Sigma^-1 X1 per phenotype: one grouped PCG, kept ON DEVICE for the
    # chunk kernel's adjustment term
    K = noks[0].X1.shape[1]
    col_map = np.repeat(np.arange(P, dtype=np.int32), K)
    cols = np.concatenate([noks[p].X1 for p in range(P)], axis=1)
    solX, _it, convX = _pcg_grouped_j(grm, Wp, taup,
                                      jnp.asarray(col_map),
                                      jnp.asarray(cols),
                                      cfg.tol_pcg, cfg.maxiter_pcg)
    if not bool(np.asarray(convX).all()):
        print("PCG does not converge (may need to increase 'maxiter').")
    N = cols.shape[0]
    SiX_s = jnp.transpose(solX.reshape(N, P, K), (1, 0, 2))  # [P, N, K]
    xsx_inv_s = jnp.asarray(np.stack([
        _mat_inv(noks[p].X1.T @ np.asarray(SiX_s[p])) for p in range(P)]))

    rows = [dict(id=[], maf=[], mac=[], var1=[], var2=[], ratio=[])
            for _ in range(P)]
    num_marker = [cfg.num_marker] * P
    active = list(range(P))
    snp_pos = 0
    num_tested = 0
    n_rand = len(marker_order)
    while snp_pos < n_rand and active:
        want = max(num_marker[p] for p in active)
        pending = []
        while num_tested + len(pending) < want and snp_pos < n_rand:
            i_snp = int(marker_order[snp_pos])  # 1-based
            snp_pos += 1
            g = codes[i_snp - 1].astype(np.float64)
            isnan = g >= 3
            num = int((~isnan).sum())
            if num == 0:
                continue
            ac = float(np.where(isnan, 0, g).sum())
            af = ac / (2 * num)
            g = np.where(isnan, ac / num, g)  # mean impute
            if af > 0.5:
                g = 2.0 - g
                ac = 2 * num - ac
                af = 1 - af
            if ac <= 20:  # suggested by the paper
                continue
            pending.append((i_snp, af, ac, g))
        if pending:
            # fixed kernel shape: marker chunks pad to num_marker columns
            # and ALL P lanes stay in the batch (inactive lanes compute
            # and are discarded) — each distinct (P, B) pair would
            # otherwise trigger another compile, and chunk sizes
            # vary (first chunk num_marker, escalations 10, drop-outs
            # shrink P)
            B0 = max(cfg.num_marker, len(pending))
            G0 = np.zeros((Wp.shape[0], B0))
            G0[:, :len(pending)] = np.stack([q[3] for q in pending], axis=1)
            ac_v = np.ones(B0)
            ac_v[:len(pending)] = [q[2] for q in pending]
            var1, var2, conv = _vr_chunk_multi_j(
                grm, jnp.asarray(G0), XXVX_inv_s, XV_s, X1_s,
                SiX_s, xsx_inv_s, Wp, taup,
                mu2_s, jnp.asarray(ac_v), cfg.tol_pcg,
                cfg.maxiter_pcg, binary)
            var1, var2 = np.asarray(var1), np.asarray(var2)
            if not bool(np.asarray(conv).all()):
                print("PCG does not converge (may need to increase "
                      "'maxiter').")
            for p in active:
                for k, (i_snp, af, ac, _) in enumerate(pending):
                    rows[p]["id"].append(i_snp)
                    rows[p]["maf"].append(af)
                    rows[p]["mac"].append(ac)
                    rows[p]["var1"].append(var1[p, k])
                    rows[p]["var2"].append(var2[p, k])
                    rows[p]["ratio"].append(var1[p, k] / var2[p, k])
                    # telemetry parity with the serial path's per-marker
                    # event (reference print, src/saige_fitnull.cpp:1335)
                    telemetry.emit("var_ratio_marker", phenotype=p,
                                   id=i_snp, maf=af, mac=ac,
                                   var1=var1[p, k], var2=var2[p, k],
                                   ratio=var1[p, k] / var2[p, k])
            num_tested += len(pending)
        still = []
        for p in active:
            if num_tested >= num_marker[p]:
                cv = _calc_cv(rows[p]["ratio"])
                if cv > cfg.ratio_cv_cutoff:
                    num_marker[p] = num_tested + 10
                    telemetry.emit("ratio_escalation",
                                   num_marker=num_marker[p], cv=cv,
                                   cutoff=cfg.ratio_cv_cutoff)
                    still.append(p)
            else:
                still.append(p)
        active = still
    return rows


def calc_var_ratio_cat(grm: GRMOperator, codes: np.ndarray, fit0: GlmFit,
                       glmm: GlmmFit, nok: ObjNoK, cfg: NullModelConfig,
                       marker_order: np.ndarray, binary: bool,
                       verbose=False):
    """Variance ratios per MAC category (opt-in via
    ``NullModelConfig.var_ratio_mac_cat`` — a newer-than-v1.12.5 SAIGEgds
    feature; the reference at /root/reference estimates ONE pooled ratio
    over markers with MAC>20, src/saige_fitnull.cpp:1316).

    Category ``c`` spans minor-allele count in ``(edges[c-1], edges[c]]``
    plus a trailing open ``(edges[-1], inf)`` category.  Each category
    runs the same estimation loop as :func:`calc_var_ratio` — initial
    ``num_marker`` markers, +10 escalation until the ratio CV is under
    ``ratio_cv_cutoff`` — with the MAC-range predicate replacing the
    fixed ``mac > 20`` cut.  Rows carry ``mac_cat`` (the category index);
    markers fall in exactly one category, so one walk of the shared
    ``marker_order`` per category never tests a marker twice."""
    edges = [float(e) for e in cfg.var_ratio_mac_cat]
    if not edges or edges != sorted(edges):
        raise ValueError("var_ratio_mac_cat must be ascending MAC bounds")
    family = _Binomial() if binary else _Gaussian()
    eta = fit0.linear_predictors
    mu = fit0.fitted_values
    mu_eta = family.mu_eta(eta)
    W = (mu_eta * mu_eta) / family.variance(mu)
    tau = glmm.tau
    X1 = nok.X1
    Sigma_iX = _pcg(grm, W, tau, X1, cfg.tol_pcg, cfg.maxiter_pcg)
    xsx_inv = _mat_inv(X1.T @ Sigma_iX)

    bounds = [(0.0 if c == 0 else edges[c - 1],
               edges[c] if c < len(edges) else math.inf)
              for c in range(len(edges) + 1)]
    rows = dict(id=[], maf=[], mac=[], var1=[], var2=[], ratio=[],
                mac_cat=[])
    n_rand = len(marker_order)
    for c, (lo, hi) in enumerate(bounds):
        num_marker = cfg.num_marker
        snp_pos = 0
        cat_ratio = []
        while snp_pos < n_rand:
            pending = []
            while len(cat_ratio) + len(pending) < num_marker \
                    and snp_pos < n_rand:
                i_snp = int(marker_order[snp_pos])  # 1-based
                snp_pos += 1
                g = codes[i_snp - 1].astype(np.float64)
                isnan = g >= 3
                num = int((~isnan).sum())
                if num == 0:
                    continue
                ac = float(np.where(isnan, 0, g).sum())
                af = ac / (2 * num)
                g = np.where(isnan, ac / num, g)  # mean impute
                if af > 0.5:
                    g = 2.0 - g
                    ac = 2 * num - ac
                    af = 1 - af
                if not (lo < ac <= hi) or ac <= 0:
                    continue
                pending.append((i_snp, af, ac, g))
            if pending:
                G0 = np.stack([p[3] for p in pending], axis=1)   # [N, B]
                G = G0 - nok.XXVX_inv @ (nok.XV @ G0)
                SiG = _pcg(grm, W, tau, G, cfg.tol_pcg, cfg.maxiter_pcg)
                adj = Sigma_iX @ (xsx_inv @ (X1.T @ SiG))
                for k, (i_snp, af, ac, _) in enumerate(pending):
                    var1 = (float(G[:, k] @ SiG[:, k]) -
                            float(G[:, k] @ adj[:, k])) / ac
                    gn = G[:, k] / math.sqrt(ac)
                    if binary:
                        var2 = float(np.sum(mu * (1 - mu) * gn * gn))
                    else:
                        var2 = float(gn @ gn)
                    rows["id"].append(i_snp)
                    rows["maf"].append(af)
                    rows["mac"].append(ac)
                    rows["var1"].append(var1)
                    rows["var2"].append(var2)
                    rows["ratio"].append(var1 / var2)
                    rows["mac_cat"].append(c)
                    cat_ratio.append(var1 / var2)
                    telemetry.emit("var_ratio_marker", id=i_snp, maf=af,
                                   mac=ac, var1=var1, var2=var2,
                                   ratio=var1 / var2, mac_cat=c)
            if len(cat_ratio) >= num_marker:
                cv = _calc_cv(cat_ratio)
                if cv > cfg.ratio_cv_cutoff:
                    num_marker += 10
                    telemetry.emit("ratio_escalation", mac_cat=c,
                                   num_marker=num_marker, cv=cv,
                                   cutoff=cfg.ratio_cv_cutoff)
                else:
                    break
            elif snp_pos >= n_rand:
                break
        if not cat_ratio:
            warnings.warn(
                f"variance-ratio MAC category ({lo}, {hi}] matched no GRM "
                f"marker; the scan falls back to the overall mean there")
        elif len(cat_ratio) < cfg.num_marker:
            warnings.warn(
                f"variance-ratio MAC category ({lo}, {hi}] found only "
                f"{len(cat_ratio)}/{cfg.num_marker} markers")
    return rows


# ---------------------------------------------------------------------------
# top-level driver


class _MarkerRows(dict):
    """Cached genotype rows for the variance-ratio markers (streamed fits).

    Keys are 0-based local indices into the GRM variant set; misses beyond
    the harvest cache fall back to random-access frame reads (``loader``)."""

    def __init__(self, cache_k: int, loader=None):
        super().__init__()
        self.cache_k = cache_k
        self.loader = loader

    def __missing__(self, key):
        if self.loader is not None:
            row = self.loader(key)
            self[key] = row
            return row
        raise RuntimeError(
            f"variance-ratio escalation needed marker row {key} beyond the "
            f"streamed cache of {self.cache_k}; refit with stream_geno=False "
            f"or a larger num_marker")


def _split_top(s: str, sep: str):
    """Split ``s`` on single-char ``sep`` outside parentheses."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def _parse_formula(formula: str):
    """Parse an R-style formula into (response, term list).

    Supports additive terms, ``a:b`` interactions, ``a*b`` crossing
    (expanded to main effects + interactions, R's rule), and ``I(expr)``
    arithmetic terms — the formula features `seqFitNullGLMM_SPA` hands to
    R's `model.matrix` (reference R/saige_main.r:345-352)."""
    lhs, rhs = formula.split("~")
    resp = lhs.strip()
    terms = []
    for t in _split_top(rhs, "+"):
        t = t.strip()
        if t in ("", "1"):
            continue
        comps = [c.strip() for c in _split_top(t, "*")]
        if len(comps) == 1:
            terms.append(t)
            continue
        # a*b*c -> all non-empty subsets, smaller interactions first
        from itertools import combinations
        for k in range(1, len(comps) + 1):
            for sub in combinations(comps, k):
                terms.append(":".join(sub))
    # dedupe, first appearance wins
    seen, out = set(), []
    for t in terms:
        if t not in seen:
            seen.add(t)
            out.append(t)
    return resp, out


def _term_vars(terms):
    """Base data columns referenced by a term list (for NA-dropping)."""
    import ast
    names = []
    for t in terms:
        for c in _split_top(t, ":"):
            c = c.strip()
            if c.startswith("I(") and c.endswith(")"):
                tree = ast.parse(c[2:-1], mode="eval")
                called = {n.func.id for n in ast.walk(tree)
                          if isinstance(n, ast.Call)
                          and isinstance(n.func, ast.Name)}
                for node in ast.walk(tree):
                    if isinstance(node, ast.Name) and node.id not in called:
                        names.append(node.id)
            else:
                names.append(c)
    seen, out = set(), []
    for n in names:
        if n not in seen:
            seen.add(n)
            out.append(n)
    return out


_I_FUNCS = {"log": np.log, "log2": np.log2, "log10": np.log10,
            "exp": np.exp, "sqrt": np.sqrt, "abs": np.abs}


# Phenotype tables: a pandas DataFrame or a mapping of column name -> 1-D
# array.  The helpers below read both without importing pandas.

def _n_rows(data) -> int:
    return len(data[next(iter(data.keys()))])


def _is_numeric(v) -> bool:
    """Numeric column (a pandas categorical is a factor, whatever its
    values)."""
    return not hasattr(v, "cat") and np.asarray(v).dtype.kind in "biuf"


def _select(data, cols):
    if hasattr(data, "iloc"):
        return data[cols]
    return {c: np.asarray(data[c]) for c in cols}


def _take_rows(data, rows):
    if hasattr(data, "iloc"):
        return data.iloc[rows].reset_index(drop=True)
    return {k: v[rows] for k, v in data.items()}


def _complete_rows(data, cols):
    """The named columns, without the rows that miss any of them (the
    ``dropna`` of R's model frame)."""
    ok = np.ones(_n_rows(data), bool)
    for c in cols:
        v = np.asarray(data[c])
        if v.dtype.kind == "f":
            ok &= ~np.isnan(v)
        elif v.dtype.kind == "O":
            ok &= ~np.asarray([_is_missing(x) for x in v], bool)
    return _take_rows(_select(data, cols), np.flatnonzero(ok))


def _is_missing(x) -> bool:
    """None, NaN, or a value whose truth is undefined (pandas' NA)."""
    try:
        return x is None or bool(x != x)
    except TypeError:
        return True


def _component_cols(data, c):
    """One formula component -> list of (name, float64 column)."""
    if c.startswith("I(") and c.endswith(")"):
        env = dict(_I_FUNCS)
        env.update({k: np.asarray(data[k], np.float64) for k in data.keys()
                    if _is_numeric(data[k])})
        val = eval(c[2:-1], {"__builtins__": {}}, env)  # noqa: S307
        return [(c, np.asarray(val, np.float64))]
    v = data[c]
    if _is_numeric(v):
        return [(c, np.asarray(v, np.float64))]
    # factor: one indicator per level after the first (R's treatment
    # contrasts); levels sort like R's factor(), or keep a categorical's
    levels = list(v.cat.categories) if hasattr(v, "cat") \
        else sorted(set(np.asarray(v).tolist()))
    vals = np.asarray(v, dtype=object)
    return [(f"{c}_{lv}", (vals == lv).astype(np.float64))
            for lv in levels[1:]]


def _model_matrix(data, terms):
    cols = [np.ones(_n_rows(data))]
    names = ["(Intercept)"]
    for t in terms:
        comps = [c.strip() for c in _split_top(t, ":")]
        blocks = [_component_cols(data, c) for c in comps]
        prod = blocks[0]
        for blk in blocks[1:]:
            prod = [(f"{na}:{nb}", va * vb) for na, va in prod
                    for nb, vb in blk]
        for nm, v in prod:
            cols.append(v)
            names.append(nm)
    return np.column_stack(cols), names


def fit_null_glmm(formula: str, data, gdsfile,
                  config: NullModelConfig = NullModelConfig(),
                  model_savefn: str = "", verbose: bool = False,
                  mesh=None, variant_id=None) -> NullModel:
    """Fit the null GLMM (the ``seqFitNullGLMM_SPA`` equivalent).

    formula: e.g. ``"y ~ x1 + x2"`` over columns of ``data`` (a pandas
    DataFrame, or a mapping of column name -> 1-D array, with a sample-id
    column, reference R/saige_main.r:223).

    ``variant_id``: explicit GRM SNP panel — REPLACES the maf/missing
    filter, exactly like the reference's ``variant.id=`` argument
    (R/saige_main.r:314-323); the ``max_num_snp`` down-sample still
    applies on top.
    """
    cfg = config
    seq = gdsfile if isinstance(gdsfile, SeqData) else SeqData(gdsfile)
    resp, covs = _parse_formula(formula)
    prep = _prepare_fit(seq, data, cfg, [resp], covs, mesh, variant_id,
                        verbose, formula)

    tele = telemetry.collect(verbose=verbose)
    tele_obj = tele.__enter__()
    try:
        model = _fit_dispatch(cfg, prep["grm"], prep["codes"],
                              np.asarray(prep["data"][resp], np.float64),
                              prep["X_new"], prep["X_qrr"], prep["X_names"],
                              prep["x_transform"], prep["variant_id"],
                              prep["sample_id"], prep["n_var"],
                              prep["n_samp"], verbose)
    finally:
        tele.__exit__(None, None, None)
    clear_checkpoint(cfg)   # fit + var-ratio complete: drop resume state
    model.fit_log = tele_obj.events
    if model_savefn:
        model.save(model_savefn)
    return model


# Device memory a fit assumes on a backend that reports none: XLA's CPU
# client has no memory_stats().  16 GiB keeps the CPU on the bf16 store up
# to 4 GiB of codes, the threshold the tests are written against.
CPU_MEMORY_BUDGET = 16 << 30


def _device_memory_budget() -> int:
    """Bytes one device may hold: ``memory_stats()["bytes_limit"]``, or
    :data:`CPU_MEMORY_BUDGET` on the CPU."""
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    if dev.platform == "cpu":
        return CPU_MEMORY_BUDGET
    raise RuntimeError(f"{dev.platform} device {dev.device_kind!r} reports "
                       "no memory_stats()['bytes_limit']; cannot size the "
                       "GRM store")


def _auto_grm_impl(n_variants: int, n_samples: int, mesh=None,
                   budget: int = 0) -> str:
    """``grm_impl="auto"``: the bf16 code store (2 B/genotype, the fastest
    matvec) while it fits in a quarter of device memory, else the 2-bit
    planar store (0.25 B/genotype, the reference's footprint; one program
    or split, :func:`_packed2_engine`).  A quarter leaves room for the
    PCG state, the probe pool and the decode transients.  A mesh shards
    the bf16 store over its devices (ShardedGrmHandle), so per-device
    memory already divides."""
    budget = budget or _device_memory_budget()
    if mesh is not None or 2 * n_variants * n_samples <= budget // 4:
        return "packed"
    return "packed2"


# Device bytes of the one-program 2-bit fit: per store byte and per padded
# missing call.  compiled.memory_analysis() of the PCG solve and of the
# device fit at N=430K x M=64Ki on an H100 gave 8.4-8.5 x the store plus
# 16 B per missing call (its three index arrays; the gathers fuse into the
# scatters); the device fit there peaked at 8.8 x the store.
ONE_PROGRAM_PER_STORE_BYTE = 9
ONE_PROGRAM_PER_MISSING = 16


def _packed2_engine(store_bytes: int, n_missing: int, budget: int = 0) -> str:
    """``grm_impl="auto"`` on the 2-bit store: the one-program fit while
    its estimated peak stays within 90% of device memory (the rest is
    allocator slack and the arrays outside the program), else the
    bounded-program split engine, whose largest program is one leaf
    group (ops/packed_grm.SplitPacked2)."""
    budget = budget or _device_memory_budget()
    peak = (ONE_PROGRAM_PER_STORE_BYTE * store_bytes
            + ONE_PROGRAM_PER_MISSING * n_missing)
    return "packed2" if peak <= 0.9 * budget else "packed2_split"


def _prepare_fit(seq: SeqData, data, cfg, resp_cols, covs, mesh,
                 variant_id, verbose, formula_str=""):
    """Shared fit preamble: sample alignment, variant filtering, GRM SNP
    down-sampling, covariate design + QR transform, and the GRM build —
    everything `fit_null_glmm` does before the response enters (reference
    R/saige_main.r:303-420).  ``resp_cols`` may hold several responses
    (PheWAS-mode `fit_null_glmm_multi`): alignment then keeps samples
    complete in ALL of them."""
    # sample alignment (R/saige_main.r:303-313)
    data = _complete_rows(data, [cfg.sample_col] + resp_cols
                          + _term_vars(covs))
    sid = np.asarray(data[cfg.sample_col]).astype(str)
    order = {s: i for i, s in enumerate(sid)}
    keep = [order[s] for s in seq.sample_id.astype(str) if s in order]
    if not keep:
        raise ValueError("No common sample.id between 'data' and the GDS file.")
    data = _take_rows(data, np.asarray(keep, np.int64))
    samp_mask = np.isin(seq.sample_id.astype(str),
                        np.asarray(data[cfg.sample_col]).astype(str))
    sample_id = seq.sample_id[samp_mask]

    stream = cfg.stream_geno
    if stream == "auto":
        # stream when the host int8 matrix would top ~4 GB (the scan
        # drivers use the same threshold, io/seqarray.py)
        stream = seq.n_variants * seq.n_samples > 4 << 30
    impl = cfg.grm_impl
    if impl == "auto":
        impl = _auto_grm_impl(seq.n_variants, len(keep), mesh)
    if mesh is not None and impl not in ("dense", "packed"):
        # fail BEFORE the (potentially hours-long) GRM build: the sharded
        # handle only wraps the dense/bf16 operators
        raise ValueError(
            f"grm_impl={impl!r} cannot be mesh-sharded; use 'packed' "
            "(per-device HBM divides by the mesh size) or 'auto'")
    streamed = impl in ("packed", "packed2") and stream \
        and seq.has_genotype()
    if streamed:
        codes = None
        if variant_id is None:
            # pass 1: streamed per-variant maf/missing for the filter
            maf = np.empty(seq.n_variants)
            miss = np.empty(seq.n_variants)
            for idx, blk in seq.iter_code_blocks(8192, streamed=True):
                blk = blk[:, samp_mask]
                valid = blk < 3
                n_valid = valid.sum(axis=1)
                ac = np.where(valid, blk, 0).sum(axis=1, dtype=np.int64)
                with np.errstate(invalid="ignore", divide="ignore"):
                    af = ac / (2.0 * n_valid)
                maf[idx] = np.minimum(af, 1 - af)
                miss[idx] = 1.0 - n_valid / blk.shape[1]
    else:
        # genotype codes for the selected samples: [M, N] int8, 3 = missing
        codes = _genotype_codes(seq)[:, samp_mask]
        valid = codes < 3
        n_valid = valid.sum(axis=1)
        ac = np.where(valid, codes, 0).sum(axis=1, dtype=np.int64)
        with np.errstate(invalid="ignore", divide="ignore"):
            af = ac / (2.0 * n_valid)
        maf = np.minimum(af, 1 - af)
        miss = 1.0 - n_valid / codes.shape[1]

    if variant_id is not None:
        # explicit GRM panel: replaces the maf/missing filter
        # (R/saige_main.r:314-323 seqSetFilter(variant.id=))
        vmask = np.isin(seq.variant_id, np.asarray(variant_id))
        if not vmask.any():
            raise ValueError("variant_id matches no variants in the GDS file")
    else:
        # variant filters: maf >= maf, missing.rate <= missing.rate
        # (seqSetFilterCond, R/saige_main.r:319-320)
        vmask = np.isfinite(maf) & (maf >= cfg.maf) & \
            (miss <= cfg.missing_rate)
    variant_id = seq.variant_id[vmask]
    if codes is not None:
        codes = codes[vmask]
    n_filtered = int(vmask.sum())

    # random down-sample to max_num_snp (R/saige_main.r:328-333)
    if cfg.max_num_snp > 0 and n_filtered > cfg.max_num_snp:
        rng = RRandom(cfg.seed)
        sel = np.sort(rng.sample_int(n_filtered, cfg.max_num_snp) - 1)
        if codes is not None:
            codes = codes[sel]
        variant_id = variant_id[sel]
        selmask = np.zeros(n_filtered, bool)
        selmask[sel] = True
    else:
        selmask = np.ones(n_filtered, bool)

    n_samp = int(samp_mask.sum())
    n_var = len(variant_id)
    if verbose:
        print(f"Fit the null model: {formula_str or resp_cols} + var(GRM)")
        print(f"    # of samples: {n_samp}\n    # of variants: {n_var}")

    # design matrix + QR transform (R/saige_main.r:356-387)
    X, X_names = _model_matrix(data, covs)
    x_transform = cfg.x_transform and X.shape[1] > 1
    if x_transform:
        X_new, X_qrr, keep_cols = qr_transform(X)
        if not keep_cols.all():   # collinear columns dropped: names follow
            X_names = [nm for nm, k in zip(X_names, keep_cols) if k]
    else:
        X_new, X_qrr = X, None

    if streamed:
        # pass 2: streamed build + harvest the rows the variance-ratio
        # estimator will touch (marker order is seed-deterministic)
        rng = RRandom(cfg.seed)
        marker_order = rng.sample_int(n_var, n_var)
        cache_k = min(n_var, max(600, cfg.num_marker * 20))
        want_rows = set(int(i) - 1 for i in marker_order[:cache_k])
        local_to_global = np.flatnonzero(vmask)[selmask]

        def _load_row(local_idx):
            row = seq.code_rows(local_to_global[local_idx:local_idx + 1])[0]
            return np.ascontiguousarray(row[samp_mask])

        marker_rows = _MarkerRows(cache_k, loader=_load_row)
        full_sel = np.zeros(seq.n_variants, bool)
        full_sel[local_to_global] = True

        def blocks():
            local0 = 0
            for idx, blk in seq.iter_code_blocks(8192, streamed=True,
                                                 variant_mask=full_sel):
                blk = np.ascontiguousarray(blk[:, samp_mask])
                for r in range(blk.shape[0]):
                    if local0 + r in want_rows:
                        marker_rows[local0 + r] = blk[r].copy()
                local0 += blk.shape[0]
                yield idx, blk

        if impl in ("packed2", "packed2_split"):
            from ..ops.packed_grm import build_packed2_grm_streamed
            grm = build_packed2_grm_streamed(blocks(), n_samp)
        elif mesh is not None:
            # place each block sample-sharded as it streams: the full
            # bf16 store never exists unsharded on one device
            from ..parallel.mesh import ShardedGrmHandle
            grm = ShardedGrmHandle.from_streamed_blocks(blocks(), n_samp,
                                                        mesh)
        else:
            grm = build_packed_grm_streamed(blocks(), n_samp)
        codes = marker_rows            # row provider for calc_var_ratio
    elif impl == "packed":
        grm = build_packed_grm(codes)
    elif impl in ("packed2", "packed2_split"):
        from ..ops.packed_grm import build_packed2_grm
        grm = build_packed2_grm(codes)
    elif impl == "dense":
        grm = build_grm(codes)
    else:
        raise ValueError(f"grm_impl must be 'auto', 'dense', 'packed', "
                         f"'packed2' or 'packed2_split', got "
                         f"{cfg.grm_impl!r}")
    if cfg.grm_impl == "auto" and impl == "packed2":
        impl = _packed2_engine(
            sum(t.nbytes for lf in grm.packed for t in lf),
            len(grm.miss_pad))
    if impl == "packed2_split":
        # bounded-program handle: host-driven PCG over per-leaf-group
        # matvec programs (ops/packed_grm.SplitPacked2); the fitter and
        # the variance ratio dispatch through it duck-typed
        from ..ops.packed_grm import SplitPacked2
        grm = SplitPacked2(grm)
    if mesh is not None:
        from ..parallel.mesh import ShardedGrmHandle
        if not isinstance(grm, ShardedGrmHandle):
            grm = ShardedGrmHandle(grm, mesh)

    return dict(data=data, sample_id=sample_id, grm=grm, codes=codes,
                variant_id=variant_id, n_var=n_var, n_samp=n_samp,
                X_new=X_new, X_qrr=X_qrr, X_names=X_names,
                x_transform=x_transform)


def fit_null_glmm_multi(formulas, data, gdsfile,
                        config: NullModelConfig = NullModelConfig(),
                        model_savefn: str = "", verbose: bool = False,
                        variant_id=None, probe_pool: int = 0) -> list:
    """PheWAS-mode null fit: P binary phenotypes over ONE resident GRM.

    ``formulas``: list of formulas (binary or quantitative per
    ``config.trait_type``) sharing the same covariate terms (e.g.
    ``["y1 ~ x1 + x2", "y2 ~ x1 + x2"]``), or a single formula whose
    response lists several columns (``"y1 + y2 ~ x1 + x2"`` is NOT
    supported — pass a list).  The GRM is ingested and kept resident
    once, every AI-REML stage solves all phenotypes' systems in one
    batched PCG (models/fit_device.fit_glmm_binary_device_multi), and the
    variance-ratio phase reuses the resident operator per phenotype — P
    fits cost about one fit.  The reference fits strictly one phenotype
    per call, re-streaming its GRM each time (R/saige_main.r:223).

    Deliberate differences from P separate :func:`fit_null_glmm` calls:
    (1) samples must be complete cases across ALL responses (one shared
    sample universe — the per-fit dropna would give each phenotype its
    own N and break the batching); (2) the AI-REML engine is the device
    fitter, which matches the host bit-replay path within the 2%
    stopping rule rather than bit-for-bit (see models/fit_device.py);
    (3) no mid-fit checkpointing.

    ``model_savefn``: optional pattern containing ``{}`` (formatted with
    the phenotype index).  ``probe_pool``: Hutchinson probe pool size
    (default ``max(2*nrun, nrun+30)``; the pool bounds trace-CV
    escalation — ``trace_capped`` on the result flags exhaustion).
    Returns a list of :class:`NullModel`, one per formula.
    """
    import jax.numpy as jnp

    from .fit_device import (fit_glmm_binary_device_multi,
                             fit_glmm_quant_device_multi)

    cfg = config
    if cfg.trait_type not in ("binary", "quantitative"):
        raise ValueError(f"Invalid trait type {cfg.trait_type!r}")
    binary = cfg.trait_type == "binary"
    if isinstance(formulas, str):
        formulas = [formulas]
    if model_savefn:
        try:
            probe = model_savefn.format(0)
        except Exception as e:
            raise ValueError(f"model_savefn is not a valid '{{}}' pattern "
                             f"({e!r}): {model_savefn!r}") from None
        if probe == model_savefn:
            raise ValueError("model_savefn must contain '{}' "
                             "(phenotype index)")
    parsed = [_parse_formula(f) for f in formulas]
    resps = [r for r, _c in parsed]
    if len(set(resps)) != len(resps):
        raise ValueError(f"duplicate response columns: {resps}")
    covs0 = parsed[0][1]
    for f, (_r, covs) in zip(formulas[1:], parsed[1:]):
        if covs != covs0:
            raise ValueError(
                f"all formulas must share the same covariate terms for a "
                f"batched fit; {formulas[0]!r} vs {f!r} differ")

    seq = gdsfile if isinstance(gdsfile, SeqData) else SeqData(gdsfile)
    prep = _prepare_fit(seq, data, cfg, resps, covs0, None, variant_id,
                        verbose, " | ".join(formulas))
    X_new = prep["X_new"]
    P = len(resps)

    ys, fit0s, noks, etas, tau0s = [], [], [], [], []
    for r in resps:
        y_raw = np.asarray(prep["data"][r], np.float64)
        if binary:
            if set(np.unique(y_raw)) - {0.0, 1.0}:
                raise ValueError(f"binary trait {r!r} must be coded 0/1")
            fit0 = glm_binomial(X_new, y_raw)
            ys.append(y_raw)
            noks.append(obj_nok_binary(X_new, y_raw))
            # initial tau: (1, 0.5) unless given (R/saige_main.r:489-495)
            tau = np.array([1.0, 0.5])
            ti = np.nan_to_num(np.asarray(cfg.tau_init, float))
            ti[ti < 0] = 0
            if ti[1] > 0:
                tau[1] = ti[1]
        else:
            yq = y_raw.copy()
            if cfg.inv_norm:
                fit_pre = glm_gaussian(X_new, yq)
                resid_sd = np.std(fit_pre.residuals, ddof=1)
                yq = rank_norm(fit_pre.residuals) * resid_sd
            fit0 = glm_gaussian(X_new, yq)
            nok = obj_nok_quant(X_new, fit0)
            ys.append(fit0.y)        # gaussian working response
            noks.append(nok)
            ti = np.nan_to_num(np.asarray(cfg.tau_init, float))
            ti[ti < 0] = 0
            tau = ti if ti.sum() > 0 else np.array([0.5, 0.5])
            tau = np.var(fit0.y, ddof=1) * tau / tau.sum()
        fit0s.append(fit0)
        etas.append(fit0.linear_predictors)
        tau0s.append(tau)

    # shared Rademacher probe pool, R-RNG replay like the host fitter's
    # first nrun probes (utils/rrandom); extra columns feed CV escalation
    n = X_new.shape[0]
    R = probe_pool or max(2 * cfg.nrun, cfg.nrun + 30)
    rng = RRandom(cfg.seed)
    U = np.stack([rng.rademacher(n).astype(np.float64) for _ in range(R)],
                 axis=1)

    from ..ops.packed_grm import SplitPacked2
    if isinstance(prep["grm"], SplitPacked2):
        # the batched one-dispatch program needs a pytree operator; with
        # grm_impl="packed2_split" run the split
        # fitters per phenotype over the shared resident store — the GRM
        # never re-ingests, which is still the PheWAS win the reference
        # lacks (it re-streams its GRM per phenotype)
        from .fit_split import fit_glmm_binary_split, fit_glmm_quant_split
        fits = []
        for p in range(P):
            if binary:
                fits.append(fit_glmm_binary_split(
                    prep["grm"], ys[p], X_new, tau0s[p], etas[p], U,
                    tol=cfg.tol, tol_pcg=cfg.tol_pcg,
                    maxiter=cfg.maxiter, maxiter_pcg=cfg.maxiter_pcg,
                    nrun=cfg.nrun, trace_cv_cutoff=cfg.trace_cv_cutoff,
                    verbose=verbose))
            else:
                fits.append(fit_glmm_quant_split(
                    prep["grm"], ys[p], X_new, tau0s[p], U,
                    tol=cfg.tol, tol_pcg=cfg.tol_pcg,
                    maxiter=cfg.maxiter, maxiter_pcg=cfg.maxiter_pcg,
                    nrun=cfg.nrun, trace_cv_cutoff=cfg.trace_cv_cutoff,
                    verbose=verbose))
        from .fit_device import DeviceFit
        fit = DeviceFit(
            coefficients=np.stack([f.coefficients for f in fits]),
            tau=np.stack([f.tau for f in fits]),
            eta=np.stack([f.eta for f in fits]),
            mu=np.stack([f.mu for f in fits]),
            cov=np.stack([f.cov for f in fits]),
            iterations=np.stack([f.iterations for f in fits]),
            converged=np.asarray([f.converged for f in fits]),
            trace_capped=np.asarray([f.trace_capped for f in fits]))
    elif binary:
        fit = fit_glmm_binary_device_multi(
            prep["grm"], jnp.asarray(np.stack(ys)), jnp.asarray(X_new),
            jnp.asarray(np.stack(tau0s)),
            jnp.asarray(np.stack(etas)), jnp.asarray(U),
            cfg.tol, cfg.tol_pcg, maxiter=cfg.maxiter,
            maxiter_pcg=cfg.maxiter_pcg, nrun=cfg.nrun,
            trace_cv_cutoff=cfg.trace_cv_cutoff)
    else:
        fit = fit_glmm_quant_device_multi(
            prep["grm"], jnp.asarray(np.stack(ys)), jnp.asarray(X_new),
            jnp.asarray(np.stack(tau0s)), jnp.asarray(U),
            cfg.tol, cfg.tol_pcg, maxiter=cfg.maxiter,
            maxiter_pcg=cfg.maxiter_pcg, nrun=cfg.nrun,
            trace_cv_cutoff=cfg.trace_cv_cutoff)
    capped = np.asarray(fit.trace_capped)
    if capped.any():
        import warnings
        bad = [r for r, c in zip(resps, capped) if c]
        warnings.warn(
            f"Hutchinson trace probe pool ({R}) exhausted with CV above "
            f"{cfg.trace_cv_cutoff} for {bad}; pass a larger probe_pool=",
            RuntimeWarning)

    glmms = [GlmmFit(
        coefficients=np.asarray(fit.coefficients[p]),
        tau=np.asarray(fit.tau[p]),
        linear_predictors=np.asarray(fit.eta[p]),
        fitted_values=np.asarray(fit.mu[p]),
        residuals=ys[p] - np.asarray(fit.mu[p]),
        cov=np.asarray(fit.cov[p]),
        converged=bool(fit.converged[p])) for p in range(P)]
    rng = RRandom(cfg.seed)
    marker_order = rng.sample_int(prep["n_var"], prep["n_var"])
    if cfg.var_ratio_mac_cat:
        vrs = [calc_var_ratio_cat(prep["grm"], prep["codes"], fit0s[p],
                                  glmms[p], noks[p], cfg, marker_order,
                                  binary=binary, verbose=verbose)
               for p in range(P)]
    else:
        # all phenotypes' marker solves stacked into shared PCG calls —
        # the GRM streams once per marker chunk for all P
        vrs = calc_var_ratio_multi(prep["grm"], prep["codes"], fit0s,
                                   glmms, noks, cfg, marker_order,
                                   binary=binary, verbose=verbose)
    models = []
    for p, r in enumerate(resps):
        model = _assemble_model(cfg, glmms[p], vrs[p], noks[p],
                                prep["X_qrr"], prep["X_names"],
                                prep["x_transform"], prep["variant_id"],
                                prep["sample_id"], prep["n_samp"])
        if model_savefn:
            model.save(model_savefn.format(p))
        models.append(model)
    return models


def _fit_dispatch(cfg, grm, codes, y_raw, X_new, X_qrr, X_names,
                  x_transform, variant_id, sample_id, n_var, n_data,
                  verbose) -> NullModel:
    if cfg.trait_type == "binary":
        if set(np.unique(y_raw)) - {0.0, 1.0}:
            raise ValueError("binary trait must be coded 0/1")
        fit0 = glm_binomial(X_new, y_raw)
        nok = obj_nok_binary(X_new, y_raw)
        # initial tau: (1, 0.5) unless tau_init given (R/saige_main.r:489-495)
        tau = np.array([1.0, 0.5])
        ti = np.nan_to_num(np.asarray(cfg.tau_init, float))
        ti[ti < 0] = 0
        if ti[1] > 0:
            tau[1] = ti[1]
        glmm = fit_ai_pcg(grm, fit0, X_new, tau, cfg, binary=True,
                          verbose=verbose)
        rng = RRandom(cfg.seed)
        marker_order = rng.sample_int(n_var, n_var)
        vr_fn = calc_var_ratio_cat if cfg.var_ratio_mac_cat \
            else calc_var_ratio
        vr = vr_fn(grm, codes, fit0, glmm, nok, cfg, marker_order,
                   binary=True, verbose=verbose)
    elif cfg.trait_type == "quantitative":
        yq = y_raw.copy()
        if cfg.inv_norm:
            fit_pre = glm_gaussian(X_new, yq)
            resid_sd = np.std(fit_pre.residuals, ddof=1)
            yq = rank_norm(fit_pre.residuals) * resid_sd
        fit0 = glm_gaussian(X_new, yq)
        nok = obj_nok_quant(X_new, fit0)
        ti = np.nan_to_num(np.asarray(cfg.tau_init, float))
        ti[ti < 0] = 0
        tau = ti if ti.sum() > 0 else np.array([0.5, 0.5])
        Y = fit0.y  # gaussian working response == y
        tau = np.var(Y, ddof=1) * tau / tau.sum()
        glmm = fit_ai_pcg(grm, fit0, nok.X1, tau, cfg, binary=False,
                          verbose=verbose)
        rng = RRandom(cfg.seed)
        marker_order = rng.sample_int(n_var, n_var)
        vr_fn = calc_var_ratio_cat if cfg.var_ratio_mac_cat \
            else calc_var_ratio
        vr = vr_fn(grm, codes, fit0, glmm, nok, cfg, marker_order,
                   binary=False, verbose=verbose)
    else:
        raise ValueError(f"Invalid trait type {cfg.trait_type!r}")

    return _assemble_model(cfg, glmm, vr, nok, X_qrr, X_names, x_transform,
                           variant_id, sample_id, n_data)


def _assemble_model(cfg, glmm, vr, nok, X_qrr, X_names, x_transform,
                    variant_id, sample_id, n_data) -> NullModel:
    # order the variance-ratio table by marker index; map ids
    # (R/saige_main.r:510-513)
    ord_ = np.argsort(np.asarray(vr["id"], dtype=np.int64), kind="stable")
    var_ratio = {k: np.asarray(v)[ord_] for k, v in vr.items()}
    var_ratio["id"] = variant_id[var_ratio["id"].astype(np.int64) - 1]
    if cfg.var_ratio_mac_cat:
        # category bin bounds travel with the model (not per-row data)
        var_ratio["mac_bins"] = np.asarray(cfg.var_ratio_mac_cat, float)

    # un-rotate coefficients through qr.R (R/saige_main.r:616-623)
    if x_transform:
        coef = np.linalg.solve(X_qrr, glmm.coefficients * np.sqrt(n_data))
        coef_names = X_names
    else:
        coef = glmm.coefficients
        coef_names = X_names[: len(coef)]

    model = NullModel(
        trait_type=cfg.trait_type,
        coefficients=coef,
        coef_names=coef_names,
        tau=glmm.tau,
        linear_predictors=glmm.linear_predictors,
        fitted_values=glmm.fitted_values,
        residuals=glmm.residuals,
        cov=glmm.cov,
        converged=glmm.converged,
        y=nok.y, mu=nok.mu, res=nok.res, V=nok.V,
        X1=nok.X1, XV=nok.XV, XXVX_inv=nok.XXVX_inv,
        var_ratio=var_ratio,
        sample_id=sample_id,
        variant_id=variant_id,
    )
    return model


def _genotype_codes(seq: SeqData) -> np.ndarray:
    """[M, N] int8 genotype codes (ALT dosage 0/1/2, 3 = missing).

    A DS (imputed-dosage) source is ROUNDED to hard codes — the reference
    fits its GRM only from integer genotype nodes, so this extension
    changes data semantics; a one-time warning reports the largest
    rounding delta."""
    if seq.has_genotype():
        from ..io.gds import read_bit2_dosage
        return read_bit2_dosage(seq.gds.root["genotype/data"])
    ds = seq.dosage_block(0, seq.n_variants)
    out = np.where(np.isfinite(ds), np.round(ds), 3)
    out = np.where((out >= 0) & (out <= 2), out, 3)
    with np.errstate(invalid="ignore"):
        delta = np.abs(ds - out)
    max_delta = float(np.nanmax(np.where(out == 3, np.nan, delta),
                                initial=0.0))
    if max_delta > 0:
        import warnings
        warnings.warn(
            f"GRM built from a dosage (DS) node: fractional dosages were "
            f"rounded to 0/1/2 hard codes (max |delta| = {max_delta:.4g}). "
            f"The reference fits only from integer genotype nodes.",
            RuntimeWarning, stacklevel=2)
    return out.astype(np.int8)
