"""Preconditioned conjugate gradient for Sigma x = b, batched over RHS.

Sigma = tau0 * diag(1/W) + tau1 * GRM applied matrix-free (the reference's
``PCG_diag_sigma``, src/saige_fitnull.cpp:581-614): Jacobi preconditioner
with a 1e-4 floor on diag(Sigma) (:553), stop when sum(r^2) <= tolPCG or
maxiterPCG.  The reference solves each RHS sequentially; here R right-hand
sides run as one batched ``lax.while_loop`` with per-column freezing, so
each column performs exactly the iterations its sequential solve would —
identical arithmetic, one device program, one batched GRM product.
Non-convergence is a warning, not an error (:610-611).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("maxiter",))
def pcg_solve_op(op, w, tau, B, tol, maxiter: int):
    """Operator-generic PCG: ``op`` is any pytree with ``.matvec([N, R])``
    and ``.diag`` (GRMOperator or PackedGRM)."""
    return _pcg_body(op.matvec, op.diag, w, tau, B, tol, maxiter)


@partial(jax.jit, static_argnames=("maxiter",))
def pcg_solve(std_geno, diag_grm, w, tau, B, tol, maxiter: int):
    """Solve Sigma X = B.

    Parameters
    ----------
    std_geno : [M, N] standardized genotypes (GRM operator state)
    diag_grm : [N] diag(GRM)
    w : [N] working weights W
    tau : [2] variance components (tau0, tau1)
    B : [N, R] right-hand sides
    tol : PCG tolerance on sum(r^2) (the reference's tolPCG)
    maxiter : iteration bound

    Returns (X [N, R], iters [R], converged [R]).
    """
    M = std_geno.shape[0]

    def grm_mv(P):
        return (std_geno.T @ (std_geno @ P)) / M

    return _pcg_body(grm_mv, diag_grm, w, tau, B, tol, maxiter)


@partial(jax.jit, static_argnames=("maxiter", "max_refine"))
def pcg_solve_mixed(op, w, tau, B, tol, maxiter: int, max_refine: int = 6):
    """Mixed-precision PCG: f32-state inner solves, exact-f64 refinement.

    Targets a device where f64 elementwise work is slow next to f32: the
    f64 solver's per-iteration state updates ([N, R] x,r,z,p arrays) and
    the 8-slice RHS decomposition.  This solver runs the CG iteration
    entirely in f32 (5 integer slices capture an f32 operand exactly,
    ``op.matvec32``), then recombines with iterative
    refinement: the TRUE f64 residual ``B - Sigma x`` (one exact matvec
    per refinement pass, not per iteration) restarts the inner solve
    until the reference's absolute ``sum(r^2) <= tol`` stop holds in
    f64.  Solutions are f64-grade; iteration counts differ from the
    exact path (per-column freezing happens on f32 residuals), so this
    is an OPT-IN tier for the 2%-stopping device fit, never the
    bit-replay host path (CLAUDE.md invariant 1).

    ``op`` needs ``.matvec`` / ``.diag``; ``.matvec32`` is used when
    present (Packed2GRM), else the exact matvec serves the inner loop
    (correct, no speedup).  Returns ``(X, iters, converged)`` like
    :func:`pcg_solve_op`.
    """
    f32 = jnp.float32
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    N, R = B.shape
    tau0, tau1 = tau[0], tau[1]
    inv_w = 1.0 / w
    if inv_w.ndim == 1:
        inv_w = inv_w[:, None]

    def sig64(P):
        return tau0 * inv_w * P + tau1 * op.matvec(P)

    mv32 = getattr(op, "matvec32", None)
    if mv32 is None:
        mv32 = lambda P: op.matvec(P.astype(jnp.float64)).astype(f32)
    w32 = w.astype(f32)
    tau32 = tau.astype(f32)
    diag32 = op.diag.astype(f32)

    rr0 = jnp.sum(B * B, axis=0)

    def cond(st):
        x, r, rr, it, k = st
        return jnp.any(rr > tol) & (k < max_refine) & (it < maxiter)

    def body(st):
        x, r, rr, it, k = st
        active = rr > tol
        # per-column normalization: keeps the f32 inner system O(1) so
        # neither overflow nor the f32 absolute floor bites
        s = jnp.max(jnp.abs(r), axis=0)
        s = jnp.where(active & (s > 0), s, 1.0)
        b32 = jnp.where(active[None, :], r / s[None, :], 0.0).astype(f32)
        # scaled absolute target, floored RELATIVE to the scaled rhs —
        # an f32 iteration stagnates near rr/rr0 ~ (eps32*cond)^2, so an
        # absolute floor is unreachable at large N and would burn every
        # pass to maxiter (the f64 refinement covers the rest)
        tol32 = jnp.maximum(tol / (s * s),
                            1e-11 * rr / (s * s)).astype(f32)
        dx32, its, _ = _pcg_body(mv32, diag32, w32, tau32, b32, tol32,
                                 maxiter)
        x1 = x + dx32.astype(jnp.float64) * s[None, :]
        r1 = B - sig64(x1)                   # exact residual, once/pass
        rr1 = jnp.sum(r1 * r1, axis=0)
        # a pass that cannot improve a column (f32 floor) keeps the old
        # iterate for it, so refinement never degrades a solution
        keep = rr1 < rr
        x1 = jnp.where(keep[None, :], x1, x)
        rr1 = jnp.where(keep, rr1, rr)
        r1 = jnp.where(keep[None, :], r1, r)
        return x1, r1, rr1, it + jnp.max(its), k + 1

    x0 = jnp.zeros_like(B)
    st = (x0, B, rr0, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    x, _r, rr, iters, _k = jax.lax.while_loop(cond, body, st)
    converged = rr <= tol
    if squeeze:
        return x[:, 0], iters, converged[0]
    return x, jnp.broadcast_to(iters, (R,)), converged


# ---------------------------------------------------------------------------
# host-driven PCG over a bounded-program GRM handle (SplitPacked2): the
# iteration loop runs in python, every step a small cached device program,
# so the LARGEST compiled program is one leaf group — independent of M.


@jax.jit
def _pcg_h_init(w, tau, diag, B):
    inv_w = 1.0 / w
    if inv_w.ndim == 1:
        inv_w = inv_w[:, None]
    tau0, tau1 = tau[0], tau[1]
    d = jnp.maximum(tau0 * inv_w + tau1 * diag[:, None], 1e-4)
    minv = jnp.broadcast_to(1.0 / d, B.shape)
    rr = jnp.sum(B * B, axis=0)
    st = dict(x=jnp.zeros_like(B), r=B, z=minv * B, p=minv * B, rr=rr,
              it=jnp.zeros((), jnp.int32),
              iters=jnp.zeros(B.shape[1], jnp.int32))
    return st, minv, inv_w


@jax.jit
def _pcg_h_step(st, gv, inv_w, tau, minv, tol):
    """One PCG iteration given this step's GRM product ``gv`` — the same
    arithmetic as ``_pcg_body``'s body (per-column freezing included)."""
    tau0, tau1 = tau[0], tau[1]
    act = st["rr"] > tol
    Ap = tau0 * inv_w * st["p"] + tau1 * gv
    rz = jnp.sum(st["r"] * st["z"], axis=0)
    pAp = jnp.sum(st["p"] * Ap, axis=0)
    a = jnp.where(act, rz / pAp, 0.0)
    x = st["x"] + a * st["p"]
    r1 = st["r"] - a * Ap
    z1 = minv * r1
    rz1 = jnp.sum(z1 * r1, axis=0)
    bet = jnp.where(act, rz1 / rz, 0.0)
    p1 = jnp.where(act, z1 + bet * st["p"], st["p"])
    rr1 = jnp.sum(r1 * r1, axis=0)
    it = st["it"] + 1
    iters = jnp.where(act, it, st["iters"])
    rr = jnp.where(act, rr1, st["rr"])
    return dict(x=jnp.where(act, x, st["x"]),
                r=jnp.where(act, r1, st["r"]),
                z=jnp.where(act, z1, st["z"]), p=p1, rr=rr, it=it,
                iters=iters), jnp.any(rr > tol)


def pcg_host(handle, w, tau, B, tol, maxiter: int, prec: str = "f64",
             check_every: int = 16):
    """Host-driven batched Jacobi-PCG (device-resident state).

    ``handle`` needs ``.mv(P, prec)`` and ``.diag``; ``tol`` may be a
    scalar or per-column vector; ``prec="f32"`` runs the whole iteration
    in f32 (cast here) — callers wanting f64-grade answers wrap with
    :func:`pcg_host_mixed`.  Returns device ``(X, iters, converged)``.
    """
    f32 = prec == "f32"
    if f32:
        w = w.astype(jnp.float32)
        tau = tau.astype(jnp.float32)
        B = B.astype(jnp.float32)
        diag = handle.diag.astype(jnp.float32)
    else:
        diag = handle.diag
    st, minv, inv_w = _pcg_h_init(w, tau, diag, B)
    it = 0
    tol_h = np.asarray(tol)
    last_rr = None
    while it < maxiter:
        gv = handle.mv(st["p"], prec=prec)
        st, any_active = _pcg_h_step(st, gv, inv_w, tau, minv, tol)
        it += 1
        if it % check_every == 0 or it >= maxiter:
            if not bool(any_active):      # one scalar roundtrip
                break
            if f32:
                # stagnation guard: an f32 iteration near its noise
                # floor stops making progress; if no still-active column
                # improved 4x over the whole check window, further
                # iterations are wasted (the f64 refinement pass around
                # this solve picks up the remaining decades)
                rr_now = np.asarray(st["rr"])
                if last_rr is not None:
                    act = rr_now > tol_h
                    # noise-floor churn shows ~no net improvement over a
                    # whole window; genuinely slow convergence still
                    # clears 10% — do NOT cut legitimate slow columns
                    if not (rr_now[act] < 0.9 * last_rr[act]).any():
                        break
                last_rr = rr_now
    return st["x"], st["iters"], st["rr"] <= tol


@jax.jit
def _refine_norm(r, tol):
    s = jnp.max(jnp.abs(r), axis=0)
    rr = jnp.sum(r * r, axis=0)
    active = rr > tol
    s = jnp.where(active & (s > 0), s, 1.0)
    b32 = jnp.where(active[None, :], r / s[None, :], 0.0).astype(jnp.float32)
    # the inner target is floored RELATIVE to the scaled rhs: an f32
    # iteration stagnates near rr/rr0 ~ (eps32 * cond)^2 — an absolute
    # floor (round-5 first cut: 1e-10) is unreachable at biobank N
    # (noise floor ~ N * eps32^2 ~ 4e-9 at N=430K), burning every pass
    # to maxiter; the f64 refinement covers the remaining decades
    rr0_32 = rr / (s * s)
    tol32 = jnp.maximum(tol / (s * s), 1e-11 * rr0_32).astype(jnp.float32)
    return s, b32, tol32


@jax.jit
def _refine_combine(x, r, rr, dx32, s, B, gv_new, inv_w, tau):
    x1 = x + dx32.astype(jnp.float64) * s[None, :]
    r1 = B - (tau[0] * inv_w * x1 + tau[1] * gv_new)
    rr1 = jnp.sum(r1 * r1, axis=0)
    keep = rr1 < rr                      # refinement never degrades
    return (jnp.where(keep[None, :], x1, x),
            jnp.where(keep[None, :], r1, r), jnp.where(keep, rr1, rr))


def pcg_host_mixed(handle, w, tau, B, tol, maxiter: int,
                   max_refine: int = 6, check_every: int = 16):
    """Host-driven mixed-precision PCG: the handle twin of
    :func:`pcg_solve_mixed` — f32 host-driven inner solves over the
    bounded per-group programs, exact-f64 residual recombination (one
    f64 ``handle.mv`` per refinement pass).  Device ``(X, iters,
    converged)``; absolute ``sum(r^2) <= tol`` holds in f64."""
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    B = jnp.asarray(B, jnp.float64)
    w = jnp.asarray(w)
    tau = jnp.asarray(tau, jnp.float64)
    inv_w = 1.0 / w
    if inv_w.ndim == 1:
        inv_w = inv_w[:, None]
    x = jnp.zeros_like(B)
    r = B
    rr = jnp.sum(r * r, axis=0)
    total_its = jnp.zeros(B.shape[1], jnp.int32)
    prev_rr = None
    for _k in range(max_refine):
        rr_h = np.asarray(rr)            # [C] readback (small)
        act = rr_h > tol
        if not act.any():
            break
        if prev_rr is not None and \
                not (rr_h[act] < 0.9 * prev_rr[act]).any():
            break                        # refinement stalled: warn-only
        prev_rr = rr_h
        s, b32, tol32 = _refine_norm(r, tol)
        dx32, its, _ = pcg_host(handle, w, tau, b32, tol32, maxiter,
                                prec="f32", check_every=check_every)
        x1 = x + dx32.astype(jnp.float64) * s[None, :]
        gv = handle.mv(x1, prec="f64")
        x, r, rr = _refine_combine(x, r, rr, dx32, s, B, gv, inv_w, tau)
        total_its = total_its + its
    conv = rr <= tol
    if squeeze:
        return x[:, 0], total_its, conv[0]
    return x, total_its, conv


def _pcg_body(grm_mv, diag_grm, w, tau, B, tol, maxiter: int):
    """``w`` may be [N] (shared weights) or [N, R] (per-column weights) and
    ``tau`` [2] (shared) or [2, R] (per-column) — the per-column forms let
    callers batch systems from DIFFERENT models (e.g. GxG pairs) into one
    solve sharing the GRM stream; arithmetic per column is identical to a
    separate solve."""
    N, R = B.shape
    tau0, tau1 = tau[0], tau[1]      # scalars or [R]

    inv_w = 1.0 / w
    if inv_w.ndim == 1:
        inv_w = inv_w[:, None]

    def sigma_mv(P):  # [N, R] -> [N, R]
        return tau0 * inv_w * P + tau1 * grm_mv(P)

    d = tau0 * inv_w + tau1 * diag_grm[:, None]
    d = jnp.maximum(d, 1e-4)
    minv = jnp.broadcast_to(1.0 / d, B.shape)

    r = B
    z = minv * r
    p = z
    x = jnp.zeros_like(B)
    rr = jnp.sum(r * r, axis=0)
    active0 = rr > tol

    def cond(s):
        return s["active"].any() & (s["it"] < maxiter)

    def body(s):
        act = s["active"]
        Ap = sigma_mv(s["p"])
        rz = jnp.sum(s["r"] * s["z"], axis=0)
        pAp = jnp.sum(s["p"] * Ap, axis=0)
        a = jnp.where(act, rz / pAp, 0.0)
        x = s["x"] + a * s["p"]
        r1 = s["r"] - a * Ap
        z1 = minv * r1
        rz1 = jnp.sum(z1 * r1, axis=0)
        bet = jnp.where(act, rz1 / rz, 0.0)
        p1 = jnp.where(act, z1 + bet * s["p"], s["p"])
        rr1 = jnp.sum(r1 * r1, axis=0)
        it = s["it"] + 1
        iters = jnp.where(act, it, s["iters"])
        active = act & (rr1 > tol) & (it < maxiter)
        rr = jnp.where(act, rr1, s["rr"])
        return dict(x=x, r=jnp.where(act, r1, s["r"]),
                    z=jnp.where(act, z1, s["z"]), p=p1, rr=rr,
                    active=active, it=it, iters=iters)

    state = dict(x=x, r=r, z=z, p=p, rr=rr, active=active0,
                 it=jnp.zeros((), jnp.int32), iters=jnp.zeros(R, jnp.int32))
    out = jax.lax.while_loop(cond, body, state)
    converged = out["rr"] <= tol
    return out["x"], out["iters"], converged
