"""Saddlepoint approximation (SPA) of score-statistic p-values, batched.

Device reimplementation of the reference's CGF machinery
(``src/SPATest.cpp:42-374``, itself derived from the SPAtest R package /
Dey et al. 2017).  Everything is vectorized over a block of variants: the
CGF sums run as masked ``[B, N]`` reductions and the Newton
root-finding runs as a ``lax.while_loop`` with per-variant lane state, so a
whole variant block is processed in a single fused XLA computation instead
of the reference's per-variant scalar loops.

Semantics reproduced exactly (they are part of the output contract):

* "fast" split: samples with nonzero raw dosage contribute exact Bernoulli
  CGF terms; the zero-dosage remainder is approximated as a Gaussian with
  moments ``NAmu``/``NAsigma`` (``src/SPATest.cpp:299-374``).
* Newton iteration with sign-change jump damping (``getroot_K1``,
  ``src/SPATest.cpp:92-135``), tolerance ``eps^0.25``.
* Barndorff-Nielsen tail formula ``z = w + log(v/w)/w``
  (``src/SPATest.cpp:188-207``).
* std-dev cutoff (initial 2.0 in the scan) with doubling escalation when
  ``p_noadj / p_spa > 1000`` (``src/SPATest.cpp:286-290``): because the SPA
  value itself does not depend on the cutoff, the escalation loop reduces
  to a closed-form select, see ``_resolve_cutoff``.
"""

import jax
import jax.numpy as jnp

from .special import pchisq1_sf, pnorm_sf

_ROOT_TOL = jnp.finfo(jnp.float64).eps ** 0.25
_MAX_ITER = 1000


def _sign(x):
    return jnp.sign(x)


def _cgf_terms(t, g, mu, mask):
    """Masked CGF of sum_i g_i X_i with X_i ~ Bernoulli(mu_i).

    t: [B] lane parameter; g, mu, mask: [B, N].
    Returns K0, K1, K2 each [B].
    """
    tt = t[:, None]
    gt = g * tt
    # log(1 - mu + mu * exp(g t)) — the reference's LITERAL Korg
    # arithmetic (src/SPATest.cpp:42-53) including its overflow: g t past
    # ~709 drives exp to inf, K to inf, and get_saddle_prob to 0, which
    # the caller reports as pval_noadj + converged=False.  A stabilized
    # logaddexp would stay finite and silently "improve" those lanes —
    # golden parity forbids that outside the opt-in mixed tier.
    k0_terms = jnp.where(mask, jnp.log(1.0 - mu + mu * jnp.exp(gt)), 0.0)
    K0 = k0_terms.sum(axis=1)
    # mu g / ((1-mu) exp(-g t) + mu)
    e_neg = jnp.exp(-gt)
    denom = (1.0 - mu) * e_neg + mu
    k1_terms = jnp.where(mask, mu * g / denom, 0.0)
    K1 = k1_terms.sum(axis=1)
    # (1-mu) mu g^2 exp(-g t) / ((1-mu) exp(-g t) + mu)^2, non-finite skipped
    k2_raw = (1.0 - mu) * mu * g * g * e_neg / (denom * denom)
    k2_terms = jnp.where(mask & jnp.isfinite(k2_raw), k2_raw, 0.0)
    K2 = k2_terms.sum(axis=1)
    return K0, K1, K2


def _getroot_K1(q, g, mu, mask, NAmu, NAsigma, g_pos, g_neg, skip=None):
    """Vectorized Newton root-find of K1(t) = q with jump damping.

    All args are [B] lanes except g/mu/mask [B, N].  Returns (root, converged).
    Mirrors ``getroot_K1_fast`` (src/SPATest.cpp:139-183); with NAmu=NAsigma=0
    and a full mask it is the plain ``getroot_K1``.  ``skip`` lanes are
    treated as already finished (their root/conv outputs are garbage — the
    caller selects away from them).
    """
    B = q.shape[0]
    out_of_range = (q >= g_pos) | (q <= g_neg)
    if skip is not None:
        out_of_range = out_of_range | skip

    def k1_adj(t):
        _, K1, _ = _cgf_terms(t, g, mu, mask)
        return K1 + NAmu + NAsigma * t - q

    def k2(t):
        _, _, K2 = _cgf_terms(t, g, mu, mask)
        return K2 + NAsigma

    t0 = jnp.zeros(B, q.dtype)
    state = dict(
        t=t0,
        root=t0,
        K1=k1_adj(t0),
        prevJump=jnp.full(B, jnp.inf, q.dtype),
        conv=jnp.zeros(B, bool),
        done=out_of_range,  # lanes finished (or never started)
        it=jnp.zeros((), jnp.int32),
    )

    def cond(s):
        return (~s["done"]).any() & (s["it"] < _MAX_ITER)

    def body(s):
        t, K1v, prevJump = s["t"], s["K1"], s["prevJump"]
        K2v = k2(t)
        tnew = t - K1v / K2v
        nonfinite = ~jnp.isfinite(tnew)
        tnew_safe = jnp.where(nonfinite, t, tnew)
        small_step = jnp.abs(tnew_safe - t) < _ROOT_TOL
        newK1 = k1_adj(tnew_safe)
        flip = _sign(K1v) != _sign(newK1)
        over = jnp.abs(tnew_safe - t) > (prevJump - _ROOT_TOL)
        damped_t = t + _sign(newK1 - K1v) * prevJump * 0.5
        use_damp = flip & over
        t2 = jnp.where(use_damp, damped_t, tnew_safe)
        # re-evaluate K1 only when some lane actually damped (rare)
        K1_2 = jax.lax.cond(
            use_damp.any(),
            lambda: jnp.where(use_damp, k1_adj(t2), newK1),
            lambda: newK1)
        prevJump2 = jnp.where(
            use_damp, prevJump * 0.5,
            jnp.where(flip, jnp.abs(tnew_safe - t), prevJump))

        active = ~s["done"]
        finish_conv = active & ~nonfinite & small_step
        finish_fail = active & nonfinite
        cont = active & ~nonfinite & ~small_step
        return dict(
            t=jnp.where(cont, t2, s["t"]),
            root=jnp.where(cont, t2, jnp.where(finish_conv, s["t"], s["root"])),
            K1=jnp.where(cont, K1_2, s["K1"]),
            prevJump=jnp.where(cont, prevJump2, s["prevJump"]),
            conv=s["conv"] | finish_conv,
            done=s["done"] | finish_conv | finish_fail,
            it=s["it"] + 1,
        )

    s = jax.lax.while_loop(cond, body, state)
    root = jnp.where(out_of_range, jnp.inf, s["root"])
    conv = jnp.where(out_of_range, True, s["conv"])
    return root, conv


def _getroot_mixed(q, g, mu, mask, NAmu, NAsigma, g_pos, g_neg):
    """f32 Newton loop + f64 escalation for failed lanes.

    The root loop evaluates the CGF over [B, N] every iteration; on a
    device whose f64 rate is far below its f32 rate, the damped Newton
    iteration runs in
    float32 (the reference's tolerance eps^0.25 ~ 1.2e-4 is far above f32
    precision); lanes that fail in f32 (overflow at extreme roots) rerun
    in the exact f64 loop.  No polish step is needed: the saddlepoint
    objective ``tq - K(t)`` is stationary at the root, so a 1.2e-4 root
    error perturbs ``w`` only to second order (~1e-8) and the p-value via
    the first-order ``v`` factor by ~1e-4/w^2 — inside the mode's
    documented ~1e-4 agreement tier.  Semantics (converged flags, damping
    path) match the f64 loop."""
    f32 = lambda x: x.astype(jnp.float32)
    root32, conv32 = _getroot_K1(f32(q), f32(g), f32(mu), mask,
                                 f32(NAmu), f32(NAsigma),
                                 f32(g_pos), f32(g_neg))
    root = root32.astype(jnp.float64)
    # exact f64 loop only for lanes the f32 loop failed (exits immediately
    # when none are active)
    need64 = ~conv32
    root64, conv64 = _getroot_K1(q, g, mu, mask, NAmu, NAsigma,
                                 g_pos, g_neg, skip=conv32)
    root = jnp.where(need64, root64, root)
    conv = conv32 | (need64 & conv64)
    return root, conv


def _saddle_prob(t, g, mu, mask, NAmu, NAsigma, q, f32_terms=False):
    """|one-sided saddlepoint tail probability| for root t (0 if invalid).

    ``f32_terms`` evaluates the elementwise [B, N] CGF terms in float32
    (the f64 exp/log passes dominate the cost where f64 is slow); the tail
    algebra stays f64.  Term error ~1e-6 relative reaches the p-value at
    ~1e-5 — used by the mixed mode, whose callers fall back to the exact
    evaluation for any lane this zeroes out."""
    if f32_terms:
        f32 = lambda x: x.astype(jnp.float32)
        K0, _, K2v = _cgf_terms(f32(t), f32(g), f32(mu), mask)
        K0 = K0.astype(jnp.float64)
        K2v = K2v.astype(jnp.float64)
    else:
        K0, _, K2v = _cgf_terms(t, g, mu, mask)
    K = K0 + NAmu * t + 0.5 * NAsigma * t * t
    k2 = K2v + NAsigma
    w = _sign(t) * jnp.sqrt(jnp.maximum(2.0 * (t * q - K), 0.0))
    v = t * jnp.sqrt(jnp.maximum(k2, 0.0))
    z = w + jnp.log(v / w) / w
    pval = jnp.where(z > 0, pnorm_sf(z), -pnorm_sf(-z))
    ok = jnp.isfinite(t) & jnp.isfinite(K) & jnp.isfinite(k2) & jnp.isfinite(z)
    return jnp.where(ok, jnp.abs(pval), 0.0)


def saddle_prob_batch(q, m1, var2, g, mu, mask, cutoff=2.0, mixed=False,
                      g_bounds=None, zero_noadj=True):
    """Batched Saddle_Prob_Fast / Saddle_Prob.

    Parameters
    ----------
    q, m1, var2 : [B] statistics (q possibly the var-ratio-tilted qtilde)
    g : [B, N] covariate-adjusted, AC-normalised genotypes
    mu : [N] or [B, N] fitted probabilities
    mask : [B, N] bool; True lanes use the exact CGF, the complement is
        folded into the Gaussian NAmu/NAsigma remainder.  Pass all-True for
        the full (non-fast) method.
    cutoff : initial std-dev cutoff (the scan uses 2.0)
    mixed : False replays the reference's f64 Newton iteration bit-for-bit
        (golden parity).  True runs the Newton loop in f32 and the tail CGF
        terms in f32 with an exact f64 re-run of any lane the f32 terms
        zero out — for devices where f64 is much slower than f32.  No
        polish is needed: the saddlepoint objective tq - K(t) is stationary
        at the root, so the f32 root error (~1.2e-4) perturbs p only at
        second order (~1e-4/w^2); measured ~2e-6 off exact on the fixtures.
        Opt-in accuracy tier — never the default (golden-parity rule).

    Returns (pval, converged) each [B].
    """
    if mu.ndim == 1:
        mu = jnp.broadcast_to(mu[None, :], g.shape)
    s = q - m1
    qinv = m1 - s
    pval_noadj = pchisq1_sf(s * s / var2)

    gm = jnp.where(mask, g, 0.0)     # masking established here once
    NAmu = m1 - jnp.sum(gm * mu, axis=1)
    NAsigma = var2 - jnp.sum(gm * gm * mu * (1.0 - mu), axis=1)
    # range bounds use the FULL adjusted genotype vector, not only the
    # exact-CGF subset (reference src/SPATest.cpp:325-331 sums over n_g);
    # compacted callers pass them explicitly
    if g_bounds is not None:
        g_pos, g_neg = g_bounds
    else:
        g_pos = jnp.sum(jnp.where(g > 0, g, 0.0), axis=1)
        g_neg = jnp.sum(jnp.where(g < 0, g, 0.0), axis=1)

    rootfn = _getroot_mixed if mixed else _getroot_K1
    root1, conv1 = rootfn(q, g, mu, mask, NAmu, NAsigma, g_pos, g_neg)
    root2, conv2 = rootfn(qinv, g, mu, mask, NAmu, NAsigma, g_pos, g_neg)
    both_conv = conv1 & conv2
    p1 = _saddle_prob(root1, g, mu, mask, NAmu, NAsigma, q, f32_terms=mixed)
    p2 = _saddle_prob(root2, g, mu, mask, NAmu, NAsigma, qinv,
                      f32_terms=mixed)
    if mixed:
        # exact re-evaluation for lanes the f32 terms zeroed out (f32
        # overflow at extreme roots) so converged-flag semantics match
        # the exact mode; skipped entirely when no lane needs it
        bad = ((p1 == 0.0) | (p2 == 0.0)) & both_conv

        def _redo(_):
            e1 = _saddle_prob(root1, g, mu, mask, NAmu, NAsigma, q)
            e2 = _saddle_prob(root2, g, mu, mask, NAmu, NAsigma, qinv)
            return jnp.where(bad, e1, p1), jnp.where(bad, e2, p2)

        p1, p2 = jax.lax.cond(bad.any(), _redo, lambda _: (p1, p2), None)
    spa = p1 + p2

    return _resolve_cutoff(pval_noadj, spa, both_conv, s, var2, cutoff,
                           zero_noadj)


def _resolve_cutoff(pval_noadj, spa, both_conv, s, var2, cutoff,
                    zero_noadj=True):
    """Closed form of the reference's cutoff-doubling loop.

    The loop (src/SPATest.cpp:286-290) only toggles between the SPA value
    and pval_noadj; doubling ends at the first branch giving a consistent
    answer, which is:
      * stat < cutoff            -> pval_noadj (converged)
      * root-finding failed      -> pval_noadj, converged = False
      * spa != 0 & ratio <= 1000 -> spa
      * spa != 0 & ratio  > 1000 -> pval_noadj (escalated past stat)
      * spa == 0                 -> pval_noadj, converged = False
        (caller semantics: pval==0 && pval_noadj>0, src/saige_main.cpp:389-391)
    """
    cutoff = max(cutoff, 0.1)
    stat = jnp.abs(s) / jnp.sqrt(var2)
    below = stat < cutoff
    ratio_big = (spa != 0) & (pval_noadj / spa > 1000.0)
    # the pval==0 -> pval_noadj substitution belongs to the SINGLE-VARIANT
    # caller (src/saige_main.cpp:390-391); Saddle_Prob itself breaks out
    # of the doubling loop with pval=0 and converged still true, which is
    # what the GxG caller reports (src/saige_fitnull.cpp:1540) —
    # zero_noadj=False preserves that
    spa_zero = (spa == 0) & (pval_noadj > 0) & zero_noadj

    pval = jnp.where(
        below | ~both_conv, pval_noadj,
        jnp.where(ratio_big, pval_noadj, jnp.where(spa_zero, pval_noadj, spa)))
    converged = jnp.where(below, True, both_conv & ~spa_zero)
    return pval, converged
