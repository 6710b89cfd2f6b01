"""GxG SNP-pair interaction tests with SPA adjustment.

Equivalent of ``seqGLMM_GxG_spa`` (reference R/saige_interaction.r:44-641 +
``saige_GxG_snp_bin`` src/saige_fitnull.cpp:1480-1558): for each SNP pair,
append the two minor-allele-coded dosage vectors to the covariates, refit
the null GLMM (or reuse a pre-fitted tau / skip via a plain-GLM screen),
then score-test the elementwise product ``g1*g2`` with a full PCG variance
(no variance-ratio shortcut) and the full saddlepoint approximation.
Binary traits only, like the reference (quantitative raises, :531-533).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import jax.numpy as jnp

from ..config import NullModelConfig
from ..io.seqarray import SeqData
from ..models.fitnull import (GlmmFit, _Binomial, _get_coeff, _mat_inv, _pcg,
                              fit_ai_pcg, _genotype_codes)
from ..models.glm import glm_binomial, obj_nok_binary, qr_transform
from ..ops.grm import GRMOperator, build_grm
from ..ops.spa import saddle_prob_batch
from ..ops.special import qnorm as _qnorm
from ..utils.rrandom import RRandom


def _minor_allele_geno(g: np.ndarray) -> np.ndarray:
    """Flip to minor allele, mean-impute (R/saige_interaction.r:12-23)."""
    g = np.asarray(g, np.float64).copy()
    if np.isnan(g).any():
        af = np.nanmean(g)
        if not np.isfinite(af):
            af = 0.0
        g[np.isnan(g)] = af
    if g.mean() > 1.0:
        g = 2.0 - g
    return g


def _gxg_stat(grm: GRMOperator, fit0, glmm: GlmmFit, nok, inter: np.ndarray,
              cfg: NullModelConfig):
    """The saige_GxG_snp_bin statistic (src/saige_fitnull.cpp:1480-1558)."""
    fam = _Binomial()
    eta = fit0.linear_predictors
    mu = fit0.fitted_values
    mu_eta = fam.mu_eta(eta)
    W = (mu_eta * mu_eta) / fam.variance(mu)
    tau = glmm.tau
    X1 = nok.X1
    Sigma_iX = _pcg(grm, W, tau, X1, cfg.tol_pcg, cfg.maxiter_pcg)

    y = fit0.y
    G0 = inter
    n_nonzero = int((G0 != 0).sum())
    G = G0 - nok.XXVX_inv @ (nok.XV @ G0)
    Sigma_iG = _pcg(grm, W, tau, G[:, None], cfg.tol_pcg, cfg.maxiter_pcg)[:, 0]
    adj = Sigma_iX @ (_mat_inv(X1.T @ Sigma_iX) @ (X1.T @ Sigma_iG))

    S = float((y - mu) @ G)
    var1 = float(G @ Sigma_iG) - float(G @ adj)
    var2 = float((mu * (1 - mu)) @ (G * G))
    beta = S / var1
    q = float(y @ G)
    m1 = float(mu @ G)
    Tstat = q - m1
    qtilde = Tstat / np.sqrt(var1) * np.sqrt(var2) + m1

    # full SPA (mask = all True -> NAmu/NAsigma vanish)
    pval_arr, conv_arr = saddle_prob_batch(
        jnp.asarray([qtilde]), jnp.asarray([m1]), jnp.asarray([var2]),
        jnp.asarray(G[None, :]), jnp.asarray(mu),
        jnp.ones((1, len(G)), bool), cutoff=2.0, zero_noadj=False)
    pval = float(pval_arr[0])
    converged = bool(conv_arr[0])
    # p.norm = pchisq((qtilde-m1)^2/var2) = pchisq(Tstat^2/var1)
    from scipy.stats import chi2, norm
    pnorm = float(chi2.sf(Tstat * Tstat / var1, 1))
    se = abs(beta / norm.ppf(pval / 2.0))
    return dict(beta=beta, SE=se, n_nonzero=n_nonzero, pval=pval,
                **{"p.norm": pnorm}, converged=converged, tau_G=float(tau[1]))


def _gxg_stat_batch(grm, states, taus, inters, cfg):
    """Batched ``saige_GxG_snp_bin``: all pairs' [X1 | G] columns ride ONE
    per-column-weight PCG solve (the GRM stream is read once per PCG
    iteration for the whole batch) and one batched SPA.  Per-pair
    arithmetic is identical to :func:`_gxg_stat` (the batched PCG freezes
    per column, so each column does exactly its sequential iterations).

    states: [(fit0, nok)] per pair; taus [P, 2]; inters [P, N].
    Returns a list of per-pair result dicts.
    """
    from scipy.stats import chi2, norm
    from ..ops.pcg import pcg_solve_op

    fam = _Binomial()
    P = len(states)
    N = inters.shape[1]
    # per-pair column offsets: X1 widths can differ when the QR transform
    # drops a collinear appended dosage for some pairs
    widths = [st[1].X1.shape[1] + 1 for st in states]
    offs = np.concatenate([[0], np.cumsum(widths)])
    B = np.empty((N, int(offs[-1])))
    Wb = np.empty((N, int(offs[-1])))
    taub = np.empty((2, int(offs[-1])))
    Gs = np.empty((P, N))
    mus = np.empty((P, N))
    for p, (fit0, nok) in enumerate(states):
        eta = fit0.linear_predictors
        mu = fit0.fitted_values
        mu_eta = fam.mu_eta(eta)
        W = (mu_eta * mu_eta) / fam.variance(mu)
        G0 = inters[p]
        G = G0 - nok.XXVX_inv @ (nok.XV @ G0)
        Gs[p], mus[p] = G, mu
        s0, s1 = int(offs[p]), int(offs[p + 1])
        B[:, s0:s1 - 1] = nok.X1
        B[:, s1 - 1] = G
        Wb[:, s0:s1] = W[:, None]
        taub[:, s0:s1] = np.asarray(taus[p])[:, None]
    sol = np.asarray(pcg_solve_op(grm, jnp.asarray(Wb), jnp.asarray(taub),
                                  jnp.asarray(B), cfg.tol_pcg,
                                  cfg.maxiter_pcg)[0])

    qts = np.empty(P)
    m1s = np.empty(P)
    var2s = np.empty(P)
    tstats = np.empty(P)
    var1s = np.empty(P)
    outs = []
    for p, (fit0, nok) in enumerate(states):
        s0, s1 = int(offs[p]), int(offs[p + 1])
        Sigma_iX = sol[:, s0:s1 - 1]
        Sigma_iG = sol[:, s1 - 1]
        X1, y, mu, G = nok.X1, fit0.y, mus[p], Gs[p]
        adj = Sigma_iX @ (_mat_inv(X1.T @ Sigma_iX) @ (X1.T @ Sigma_iG))
        S = float((y - mu) @ G)
        var1 = float(G @ Sigma_iG) - float(G @ adj)
        var2 = float((mu * (1 - mu)) @ (G * G))
        q = float(y @ G)
        m1 = float(mu @ G)
        Tstat = q - m1
        qts[p] = Tstat / np.sqrt(var1) * np.sqrt(var2) + m1
        m1s[p] = m1
        var2s[p] = var2
        tstats[p] = Tstat
        var1s[p] = var1
        outs.append(dict(beta=S / var1, var1=var1,
                         n_nonzero=int((inters[p] != 0).sum()),
                         tau_G=float(np.asarray(taus[p])[1])))
    pv, conv = saddle_prob_batch(
        jnp.asarray(qts), jnp.asarray(m1s), jnp.asarray(var2s),
        jnp.asarray(Gs), jnp.asarray(mus), jnp.ones((P, N), bool),
        cutoff=2.0, zero_noadj=False)
    pv, conv = np.asarray(pv), np.asarray(conv)
    for p, d in enumerate(outs):
        d.pop("var1")
        d["pval"] = float(pv[p])
        d["p.norm"] = float(chi2.sf(tstats[p] * tstats[p] / var1s[p], 1))
        d["SE"] = abs(d["beta"] / norm.ppf(d["pval"] / 2.0))
        d["converged"] = bool(conv[p])
        d = {k: d[k] for k in ("beta", "SE", "n_nonzero", "pval", "p.norm",
                               "converged", "tau_G")}
        outs[p] = d
    return outs


def _device_taus(grm, y, X_list, eta0_list, tau_init, cfg):
    """Per-pair tau via the vmapped single-dispatch device fit (shared GRM
    operand, lockstep while_loops): the batched replacement for the serial
    per-pair host refit.  Device-fit tier: agrees with the host fitter
    within the 2% AI-REML stopping rule (see models/fit_device.py)."""
    import functools

    import jax

    from ..models.fit_device import fit_glmm_binary_device
    from ..utils.rrandom import RRandom

    rng = RRandom(cfg.seed)
    n = len(y)
    U = np.stack([rng.rademacher(n).astype(np.float64)
                  for _ in range(cfg.nrun + 30)], axis=1)
    f = functools.partial(fit_glmm_binary_device, nrun=cfg.nrun,
                          maxiter=cfg.maxiter, maxiter_pcg=cfg.maxiter_pcg,
                          trace_cv_cutoff=cfg.trace_cv_cutoff)
    yj, tauj, Uj = jnp.asarray(y), jnp.asarray(tau_init, jnp.float64), \
        jnp.asarray(U)
    try:
        fit = jax.vmap(f, in_axes=(None, None, 0, None, 0, None, None,
                                   None))(
            grm, yj, jnp.asarray(np.stack(X_list)), tauj,
            jnp.asarray(np.stack(eta0_list)), Uj, cfg.tol, cfg.tol_pcg)
        return np.asarray(fit.tau)
    except Exception:
        # XLA CPU cannot execute the batched bf16 dots a vmapped packed
        # matvec produces — fall back to one device dispatch per pair
        # (still far fewer round-trips than the host per-pair refit)
        taus = [np.asarray(f(grm, yj, jnp.asarray(X), tauj,
                             jnp.asarray(eta), Uj, cfg.tol, cfg.tol_pcg).tau)
                for X, eta in zip(X_list, eta0_list)]
        return np.stack(taus)


def _gxg_run_batched(grm, ori_X, y, pairs, fetch, tau_init, use_approx_tau,
                     glm_threshold, cfg, pair_batch, res_savefn,
                     extra_cols, res_compress="LZMA") -> pd.DataFrame:
    """Chunked batched GxG: P pairs per device dispatch instead of several
    dispatches per pair (reference R/saige_interaction.r:413-521 is
    strictly per-pair).  With ``use_approx_tau`` / the GLM screen the
    arithmetic is identical to the serial path; full per-pair refits use
    the vmapped device fitter (tau within the 2% stopping rule)."""
    import pandas as pd

    rows = []
    for c0 in range(0, len(pairs), pair_batch):
        chunk = pairs[c0:c0 + pair_batch]
        metas, states, inters, Xs, eta0s = [], [], [], [], []
        for pair in chunk:
            i1, i2 = pair.iloc[0], pair.iloc[1]
            g1, s1 = fetch(i1)
            g2, s2 = fetch(i2)
            X = np.column_stack([ori_X, g1, g2])
            X_new, _, _ = qr_transform(X)
            fit0 = glm_binomial(X_new, y)
            nok = obj_nok_binary(X_new, y)
            metas.append(dict(id1=i1, snp1=s1, maf1=g1.mean() * 0.5,
                              id2=i2, snp2=s2, maf2=g2.mean() * 0.5))
            states.append((fit0, nok))
            inters.append(g1 * g2)
            Xs.append(X_new)
            eta0s.append(fit0.linear_predictors)
        inters = np.stack(inters)
        P = len(chunk)

        screen = None
        run = np.ones(P, bool)
        if glm_threshold is not False:
            taus = np.tile([1.0, 0.0], (P, 1))
            screen = _gxg_stat_batch(grm, states, taus, inters, cfg)
            run = np.asarray([np.isfinite(d["pval"]) and
                              d["pval"] <= glm_threshold for d in screen])

        sel = np.flatnonzero(run)
        taus_full = np.tile(np.asarray(tau_init, float), (P, 1))
        if len(sel) and not use_approx_tau:
            taus_full[sel] = _device_taus(
                grm, y, [Xs[i] for i in sel], [eta0s[i] for i in sel],
                tau_init, cfg)
        full = [None] * P
        if len(sel):
            res = _gxg_stat_batch(grm, [states[i] for i in sel],
                                  taus_full[sel], inters[sel], cfg)
            for j, i in enumerate(sel):
                full[i] = res[j]

        for p in range(P):
            if screen is not None:
                d = dict(full[p]) if full[p] is not None else dict(screen[p])
                if full[p] is None:
                    d["pval"] = d["p.norm"] = np.nan
                d["p.glm"] = screen[p]["pval"]
                d["p.glm.norm"] = screen[p]["p.norm"]
            else:
                d = full[p]
            row = dict(metas[p])
            row.update(d)
            rows.append(row)
        if res_savefn:
            from .single import save_assoc
            save_assoc(pd.DataFrame(rows), res_savefn,
                       res_compress=res_compress)

    out = pd.DataFrame(rows)
    for c, vals in extra_cols.items():
        out[c] = vals[: len(out)]
    if res_savefn:
        from .single import save_assoc
        save_assoc(out, res_savefn, res_compress=res_compress)
    return out


def gxg_spa(formula: str, data: pd.DataFrame, gds_grm, snp_pair,
            gds_assoc=None, config: NullModelConfig = NullModelConfig(),
            use_approx_tau: bool = False,
            glm_threshold: Union[bool, float] = False,
            res_savefn: str = "", verbose: bool = False,
            variant_id=None, pair_batch: int = 0,
            res_compress: str = "LZMA") -> pd.DataFrame:
    """GxG interaction scan over SNP pairs (binary traits).

    snp_pair: DataFrame whose first two columns are variant ids in
    ``gds_assoc`` (defaults to ``gds_grm``).

    ``variant_id``: explicit GRM SNP panel, replacing the maf/missing
    filter (the reference's ``variant.id=``, R/saige_interaction.r:46,
    :237-247).

    ``pair_batch > 1`` batches that many pairs per device dispatch: all
    pairs' PCG systems share one per-column-weight solve and one batched
    SPA.  Identical results to the serial path with ``use_approx_tau``
    or the GLM screen; full per-pair refits then use the vmapped device
    fitter (tau within the AI-REML stopping tolerance of the host's).
    """
    import pandas as pd

    from ..models.fitnull import (_complete_rows, _model_matrix,
                                  _parse_formula, _take_rows, _term_vars)

    if config.trait_type != "binary":
        raise NotImplementedError(
            "quantitative GxG is unimplemented, like the reference "
            "(R/saige_interaction.r:531-533)")

    # per-pair refits must not collide on a mid-fit checkpoint; GxG's
    # resume story is the per-pair incremental result save below
    cfg = (dataclasses.replace(config, checkpoint="")
           if config.checkpoint else config)
    seq = gds_grm if isinstance(gds_grm, SeqData) else SeqData(gds_grm)
    seq_assoc = seq if gds_assoc is None else (
        gds_assoc if isinstance(gds_assoc, SeqData) else SeqData(gds_assoc))
    resp, covs = _parse_formula(formula)

    data = _complete_rows(data, [cfg.sample_col] + [resp]
                          + _term_vars(covs))
    sid = np.asarray(data[cfg.sample_col]).astype(str)
    order = {s: i for i, s in enumerate(sid)}
    keep = [order[s] for s in seq.sample_id.astype(str) if s in order]
    data = _take_rows(data, np.asarray(keep, np.int64))
    samp_mask = np.isin(seq.sample_id.astype(str),
                        np.asarray(data[cfg.sample_col]).astype(str))

    # GRM SNP load + filters (same as the null fit)
    codes = _genotype_codes(seq)[:, samp_mask]
    if variant_id is not None:
        # explicit GRM panel replaces the maf/missing filter
        # (R/saige_interaction.r:237-247 seqSetFilter(variant.id=))
        vmask = np.isin(seq.variant_id, np.asarray(variant_id))
        if not vmask.any():
            raise ValueError("variant_id matches no variants in the GDS file")
    else:
        valid = codes < 3
        n_valid = valid.sum(axis=1)
        ac = np.where(valid, codes, 0).sum(axis=1, dtype=np.int64)
        with np.errstate(invalid="ignore", divide="ignore"):
            af = ac / (2.0 * n_valid)
        maf = np.minimum(af, 1 - af)
        miss = 1.0 - n_valid / codes.shape[1]
        vmask = np.isfinite(maf) & (maf >= cfg.maf) & \
            (miss <= cfg.missing_rate)
    codes = codes[vmask]
    if cfg.max_num_snp > 0 and codes.shape[0] > cfg.max_num_snp:
        rng = RRandom(cfg.seed)
        sel = np.sort(rng.sample_int(codes.shape[0], cfg.max_num_snp) - 1)
        codes = codes[sel]
    impl = cfg.grm_impl
    if impl == "auto":    # same residency rule as fit_null_glmm
        from ..models.fitnull import _auto_grm_impl
        impl = _auto_grm_impl(*codes.shape)
    if impl == "packed":
        from ..ops.packed_grm import build_packed_grm
        grm = build_packed_grm(codes)
    elif impl == "packed2":
        from ..ops.packed_grm import build_packed2_grm
        grm = build_packed2_grm(codes)
    else:
        grm = build_grm(codes)

    y = np.asarray(data[resp], np.float64)
    ori_X, _ = _model_matrix(data, covs)

    # sample index into the assoc data
    a_order = {s: i for i, s in enumerate(seq_assoc.sample_id.astype(str))}
    i_geno = np.asarray([a_order[s] for s in
                         np.asarray(data[cfg.sample_col]).astype(str)])
    vid_pos = {v: i for i, v in enumerate(seq_assoc.variant_id)}

    # initial tau (optionally pre-fitted once)
    tau_init = np.array([1.0, 0.5])
    ti = np.nan_to_num(np.asarray(cfg.tau_init, float))
    ti[ti < 0] = 0
    if ti[1] > 0:
        tau_init[1] = ti[1]
    if use_approx_tau:
        X_new, _, _ = qr_transform(ori_X)
        fit0 = glm_binomial(X_new, y)
        glmm0 = fit_ai_pcg(grm, fit0, X_new, tau_init, cfg, binary=True)
        tau_init = glmm0.tau

    if glm_threshold is True:
        glm_threshold = 0.01

    def _fetch(vid):  # noqa: E306
        i = vid_pos[vid]
        g = seq_assoc.dosage_block(i, i + 1)[0][i_geno]
        chrom = seq_assoc.chromosome[i]
        pos = seq_assoc.position[i]
        allele = seq_assoc.allele[i].replace(",", "_")
        return _minor_allele_geno(g), f"{chrom}:{pos}_{allele}"

    snp_pair = pd.DataFrame(snp_pair)
    if pair_batch and pair_batch > 1:
        extra = {c: snp_pair[c].to_numpy() for c in snp_pair.columns[2:]}
        return _gxg_run_batched(grm, ori_X, y,
                                [row for _, row in snp_pair.iterrows()],
                                _fetch, tau_init, use_approx_tau,
                                glm_threshold, cfg, pair_batch, res_savefn,
                                extra, res_compress)

    rows = []
    for _, pair in snp_pair.iterrows():
        i1, i2 = pair.iloc[0], pair.iloc[1]
        g1, s1 = _fetch(i1)
        g2, s2 = _fetch(i2)
        maf1 = g1.mean() * 0.5
        maf2 = g2.mean() * 0.5

        X = np.column_stack([ori_X, g1, g2])
        # collinearity drop + QR transform (R/saige_interaction.r:457-480)
        X_new, _, _ = qr_transform(X)
        fit0 = glm_binomial(X_new, y)
        nok = obj_nok_binary(X_new, y)

        d = None
        p_glm = p_glm_norm = None
        run_glmm = True
        if glm_threshold is not False:
            glmm = fit_ai_pcg(grm, fit0, X_new, np.array([1.0, 0.0]), cfg,
                              binary=True, no_iteration=True)
            d = _gxg_stat(grm, fit0, glmm, nok, g1 * g2, cfg)
            p_glm, p_glm_norm = d["pval"], d["p.norm"]
            d["pval"] = d["p.norm"] = np.nan
            d["p.glm"] = p_glm
            d["p.glm.norm"] = p_glm_norm
            run_glmm = np.isfinite(p_glm) and p_glm <= glm_threshold
        if run_glmm:
            glmm = fit_ai_pcg(grm, fit0, X_new, tau_init.copy(), cfg,
                              binary=True, no_iteration=use_approx_tau)
            d = _gxg_stat(grm, fit0, glmm, nok, g1 * g2, cfg)
            if p_glm is not None:
                d["p.glm"] = p_glm
                d["p.glm.norm"] = p_glm_norm

        row = dict(id1=i1, snp1=s1, maf1=maf1, id2=i2, snp2=s2, maf2=maf2)
        row.update(d)
        rows.append(row)
        if res_savefn:
            # incremental checkpoint after every pair, like the reference
            # (R/saige_interaction.r:612-631) — a crash loses no results
            from .single import save_assoc
            save_assoc(pd.DataFrame(rows), res_savefn,
                       res_compress=res_compress)

    out = pd.DataFrame(rows)
    if snp_pair.shape[1] > 2:
        for c in snp_pair.columns[2:]:
            out[c] = snp_pair[c].to_numpy()[: len(out)]
    if res_savefn:
        from .single import save_assoc
        save_assoc(out, res_savefn, res_compress=res_compress)
    return out
