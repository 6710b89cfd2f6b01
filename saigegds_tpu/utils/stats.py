"""User-facing statistical utilities (pACAT, heritability, result loading).

Equivalents of the reference's exported helpers ``pACAT``/``pACAT2``
(R/saige_main.r:145-156), ``glmmHeritability`` (R/saige_main.r:666-691) and
``seqSAIGE_LoadPval`` (R/saige_main.r:164-215).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from ..ops.acat import acat_pval, beta_weights


def acat_p(pvals, weights=None) -> float:
    """Cauchy-combination p-value (pACAT)."""
    p = np.atleast_1d(np.asarray(pvals, dtype=np.float64))
    if p.size == 1:
        return float(p[0])
    return float(acat_pval(p, weights))


def acat_p_maf(pvals, maf, wbeta=(1.0, 25.0)) -> float:
    """pACAT2: weights dbeta(maf; b1, b2)^2 * maf * (1 - maf)."""
    maf = np.asarray(maf, dtype=np.float64)
    w = np.asarray(beta_weights(maf, wbeta[0], wbeta[1])) ** 2 * maf * (1.0 - maf)
    return acat_p(pvals, w)


def glmm_heritability(model, adjust: bool = True) -> float:
    """Heritability estimate from a fitted null model (glmmHeritability).

    binary: h2 = tau_G / (pi^2/3 + tau_G), scaled (``adjust=True``) to the
    liability scale with r = 2.970 + 0.372*log10(p) where p is the observed
    case fraction of the model's y (Zhou et al. 2018, Supp. Table 7;
    reference R/saige_main.r:666-691).
    quantitative: h2 = tau_G / (tau_E + tau_G).
    """
    from ..models.nullmodel import NullModel
    m = NullModel.load(model)
    tau = np.asarray(m.tau, dtype=float)
    if m.trait_type == "binary":
        r = 1.0
        if adjust:
            p = float(np.mean(np.asarray(m.y) == 1))
            r = 2.970 + 0.372 * np.log10(p)
        return float(tau[1] / (np.pi ** 2 / 3.0 + tau[1]) * r)
    if m.trait_type == "quantitative":
        return float(tau[1] / (tau[0] + tau[1]))
    raise ValueError(f"unknown trait type {m.trait_type!r}")


def load_pval(files: Union[str, Sequence[str]], columns=None,
              index=None):
    """Load and row-bind association result shards (seqSAIGE_LoadPval).

    Supports our gds/parquet/tsv/csv outputs and the reference's .rds and
    SAIGE_OUTPUT .gds files.  ``columns`` subsets columns (varnm);
    ``index`` subsets rows of a single file (like the reference, it is
    rejected for multi-file merges).  Returns a pandas DataFrame.
    """
    import pandas as pd

    if index is not None and not isinstance(files, str) and len(files) > 1:
        raise ValueError("'index' should be None for multiple input files")
    if isinstance(files, (str,)):
        files = [files]
    parts = []
    for fn in files:
        low = fn.lower()
        if low.endswith(".rds") or low.endswith(".rda") or \
                low.endswith(".rdata"):
            from ..io.rds import read_rdata, read_rds, strip
            if low.endswith(".rds"):
                obj = read_rds(fn)
            else:
                # .rda/.RData container: the single stored object, like
                # the reference's get(load(fn)) (R/saige_main.r:191-194)
                objs = read_rdata(fn)
                obj = next(iter(objs.values()))
            names = obj.names
            data = {k: np.asarray(strip(obj[k])) for k in names}
            parts.append(pd.DataFrame(data))
        elif low.endswith(".gds"):
            # reference SAIGE_OUTPUT / SAIGE_OUTPUT_SET files
            # (seqSAIGE_LoadPval's gds branch, R/saige_main.r:176-191)
            from ..io.gds import open_gds
            f = open_gds(fn)
            fmt = f.root.attrs.get("FileFormat", "")
            fmt = fmt[0] if isinstance(fmt, list) else fmt
            if fmt not in ("SAIGE_OUTPUT", "SAIGE_OUTPUT_SET"):
                raise ValueError(
                    "FileFormat should be 'SAIGE_OUTPUT' or "
                    f"'SAIGE_OUTPUT_SET', got {fmt!r}")
            data = {}
            for nm in f.root.ls():
                if nm == "sample.id" or f.root[nm].is_folder:
                    continue
                if columns is not None and nm not in columns:
                    continue     # don't inflate unrequested columns
                data[nm] = np.asarray(f.root[nm].read())
            parts.append(pd.DataFrame(data))
        elif low.endswith(".parquet"):
            parts.append(pd.read_parquet(fn))
        elif low.endswith(".csv") or low.endswith(".csv.gz"):
            parts.append(pd.read_csv(fn))
        else:
            parts.append(pd.read_csv(fn, sep="\t"))
    df = pd.concat(parts, ignore_index=True)
    if columns is not None:
        df = df[list(columns)]
    if index is not None:
        df = df.iloc[np.asarray(index)].reset_index(drop=True)
    return df
