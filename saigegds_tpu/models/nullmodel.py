"""Null-model container: fit results, (de)serialization, scan preparation.

``NullModel`` mirrors the reference's ``ClassSAIGE_NullModel`` S3 object
(``R/saige_main.r:616-628``) so models are interchangeable: we can load a
model fitted by the R package from ``.rds`` and vice versa (ours saves to
``.npz``/``.json``).  ``fit_null_glmm`` is the device fitting entry
point (see ``fitnull.py``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

import warnings

import numpy as np

from ..io.rds import read_rds, strip, RObject


@dataclass
class NullModel:
    trait_type: str                   # "binary" | "quantitative"
    coefficients: np.ndarray          # [K]
    coef_names: list
    tau: np.ndarray                   # [2] (Sigma_E, Sigma_G)
    linear_predictors: np.ndarray     # [N]
    fitted_values: np.ndarray         # [N] mu
    residuals: np.ndarray             # [N] y - mu
    cov: np.ndarray                   # [K, K]
    converged: bool
    # obj.noK (the SPAtest-style projection state)
    y: np.ndarray                     # [N]
    mu: np.ndarray                    # [N]
    res: np.ndarray                   # [N]
    V: np.ndarray                     # [N]
    X1: np.ndarray                    # [N, K]
    XV: np.ndarray                    # [K, N]
    XXVX_inv: np.ndarray              # [N, K]
    # variance ratio table (id, maf, mac, var1, var2, ratio)
    var_ratio: dict = field(default_factory=dict)
    sample_id: np.ndarray = None
    variant_id: np.ndarray = None
    # structured convergence telemetry from the fit (iteration taus,
    # trace-CV escalations, per-marker variance ratios; utils/telemetry.py);
    # not serialized
    fit_log: list = None

    @property
    def n_samples(self) -> int:
        return len(self.y)

    def __repr__(self) -> str:
        """Compact structure dump (print.ClassSAIGE_NullModel = str(x),
        reference R/saige_main.r:658)."""
        tau = np.asarray(self.tau, dtype=float)
        coef = ", ".join(f"{n}={c:.6g}" for n, c in
                         zip(self.coef_names, np.asarray(self.coefficients)))
        vr = np.asarray(self.var_ratio.get("ratio", []), dtype=float)
        lines = [
            f"<NullModel trait_type={self.trait_type!r} "
            f"n_samples={self.n_samples} converged={self.converged}>",
            f"  tau (Sigma_E, Sigma_G): {tau[0]:.6g}, {tau[1]:.6g}",
            f"  coefficients: {coef}",
            f"  var.ratio: n={vr.size}"
            + (f" mean={vr.mean():.6g}" if vr.size else ""),
            f"  GRM variants: "
            f"{0 if self.variant_id is None else len(self.variant_id)}",
        ]
        return "\n".join(lines)

    @property
    def mean_var_ratio(self) -> float:
        """NaN-skipping mean like the reference's
        mean(var.ratio$ratio, na.rm=TRUE), which also hard-errors on a
        non-finite result (R/assoc_single.r:157, .init_nullmod:21-22)."""
        r = np.asarray(self.var_ratio.get("ratio", [1.0]), dtype=float)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # all-NaN mean warns
            v = float(np.nanmean(r))
        if not np.isfinite(v):
            raise ValueError("the variance ratio is not finite")
        return v

    # ---- persistence ----

    @classmethod
    def load(cls, path_or_obj) -> "NullModel":
        """Load from .rds (R package format), .npz (ours), or pass-through."""
        if isinstance(path_or_obj, NullModel):
            return path_or_obj
        path = str(path_or_obj)
        low = path.lower()
        if low.endswith(".rds"):
            return cls.from_r_object(read_rds(path))
        if low.endswith(".rda") or low.endswith(".rdata"):
            # .rda/.RData container: the reference's .check_modobj does
            # get(load(fn)) — take the single stored object
            from ..io.rds import read_rdata
            objs = read_rdata(path)
            return cls.from_r_object(next(iter(objs.values())))
        if path.endswith(".npz"):
            return cls.from_npz(path)
        raise ValueError(f"unknown model file format: {path}")

    @classmethod
    def from_r_object(cls, m) -> "NullModel":
        """Decode a ClassSAIGE_NullModel read from RDS."""
        nok = m["obj.noK"]
        N = len(strip(nok["y"]))
        coef = m["coefficients"]
        coef_names = coef.names if isinstance(coef, RObject) else None
        K = len(strip(coef))

        def mat(x, shape):
            return np.asarray(strip(x), dtype=np.float64).reshape(shape, order="F")

        vr = m["var.ratio"]
        vrd = {k: np.asarray(strip(vr[k])) for k in vr.names} if vr is not None else {}
        if vr is not None and isinstance(vr, RObject) \
                and "mac.bins" in vr.attributes:
            vrd["mac_bins"] = np.asarray(strip(vr.attributes["mac.bins"]))
        return cls(
            trait_type=str(strip(m["trait.type"])[0]),
            coefficients=np.asarray(strip(coef), dtype=np.float64),
            coef_names=list(coef_names) if coef_names else [f"b{i}" for i in range(K)],
            tau=np.asarray(strip(m["tau"]), dtype=np.float64),
            linear_predictors=np.asarray(strip(m["linear.predictors"]), np.float64),
            fitted_values=np.asarray(strip(m["fitted.values"]), np.float64),
            residuals=np.asarray(strip(m["residuals"]), np.float64),
            cov=mat(m["cov"], (K, K)),
            converged=bool(np.asarray(strip(m["converged"]))[0]),
            y=np.asarray(strip(nok["y"]), np.float64),
            mu=np.asarray(strip(nok["mu"]), np.float64),
            res=np.asarray(strip(nok["res"]), np.float64),
            V=np.asarray(strip(nok["V"]), np.float64),
            X1=mat(nok["X1"], (N, K)),
            XV=mat(nok["XV"], (K, N)),
            XXVX_inv=mat(nok["XXVX_inv"], (N, K)),
            var_ratio=vrd,
            sample_id=np.asarray(strip(m["sample.id"])),
            variant_id=np.asarray(strip(m["variant.id"])),
        )

    def to_r_object(self) -> RObject:
        """Build the R-side ``ClassSAIGE_NullModel`` structure (the inverse
        of :meth:`from_r_object`; layout per R/saige_main.r:616-628)."""
        K = len(self.coefficients)
        vr = dict(self.var_ratio)
        # category bin bounds aren't per-row data: carry them as an R
        # attribute on the data.frame (wrong length for a column)
        mac_bins = vr.pop("mac_bins", None)
        vr_n = len(np.asarray(vr.get("ratio", [])))
        vr_attrs = {"class": "data.frame",
                    "row.names": np.asarray([-2147483648, -vr_n], np.int32)}
        if mac_bins is not None:
            vr_attrs["mac.bins"] = np.asarray(mac_bins, np.float64)
        var_ratio = RObject({k: np.asarray(v) for k, v in vr.items()},
                            vr_attrs)
        obj_nok = {
            "y": self.y, "mu": self.mu, "res": self.res, "V": self.V,
            "X1": self.X1, "XV": self.XV, "XXVX_inv": self.XXVX_inv,
        }
        body = {
            "coefficients": RObject(
                np.asarray(self.coefficients, np.float64),
                {"names": np.asarray(self.coef_names, object)}),
            "tau": RObject(np.asarray(self.tau, np.float64),
                           {"names": np.asarray(["Sigma_E", "Sigma_G"],
                                                object)}),
            "linear.predictors": np.asarray(self.linear_predictors,
                                            np.float64),
            "fitted.values": np.asarray(self.fitted_values, np.float64),
            "residuals": np.asarray(self.residuals, np.float64),
            "cov": np.asarray(self.cov, np.float64).reshape(K, K),
            "converged": bool(self.converged),
            "obj.noK": obj_nok,
            "var.ratio": var_ratio,
            "trait.type": str(self.trait_type),
            "sample.id": self.sample_id,
            "variant.id": self.variant_id,
        }
        return RObject(body, {"class": "ClassSAIGE_NullModel"})

    def save(self, path: str):
        """Save to .npz (ours) or .rds (R-interoperable checkpoint, the
        reference's contract R/saige_main.r:630-643)."""
        low = path.lower()
        if low.endswith(".rds"):
            from ..io.rds_write import write_rds
            write_rds(path, self.to_r_object())
            return
        if low.endswith(".rda") or low.endswith(".rdata"):
            # the reference's save(glmm, file=) container (:630-643)
            from ..io.rds_write import write_rdata
            write_rdata(path, {"glmm": self.to_r_object()})
            return
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez_compressed(
            path,
            trait_type=self.trait_type,
            coefficients=self.coefficients,
            coef_names=np.asarray(self.coef_names, dtype=object),
            tau=self.tau,
            linear_predictors=self.linear_predictors,
            fitted_values=self.fitted_values,
            residuals=self.residuals,
            cov=self.cov,
            converged=self.converged,
            y=self.y, mu=self.mu, res=self.res, V=self.V,
            X1=self.X1, XV=self.XV, XXVX_inv=self.XXVX_inv,
            var_ratio=json.dumps({k: np.asarray(v).tolist()
                                  for k, v in self.var_ratio.items()}),
            sample_id=self.sample_id,
            variant_id=self.variant_id,
        )

    @classmethod
    def from_npz(cls, path: str) -> "NullModel":
        z = np.load(path, allow_pickle=True)
        return cls(
            trait_type=str(z["trait_type"]),
            coefficients=z["coefficients"],
            coef_names=list(z["coef_names"]),
            tau=z["tau"],
            linear_predictors=z["linear_predictors"],
            fitted_values=z["fitted_values"],
            residuals=z["residuals"],
            cov=z["cov"],
            converged=bool(z["converged"]),
            y=z["y"], mu=z["mu"], res=z["res"], V=z["V"],
            X1=z["X1"], XV=z["XV"], XXVX_inv=z["XXVX_inv"],
            var_ratio={k: np.asarray(v) for k, v in
                       json.loads(str(z["var_ratio"])).items()},
            sample_id=z["sample_id"],
            variant_id=z["variant_id"],
        )

    # ---- scan preparation (the .init_nullmod analog) ----

    def scan_model(self, sample_index: Optional[np.ndarray] = None,
                   var_ratio: float = float("nan")):
        """Build the device-side ScanModel (cf. R/assoc_single.r:17-67).

        ``sample_index[j]`` is the *model* position of the j-th genotype
        column the scan will feed in (the reference's
        ``ii <- match(sid, modobj$sample.id)``); the model's per-sample
        arrays are gathered into that column order.  Callers must subset
        genotype blocks to the matching columns (see
        ``assoc.single._match_samples``)."""
        import jax.numpy as jnp
        from ..ops.score import ScanModel

        ii = np.arange(self.n_samples) if sample_index is None else sample_index
        y = self.y[ii]
        mu = self.fitted_values[ii]
        vr_edges = vr_ratios = None
        if not np.isfinite(var_ratio):
            vrd = self.var_ratio
            if len(np.asarray(vrd.get("mac_bins", []))) \
                    and "mac_cat" in vrd:
                # MAC-categorized ratios (fitnull.calc_var_ratio_cat):
                # per-category means, empty categories fall back to the
                # overall mean
                edges = np.asarray(vrd["mac_bins"], float)
                cat = np.asarray(vrd["mac_cat"], int)
                rat = np.asarray(vrd["ratio"], float)
                means = np.full(len(edges) + 1, self.mean_var_ratio)
                for c in range(len(means)):
                    rc = rat[cat == c]
                    rc = rc[np.isfinite(rc)]
                    if rc.size:
                        means[c] = rc.mean()
                vr_edges = jnp.asarray(edges)
                vr_ratios = jnp.asarray(means)
            var_ratio = self.mean_var_ratio
        return ScanModel(
            trait_binary=(self.trait_type == "binary"),
            tau=jnp.asarray(self.tau),
            y=jnp.asarray(y),
            mu=jnp.asarray(mu),
            y_mu=jnp.asarray(y - mu),
            mu2=jnp.asarray(mu * (1.0 - mu)),
            XV=jnp.asarray(self.XV[:, ii]),
            XXVX_inv=jnp.asarray(self.XXVX_inv[ii, :]),
            var_ratio=float(var_ratio),
            vr_edges=vr_edges,
            vr_ratios=vr_ratios,
        )


def fit_null_glmm(*args, **kwargs):
    from .fitnull import fit_null_glmm as _fit
    return _fit(*args, **kwargs)


def fit_null_glmm_multi(*args, **kwargs):
    from .fitnull import fit_null_glmm_multi as _fit
    return _fit(*args, **kwargs)
