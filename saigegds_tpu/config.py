"""Configuration dataclasses with the reference defaults.

Defaults mirror the documented arguments of ``seqFitNullGLMM_SPA`` and
``seqAssocGLMM_SPA`` (reference: ``man/seqFitNullGLMM_SPA.Rd:10-15``,
``R/saige_main.r:223-233``, ``R/assoc_single.r:92``), so that results are
reproducible against the R package bit-for-bit at the algorithm level.
"""

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class NullModelConfig:
    trait_type: str = "binary"  # "binary" | "quantitative"
    sample_col: str = "sample.id"
    maf: float = 0.005            # GRM SNP MAF filter
    missing_rate: float = 0.01    # GRM SNP missing-rate filter
    max_num_snp: int = 1_000_000  # random down-sample bound for GRM SNPs
    inv_norm: bool = True         # rank-based inverse normal (quantitative)
    x_transform: bool = True      # QR-orthonormalise the covariate matrix
    tol: float = 0.02             # outer AI-REML convergence tolerance
    maxiter: int = 20             # outer iterations
    nrun: int = 30                # initial number of Hutchinson probes
    nrun_max: int = 0             # cap on CV-escalated probes (0 = unbounded,
                                  # the reference's semantics; a finite cap
                                  # warns and proceeds with the probes so far)
    checkpoint: str = ""          # mid-fit checkpoint path prefix: the
                                  # outer AI-REML loop and the variance-
                                  # ratio pass save resumable state there
                                  # (exact replay; models/fitnull.py)
    tol_pcg: float = 1e-5         # PCG residual tolerance
    maxiter_pcg: int = 500        # PCG iteration bound
    num_marker: int = 30          # initial markers for the variance ratio
    # opt-in MAC-categorized variance ratios (newer-than-v1.12.5 SAIGEgds
    # feature; () = the reference's single pooled ratio over MAC>20
    # markers).  Ascending minor-AC bin bounds: e.g. (10.5, 20.5) makes
    # categories (0, 10.5], (10.5, 20.5], (20.5, inf); the scan then looks
    # each variant's ratio up by its MAC (models/fitnull.calc_var_ratio_cat)
    var_ratio_mac_cat: Tuple[float, ...] = ()
    tau_init: Tuple[float, float] = (0.0, 0.0)
    trace_cv_cutoff: float = 0.0025
    ratio_cv_cutoff: float = 0.001
    # The reference's geno.sparse flag picks its sparse index-list vs dense
    # 2-bit store (R/saige_main.r:399-420); here grm_impl covers that axis:
    # "packed" (bf16-exact integer codes + sparse missing corrections)
    # subsumes both layouts; "packed2" keeps the genotypes 2-bit
    # planar-packed on device (0.25 B/genotype, the reference's
    # footprint) with on-device decode — same exact integer-slice matvec.
    grm_impl: str = "auto"        # "auto" = packed, or packed2 when the
                                  # bf16 store would top a quarter of
                                  # device memory (packed2_split when its
                                  # one program would not fit) | "dense"
                                  # f64 G_std | "packed" bf16 codes |
                                  # "packed2" 2-bit
                                  # | "packed2_split" 2-bit, one program
                                  # per leaf group (models/fit_split.py)
    stream_geno: object = "auto"  # out-of-core streamed GRM ingestion
                                  # (packed/packed2 only; host holds one
                                  # block).  True | False | "auto" (stream
                                  # when the int8 matrix would top ~4 GB)
    seed: int = 200
    num_thread: int = 1


@dataclass(frozen=True)
class ScanConfig:
    maf: float = float("nan")     # NaN = no filter
    mac: float = 10.0
    missing: float = 0.1
    spa_pval: float = 0.05        # run SPA when p_noadj below this
    var_ratio: float = float("nan")  # NaN = mean of model's var.ratio table
    dsnode: str = ""              # "" = auto-detect genotype vs DS
    use_packed: bool = True       # integer-code fast path for genotype nodes
    packed_2bit: bool = True      # ship scan blocks 2-bit planar-packed
                                  # (0.25 B/genotype host->device and on
                                  # device;
                                  # decode on device; bit-parity with int8)
    packed_sparse: bool = True    # ALLOW shipping rare rows (nnz < N/8)
                                  # gap-coded (2 B/nonzero; the reference's
                                  # sparse store recast as transport,
                                  # exact).  Engagement is link-aware: the
                                  # tier only activates when the scan's own
                                  # measured upload rate makes the dense
                                  # bytes the pipeline's binder
                                  # (assoc.single.TransportPolicy)
    transport_policy: str = "auto"  # "auto": the link-aware engagement
                                  # above; "static": the nnz-only rule
                                  # (engage sparse purely on rarity — for
                                  # benches/tests of the tier machinery)
    spa_compact: bool = True      # gather nonzero lanes before the SPA
                                  # CGF loops (exact; big win for rare vars)
    spa_mixed: bool = False       # DEPRECATED: f32+polish SPA root-finding
                                  # (~1e-4 agreement instead of bit-parity).
                                  # Kept for compatibility; may be removed.
    block_size: int = 1024        # variants per device batch


@dataclass(frozen=True)
class AggregateConfig:
    # beta(1,1) & beta(1,25) weighting schemes (AggrParamBeta,
    # reference R/assoc_aggregate.r:18-19)
    wbeta: Tuple[Tuple[float, float], ...] = ((1.0, 1.0), (1.0, 25.0))
    summac: float = 3.0           # minimum weighted sum of MAC
    acatv_mac: float = 10.0       # ACAT-V MAC threshold for single-variant part
    spa_pval: float = 0.05
    var_ratio: float = float("nan")
    dsnode: str = ""              # "" = auto-detect genotype vs DS
    block_size: int = 256         # test vectors per device batch (the
                                  # streaming kernel's dispatch size)
