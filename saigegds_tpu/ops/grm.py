"""Matrix-free GRM operator: v -> G_std' (G_std v) / M on device.

Device equivalent of the reference's TBB-parallel crossprod hot loop
(``get_crossprod_b_grm``, src/saige_fitnull.cpp:432-536).  The reference
decodes 2-bit genotypes through a 4-value standardization lookup per
variant; here the standardized matrix is materialised (or streamed in
variant blocks) so the product becomes two large matmuls.  Multi-chip: samples are sharded across the mesh and the
M-partials reduced with ``psum`` (see ``parallel/mesh.py``).

Standardization (src/saige_fitnull.cpp:182-202): per variant with allele
frequency ``af`` over non-missing samples, s(g) = (g - 2 af) / sqrt(2 af
(1-af)) for g in {0,1,2} and s(missing) = 0; GRM = (1/M) sum_m s_m s_m'.
Allele flipping in the sparse store (:295-303) only flips the sign of s_m,
leaving the GRM unchanged, so it is not reproduced.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class GRMOperator(NamedTuple):
    """Device-resident standardized genotypes + diag(GRM)."""

    std_geno: jnp.ndarray   # [M, N] float64 standardized genotypes
    diag: jnp.ndarray       # [N] diag(GRM)
    n_variants: int
    n_samples: int

    def matvec(self, b):
        return grm_matvec(self.std_geno, b)

    def matmat(self, B):
        return grm_matmat(self.std_geno, B)


def std_lookup_table(codes: np.ndarray) -> np.ndarray:
    """Per-variant 4-value standardized lookup [M, 4] from int8 codes.

    codes: [M, N] with 0/1/2 dosage and 3 = missing (the ``buf_std_geno``
    analog, src/saige_fitnull.cpp:182-202)."""
    valid = codes < 3
    n_valid = valid.sum(axis=1)
    s = np.where(valid, codes, 0).sum(axis=1, dtype=np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        af = s / (2.0 * n_valid)
        inv = 1.0 / np.sqrt(2.0 * af * (1.0 - af))
    bad = ~np.isfinite(af) | ~np.isfinite(inv)
    af = np.where(bad, 0.0, af)
    inv = np.where(bad, 0.0, inv)
    tab = np.empty((codes.shape[0], 4), dtype=np.float64)
    tab[:, 0] = (0.0 - 2.0 * af) * inv
    tab[:, 1] = (1.0 - 2.0 * af) * inv
    tab[:, 2] = (2.0 - 2.0 * af) * inv
    tab[:, 3] = 0.0
    return tab


def build_grm(codes: np.ndarray) -> GRMOperator:
    """Build the device GRM operator from int8 genotype codes [M, N]."""
    tab = std_lookup_table(codes)
    std = np.take_along_axis(tab, codes.astype(np.int64), axis=1)
    M, N = codes.shape
    diag = (std * std).sum(axis=0) / M
    return GRMOperator(
        std_geno=jnp.asarray(std),
        diag=jnp.asarray(diag),
        n_variants=M,
        n_samples=N,
    )


@jax.jit
def grm_matvec(std_geno, b):
    """GRM @ b = G_std' (G_std b) / M for b [N] or [N, R]."""
    M = std_geno.shape[0]
    gb = std_geno @ b              # [M] or [M, R]
    return (std_geno.T @ gb) / M   # [N] or [N, R]


grm_matmat = grm_matvec
