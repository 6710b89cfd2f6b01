"""saigegds_tpu: a mixed-model association engine in JAX.

A from-scratch JAX/XLA framework with the capabilities of the SAIGEgds R
package (null GLMM fitting against an implicit GRM, variance-ratio
estimation, score tests with saddlepoint-approximation p-values, burden /
ACAT-V / ACAT-O aggregate tests, GxG interaction tests), run on a GPU and
sharded over several with a device mesh.

The reference contract is float64 throughout (SAIGEgds promotes all float32
math in the original SAIGE to double, ``/root/reference/README.md:12``), so
x64 mode is enabled at import.
"""

import jax

jax.config.update("jax_enable_x64", True)

from .config import NullModelConfig, ScanConfig  # noqa: E402
from .models.nullmodel import (NullModel, fit_null_glmm,  # noqa: E402
                               fit_null_glmm_multi)
from .assoc.single import assoc_spa, assoc_spa_multi, assoc_spa_user  # noqa: E402
from .assoc.aggregate import (assoc_burden, assoc_acat_v,  # noqa: E402
                              assoc_acat_o, sliding_windows,
                              units_from_groups)
from .assoc.gxg import gxg_spa  # noqa: E402
from .utils.stats import acat_p, acat_p_maf, glmm_heritability, load_pval  # noqa: E402
from .utils.profiling import device_info, phase_timer, profile_trace  # noqa: E402
from .models.fit_device import (fit_glmm_binary_device,  # noqa: E402
                                fit_glmm_binary_device_multi,
                                fit_glmm_quant_device,
                                fit_glmm_quant_device_multi)

__version__ = "0.1.0"
