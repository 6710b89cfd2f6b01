"""Multi-host orchestration: process init, variant-range sharding, merge.

The reference scales across machines by running independent jobs on variant
ranges and row-binding the result files (``seqSAIGE_LoadPval``,
R/saige_main.r:205-213).  This package keeps that embarrassingly-parallel
structure for the scan — each host owns a contiguous variant range and
writes one result shard — while the *fit* shards samples across all
devices (``ShardedGrmHandle`` + ``psum`` over the interconnect; initialize
with :func:`init_distributed` so every host sees the global mesh).
"""

from __future__ import annotations

import glob
from typing import Optional, Tuple

import numpy as np


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Initialize jax.distributed for a multi-host run.

    Pass the coordinator address (``host:port``), the process count and
    this process's id; a bare call works only where a cluster environment
    JAX recognises provides them.  Returns (process_id, process_count).
    No-op when already initialized.
    """
    import jax
    from jax._src import distributed as _dist
    already = getattr(_dist.global_state, "client", None) is not None
    if not already:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id)
        except (ValueError, RuntimeError):
            # single-process run with nothing to auto-detect, or the
            # backend is already up (e.g. init after a device query):
            # degrade to a no-op — process_index/count report (0, 1)
            if coordinator_address is not None or \
                    (num_processes or 1) > 1:
                raise       # an explicit multi-process setup must not fail
    return jax.process_index(), jax.process_count()


def host_variant_range(n_variants: int,
                       process_id: Optional[int] = None,
                       process_count: Optional[int] = None) -> Tuple[int, int]:
    """Contiguous [start, stop) variant range owned by this host."""
    import jax
    pid = jax.process_index() if process_id is None else process_id
    cnt = jax.process_count() if process_count is None else process_count
    per = -(-n_variants // cnt)
    start = min(pid * per, n_variants)
    return start, min(start + per, n_variants)


def shard_path(out_prefix: str, process_id: int) -> str:
    return f"{out_prefix}.part{process_id:04d}.parquet"


def assoc_spa_sharded(gdsfile, modobj, out_prefix: str, config=None,
                      process_id: Optional[int] = None,
                      process_count: Optional[int] = None,
                      mesh=None) -> str:
    """Scan this host's variant range and write one result shard.

    Run the same command on every host (or as independent cluster jobs with
    explicit ``process_id``/``process_count``); afterwards any host merges
    with :func:`merge_shards`.  Returns the shard path written.
    """
    from ..assoc.single import assoc_spa, save_assoc
    from ..config import ScanConfig
    from ..io.seqarray import SeqData

    config = config or ScanConfig()
    seq = gdsfile if isinstance(gdsfile, SeqData) else SeqData(gdsfile)
    start, stop = host_variant_range(seq.n_variants, process_id, process_count)
    mask = np.zeros(seq.n_variants, dtype=bool)
    mask[start:stop] = True
    df = assoc_spa(seq, modobj, config, variant_mask=mask, mesh=mesh)
    import jax
    pid = jax.process_index() if process_id is None else process_id
    path = shard_path(out_prefix, pid)
    save_assoc(df, path)
    return path


def merge_shards(out_prefix: str, columns=None):
    """Row-bind all shards of a sharded scan (the seqSAIGE_LoadPval merge)."""
    from ..utils.stats import load_pval
    paths = sorted(glob.glob(f"{out_prefix}.part*.parquet"))
    if not paths:
        raise FileNotFoundError(f"no shards matching {out_prefix}.part*")
    return load_pval(paths, columns=columns)
