"""Single-variant association scan (the ``seqAssocGLMM_SPA`` equivalent).

Streams variant blocks host->device and runs the batched score-test kernel
(``ops/score.py``); output columns and semantics match the reference
(``R/assoc_single.r:92-334``): id, chr, pos, rs.id, ref, alt, AF.alt, mac,
num, beta, SE, pval [, p.norm, converged].  Variants failing the MAF/MAC/
missing filters are dropped from the table, as in the reference's NULL
results (R/assoc_single.r:228-234).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np

from ..config import ScanConfig
from ..io.seqarray import SeqData
from ..models.nullmodel import NullModel
from ..ops.score import (ScanParams, score_stats_binary, score_stats_quant,
                         spa_refine_binary)

SPA_BATCH = 256  # compact SPA refinement batch size
SPA_FLUSH_BYTES = 1 << 30  # flagged-set host budget before an incremental
#                            phase-2 flush (bounds scan memory at scale)


def _prefetch_blocks(block_iter, depth: int = 2, name: str = "",
                     instrument=None):
    """Run the block iterator in a background thread with a bounded queue,
    so host-side GDS decode of block k+1 overlaps the device compute and
    upload of block k (decode is zlib/lzma + native kernels — all release
    the GIL).

    With ``instrument`` and ``name``, three per-item wait timers land in
    lists (inter-stage attribution):
    ``stall_{name}_s`` — the producer blocked on a full queue (the stage
    DOWNSTREAM of ``name`` is the laggard); ``idle_{name}_s`` — the
    consumer blocked on an empty queue (``name`` itself is the laggard);
    ``queued_{name}_s`` — how long a finished item sat ready-but-
    unconsumed (downstream occupancy, not handoff overhead).
    """
    import time as _time
    import queue
    import threading

    q = queue.Queue(maxsize=depth)
    _END = object()
    rec = (lambda k, v: instrument.setdefault(k, []).append(v)) \
        if instrument is not None and name else (lambda k, v: None)

    def worker():
        try:
            for item in block_iter:
                t0 = _time.perf_counter()
                q.put((t0, item))
                rec(f"stall_{name}_s", _time.perf_counter() - t0)
            q.put(_END)
        except BaseException as e:               # surface in the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        t0 = _time.perf_counter()
        item = q.get()
        t1 = _time.perf_counter()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        t_ready, item = item
        rec(f"idle_{name}_s", t1 - t0)
        rec(f"queued_{name}_s", max(t1 - t_ready, 0.0))
        yield item


class TransportPolicy:
    """Link-aware engagement of the gap-coded sparse transport tier.

    Under the three-stage pipeline (decode || pack || upload) the upload
    bytes the sparse tier saves only buy wall-clock when the UPLOAD stage
    is the binder; when decode binds, the tier's device-side decode and
    extra dispatches sit on the critical path for nothing.  The scan
    therefore starts dense and engages the sparse tier only when the
    measured link is the bottleneck:

      projected dense upload (dense_bytes / measured link B/s)
          > hysteresis x measured decode seconds per block.

    Rates are EMAs of the pipeline's own stage timings; the link rate is
    tier-independent (bytes moved / upload-stage seconds), so engaging
    the tier does not flip the signal back (no oscillation).  With no
    measurements yet (first blocks) the decision is ``starved=False`` —
    i.e. the default tier is 2-bit dense.
    """

    EMA = 0.5           # per-block smoothing
    HYSTERESIS = 1.2    # band around the engage threshold
    # Engage only on a DEEPLY starved link: the sparse tier's own costs
    # (device-side decode, extra dispatches, sparse SPA payloads) can be
    # of the same order as a block's decode, so a marginally upload-bound
    # scan still runs faster dense.  The factor 4 is not yet measured on
    # the GPU.
    STARVE_FACTOR = 4.0
    MIN_DECODE_S = 0.05     # below these floors the signals are fixed-
    MIN_UPLOAD_BYTES = 4 << 20  # overhead noise (tiny blocks/payloads):
    #                         stay dense and keep the rate estimates
    #                         untouched — at real block sizes (~110 MB at
    #                         biobank N) both floors are far exceeded

    def __init__(self):
        self.decode_s = None      # EMA seconds per block
        self.link_bps = None      # EMA upload bytes/s
        self._engaged = False

    def note_decode(self, seconds: float):
        if seconds > 0:
            self.decode_s = seconds if self.decode_s is None else \
                (1 - self.EMA) * self.decode_s + self.EMA * seconds

    def note_upload(self, seconds: float, nbytes: int):
        # small transfers measure per-transfer overhead, not bandwidth —
        # they would poison the projection for full-size blocks
        if seconds > 0 and nbytes >= self.MIN_UPLOAD_BYTES:
            bps = nbytes / seconds
            self.link_bps = bps if self.link_bps is None else \
                (1 - self.EMA) * self.link_bps + self.EMA * bps

    def starved(self, dense_bytes: int) -> bool:
        """True when shipping ``dense_bytes`` dense is projected to bind
        the pipeline (the sparse tier's byte saving buys wall-clock)."""
        if self.decode_s is None or self.link_bps is None or \
                self.decode_s < self.MIN_DECODE_S:
            return False
        proj_upload = dense_bytes / self.link_bps
        thr = self.STARVE_FACTOR * (
            self.HYSTERESIS if not self._engaged else 1.0 / self.HYSTERESIS)
        self._engaged = proj_upload > thr * self.decode_s
        return self._engaged


def _shrink_f32(G: np.ndarray) -> np.ndarray:
    """Ship a dosage block f32 when that is lossless (always true for
    dFloat32/dPackedReal GDS sources): halves the host->device bytes;
    kernels widen back to f64 on device (ops/score.prep_dosage)."""
    G32 = G.astype(np.float32)
    if np.array_equal(G32.astype(np.float64), G, equal_nan=True):
        return G32
    return G


def _pad_block(G: np.ndarray, B: int, fill=np.nan) -> np.ndarray:
    if G.shape[0] == B:
        return G
    pad = np.full((B - G.shape[0], G.shape[1]), fill, dtype=G.dtype)
    return np.concatenate([G, pad], axis=0)


def _pack2_block(G: np.ndarray, rows_pad: int) -> np.ndarray:
    """2-bit planar pack of an int8 code block, padded to ``rows_pad``
    all-missing rows — the scan transport's pack stage.  The native
    threaded kernel (sg_pack2_raw) replaces the numpy formulation's ~5
    full passes over the block (pad concat + 4 shift/or passes), which
    fought the decode/upload threads for the same cores."""
    from ..io import native
    out = native.pack2_raw(G, rows_pad)
    if out is not None:
        return out
    from ..ops.packed_grm import pack_codes_2bit
    return pack_codes_2bit(_pad_block(G, rows_pad, fill=3))


def _frame(cols: dict):
    """Result columns -> the pandas DataFrame the public drivers return."""
    import pandas as pd
    return pd.DataFrame(cols)


def _nrows(cols: dict) -> int:
    return len(next(iter(cols.values()))) if cols else 0


def assoc_spa(gdsfile, modobj: Union[NullModel, str],
              config: ScanConfig = ScanConfig(),
              res_savefn: str = "", verbose: bool = False,
              variant_mask: Optional[np.ndarray] = None,
              mesh=None, res_compress: str = "LZMA",
              instrument=None):
    """Score-test + SPA scan over all variants of a SeqArray GDS file.

    ``variant_mask`` restricts the scan (multi-host range sharding, see
    parallel/distributed.py); ``mesh`` data-parallelizes each block over
    local devices with the model replicated.  ``res_compress``: output
    compression, the reference's ``res.compress`` choices
    (see :func:`save_assoc`).  Returns a pandas DataFrame.
    """
    return _frame(scan_table(gdsfile, modobj, config, res_savefn, verbose,
                             variant_mask, mesh, res_compress, instrument))


def scan_table(gdsfile, modobj: Union[NullModel, str],
               config: ScanConfig = ScanConfig(),
               res_savefn: str = "", verbose: bool = False,
               variant_mask: Optional[np.ndarray] = None,
               mesh=None, res_compress: str = "LZMA",
               instrument=None) -> dict:
    """:func:`assoc_spa` returning its columns as a dict of numpy arrays
    (the path that needs no pandas)."""
    model = NullModel.load(modobj)
    seq = gdsfile if isinstance(gdsfile, SeqData) else SeqData(gdsfile)

    # sample alignment (R/assoc_single.r:136-142): cols restricts genotype
    # columns to the model's samples (seqSetFilter(sample.id=) analog, GDS
    # order); ii gathers the model's per-sample arrays to those columns
    # (ii <- match(sid, modobj$sample.id))
    cols, ii = _match_samples(seq.sample_id, model.sample_id)
    scan_model = model.scan_model(sample_index=ii, var_ratio=config.var_ratio)

    params = ScanParams(
        maf=-1.0 if math.isnan(config.maf) else config.maf,
        mac=-1.0 if math.isnan(config.mac) else config.mac,
        missing=1.0 if math.isnan(config.missing) else config.missing,
        spa_pval=config.spa_pval,
    )
    binary = model.trait_type == "binary"
    if verbose:
        print(f"SPA association scan ({model.trait_type} trait): "
              f"{seq.n_variants} variants x {model.n_samples} samples")

    # packed fast path: integer genotype node -> the int8 codes are the
    # only [B, N] operand (ops/score_packed.py)
    packed = config.use_packed and seq.has_genotype() \
        and not config.dsnode and cols is None
    if packed:
        blocks = seq.iter_code_blocks(config.block_size,
                                      variant_mask=variant_mask)
    else:
        blocks = seq.iter_dosage_blocks(config.block_size,
                                        dsnode=config.dsnode,
                                        variant_mask=variant_mask)
    df = _scan_blocks(scan_model, params, binary, config.block_size,
                      blocks, mesh=mesh, packed=packed,
                      packed_2bit=config.packed_2bit,
                      packed_sparse=config.packed_sparse,
                      spa_mixed=config.spa_mixed,
                      spa_compact=config.spa_compact, cols=cols,
                      instrument=instrument,
                      transport_policy=None
                      if config.transport_policy == "auto"
                      else config.transport_policy)
    df = _with_meta(seq, df)
    if verbose:
        n = _nrows(df)
        print(f"    tested {n} variants "
              f"(filters dropped {seq.n_variants - n})")
    if res_savefn:
        save_assoc(df, res_savefn, res_compress=res_compress)
        if verbose:
            print(f"    saved to {res_savefn}")
    return df


def _with_meta(seq: SeqData, tab: dict) -> dict:
    """Prepend the variant descriptor columns to a scan core's table."""
    idx = tab.pop("__idx__")
    ref, alt = seq.ref_alt
    return {"id": seq.variant_id[idx], "chr": seq.chromosome[idx],
            "pos": seq.position[idx], "rs.id": seq.rs_id[idx],
            "ref": ref[idx], "alt": alt[idx], **tab}


def assoc_spa_multi(gdsfile, modobjs, config: ScanConfig = ScanConfig(),
                    res_savefn: str = "", verbose: bool = False,
                    variant_mask: Optional[np.ndarray] = None,
                    mesh=None, res_compress: str = "LZMA",
                    model_batch: int = 0) -> list:
    """PheWAS-mode scan (see :func:`scan_tables_multi`); returns a list of
    pandas DataFrames, one per model."""
    return [_frame(t) for t in scan_tables_multi(
        gdsfile, modobjs, config, res_savefn, verbose, variant_mask, mesh,
        res_compress, model_batch)]


def scan_tables_multi(gdsfile, modobjs, config: ScanConfig = ScanConfig(),
                      res_savefn: str = "", verbose: bool = False,
                      variant_mask: Optional[np.ndarray] = None,
                      mesh=None, res_compress: str = "LZMA",
                      model_batch: int = 0) -> list:
    """PheWAS-mode scan: score-test + SPA for SEVERAL null models over ONE
    pass of the genotype stream.

    At biobank N the scan's binding resource is moving genotypes (host
    decode + transport + upload); those costs are paid once here and every
    model's phase-1 kernel runs on the resident block, so P phenotypes
    cost about one scan instead of P.  The reference has no counterpart —
    ``seqAssocGLMM_SPA`` re-streams the GDS per phenotype/model
    (R/assoc_single.r:202-222); this is the natural batching for an
    accelerator with the payload already in HBM.

    ``modobjs``: list of NullModel objects or paths.  Binary and
    quantitative models may mix; every model must select the SAME GDS
    sample columns (same sample universe — per-model covariates and
    phenotypes differ freely).  Filters (maf/mac/missing) come from the
    shared ``config``, so all result tables cover the identical variant
    set, in the same order.

    ``res_savefn``: optional pattern containing ``{}`` (formatted with the
    model's index, e.g. ``"out_{}.gds"``).

    ``model_batch``: >0 caps how many models stay device-resident per
    genotype pass — beyond ~32 models at biobank N the per-model scan
    state (XV/XXVX_inv/mu vectors, ~41 MB each at N=430k) exhausts one
    chip's HBM, so larger P runs in ceil(P / model_batch) passes (still
    P/model_batch fewer streams than the reference's one-pass-per-model).

    Returns a list of column dicts, one per model, each shaped exactly
    like :func:`scan_table`'s output.
    """
    if not modobjs:
        raise ValueError("assoc_spa_multi: empty model list")
    if res_savefn:
        # fail malformed patterns BEFORE the scan runs (stray braces like
        # "out_{run}_{}.csv" pass a substring check but raise at save time)
        try:
            probe = res_savefn.format(0)
        except Exception as e:
            raise ValueError(f"res_savefn is not a valid '{{}}' pattern "
                             f"({e!r}): {res_savefn!r}") from None
        if probe == res_savefn:
            raise ValueError("res_savefn must contain '{}' (model index)")
    if model_batch and len(modobjs) > model_batch:
        results = []
        for g0 in range(0, len(modobjs), model_batch):
            grp = modobjs[g0:g0 + model_batch]
            dfs = scan_tables_multi(gdsfile, grp, config, "", verbose,
                                    variant_mask, mesh, res_compress)
            if res_savefn:
                for i, df in enumerate(dfs):
                    save_assoc(df, res_savefn.format(g0 + i),
                               res_compress=res_compress)
            results.extend(dfs)
        return results
    models = [NullModel.load(m) for m in modobjs]
    seq = gdsfile if isinstance(gdsfile, SeqData) else SeqData(gdsfile)

    cols0 = None
    scan_models = []
    for i, model in enumerate(models):
        cols, ii = _match_samples(seq.sample_id, model.sample_id)
        if i == 0:
            cols0 = cols
        elif not ((cols is None and cols0 is None) or
                  (cols is not None and cols0 is not None and
                   np.array_equal(cols, cols0))):
            raise ValueError(
                "assoc_spa_multi: all models must select the same GDS "
                "sample columns (fit them on one sample universe, or scan "
                "separately with assoc_spa)")
        scan_models.append(model.scan_model(sample_index=ii,
                                            var_ratio=config.var_ratio))

    params = ScanParams(
        maf=-1.0 if math.isnan(config.maf) else config.maf,
        mac=-1.0 if math.isnan(config.mac) else config.mac,
        missing=1.0 if math.isnan(config.missing) else config.missing,
        spa_pval=config.spa_pval,
    )
    if verbose:
        kinds = ",".join(m.trait_type for m in models)
        print(f"SPA association scan x{len(models)} models ({kinds}): "
              f"{seq.n_variants} variants, one genotype pass")

    packed = config.use_packed and seq.has_genotype() \
        and not config.dsnode and cols0 is None
    if packed:
        blocks = seq.iter_code_blocks(config.block_size,
                                      variant_mask=variant_mask)
    else:
        blocks = seq.iter_dosage_blocks(config.block_size,
                                        dsnode=config.dsnode,
                                        variant_mask=variant_mask)
    dfs = _scan_blocks_multi(
        [(sm, m.trait_type == "binary")
         for sm, m in zip(scan_models, models)],
        params, config.block_size, blocks, mesh=mesh, packed=packed,
        packed_2bit=config.packed_2bit, packed_sparse=config.packed_sparse,
        spa_mixed=config.spa_mixed, spa_compact=config.spa_compact,
        cols=cols0,
        transport_policy=None if config.transport_policy == "auto"
        else config.transport_policy)

    results = []
    for i, df in enumerate(dfs):
        out = _with_meta(seq, df)
        if res_savefn:
            save_assoc(out, res_savefn.format(i), res_compress=res_compress)
        results.append(out)
    if verbose:
        print(f"    tested {_nrows(results[0])} variants per model")
    return results


def assoc_spa_user(geno_fn, n_variants: int, modobj: Union[NullModel, str],
                   config: ScanConfig = ScanConfig(),
                   variant_id=None, res_savefn: str = "",
                   res_compress: str = "LZMA"):
    """Score-test + SPA scan over user-supplied dosages (the reference's
    internal ``.UserGLMM_SPA`` driver, R/assoc_single.r:342-554).

    ``geno_fn(start, stop)`` must return a ``[stop-start, N]`` float array
    of ALT dosages (NaN = missing) aligned with the model's samples.
    """
    model = NullModel.load(modobj)
    scan_model = model.scan_model(var_ratio=config.var_ratio)
    params = ScanParams(
        maf=-1.0 if math.isnan(config.maf) else config.maf,
        mac=-1.0 if math.isnan(config.mac) else config.mac,
        missing=1.0 if math.isnan(config.missing) else config.missing,
        spa_pval=config.spa_pval,
    )
    binary = model.trait_type == "binary"
    B = config.block_size

    def blocks():
        for s in range(0, n_variants, B):
            e = min(s + B, n_variants)
            G = np.asarray(geno_fn(s, e), np.float64)
            if G.shape != (e - s, model.n_samples):
                raise ValueError(
                    f"geno_fn({s}, {e}) returned shape {G.shape}, expected "
                    f"({e - s}, {model.n_samples})")
            yield np.arange(s, e), G

    df = _scan_blocks(scan_model, params, binary, B, blocks())
    idx = df.pop("__idx__")
    ids = np.asarray(variant_id)[idx] if variant_id is not None else idx + 1
    df = {"id": ids, **df}
    if res_savefn:
        save_assoc(df, res_savefn, res_compress=res_compress)
    return _frame(df)


def _scan_blocks(scan_model, params, binary: bool, B: int, block_iter,
                 mesh=None, packed: bool = False, packed_2bit: bool = False,
                 packed_sparse: bool = False, spa_mixed: bool = False,
                 spa_compact: bool = True, cols=None,
                 instrument=None, transport_policy=None) -> dict:
    """Single-model two-phase scan core (see :func:`_scan_blocks_multi`)."""
    return _scan_blocks_multi(
        [(scan_model, binary)], params, B, block_iter, mesh=mesh,
        packed=packed, packed_2bit=packed_2bit, packed_sparse=packed_sparse,
        spa_mixed=spa_mixed, spa_compact=spa_compact, cols=cols,
        instrument=instrument, transport_policy=transport_policy)[0]


def _scan_blocks_multi(models, params, B: int, block_iter,
                       mesh=None, packed: bool = False,
                       packed_2bit: bool = False,
                       packed_sparse: bool = False, spa_mixed: bool = False,
                       spa_compact: bool = True, cols=None,
                       instrument=None, transport_policy=None):
    """Shared two-phase scan core: batched score kernel + compact SPA.

    ``models`` is a list of ``(scan_model, binary)`` pairs that all scan
    the SAME genotype stream: the host decode, transport build, and
    host->device upload happen ONCE per block, and phase 1 dispatches one
    kernel per model on the resident payload (PheWAS mode — the transfer
    is the binding resource at biobank N, so P phenotypes cost ~one scan;
    the reference re-streams the GDS per phenotype, R/assoc_single.r:202).
    The validity filters (maf/mac/missing) are genotype-only, so every
    model tests the identical variant set; per-model outputs differ in
    beta/SE/pval and the SPA-flagged subsets refined in phase 2.

    With ``mesh``, each padded block is sharded over its variant axis and
    the model replicated — embarrassingly parallel, the mesh analog of the
    reference's ``seqParallel(split="by.variant")`` (R/assoc_single.r:202).

    With ``packed_sparse``, rare rows of each packed block (nonzero
    fraction < 1/8) ship gap-coded at 2 B/nonzero instead of 0.25 B/sample
    (ops/sparse_codes — the reference's maf<0.05 sparse split,
    src/saige_main.cpp:299, recast as transport) and common rows ship
    2-bit planar; both decode on device into the same exact contraction.

    ``instrument``: optional dict; when given, per-block wall-times land
    in lists under ``decode_s`` (GDS block read, stage-A thread),
    ``pack_s`` (transport payload build, stage-B thread), ``upload_s``
    (host->device transfer, stage-C thread), ``dispatch_s`` (phase-1
    kernel enqueue, main thread), ``drain_s`` (result sync + readback),
    ``bytes`` (transport payload sizes), plus scalar ``spa_s`` (total
    phase-2 time).  Stages overlap (one prefetch thread each), so sums
    exceed wall-clock by design; the lists attribute where a scan's
    time goes.
    """
    import time as _time
    if instrument is not None:
        for k in ("decode_s", "pack_s", "upload_s", "dispatch_s",
                  "drain_s", "bytes"):
            instrument.setdefault(k, [])
        instrument.setdefault("spa_s", 0.0)
    P = len(models)
    scan_models = [sm for sm, _b in models]
    binaries = [b for _sm, b in models]
    if packed:
        from ..ops.score_packed import (pack_scan_model,
                                        score_stats_binary_packed,
                                        score_stats_quant_packed)
        pms = [pack_scan_model(sm) for sm in scan_models]
        dense_impl = "xla2" if packed_2bit else "xla"
        pks = [score_stats_binary_packed if b else score_stats_quant_packed
               for b in binaries]
    else:
        kernels = [score_stats_binary if b else score_stats_quant
                   for b in binaries]
    if mesh is not None:
        from ..parallel.mesh import replicate, shard_variant_batch
        scan_models = [replicate(mesh, sm) for sm in scan_models]
        _place = lambda Gp: shard_variant_batch(mesh, Gp)
        packed_sparse = False     # entry streams don't shard by variant
    else:
        _place = lambda Gp: Gp
    rows_idx = []
    outs = [[] for _ in range(P)]
    # flagged variants for phase-2 refinement, per model
    spa_G = [[] for _ in range(P)]
    spa_rows = [[] for _ in range(P)]
    row0 = 0

    # three-stage dispatch pipeline, one worker thread per stage: GDS
    # decode || transport pack || host->device transfer (device_put is
    # thread-safe; numpy/zlib release the GIL).  Overlapping the stages
    # moves the block rate to the SLOWEST stage instead of their sum.
    # The window then bounds in-flight device blocks.
    import jax
    import jax.numpy as jnp
    from collections import deque
    window = deque()
    DEPTH = 3
    _put = jax.device_put if mesh is None else _place
    # link-aware sparse-tier engagement: the pipeline's own
    # decode/upload timings drive the decision, so the tier engages
    # only on a measured link-bound scan.  ``transport_policy``:
    # None -> a fresh TransportPolicy; "static" -> the
    # nnz-only rule (benches/tests that exercise the tier machinery
    # regardless of link state); or a caller-provided policy object.
    if not (packed and packed_sparse) or transport_policy == "static":
        policy = None
    else:
        policy = transport_policy or TransportPolicy()

    def _decoded(raw):
        it = iter(raw)
        while True:
            t0 = _time.perf_counter()
            try:
                idx, G = next(it)            # GDS decode happens here
            except StopIteration:
                break
            dt = _time.perf_counter() - t0
            if policy is not None:
                policy.note_decode(dt)
            if instrument is not None:
                instrument["decode_s"].append(dt)
            yield idx, G

    def _packed_stage(it):
        host = lambda x: x
        for idx, G in it:
            t0 = _time.perf_counter()
            if packed:
                G = np.asarray(G, np.int8)
                pl = _packed_parts(G, B, dense_impl, packed_2bit,
                                   packed_sparse, host, policy=policy)
            else:
                G = np.asarray(G, np.float64)
                if cols is not None:
                    G = G[:, cols]
                pl = [(np.arange(len(idx)),
                       _pad_block(_shrink_f32(G), B), None)]
            if instrument is not None:
                instrument["pack_s"].append(_time.perf_counter() - t0)
            yield idx, G, pl

    def _uploaded(it):
        for idx, G, pl_host in it:
            t0 = _time.perf_counter()
            pl = [(rows, _put(payload), impl)
                  for rows, payload, impl in pl_host]
            # complete the transfer in THIS thread so the main loop
            # dispatches on fully-resident operands
            jax.block_until_ready([p for _, p, _ in pl])
            dt = _time.perf_counter() - t0
            nbytes = sum(
                sum(a.nbytes for a in jax.tree_util.tree_leaves(p))
                for _, p, _ in pl_host)
            if policy is not None:
                policy.note_upload(dt, nbytes)
            if instrument is not None:
                instrument["upload_s"].append(dt)
                instrument["bytes"].append(nbytes)
            yield idx, G, pl

    block_iter = _prefetch_blocks(
        _uploaded(_prefetch_blocks(
            _packed_stage(_prefetch_blocks(
                _decoded(block_iter),
                name="decode", instrument=instrument)),
            name="pack", instrument=instrument)),
        name="upload", instrument=instrument)

    def _drain_one():
        nonlocal row0
        t_dr = _time.perf_counter()
        idx, G, parts = window.popleft()
        n = len(idx)
        n_valid = 0
        for p in range(P):
            valid = np.empty(n, bool)
            need = np.empty(n, bool)
            f = {k: np.empty(n) for k in ("af", "mac", "num",
                                          "beta", "se", "pval")}
            for rows, stacks in parts:
                from ..ops.score import unstack_stats
                # one stacked device->host transfer per model per part
                # (the stats ride one [7, B] array, not 7 small fetches)
                res = unstack_stats(stacks[p])
                m = len(rows)
                valid[rows] = res.valid[:m]
                need[rows] = res.need_spa[:m]
                for k in f:
                    f[k][rows] = getattr(res, k)[:m]
            if p == 0:
                # validity is genotype-only (maf/mac/missing), identical
                # across models — index bookkeeping follows model 0
                rows_idx.append(idx[valid])
                n_valid = int(valid.sum())
            out = {k: v[valid] for k, v in f.items()}
            out["converged"] = np.isfinite(out["pval"])
            out["pval_noadj"] = out["pval"].copy()
            needv = need[valid]
            if needv.any():
                Gf = G[valid][needv]
                if packed and packed_2bit:
                    pass      # keep int8 codes; phase 2 ships them 2-bit
                elif packed:
                    Gf = np.where(Gf == 3, np.nan, Gf).astype(np.float64)
                spa_G[p].append(Gf)
                spa_rows[p].append(row0 + np.flatnonzero(needv))
                spa_state[p]["bytes"] += Gf.nbytes
            outs[p].append(out)
        row0 += n_valid
        # bound host memory: refine incrementally once the flagged set
        # grows past the budget (a whole-scan ~5% flagged set at biobank
        # scale would otherwise hold tens of GB until phase 2).  The
        # budget divides by P so TOTAL staged bytes stay bounded
        # independent of how many models share the pass
        for p in range(P):
            if spa_state[p]["bytes"] >= SPA_FLUSH_BYTES // P:
                _flush_spa(p)
        if instrument is not None:
            instrument["drain_s"].append(_time.perf_counter() - t_dr)

    spa_state = [{"bytes": 0} for _ in range(P)]
    spa_out = [[] for _ in range(P)]  # (rows, pval, conv, beta, se)/flush

    def _flush_spa(p):
        if not spa_G[p]:
            return
        scan_model = scan_models[p]
        Gs = np.concatenate(spa_G[p], axis=0)
        rows = np.concatenate(spa_rows[p])
        spa_G[p], spa_rows[p] = [], []
        spa_state[p]["bytes"] = 0
        # compact batches grouped by nonzero count, so rare variants run
        # the compacted CGF even when the flagged set mixes in common ones
        if spa_compact and len(rows) > 1:
            order = np.argsort(_spa_nnz(Gs), kind="stable")
            Gs, rows = Gs[order], rows[order]
        pending = deque()

        def _drain_spa():
            r, stacked = pending.popleft()
            m = len(r)
            a = np.asarray(stacked)
            spa_out[p].append((r, a[0][:m], a[1][:m] != 0,
                               a[2][:m], a[3][:m]))

        def _spa_payloads():
            # payload build + upload in the prefetch worker, like phase 1
            for s in range(0, len(rows), SPA_BATCH):
                Gi = Gs[s : s + SPA_BATCH]
                cap = _spa_cap(Gi) if spa_compact else 0
                if np.issubdtype(Gi.dtype, np.integer):
                    # ship codes 2-bit packed (N/4 bytes per variant
                    # instead of 8N) or, for a rare-variant batch,
                    # gap-coded sparse (2 B/nonzero), to cut the
                    # host->device bytes.
                    # nnz sorting makes batches homogeneous, so one
                    # whole-batch decision suffices; pad rows are empty
                    # (their lanes are discarded)
                    from ..ops.sparse_codes import sparse_beats_dense
                    if packed_sparse and \
                            (policy is None or
                             policy.starved(len(Gi) * (Gi.shape[1] // 4))) \
                            and SPA_BATCH * Gi.shape[1] < (1 << 31) and \
                            sparse_beats_dense(Gi):  # int32 decode bound
                        from ..ops.sparse_codes import (encode_sparse_rows,
                                                        pad_entries)
                        entries, row_ptr = encode_sparse_rows(Gi)
                        rp = np.full(SPA_BATCH + 1, row_ptr[-1], np.int32)
                        rp[: len(row_ptr)] = row_ptr
                        Gb = _put((pad_entries(entries), rp))
                    else:
                        Gb = _put(_pack2_block(Gi, SPA_BATCH))
                    yield rows[s : s + SPA_BATCH], Gb, cap, Gi.shape[1]
                else:
                    Gb = _put(_pad_block(_shrink_f32(Gi), SPA_BATCH))
                    yield rows[s : s + SPA_BATCH], Gb, cap, 0

        for r, Gb, cap, pn in _prefetch_blocks(_spa_payloads()):
            res = spa_refine_binary(scan_model, Gb, mixed=spa_mixed,
                                    cap=cap, packed_n=pn)
            # one stacked [4, Bs] readback at drain time: four small
            # fetches would each pay the device round-trip, same idea as
            # ops.score.stack_stats
            pending.append((r, jnp.stack([res[0],
                                          res[1].astype(jnp.float64),
                                          res[2], res[3]])))
            if len(pending) >= DEPTH:
                _drain_spa()
        while pending:
            _drain_spa()

    from ..ops.score import stack_stats
    for idx, G, pl in block_iter:
        t_di = _time.perf_counter()
        # one payload upload, P phase-1 dispatches on the resident block
        parts = [(rows,
                  [stack_stats(
                      pks[p](pms[p], params, payload, impl=impl)
                      if impl is not None
                      else kernels[p](scan_models[p], params, payload))
                   for p in range(P)])
                 for rows, payload, impl in pl]
        if instrument is not None:
            instrument["dispatch_s"].append(_time.perf_counter() - t_di)
        window.append((idx, G, parts))
        if len(window) >= DEPTH:
            _drain_one()
    while window:
        _drain_one()
    t_spa = _time.perf_counter()
    for p in range(P):
        _flush_spa(p)  # phase 2 over the remaining flagged subsets
    if instrument is not None:
        instrument["spa_s"] += _time.perf_counter() - t_spa

    idx = np.concatenate(rows_idx) if rows_idx else np.empty(0, int)
    dfs = []
    for p in range(P):
        def col(k):
            return np.concatenate([o[k] for o in outs[p]]) if outs[p] \
                else np.empty(0)

        pval = col("pval")
        pval_noadj = col("pval_noadj")
        beta = col("beta")
        se = col("se")
        converged = col("converged")
        for r, pv, conv, b, e in spa_out[p]:
            pval[r] = pv
            converged[r] = conv
            beta[r] = b
            se[r] = e

        tab = {
            "__idx__": idx,
            "AF.alt": col("af"),
            "mac": col("mac"),
            "num": col("num").astype(np.int32),
            "beta": beta,
            "SE": se,
            "pval": pval,
        }
        if binaries[p]:
            tab["p.norm"] = pval_noadj
            tab["converged"] = converged.astype(bool)
        dfs.append(tab)
    return dfs


SPLIT_SAVE_BYTES = 4 << 20   # min upload saving to justify a 2nd dispatch
SPLIT_SAVE_FRAC = 0.25       # ... and it must be >= this fraction of the
#                              block's 2-bit bytes (dispatch has a fixed
#                              latency floor)


def _packed_parts(G: np.ndarray, B: int, dense_impl: str,
                  packed_2bit: bool, packed_sparse: bool, place,
                  policy=None):
    """Split one packed int8 block into transport parts.

    Returns ``[(rows, device_payload, impl), ...]`` where ``rows`` indexes
    the unpadded block.  Rare rows (nonzero fraction < 1/8) ship as the
    gap-coded entry stream; the rest ship as before (2-bit planar or int8,
    padded to ``B`` when the block isn't split so the compiled shape stays
    unique).  Because every dispatch pays a fixed latency floor, the block
    splits into two parts only when the sparse side's byte saving is
    substantial (SPLIT_SAVE_BYTES and SPLIT_SAVE_FRAC); otherwise the
    whole block routes the cheaper way in ONE dispatch — uniformly rare
    files still get the full sparse win without extra dispatches.

    ``policy`` (a :class:`TransportPolicy`) gates the tier on the
    MEASURED link state: the sparse stream only helps when uploads bind
    the pipeline, so on a healthy link blocks stay 2-bit dense even for
    rare files.  ``policy=None`` keeps the static nnz-only rule (tests,
    single-shot calls with no rate history).
    """
    n, N = G.shape
    sp_rows = de_rows = None
    if packed_sparse and policy is not None and \
            not policy.starved(n * (N // 4)):
        sp_rows = np.empty(0, np.int64)     # healthy link: stay dense
        de_rows = np.arange(n)
    elif packed_sparse and B * N < (1 << 31):  # int32 decode cursor bound
        from ..ops.sparse_codes import SPARSE_NNZ_FRAC
        nnz = (G != 0).sum(axis=1)
        mask = nnz < (N * SPARSE_NNZ_FRAC)
        ns = int(mask.sum())
        row_bytes = N // 4
        # whole-block sparse must save >= 50% of the 2-bit bytes: the
        # device decode has its own cost, so marginal savings are not
        # worth flipping the transport
        whole_sparse = 2 * int(nnz.sum()) < (n * row_bytes) // 2
        saving = ns * row_bytes - 2 * int(nnz[mask].sum())
        MIN_SPLIT = 64
        if min(ns, n - ns) < MIN_SPLIT or \
                saving < max(SPLIT_SAVE_BYTES, SPLIT_SAVE_FRAC * n * row_bytes):
            if whole_sparse:
                sp_rows, de_rows = np.arange(n), np.empty(0, np.int64)
            else:
                sp_rows, de_rows = np.empty(0, np.int64), np.arange(n)
        else:
            sp_rows, de_rows = np.flatnonzero(mask), np.flatnonzero(~mask)
    if sp_rows is None or not len(sp_rows):
        Gd = _pack2_block(G, B) if packed_2bit \
            else _pad_block(G, B, fill=3)  # uint8 [B, ceil(N/4)] / int8
        return [(np.arange(n), place(Gd), dense_impl)]

    from ..ops.sparse_codes import (bucket_rows, encode_sparse_rows,
                                    pad_entries)
    parts = []
    # the sparse part's row axis is always B: the entry stream is the only
    # upload, so padding rows is free and removes a compile-shape axis
    # (shape variants come only from the entry-length buckets)
    entries, row_ptr = encode_sparse_rows(G[sp_rows])
    entries = pad_entries(entries)
    rp = np.full(B + 1, row_ptr[-1], np.int32)    # pad rows are empty
    rp[: len(row_ptr)] = row_ptr
    parts.append((sp_rows, place((entries, rp)), "sparse"))
    if len(de_rows):
        Bd = bucket_rows(len(de_rows), B)
        Gd = _pack2_block(G[de_rows], Bd) if packed_2bit \
            else _pad_block(G[de_rows], Bd, fill=3)
        parts.append((de_rows, place(Gd), dense_impl))
    return parts


def _spa_nnz(Gi: np.ndarray) -> np.ndarray:
    """Per-variant nonzero count after imputation + flip (for bucketing).

    Accepts f64 dosages (NaN missing) or int8 codes (3 missing); the codes
    branch computes the identical count from per-variant 0/2/missing tallies
    without materializing the f64 matrix (flip iff ac > num; an imputed
    entry is nonzero iff ac != 0, or ac != 2*num when flipped)."""
    if np.issubdtype(Gi.dtype, np.integer):
        N = Gi.shape[1]
        miss = Gi == 3
        n_miss = miss.sum(axis=1)
        num = N - n_miss
        ac = np.where(miss, 0, Gi).sum(axis=1, dtype=np.int64)
        c0 = (Gi == 0).sum(axis=1)
        c2 = (Gi == 2).sum(axis=1)
        flip = ac > num
        nz_obs = np.where(flip, N - c2, N - c0) - n_miss
        imp_nz = np.where(flip, ac != 2 * num, ac != 0)
        return nz_obs + np.where(imp_nz, n_miss, 0)
    isnan = np.isnan(Gi)
    num = (~isnan).sum(axis=1)
    ac = np.where(isnan, 0.0, Gi).sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        af = ac / (2 * num)
        g = np.where(isnan, (ac / np.maximum(num, 1))[:, None], Gi)
    g = np.where((af > 0.5)[:, None], 2.0 - g, g)
    return np.nan_to_num(g != 0).sum(axis=1)


def _spa_cap(Gi: np.ndarray) -> int:
    """Power-of-two bucket covering the batch's max nonzero count after
    imputation + flip (so compaction is exact); 0 disables compaction."""
    nnz_max = int(_spa_nnz(Gi).max(initial=0))
    cap = 1 << max(10, int(nnz_max - 1).bit_length())
    return 0 if cap >= 0.75 * Gi.shape[1] else cap


def _match_samples(gds_samples, model_samples):
    """Align GDS genotype columns with the model's samples
    (reference R/assoc_single.r:136-142).

    Returns ``(cols, ii)``: ``cols`` selects the GDS columns belonging to
    the model's samples, kept in GDS order (the ``seqSetFilter(sample.id=)``
    analog — extra GDS samples are dropped), and ``ii`` is the model
    position of each kept column (``ii <- match(sid, modobj$sample.id)``),
    used to gather the model's per-sample arrays into GDS order.  Both are
    ``None`` when the orders already coincide.
    """
    if model_samples is None:
        return None, None
    gds_samples = np.asarray(gds_samples)
    model_samples = np.asarray(model_samples)
    if len(gds_samples) == len(model_samples) and \
            (gds_samples == model_samples).all():
        return None, None
    lookup = {s: i for i, s in enumerate(model_samples)}
    cols = np.asarray([i for i, s in enumerate(gds_samples) if s in lookup],
                      dtype=np.int64)
    if len(cols) != len(model_samples):
        raise ValueError("model samples missing from the GDS file")
    ii = np.asarray([lookup[gds_samples[c]] for c in cols], dtype=np.int64)
    return cols, ii


RES_COMPRESS_CHOICES = ("LZMA", "LZMA_RA", "ZIP", "ZIP_RA", "none")


def save_assoc(df, path: str, file_format: str = "SAIGE_OUTPUT",
               res_compress: str = "LZMA"):
    """Save results (gds / rds / rda / parquet / csv / tsv by extension).

    ``df``: a pandas DataFrame or a dict of equal-length numpy columns;
    gds/rds/rda need no pandas, parquet and csv/tsv import it.

    ``.gds`` writes the reference's SAIGE_OUTPUT container and
    ``.rds``/``.rda`` its saveRDS/save outputs (R/assoc_single.r:242-333;
    the .rda object is named ``.res`` like the reference's), all readable
    by ``load_pval`` and by R.

    ``res_compress``: one of LZMA, LZMA_RA, ZIP, ZIP_RA, none — the
    reference's ``res.compress`` choices (R/assoc_single.r:93,105-106);
    applies to the gds container's column pipes and, mapped like the
    reference's switch (LZMA*->xz, ZIP*->gzip, R/assoc_single.r:313-314),
    to the rds/rda streams.  Other formats ignore it."""
    if res_compress not in RES_COMPRESS_CHOICES:
        raise ValueError("`res_compress` should be one of LZMA, LZMA_RA, "
                         "ZIP, ZIP_RA and none.")
    df = {k: np.asarray(df[k]) for k in df.keys()}
    low = path.lower()
    if low.endswith(".gds"):
        from ..io.gds_write import save_assoc_gds
        save_assoc_gds(df, path, file_format=file_format,
                       compress="" if res_compress == "none"
                       else res_compress)
    elif low.endswith(".rds"):
        from ..io.rds_write import write_rds
        write_rds(path, _df_to_robject(df), compress=_rcompress(res_compress))
    elif low.endswith(".rda") or low.endswith(".rdata"):
        from ..io.rds_write import write_rdata
        write_rdata(path, {".res": _df_to_robject(df)},
                    compress=_rcompress(res_compress))
    elif low.endswith(".parquet"):
        _frame(df).to_parquet(path)
    elif low.endswith(".csv") or low.endswith(".csv.gz"):
        _frame(df).to_csv(path, index=False)
    else:
        _frame(df).to_csv(path, sep="\t", index=False)


def _rcompress(res_compress: str):
    """res.compress -> saveRDS/save compress arg (R/assoc_single.r:313)."""
    return {"LZMA": "xz", "LZMA_RA": "xz", "ZIP": "gzip",
            "ZIP_RA": "gzip"}.get(res_compress, True)


def _df_to_robject(df: dict):
    """Result columns -> an R data.frame RObject for the rds writer."""
    from ..io.rds import RObject
    cols = {}
    for c, v in df.items():
        if v.dtype == object or v.dtype.kind in ("U", "S"):
            v = np.asarray([None if x is None else str(x) for x in v],
                           dtype=object)
        cols[c] = v
    return RObject(cols, {
        "names": np.asarray(list(df), dtype=object),
        "class": np.asarray(["data.frame"], dtype=object),
        "row.names": np.arange(1, _nrows(df) + 1, dtype=np.int32),
    })
