#!/usr/bin/env python3
"""Smoke check of the main path on one GPU: GDS -> null-model fit -> scan.

Run from the root of a checkout:

    python3 chip_smoke.py              # one GPU, every phase below
    python3 chip_smoke.py --multi      # four GPUs: sharded fit + scan only

A biobank null-model fit (N=100,000 samples x M=16,384 GRM markers) and the
variant scans that follow it run through the command-line entry point
(``saigegds_tpu.__main__.main``, called in this process) on data generated
from ``--seed`` into ``.smoke_data/`` (reused when present).  Each phase
compares its output with a plain reference and prints one JSON line: wall
time, achieved bytes/s where it reads a store, its largest error beside the
limit, and the device's ``peak_bytes_in_use`` since the process started
(the fit runs first, so its figure is the fit's own; the dense float64
reference of the kernels phase, the largest allocation, runs last).  The
CPU comparisons run in a child process that never opens the GPU.  The last
line is ``{"ok": true, "device": {...}}``; a run with no GPU, or a phase
that fails, exits non-zero without it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FORMULA = "y ~ x1 + x2 + x3"


@dataclasses.dataclass(frozen=True)
class Sizes:
    n: int = 100_000          # samples
    m_fit: int = 16_384       # GRM markers of the fit
    m_dense: int = 4_096      # GRM markers of the f64-operator fit
    n_small: int = 4_000      # the GPU-vs-CPU fit
    m_small: int = 2_048
    n_rhs: int = 31           # 30 Hutchinson probes + 1
    score_block: int = 1_024
    n_scan: int = 8_192
    n_scan_ref: int = 1_024   # variants re-scanned by the dense f64 kernel
    n_rare: int = 4_096
    window: int = 64          # acat-o: n_rare / window windows


FULL = Sizes()

# largest relative error each comparison may show
LIMITS = dict(matvec=1e-12, score=1e-10, fit_packed2=1e-12, fit_dense=1e-8,
              fit_cpu=1e-9, scan_beta_se=1e-10, scan_p=1e-8, rare_p=1e-12,
              aggregate_p=1e-8, multi_fit=1e-10, multi_scan_p=1e-12)


def rel_err(a, b, normwise=False) -> float:
    """Largest relative difference of ``a`` from the reference ``b``:
    elementwise, or against max|b| (``normwise``)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise AssertionError(f"shape {a.shape} != reference {b.shape}")
    if b.size == 0:
        return 0.0
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return float("inf")
    den = np.max(np.abs(b)) if normwise else np.abs(b)
    return float(np.max(np.abs(a - b) / np.maximum(den, 1e-300)))


def check(errors: dict, name: str, err: float) -> None:
    """Record ``err`` beside its limit; fail the phase past the limit."""
    errors[name] = [err, LIMITS[name]]
    if not err <= LIMITS[name]:
        raise AssertionError(f"{name}: error {err:.3e} > limit "
                             f"{LIMITS[name]:.0e}")


def peak_bytes(devices) -> list:
    return [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in devices]


def report(phase: str, t0: float, errors: dict, **kw) -> dict:
    import jax
    rec = dict(phase=phase, wall_s=time.perf_counter() - t0, **kw,
               max_err=errors,
               peak_bytes_in_use=peak_bytes(jax.devices()[:1])[0])
    print(json.dumps(rec), flush=True)
    return rec


# ---------------------------------------------------------------------------
# data, made from the seed


def genotype_codes(rng, m: int, n: int, af_lo: float, af_hi: float,
                   miss: float) -> np.ndarray:
    """[m, n] int8 codes: ALT dosage ~ Binomial(2, af) with af ~ U(af_lo,
    af_hi) per variant, a ``miss`` share of calls missing (code 3)."""
    af = rng.uniform(af_lo, af_hi, size=(m, 1))
    thr = np.maximum(np.round(af * 65536), 1).astype(np.uint16)
    miss_thr = int(round(miss * 65536))
    codes = np.empty((m, n), np.int8)
    for s in range(0, m, 512):
        e = min(s + 512, m)

        def draw():
            return np.frombuffer(rng.bytes(2 * (e - s) * n),
                                 np.uint16).reshape(e - s, n)
        c = (draw() < thr[s:e]).astype(np.int8)
        c += draw() < thr[s:e]
        if miss_thr:
            c[draw() < miss_thr] = 3
        codes[s:e] = c
    return codes


def write_pheno(path: str, codes: np.ndarray, rng, cases: float = 0.15):
    """Binary trait with a polygenic signal (true tau_G ~ 0.6) and three
    covariates, ``cases`` of the samples cases; TSV with a header."""
    m, n = codes.shape
    X = rng.normal(size=(n, 3))
    af = np.clip(np.where(codes < 3, codes, 0).mean(axis=1) / 2, 0.01, 0.99)
    b = rng.normal(size=m) * np.sqrt(0.6 / m) / np.sqrt(2 * af * (1 - af))
    g = np.zeros(n)
    for s in range(0, m, 1024):
        c = np.where(codes[s:s + 1024] < 3, codes[s:s + 1024], 0)
        g += (c.astype(np.float32).T @ b[s:s + 1024].astype(np.float32))
    eta = X @ (rng.normal(size=3) * 0.3) + g - g.mean()
    lo, hi = -20.0, 20.0                  # intercept giving `cases`
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if np.mean(1 / (1 + np.exp(-eta - mid))) < cases \
            else (lo, mid)
    y = (rng.random(n) < 1 / (1 + np.exp(-eta - lo))).astype(int)
    with open(path, "w") as fh:
        fh.write("sample.id\ty\tx1\tx2\tx3\n")
        for i, (yi, x) in enumerate(zip(y.tolist(), X.tolist())):
            fh.write(f"{i + 1}\t{yi}\t{x[0]!r}\t{x[1]!r}\t{x[2]!r}\n")


def make_data(data: str, sizes: Sizes, seed: int, multi: bool) -> dict:
    """Write the phase inputs under ``data`` (skipped when present); the
    four-device run needs only the fit and scan sets."""
    from saigegds_tpu.io.gds_write import write_seqarray_gds
    os.makedirs(os.path.join(data, "logs"), exist_ok=True)
    p = {k: os.path.join(data, f) for k, f in dict(
        fit="fit.gds", dense="fit_dense.gds", pheno="pheno.tsv",
        small="small.gds", pheno_small="pheno_small.tsv", scan="scan.gds",
        rare="rare.gds").items()}
    stamp = os.path.join(data, "stamp.json")
    want = dict(sizes=dataclasses.asdict(sizes), seed=seed, multi=multi)
    if os.path.exists(stamp) and json.load(open(stamp)) == want:
        return p
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    codes = genotype_codes(rng, sizes.m_fit, sizes.n, 0.05, 0.5, 0.005)
    write_seqarray_gds(p["fit"], codes, compress="ZIP_ra")
    # the signal sits on the markers both fit GRMs share, so the
    # M_dense fit also estimates a nonzero tau_G
    write_pheno(p["pheno"], codes[:sizes.m_dense], rng)
    write_seqarray_gds(p["scan"], genotype_codes(
        rng, sizes.n_scan, sizes.n, 0.05, 0.5, 0.005), compress="ZIP_ra")
    if not multi:
        write_seqarray_gds(p["dense"], codes[:sizes.m_dense],
                           compress="ZIP_ra")
        small = genotype_codes(rng, sizes.m_small, sizes.n_small, 0.05,
                               0.5, 0.005)
        write_seqarray_gds(p["small"], small, compress="ZIP_ra")
        write_pheno(p["pheno_small"], small, rng)
        write_seqarray_gds(p["rare"], genotype_codes(
            rng, sizes.n_rare, sizes.n, 0.0005, 0.01, 0.001),
            compress="ZIP_ra")
    del codes
    json.dump(want, open(stamp, "w"))
    print(json.dumps(dict(phase="data", wall_s=time.perf_counter() - t0,
                          dir=data)), flush=True)
    return p


# ---------------------------------------------------------------------------
# helpers


def cli(args, log: str) -> None:
    """Run the command-line entry in this process, its output to ``log``."""
    from saigegds_tpu.__main__ import main
    with open(log, "a") as fh, contextlib.redirect_stdout(fh):
        print("$ python -m saigegds_tpu " + " ".join(args))
        rc = main(args)
    if rc:
        raise RuntimeError(f"saigegds_tpu {args[0]} exited {rc}; see {log}")


def cpu_child(tasks, log: str) -> None:
    """Run CLI invocations in a child process held to the CPU (set in its
    environment before jax is imported), so it never opens the GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--cpu-child", json.dumps(dict(tasks=tasks,
                                                       log=log))],
                       env=env, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"CPU child failed ({r.returncode}):\n"
                           f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    last = json.loads(r.stdout.strip().splitlines()[-1])
    if last.get("platform") != "cpu":
        raise RuntimeError(f"CPU child ran on {last.get('platform')!r}")


def pcg_iterations(log: str, out: str) -> int:
    """Total PCG iterations of the fit that wrote ``out``, from the fit's
    telemetry lines in ``log``."""
    total, inside = 0, False
    for line in open(log):
        if line.startswith("$ "):
            inside = out in line
        elif inside and line.strip().startswith('{"event": "pcg"'):
            total += int(np.sum(json.loads(line)["iters"]))
    return total


def read_table(path: str) -> dict:
    """A result GDS table -> {column: numpy array}."""
    from saigegds_tpu.io.gds import open_gds
    root = open_gds(path).root
    return {nm: np.asarray(root[nm].read()) for nm in root.ls()
            if not root[nm].is_folder}


def model_fields(path: str) -> dict:
    from saigegds_tpu.models.nullmodel import NullModel
    m = NullModel.load(path)
    return dict(tau=np.asarray(m.tau, float),
                coefficients=np.asarray(m.coefficients, float),
                var_ratio=np.asarray(m.var_ratio["ratio"], float))


def compare_models(errors, name, got: str, want: str, keys=None) -> None:
    a, b = model_fields(got), model_fields(want)
    check(errors, name, max(rel_err(a[k], b[k]) for k in keys or a))


def timed(fn, *args, reps: int = 3) -> float:
    """Seconds per call of a jitted ``fn`` after one warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------------------
# phases


def phase_kernels(p: dict, sizes: Sizes, seed: int) -> dict:
    """GRM matvec (bf16 and 2-bit stores) on the fit's genotypes and score
    phase 1 (2-bit block) against dense float64 built on the device."""
    import jax
    import jax.numpy as jnp
    from saigegds_tpu.ops.packed_grm import (build_packed2_grm,
                                             build_packed_grm,
                                             pack_codes_2bit)
    from saigegds_tpu.ops.score import (ScanModel, ScanParams,
                                        score_stats_binary)
    from saigegds_tpu.ops.score_packed import (pack_scan_model,
                                               score_stats_binary_packed)
    from saigegds_tpu.io.seqarray import SeqData
    from saigegds_tpu.models.fitnull import _genotype_codes
    t0 = time.perf_counter()
    errors, rates = {}, {}
    rng = np.random.default_rng(seed + 1)
    codes = _genotype_codes(SeqData(p["fit"]))
    M, N = codes.shape
    V = jnp.asarray(rng.normal(size=(N, sizes.n_rhs)))
    hi = jax.lax.Precision.HIGHEST

    @jax.jit
    def standardize(c):
        valid = c < 3
        g = jnp.where(valid, c, 0).astype(jnp.float64)
        af = g.sum(axis=1) / (2.0 * valid.sum(axis=1))
        inv = 1.0 / jnp.sqrt(2.0 * af * (1.0 - af))
        return jnp.where(valid, (g - 2.0 * af[:, None]) * inv[:, None], 0.0)

    @jax.jit
    def dense_matvec(std, v):
        return jnp.matmul(std.T, jnp.matmul(std, v, precision=hi),
                          precision=hi) / std.shape[0]

    std = standardize(jnp.asarray(codes))
    ref = np.asarray(dense_matvec(std, V))
    rates["dense_f64_s"] = timed(dense_matvec, std, V)
    del std
    for name, grm, nbytes in (
            ("packed", build_packed_grm(codes), 2 * M * N),
            ("packed2", build_packed2_grm(codes), M * (-(-N // 4)))):
        got = np.asarray(grm.matvec(V))
        check(errors, f"matvec", max(errors.get("matvec", [0])[0],
                                     rel_err(got, ref, normwise=True)))
        s = timed(grm.matvec, V)
        rates[f"{name}_s"] = s
        rates[f"{name}_store_bytes_per_s"] = nbytes / s
        del grm
    del codes

    # score phase 1: a [B, N] 2-bit block against the dense f64 kernel
    B = sizes.score_block
    X = np.column_stack([np.ones(N), rng.normal(size=(N, 3))])
    mu = 1 / (1 + np.exp(-(X @ (rng.normal(size=4) * 0.3) - 1.7)))
    y = (rng.random(N) < mu).astype(np.float64)
    W = mu * (1 - mu)
    sm = ScanModel(trait_binary=True, tau=jnp.asarray([1.0, 0.5]),
                   y=jnp.asarray(y), mu=jnp.asarray(mu),
                   y_mu=jnp.asarray(y - mu), mu2=jnp.asarray(W),
                   XV=jnp.asarray((X * W[:, None]).T),
                   XXVX_inv=jnp.asarray(
                       X @ np.linalg.inv(X.T @ (X * W[:, None]))),
                   var_ratio=0.95)
    params = ScanParams(maf=-1.0, mac=10.0, missing=0.1, spa_pval=0.05)
    blk = genotype_codes(rng, B, N, 0.01, 0.5, 0.005)
    packed = jnp.asarray(pack_codes_2bit(blk))
    G = jnp.asarray(np.where(blk == 3, np.nan, blk).astype(np.float64))
    pm = pack_scan_model(sm)

    def xla2(p):
        return score_stats_binary_packed(pm, params, p, impl="xla2")

    def dense(g):
        return score_stats_binary(sm, params, g)

    got, want = xla2(packed), dense(G)
    ok = np.array(want.valid)
    if not np.array_equal(np.asarray(got.valid), ok):
        raise AssertionError("score: packed and dense validity differ")
    ok &= np.abs(np.asarray(want.beta)) < 1e6       # non-degenerate lanes
    check(errors, "score", max(
        rel_err(np.asarray(getattr(got, f))[ok],
                np.asarray(getattr(want, f))[ok]) for f in ("beta", "se")))
    s = timed(xla2, packed)
    rates.update(score_xla2_s=s, score_xla2_block_bytes_per_s=packed.nbytes
                 / s, score_dense_f64_s=timed(dense, G))
    return report("kernels", t0, errors, bytes_per_s=rates)


def phase_fit(p: dict, sizes: Sizes, data: str) -> dict:
    """CLI fits at N x M_fit (auto tier), the same with the 2-bit store,
    packed vs the f64 operator at N x M_dense, and a small fit against a
    CPU run of the same command."""
    from saigegds_tpu.config import NullModelConfig
    from saigegds_tpu.models.fitnull import _auto_grm_impl
    from saigegds_tpu.models.nullmodel import fit_null_glmm
    from saigegds_tpu.__main__ import _read_pheno
    t0 = time.perf_counter()
    errors = {}
    log = os.path.join(data, "logs", "fit.log")
    out = {k: os.path.join(data, f"model_{k}.npz")
           for k in ("auto", "packed2", "m_dense", "dense", "small",
                     "small_cpu")}
    fit = ["fit", "--formula", FORMULA]
    cli(fit + ["--pheno", p["pheno"], "--gds", p["fit"], "--out",
               out["auto"]], log)
    t_auto = time.perf_counter() - t0
    fit_null_glmm(FORMULA, _read_pheno(p["pheno"]), p["fit"],
                  NullModelConfig(grm_impl="packed2"),
                  model_savefn=out["packed2"])
    compare_models(errors, "fit_packed2", out["packed2"], out["auto"])
    cli(fit + ["--pheno", p["pheno"], "--gds", p["dense"], "--out",
               out["m_dense"]], log)
    cli(fit + ["--pheno", p["pheno"], "--gds", p["dense"], "--out",
               out["dense"], "--dense"], log)
    compare_models(errors, "fit_dense", out["dense"], out["m_dense"])
    small = ["--pheno", p["pheno_small"], "--gds", p["small"], "--out"]
    cli(fit + small + [out["small"]], log)
    cpu_log = os.path.join(data, "logs", "fit_cpu.log")
    cpu_child([fit + small + [out["small_cpu"]]], cpu_log)
    compare_models(errors, "fit_cpu", out["small"], out["small_cpu"])
    return report(
        "fit", t0, errors, auto_fit_s=t_auto,
        auto_grm_impl=_auto_grm_impl(sizes.m_fit, sizes.n),
        gds_bytes_per_s=os.path.getsize(p["fit"]) / t_auto,
        pcg_iterations=dict(
            small_gpu=pcg_iterations(log, out["small"]),
            small_cpu=pcg_iterations(cpu_log, out["small_cpu"])),
        model=out["auto"])


def phase_scan(p: dict, sizes: Sizes, data: str, model: str) -> dict:
    """CLI scan into a .gds table; its first variants re-scanned by the
    dense float64 kernel."""
    from saigegds_tpu.assoc.single import scan_table
    from saigegds_tpu.config import ScanConfig
    t0 = time.perf_counter()
    errors = {}
    res = os.path.join(data, "assoc_scan.gds")
    cli(["scan", "--gds", p["scan"], "--model", model, "--out", res],
        os.path.join(data, "logs", "scan.log"))
    wall = time.perf_counter() - t0
    got = read_table(res)
    mask = np.zeros(sizes.n_scan, bool)
    mask[:sizes.n_scan_ref] = True
    want = scan_table(p["scan"], model, ScanConfig(use_packed=False),
                      variant_mask=mask)
    sel = np.isin(got["id"], want["id"])
    got = {k: v[sel] for k, v in got.items()}
    if not np.array_equal(got["id"], want["id"]):
        raise AssertionError("scan: packed and dense tested other variants")
    if not np.array_equal(got["p.norm"] <= 0.05, want["p.norm"] <= 0.05):
        raise AssertionError("scan: other variants sent to SPA")
    check(errors, "scan_beta_se", max(rel_err(got[k], want[k])
                                      for k in ("beta", "SE")))
    check(errors, "scan_p", max(rel_err(got[k], want[k])
                                for k in ("pval", "p.norm")))
    return report("scan", t0, errors, scan_s=wall,
                  gds_bytes_per_s=os.path.getsize(p["scan"]) / wall,
                  variants_tested=int(sel.size),
                  sent_to_spa=int(np.sum(want["p.norm"] <= 0.05)))


def phase_rare(p: dict, data: str, model: str) -> dict:
    """Rare-variant scan through the gap-coded transport (decoded on the
    device) against the same scan shipping 2-bit blocks."""
    from saigegds_tpu.assoc.single import scan_table
    from saigegds_tpu.config import ScanConfig
    t0 = time.perf_counter()
    errors = {}
    sparse_io, dense_io = {}, {}
    got = scan_table(p["rare"], model, ScanConfig(transport_policy="static"),
                     instrument=sparse_io)
    wall = time.perf_counter() - t0
    want = scan_table(p["rare"], model, ScanConfig(packed_sparse=False),
                      instrument=dense_io)
    if not np.array_equal(got["id"], want["id"]):
        raise AssertionError("rare: the two transports tested other variants")
    sb, db = sum(sparse_io["bytes"]), sum(dense_io["bytes"])
    if not sb < db:
        raise AssertionError("rare: the gap-coded transport did not engage")
    check(errors, "rare_p", max(rel_err(got[k], want[k])
                                for k in ("pval", "p.norm")))
    return report("rare", t0, errors, scan_s=wall,
                  gds_bytes_per_s=os.path.getsize(p["rare"]) / wall,
                  shipped_bytes=dict(sparse=sb, two_bit=db),
                  variants_tested=int(len(got["id"])))


def phase_aggregate(p: dict, sizes: Sizes, data: str, model: str) -> dict:
    """CLI acat-o over windows of rare variants; the first quarter of the
    windows again in the CPU child."""
    t0 = time.perf_counter()
    errors = {}
    res = os.path.join(data, "acato.gds")
    res_cpu = os.path.join(data, "acato_cpu.gds")
    args = ["acat-o", "--gds", p["rare"], "--model", model,
            "--win-size", str(sizes.window), "--win-shift", str(sizes.window)]
    cli(args + ["--out", res], os.path.join(data, "logs", "aggregate.log"))
    wall = time.perf_counter() - t0
    cpu_child([args + ["--unit-shard", "0/4", "--out", res_cpu]],
              os.path.join(data, "logs", "aggregate_cpu.log"))
    got, want = read_table(res), read_table(res_cpu)
    k = len(want["pval"])
    if not np.array_equal(got["start"][:k], want["start"]):
        raise AssertionError("aggregate: the CPU run tested other windows")
    pcols = [c for c in want if c.startswith("pval")]
    check(errors, "aggregate_p", max(rel_err(got[c][:k], want[c])
                                     for c in pcols))
    return report("aggregate", t0, errors, acato_s=wall,
                  windows=int(len(got["pval"])), windows_cpu=k)


def phase_multi(p: dict, data: str, n_dev: int = 4) -> dict:
    """Sample-sharded fit and variant-sharded scan over ``n_dev`` devices
    against the same work on one device, in this process."""
    import jax
    from saigegds_tpu.__main__ import _read_pheno
    from saigegds_tpu.assoc.single import scan_table
    from saigegds_tpu.config import NullModelConfig, ScanConfig
    from saigegds_tpu.models.nullmodel import fit_null_glmm
    from saigegds_tpu.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    errors = {}
    mesh = make_mesh(n_dev)
    devs = list(mesh.devices.flat)
    pheno = _read_pheno(p["pheno"])
    cfg = NullModelConfig(grm_impl="packed", stream_geno=True)
    m_mesh = os.path.join(data, "model_mesh.npz")
    m_one = os.path.join(data, "model_one.npz")
    fit_null_glmm(FORMULA, pheno, p["fit"], cfg, model_savefn=m_mesh,
                  mesh=mesh)
    t_mesh = time.perf_counter() - t0
    peaks_mesh_fit = peak_bytes(devs)
    fit_null_glmm(FORMULA, pheno, p["fit"], cfg, model_savefn=m_one)
    compare_models(errors, "multi_fit", m_mesh, m_one,
                   keys=("tau", "coefficients"))
    t1 = time.perf_counter()
    got = scan_table(p["scan"], m_one, ScanConfig(), mesh=mesh)
    t_scan = time.perf_counter() - t1
    want = scan_table(p["scan"], m_one, ScanConfig())
    if not np.array_equal(got["id"], want["id"]):
        raise AssertionError("multi: sharded scan tested other variants")
    check(errors, "multi_scan_p", max(rel_err(got[k], want[k])
                                      for k in ("pval", "p.norm")))
    return report("multi", t0, errors, devices=n_dev, mesh_fit_s=t_mesh,
                  mesh_scan_s=t_scan,
                  peak_bytes_per_device_after_mesh_fit=peaks_mesh_fit,
                  peak_bytes_per_device=peak_bytes(devs),
                  jax_devices=len(jax.devices()))


# ---------------------------------------------------------------------------


def card_lines() -> list:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines() or [r.stderr.strip()]
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi: {e}"]


def run_cpu_child(spec: str) -> int:
    import jax
    from saigegds_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    spec = json.loads(spec)
    for args in spec["tasks"]:
        cli(args, spec["log"])
    print(json.dumps(dict(platform=jax.devices()[0].platform)))
    return 0


def run(sizes: Sizes, seed: int, data: str, multi: bool) -> list:
    """Every phase (or, with ``multi``, the four-device one) in order."""
    p = make_data(data, sizes, seed, multi)
    if multi:
        return [phase_multi(p, data)]
    # the kernels phase last: its dense f64 reference would otherwise
    # set every later phase's peak_bytes_in_use
    fit = phase_fit(p, sizes, data)
    return [fit, phase_scan(p, sizes, data, fit["model"]),
            phase_rare(p, data, fit["model"]),
            phase_aggregate(p, sizes, data, fit["model"]),
            phase_kernels(p, sizes, seed)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: sharded fit and scan vs one GPU")
    ap.add_argument("--cpu-child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.cpu_child:
        return run_cpu_child(args.cpu_child)

    import jax
    from saigegds_tpu.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    devs = jax.devices()
    need = 4 if args.multi else 1
    if devs[0].platform != "gpu" or len(devs) < need:
        print(f"chip_smoke: needs {need} GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 1
    from saigegds_tpu.io import native
    for line in card_lines():
        print(line)
    print(json.dumps(dict(phase="device", card=card_lines(),
                          jax=jax.__version__,
                          native_decode=native._load() is not None,
                          compile_cache=cache, platform=devs[0].platform,
                          kind=devs[0].device_kind, count=len(devs))),
          flush=True)
    run(FULL, args.seed, os.path.join(ROOT, ".smoke_data"), args.multi)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
