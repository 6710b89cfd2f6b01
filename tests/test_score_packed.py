"""Packed integer score kernel: parity with the dense f64 kernel."""

import jax.numpy as jnp
import numpy as np
import pytest

from saigegds_tpu.io.seqarray import SeqData
from saigegds_tpu.models.nullmodel import NullModel
from saigegds_tpu.ops.score import ScanParams, score_stats_binary
from saigegds_tpu.ops.score_packed import (pack_scan_model,
                                           score_stats_binary_packed)


@pytest.fixture(scope="module")
def setup():
    model = NullModel.load("/root/reference/inst/unitTests/saige_model.rds")
    seq = SeqData("/root/reference/inst/extdata/grm1k_10k_snp.gds")
    sm = model.scan_model()
    return seq, sm, pack_scan_model(sm)


@pytest.mark.parametrize("start,stop", [(0, 512), (512, 1024), (9488, 10000)])
def test_packed_matches_dense(setup, start, stop):
    seq, sm, pm = setup
    params = ScanParams(maf=-1.0, mac=4.0, missing=0.1, spa_pval=0.05)
    G = seq.dosage_block(start, stop)                 # f64 with NaN
    codes = np.where(np.isnan(G), 3, G).astype(np.int8)

    want = score_stats_binary(sm, params, jnp.asarray(G))
    got = score_stats_binary_packed(pm, params, jnp.asarray(codes))

    np.testing.assert_array_equal(np.asarray(got.valid),
                                  np.asarray(want.valid))
    np.testing.assert_array_equal(np.asarray(got.need_spa),
                                  np.asarray(want.need_spa))
    for f in ("af", "mac", "num"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=1e-14)
    v = np.asarray(want.valid)
    for f in ("beta", "se", "pval"):
        a = np.asarray(getattr(got, f))[v]
        b = np.asarray(getattr(want, f))[v]
        np.testing.assert_allclose(a, b, rtol=1e-10, err_msg=f)


def test_packed_all_missing_variant(setup):
    _, sm, pm = setup
    params = ScanParams(maf=-1.0, mac=4.0, missing=0.1, spa_pval=0.05)
    codes = np.full((4, sm.y.shape[0]), 3, dtype=np.int8)
    codes[1] = 1      # all-het (af = 0.5)
    codes[2] = 0      # monomorphic REF
    codes[3, :10] = 2
    got = score_stats_binary_packed(pm, params, jnp.asarray(codes))
    G = codes.astype(np.float64)
    G[codes == 3] = np.nan
    want = score_stats_binary(sm, params, jnp.asarray(G))
    np.testing.assert_array_equal(np.asarray(got.valid),
                                  np.asarray(want.valid))
    assert not bool(np.asarray(got.valid)[0])   # all-missing -> invalid
    assert not bool(np.asarray(got.valid)[2])   # monomorphic -> maf 0


def test_quant_packed_matches_dense():
    from saigegds_tpu.ops.score import score_stats_quant
    from saigegds_tpu.ops.score_packed import score_stats_quant_packed

    model = NullModel.load(
        "/root/reference/inst/unitTests/saige_model_quant.rds")
    seq = SeqData("/root/reference/inst/extdata/grm1k_10k_snp.gds")
    sm = model.scan_model()
    pm = pack_scan_model(sm)
    params = ScanParams(maf=-1.0, mac=4.0, missing=0.1, spa_pval=0.05)
    G = seq.dosage_block(100, 600)
    codes = np.where(np.isnan(G), 3, G).astype(np.int8)
    want = score_stats_quant(sm, params, jnp.asarray(G))
    got = score_stats_quant_packed(pm, params, jnp.asarray(codes))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(np.asarray(got.valid), v)
    for f in ("beta", "se", "pval"):
        np.testing.assert_allclose(np.asarray(getattr(got, f))[v],
                                   np.asarray(getattr(want, f))[v],
                                   rtol=1e-10, err_msg=f)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_packed_fuzz_parity(setup, seed):
    """Random AF/missingness regimes: packed == dense on synthetic blocks.

    Sweeps monomorphic, ultra-rare, common, high-missingness, and
    all-heterozygous corners that the fixture data does not cover."""
    _, sm, pm = setup
    n = sm.mu.shape[0]
    rng = np.random.default_rng(seed)
    B = 64
    af = np.concatenate([
        np.zeros(8),                       # monomorphic ref
        np.ones(8),                        # monomorphic alt
        rng.uniform(0.0005, 0.01, 16),     # ultra-rare
        rng.uniform(0.3, 0.7, 16),         # common / flip boundary
        rng.uniform(0.05, 0.3, 16),
    ])
    G = rng.binomial(2, af[:, None], size=(B, n)).astype(np.float64)
    miss = rng.random((B, n)) < rng.uniform(0, 0.15, (B, 1))
    G[miss] = np.nan
    G[-1] = 1.0                            # all-het row
    codes = np.where(np.isnan(G), 3, G).astype(np.int8)

    params = ScanParams(maf=-1.0, mac=1.0, missing=0.2, spa_pval=0.05)
    want = score_stats_binary(sm, params, jnp.asarray(G))
    got = score_stats_binary_packed(pm, params, jnp.asarray(codes))

    np.testing.assert_array_equal(np.asarray(got.valid),
                                  np.asarray(want.valid))
    v = np.asarray(want.valid)
    for f in ("af", "mac", "num"):
        np.testing.assert_allclose(np.asarray(getattr(got, f))[v],
                                   np.asarray(getattr(want, f))[v],
                                   rtol=1e-12, err_msg=f)
    # effect sizes compare only on non-degenerate lanes: a near-constant
    # dosage (e.g. the all-het row) leaves g_tilde ~ projection residual,
    # var ~ 0, and beta = noise/noise in BOTH kernels
    w = v & (np.abs(np.asarray(want.beta)) < 1e6)
    assert w.sum() >= v.sum() - 2
    for f in ("beta", "se", "pval"):
        np.testing.assert_allclose(np.asarray(getattr(got, f))[w],
                                   np.asarray(getattr(want, f))[w],
                                   rtol=1e-9, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("impl", ["xla2"])
def test_2bit_impl_matches_int8(setup, impl):
    """Planar 2-bit packed blocks reproduce the int8 path exactly
    (same exact-integer contraction; N not divisible by 4 pads)."""
    from saigegds_tpu.ops.packed_grm import pack_codes_2bit

    seq, sm, pm = setup
    params = ScanParams(maf=-1.0, mac=4.0, missing=0.1, spa_pval=0.05)
    G = seq.dosage_block(0, 300)
    codes = np.where(np.isnan(G), 3, G).astype(np.int8)
    packed = pack_codes_2bit(codes)
    assert packed.shape == (300, 250)
    want = score_stats_binary_packed(pm, params, jnp.asarray(codes))
    got = score_stats_binary_packed(pm, params, jnp.asarray(packed),
                                    impl=impl)
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(np.asarray(got.valid), v)
    np.testing.assert_array_equal(np.asarray(got.need_spa),
                                  np.asarray(want.need_spa))
    for f in ("af", "mac", "num", "beta", "se", "pval"):
        np.testing.assert_allclose(np.asarray(getattr(got, f))[v],
                                   np.asarray(getattr(want, f))[v],
                                   rtol=1e-12, err_msg=f)


def test_2bit_quant_matches(setup):
    from saigegds_tpu.ops.packed_grm import pack_codes_2bit
    from saigegds_tpu.ops.score import score_stats_quant
    from saigegds_tpu.ops.score_packed import score_stats_quant_packed

    model = NullModel.load(
        "/root/reference/inst/unitTests/saige_model_quant.rds")
    seq = SeqData("/root/reference/inst/extdata/grm1k_10k_snp.gds")
    sm = model.scan_model()
    pmq = pack_scan_model(sm)
    params = ScanParams(maf=-1.0, mac=4.0, missing=0.1, spa_pval=0.05)
    G = seq.dosage_block(100, 400)
    codes = np.where(np.isnan(G), 3, G).astype(np.int8)
    want = score_stats_quant(sm, params, jnp.asarray(G))
    got = score_stats_quant_packed(pmq, params,
                                   jnp.asarray(pack_codes_2bit(codes)),
                                   impl="xla2")
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(np.asarray(got.valid), v)
    for f in ("beta", "se", "pval"):
        np.testing.assert_allclose(np.asarray(getattr(got, f))[v],
                                   np.asarray(getattr(want, f))[v],
                                   rtol=1e-10, err_msg=f)
