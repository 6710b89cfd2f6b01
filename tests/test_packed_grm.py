"""Packed int8 GRM operator: exact-int8-slice matvec vs the f64 reference."""

import jax.numpy as jnp
import numpy as np
import pytest

from saigegds_tpu.ops.grm import build_grm
from saigegds_tpu.ops.packed_grm import (build_packed_grm, _slice_i8,
                                         packed_grm_matvec)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 3, size=(400, 1537)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.03] = 3
    codes[5] = 0                     # monomorphic variant (af=0, inv=0)
    codes[6] = np.where(codes[6] == 3, 3, 2)   # af ~ 1 variant
    return codes, build_grm(codes), build_packed_grm(codes)


def test_slice_reconstruction():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(257, 3)) * np.array([1.0, 1e6, 1e-6])
    d, scale = _slice_i8(jnp.asarray(x), 8)
    d = np.asarray(d, dtype=np.float64)
    w = np.asarray(scale)[None, :, None] / 64.0 \
        * (1.0 / 128.0) ** np.arange(8)[None, None, :]
    rec = (d * w).sum(-1)
    err = np.abs(rec - x) / np.abs(x).max(axis=0)
    assert err.max() < 1e-15
    assert np.abs(d).max() <= 64


@pytest.mark.parametrize("precision", ["f64", "exact_i8"])
def test_matvec_matches_reference(problem, precision):
    codes, g0, pg = problem
    rng = np.random.default_rng(1)
    b = rng.normal(size=(codes.shape[1], 4)) * np.array([1, 1e4, 1e-4, 1])
    want = np.asarray(g0.matvec(jnp.asarray(b)))
    got = np.asarray(pg.matvec(jnp.asarray(b), precision=precision))
    scale = np.abs(want).max(axis=0)
    np.testing.assert_array_less(np.abs(got - want) / scale, 1e-12)


def test_matvec_1d(problem):
    codes, g0, pg = problem
    b = np.random.default_rng(2).normal(size=codes.shape[1])
    want = np.asarray(g0.matvec(jnp.asarray(b)))
    got = np.asarray(pg.matvec(jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


def test_diag_matches(problem):
    _, g0, pg = problem
    np.testing.assert_allclose(np.asarray(pg.diag), np.asarray(g0.diag),
                               rtol=1e-12)


def test_no_missing_genotypes():
    """nnz == 0 exercises the all-padding sparse-correction path."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 3, size=(64, 256)).astype(np.int8)
    g0, pg = build_grm(codes), build_packed_grm(codes)
    b = rng.normal(size=256)
    np.testing.assert_allclose(np.asarray(pg.matvec(jnp.asarray(b))),
                               np.asarray(g0.matvec(jnp.asarray(b))),
                               atol=1e-13)


def test_streamed_build_matches(problem):
    from saigegds_tpu.ops.packed_grm import build_packed_grm_streamed

    codes, g0, pg = problem
    def blocks():
        for s in range(0, codes.shape[0], 97):
            yield np.arange(s, min(s + 97, codes.shape[0])), codes[s:s + 97]
    sg = build_packed_grm_streamed(blocks(), codes.shape[1])
    b = np.random.default_rng(4).normal(size=codes.shape[1])
    np.testing.assert_allclose(np.asarray(sg.matvec(jnp.asarray(b))),
                               np.asarray(pg.matvec(jnp.asarray(b))),
                               atol=1e-13)
    np.testing.assert_allclose(np.asarray(sg.diag), np.asarray(pg.diag),
                               rtol=1e-12)


# ---- 2-bit planar device residency ----


def test_pack_unpack_roundtrip():
    from saigegds_tpu.ops.packed_grm import pack_codes_2bit, unpack_codes_2bit
    rng = np.random.default_rng(5)
    for N in (1, 3, 4, 257, 1537):
        codes = rng.integers(0, 4, size=(7, N)).astype(np.int8)
        packed = pack_codes_2bit(codes)
        assert packed.shape == (7, -(-N // 4))
        np.testing.assert_array_equal(unpack_codes_2bit(packed, N), codes)


def test_packed2_matvec_bit_identical(problem):
    """The 2-bit resident operator equals the bf16 store EXACTLY (both are
    the same exact-integer-slice algebra, so chunking cannot differ)."""
    from saigegds_tpu.ops.packed_grm import build_packed2_grm

    codes, _g0, pg = problem
    p2 = build_packed2_grm(codes)
    rng = np.random.default_rng(6)
    b = rng.normal(size=(codes.shape[1], 3)) * np.array([1, 1e5, 1e-5])
    want = np.asarray(pg.matvec(jnp.asarray(b)))
    got = np.asarray(p2.matvec(jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(p2.diag), np.asarray(pg.diag))


def test_packed2_matvec_1d_and_chunking():
    """Cross tile boundaries: force multiple row leaves AND column tiles
    via tiny build-time caps; device code never slices (invariant 4)."""
    import saigegds_tpu.ops.packed_grm as m

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 3, size=(97, 1031)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.05] = 3
    pg = m.build_packed_grm(codes)
    b = rng.normal(size=1031)
    orig_tile, orig_rows = m._TILE_COLS, m._leaf_rows
    try:
        m._TILE_COLS = 64                 # 1031 samples -> 258 bytes -> 5 tiles
        m._leaf_rows = lambda N4: 33      # 97 rows -> 3 leaves
        p2 = m.build_packed2_grm(codes)
        assert len(p2.packed) == 3 and len(p2.packed[0]) == 5
        got = np.asarray(m.packed2_grm_matvec(
            p2.packed, p2.af, p2.inv, p2.miss_var, p2.miss_samp,
            p2.miss_pad, p2.samp_mask, jnp.asarray(b)))
    finally:
        m._TILE_COLS, m._leaf_rows = orig_tile, orig_rows
    want = np.asarray(pg.matvec(jnp.asarray(b)))
    # tile partials are exact integers; only the final f64 combines can
    # reassociate, so any tiling agrees to ~1 ULP
    np.testing.assert_allclose(got, want, atol=1e-13 * np.abs(want).max())


def test_packed2_streamed_build(problem):
    from saigegds_tpu.ops.packed_grm import (build_packed2_grm,
                                             build_packed2_grm_streamed)

    codes, _g0, _pg = problem
    def blocks():
        for s in range(0, codes.shape[0], 89):
            yield np.arange(s, min(s + 89, codes.shape[0])), codes[s:s + 89]
    sg = build_packed2_grm_streamed(blocks(), codes.shape[1])
    p2 = build_packed2_grm(codes)
    b = np.random.default_rng(8).normal(size=codes.shape[1])
    np.testing.assert_array_equal(np.asarray(sg.matvec(jnp.asarray(b))),
                                  np.asarray(p2.matvec(jnp.asarray(b))))
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(lf) for lf in sg.packed]),
        np.concatenate([np.asarray(lf) for lf in p2.packed]))
