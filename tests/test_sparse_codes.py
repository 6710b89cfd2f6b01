"""Sparse gap-coded genotype transport: roundtrip + kernel/scan parity.

The transport analog of the reference's sparse genotype path
(/root/reference/src/saige_fitnull.cpp:236-427, src/saige_main.cpp:299-350);
must be exact — decode reproduces the int8 block bit-for-bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from saigegds_tpu.ops.sparse_codes import (MAX_GAP, bucket_rows,
                                           decode_codes, encode_sparse_rows,
                                           pad_entries, sparse_beats_dense,
                                           sparse_row_mask)


def _roundtrip(codes: np.ndarray, pad: bool = False) -> np.ndarray:
    entries, row_ptr = encode_sparse_rows(codes)
    if pad:
        entries = pad_entries(entries)
    out = decode_codes(jnp.asarray(entries), jnp.asarray(row_ptr),
                       codes.shape[0], codes.shape[1])
    return np.asarray(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roundtrip_fuzz(seed):
    rng = np.random.default_rng(seed)
    B, N = 37, 503
    codes = rng.choice(np.int8([0, 0, 0, 0, 0, 1, 2, 3]), size=(B, N))
    codes[5] = 0                      # empty row
    codes[6] = 3                      # all-missing row
    codes[:, -7:] = 0                 # trailing zero columns
    np.testing.assert_array_equal(_roundtrip(codes, pad=True), codes)


def test_roundtrip_escape_entries():
    """Gaps beyond 16383 need escape entries; exercise exact boundaries."""
    B, N = 5, 3 * (MAX_GAP + 1) + 10
    codes = np.zeros((B, N), np.int8)
    codes[0, MAX_GAP] = 1             # max single-entry gap (dist-1 == MAX)
    codes[1, MAX_GAP + 1] = 2         # first gap needing one escape
    codes[2, N - 1] = 3               # multiple escapes
    codes[3, 0] = 1
    codes[3, N - 1] = 2               # escape mid-row after a real entry
    entries, _ = encode_sparse_rows(codes)
    assert len(entries) > 4           # escapes present
    np.testing.assert_array_equal(_roundtrip(codes), codes)
    np.testing.assert_array_equal(_roundtrip(codes, pad=True), codes)


def test_roundtrip_empty_and_padded_rows():
    codes = np.zeros((4, 100), np.int8)
    np.testing.assert_array_equal(_roundtrip(codes, pad=True), codes)
    # decode with extra padding rows (row_ptr repeats the end offset)
    entries, row_ptr = encode_sparse_rows(np.int8([[0, 1, 0, 2]]))
    rp = np.full(9, row_ptr[-1], np.int32)
    rp[: len(row_ptr)] = row_ptr
    out = np.asarray(decode_codes(jnp.asarray(pad_entries(entries)),
                                  jnp.asarray(rp), 8, 4))
    np.testing.assert_array_equal(out[0], [0, 1, 0, 2])
    assert (out[1:] == 0).all()


def test_row_mask_and_batch_decision():
    N = 800
    codes = np.zeros((4, N), np.int8)
    codes[0, :10] = 1                         # rare
    codes[1, : N // 2] = 2                    # common
    mask = sparse_row_mask(codes)
    np.testing.assert_array_equal(mask, [True, False, True, True])
    assert sparse_beats_dense(codes[[0, 2, 3]])
    assert not sparse_beats_dense(codes[[1]])


def test_bucket_rows_bounds():
    assert bucket_rows(1, 1024) == 64
    assert bucket_rows(1024, 1024) == 1024
    assert bucket_rows(5000, 1024) == 1024    # capped
    seen = set()
    for n in range(1, 1025):
        b = bucket_rows(n, 1024)
        assert n <= b <= 1024
        assert (b - n) <= max(n // 4, 64)     # padding waste bounded
        seen.add(b)
    assert len(seen) <= 24                    # compiled shapes bounded


@pytest.fixture(scope="module")
def setup():
    from saigegds_tpu.io.seqarray import SeqData
    from saigegds_tpu.models.nullmodel import NullModel
    from saigegds_tpu.ops.score_packed import pack_scan_model

    model = NullModel.load("/root/reference/inst/unitTests/saige_model.rds")
    seq = SeqData("/root/reference/inst/extdata/grm1k_10k_snp.gds")
    sm = model.scan_model()
    return seq, sm, pack_scan_model(sm)


def test_sparse_impl_matches_int8(setup):
    """impl='sparse' == the int8 xla path (bit-parity by construction)."""
    from saigegds_tpu.ops.score import ScanParams
    from saigegds_tpu.ops.score_packed import score_stats_binary_packed

    seq, sm, pm = setup
    params = ScanParams(maf=-1.0, mac=4.0, missing=0.1, spa_pval=0.05)
    G = seq.dosage_block(0, 300)
    codes = np.where(np.isnan(G), 3, G).astype(np.int8)
    want = score_stats_binary_packed(pm, params, jnp.asarray(codes))
    entries, row_ptr = encode_sparse_rows(codes)
    got = score_stats_binary_packed(
        pm, params,
        (jnp.asarray(pad_entries(entries)), jnp.asarray(row_ptr)),
        impl="sparse")
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(np.asarray(got.valid), v)
    np.testing.assert_array_equal(np.asarray(got.need_spa),
                                  np.asarray(want.need_spa))
    for f in ("af", "mac", "num", "beta", "se", "pval"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f))[v],
                                      np.asarray(getattr(want, f))[v],
                                      err_msg=f)


def test_spa_refine_sparse_payload(setup):
    """Phase-2 SPA: the gap-coded payload == the 2-bit payload == dense f64
    (device decode is exact; empty pad rows are discarded lanes)."""
    from saigegds_tpu.ops.packed_grm import pack_codes_2bit
    from saigegds_tpu.ops.score import spa_refine_binary

    seq, sm, _ = setup
    G = seq.dosage_block(0, 200)
    codes = np.where(np.isnan(G), 3, G).astype(np.int8)
    # keep rows rare enough that the sparse transport is the natural choice
    keep = (codes != 0).sum(axis=1) < codes.shape[1] // 8
    codes = codes[keep][:100]
    n = codes.shape[1]

    want = spa_refine_binary(sm, jnp.asarray(
        np.where(codes == 3, np.nan, codes).astype(np.float64)))
    via2 = spa_refine_binary(sm, jnp.asarray(pack_codes_2bit(codes)),
                             packed_n=n)
    entries, row_ptr = encode_sparse_rows(codes)
    B = 128                                   # pad rows beyond the batch
    rp = np.full(B + 1, row_ptr[-1], np.int32)
    rp[: len(row_ptr)] = row_ptr
    got = spa_refine_binary(sm, (jnp.asarray(pad_entries(entries)),
                                 jnp.asarray(rp)), packed_n=n)
    m = codes.shape[0]
    for i, name in enumerate(("pval", "conv", "beta", "se")):
        np.testing.assert_array_equal(np.asarray(got[i])[:m],
                                      np.asarray(via2[i])[:m], err_msg=name)
        np.testing.assert_array_equal(np.asarray(got[i])[:m],
                                      np.asarray(want[i])[:m], err_msg=name)


@pytest.mark.parametrize("packed_2bit", [False, True])
def test_scan_split_parity(setup, packed_2bit, monkeypatch):
    """End-to-end _scan_blocks: the sparse/dense row split returns the
    identical table as the all-dense transport (mixed rare/common block,
    both sides above the split minimum; thresholds zeroed so the split
    engages at test scale)."""
    import saigegds_tpu.assoc.single as single_mod
    from saigegds_tpu.assoc.single import _scan_blocks
    from saigegds_tpu.ops.score import ScanParams

    monkeypatch.setattr(single_mod, "SPLIT_SAVE_BYTES", 0)
    monkeypatch.setattr(single_mod, "SPLIT_SAVE_FRAC", 0.0)
    _, sm, _ = setup
    n = sm.y.shape[0]
    rng = np.random.default_rng(7)
    B = 256
    af = np.concatenate([rng.uniform(0.001, 0.02, 150),   # rare rows
                         rng.uniform(0.2, 0.5, 106)])     # common rows
    rng.shuffle(af)
    codes = rng.binomial(2, af[:, None], size=(B, n)).astype(np.int8)
    codes[rng.random((B, n)) < 0.01] = 3
    params = ScanParams(maf=-1.0, mac=4.0, missing=0.1, spa_pval=0.05)

    def blocks():
        yield np.arange(B), codes.copy()

    kw = dict(packed=True, packed_2bit=packed_2bit, spa_mixed=False,
              transport_policy="static")   # exercise the split machinery
    want = _scan_blocks(sm, params, True, B, blocks(),
                        packed_sparse=False, **kw)
    got = _scan_blocks(sm, params, True, B, blocks(),
                       packed_sparse=True, **kw)
    assert (np.asarray(sparse_row_mask(codes)).sum() >= 64)
    np.testing.assert_array_equal(got["__idx__"], want["__idx__"])
    for c in ("AF.alt", "mac", "num", "beta", "SE", "pval", "p.norm"):
        np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                   rtol=1e-12, err_msg=c)


@pytest.mark.parametrize("regime", ["rare", "common"])
def test_packed_parts_whole_block_routing(setup, regime):
    """Below the split thresholds the block routes whole: one dispatch,
    sparse payload iff the entry stream is smaller than the 2-bit block."""
    from saigegds_tpu.assoc.single import _packed_parts

    rng = np.random.default_rng(3)
    n = 1000
    af = 0.01 if regime == "rare" else 0.3
    codes = rng.binomial(2, af, size=(200, n)).astype(np.int8)
    parts = _packed_parts(codes, 256, "xla2", packed_2bit=True,
                          packed_sparse=True, place=lambda x: x)
    assert len(parts) == 1
    rows, payload, impl = parts[0]
    np.testing.assert_array_equal(rows, np.arange(200))
    if regime == "rare":
        assert impl == "sparse" and isinstance(payload, tuple)
    else:
        assert impl == "xla2" and not isinstance(payload, tuple)


@pytest.mark.parametrize("seed", [0, 1])
def test_native_encoder_matches_numpy(seed):
    """The SIMD C encoder (native/fastio.cpp sg_sparse_encode) produces the
    byte-identical entry stream + row_ptr as the numpy reference."""
    from saigegds_tpu.io import native
    from saigegds_tpu.ops.sparse_codes import _encode_sparse_rows_np

    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(seed)
    B, N = 23, 40000
    codes = np.zeros((B, N), np.int8)
    nz = rng.random((B, N)) < 0.003
    codes[nz] = rng.choice(np.int8([1, 2, 3]), size=int(nz.sum()))
    codes[3] = 0                               # empty row
    codes[5, N - 1] = 2                        # long-gap escape
    codes[7, :64] = 1                          # dense prefix
    got = native.sparse_encode(codes)
    want = _encode_sparse_rows_np(codes)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# device decode round trips at the stream's edge cases


def _case_codes(case: str) -> np.ndarray:
    if case.startswith("fuzz"):
        rng = np.random.default_rng(int(case[4:]))
        codes = rng.choice(np.int8([0, 0, 0, 0, 0, 1, 2, 3]), size=(37, 503))
        codes[5] = 0
        codes[6] = 3
        codes[:, -7:] = 0
    elif case == "escapes":
        codes = np.zeros((8, 3 * (MAX_GAP + 1) + 10), np.int8)
        N = codes.shape[1]
        codes[0, N - 1] = 2               # two escapes then the entry
        codes[1, 0] = 3                   # first position, missing code
        codes[2, MAX_GAP] = 1             # exactly max gap, no escape
        codes[3, MAX_GAP + 1] = 1         # one escape, zero remainder
        codes[5, [10, 11, 12]] = 2        # adjacent entries
    elif case == "empty":
        codes = np.zeros((12, 256), np.int8)
    else:                                 # "rare": 5% nonzero, one value
        rng = np.random.default_rng(4)
        codes = (rng.random((8, 512)) < 0.05).astype(np.int8) * 2
    return codes


@pytest.mark.parametrize("case", ["fuzz0", "fuzz1", "escapes", "empty",
                                  "rare"])
@pytest.mark.parametrize("pad", [False, True])
def test_decode_roundtrip_cases(case, pad):
    codes = _case_codes(case)
    entries, row_ptr = encode_sparse_rows(codes)
    if pad:
        entries = pad_entries(entries)
    out = decode_codes(jnp.asarray(entries), jnp.asarray(row_ptr),
                       codes.shape[0], codes.shape[1])
    np.testing.assert_array_equal(np.asarray(out), codes)
