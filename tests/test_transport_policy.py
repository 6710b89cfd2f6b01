"""Link-aware sparse-transport engagement (assoc.single.TransportPolicy).

Under the three-stage pipeline the gap-coded tier can lose on a healthy
link (its device decode sits on the critical path while uploads hide
behind decode) and win when the link binds.  The policy must therefore engage the tier only
when the scan's own measured rates make dense uploads the binder — and
the default scan must never route sparse on a healthy link.
"""

import numpy as np
import pytest

from saigegds_tpu.assoc.single import (TransportPolicy, _packed_parts,
                                       _prefetch_blocks)

DENSE = 1024 * (100_000 // 4)           # one block's 2-bit bytes


def test_policy_defaults_dense_without_measurements():
    p = TransportPolicy()
    assert not p.starved(DENSE)


def test_policy_engages_when_link_binds():
    p = TransportPolicy()
    for _ in range(4):
        p.note_decode(1.0)                    # 1 s/block decode
        p.note_upload(10.0, DENSE)            # link would take 10 s/block
    assert p.starved(DENSE)                   # deeply starved: engage


def test_policy_stays_dense_when_decode_binds():
    p = TransportPolicy()
    for _ in range(4):
        p.note_decode(4.0)                    # decode is the binder
        p.note_upload(1.0, DENSE)             # healthy link
    assert not p.starved(DENSE)


def test_policy_no_oscillation_once_engaged():
    """Engaging the tier shrinks measured upload SECONDS but the signal is
    the link RATE applied to dense bytes, so the decision holds."""
    p = TransportPolicy()
    for _ in range(4):
        p.note_decode(1.0)
        p.note_upload(10.0, DENSE)            # 10 s for dense bytes
    assert p.starved(DENSE)
    rate = p.link_bps
    for _ in range(8):
        p.note_decode(1.0)
        p.note_upload(10.0 * (DENSE // 8) / DENSE, DENSE // 8)  # sparse now
        assert p.starved(DENSE)               # same link rate -> stays on
    assert p.link_bps == pytest.approx(rate, rel=0.01)


def test_policy_hysteresis_band():
    """Projections inside the hysteresis band keep the current tier; a
    merely upload-bound (but not deeply starved) link stays dense."""
    p = TransportPolicy()
    p.note_decode(1.0)
    p.note_upload(3.0, DENSE)                 # 3x decode: upload-bound but
    assert not p.starved(DENSE)               # below 4x1.2 -> stay dense
    p2 = TransportPolicy()
    p2.note_decode(1.0)
    p2.note_upload(6.0, DENSE)
    assert p2.starved(DENSE)                  # engaged (> 4.8x)
    p2.note_upload(4.0, DENSE)                # still > 4/1.2 x decode
    assert p2.starved(DENSE)                  # hysteresis keeps it on


def test_packed_parts_policy_gates_tier():
    """A rare block routes dense on a healthy link, sparse on a starved
    one, and static (policy=None) keeps the nnz-only rule."""
    rng = np.random.default_rng(3)
    codes = rng.binomial(2, 0.01, size=(200, 1000)).astype(np.int8)

    healthy = TransportPolicy()
    healthy.note_decode(4.0)
    healthy.note_upload(0.5, 64 << 20)
    parts = _packed_parts(codes, 256, "xla2", packed_2bit=True,
                          packed_sparse=True, place=lambda x: x,
                          policy=healthy)
    assert len(parts) == 1 and parts[0][2] == "xla2"

    starved = TransportPolicy()
    starved.note_decode(0.5)
    starved.note_upload(10000.0, 64 << 20)  # ~6.7 KB/s: deeply starved
    parts = _packed_parts(codes, 256, "xla2", packed_2bit=True,
                          packed_sparse=True, place=lambda x: x,
                          policy=starved)
    assert len(parts) == 1 and parts[0][2] == "sparse"

    parts = _packed_parts(codes, 256, "xla2", packed_2bit=True,
                          packed_sparse=True, place=lambda x: x,
                          policy=None)
    assert parts[0][2] == "sparse"            # static rule: nnz decides


def test_prefetch_queue_wait_instrumentation():
    """The inter-stage wait timers record per item."""
    import time

    def slow_producer():
        for i in range(5):
            time.sleep(0.01)
            yield i

    inst = {}
    out = list(_prefetch_blocks(slow_producer(), name="decode",
                                instrument=inst))
    assert out == list(range(5))
    for k in ("stall_decode_s", "idle_decode_s", "queued_decode_s"):
        assert len(inst[k]) == 5, (k, inst)
    # producer is the laggard here: consumer idle time ~ production time
    assert sum(inst["idle_decode_s"]) > 0.02
