"""Batch-aware longseq routing.

A batch whose TOTAL pointer bytes exceed the HBM budget must stream
through budget-sized device-walk chunks (serialized via
BatchAligner._reserve_tb), NOT fall back to checkpoint+refill; longseq
engages only when even ONE tile group's pointers bust the budget.
"""

import numpy as np
import pytest

import smithwaterman_tpu as swt
from smithwaterman_tpu.ops import longseq

LETTERS = "ARNDCQEGHILKMFPSTWYV"


def _pairs(rng, n_pairs, lo, hi):
    def rseq(n):
        return "".join(rng.choice(list(LETTERS), n))

    return [
        (rseq(rng.integers(lo, hi)), rseq(rng.integers(lo, hi)))
        for _ in range(n_pairs)
    ]


def _fields(r):
    return (r.aligned1, r.aligned2, r.score,
            r.start1, r.end1, r.start2, r.end2)


def test_over_budget_batch_chunks_device_walk(monkeypatch):
    # 24 pairs in the 256x256 bucket, tile=8 -> 3 groups of 512 KiB tb.
    # Budget 1 MiB: total (1.5 MiB) busts it, one group fits -> chunked
    # device walk, longseq must NOT engage.
    monkeypatch.setenv("SWTPU_TB_HBM_BYTES", str(1 << 20))

    def boom(*a, **k):
        raise AssertionError("longseq engaged for a chunkable batch")

    monkeypatch.setattr(longseq, "align_long", boom)
    rng = np.random.default_rng(42)
    pairs = _pairs(rng, 24, 200, 256)
    ba = swt.BatchAligner(mode=swt.LOCAL, backend="xla",
                          tile_pairs=8)
    assert ba.tb_hbm_bytes == 1 << 20
    res = ba.align_pairs(pairs)
    ref = swt.BatchAligner(mode=swt.LOCAL, backend="xla",
                           device_walk=False).align_pairs(pairs)
    for a, b in zip(res, ref):
        assert _fields(a) == _fields(b)
    # every dispatched chunk was tracked against the budget
    assert ba._tb_inflight_bytes == 0


@pytest.mark.parametrize("mode", [swt.GLOBAL, swt.GLOCAL])
def test_over_budget_chunks_nonlocal(mode, monkeypatch):
    monkeypatch.setenv("SWTPU_TB_HBM_BYTES", str(1 << 20))
    rng = np.random.default_rng(7)
    pairs = _pairs(rng, 24, 200, 256)
    res = swt.BatchAligner(mode=mode, backend="xla",
                           tile_pairs=8).align_pairs(pairs)
    ref = swt.BatchAligner(mode=mode, backend="xla",
                           device_walk=False).align_pairs(pairs)
    for a, b in zip(res, ref):
        assert _fields(a) == _fields(b)


def test_single_group_over_budget_still_longseq(monkeypatch):
    # budget below ONE tile group's pointers -> checkpoint+refill remains
    # the only route and must be taken
    monkeypatch.setenv("SWTPU_TB_HBM_BYTES", str(256 << 10))
    called = {}
    orig = longseq.align_long_packed

    def spy(*a, **k):
        called["yes"] = True
        return orig(*a, **k)

    monkeypatch.setattr(longseq, "align_long_packed", spy)
    rng = np.random.default_rng(3)
    pairs = _pairs(rng, 8, 200, 256)
    res = swt.BatchAligner(mode=swt.LOCAL, backend="xla",
                           tile_pairs=8).align_pairs(pairs)
    assert called.get("yes")
    ref = swt.BatchAligner(mode=swt.LOCAL, backend="xla",
                           device_walk=False).align_pairs(pairs)
    for a, b in zip(res, ref):
        assert _fields(a) == _fields(b)


@pytest.mark.parametrize("mode", [swt.LOCAL, swt.GLOBAL, swt.GLOCAL])
def test_forced_longseq_packed_end_to_end(mode, monkeypatch):
    """BatchAligner longseq route with the packed device walk must match
    both the host longseq path and the plain host walk, field-exact."""
    rng = np.random.default_rng(mode + 99)
    pairs = _pairs(rng, 9, 60, 128)
    monkeypatch.setenv("SWTPU_PACKED_WALK", "1")
    packed = swt.BatchAligner(mode=mode, backend="xla",
                              longseq_cells=1, tile_pairs=8).align_pairs(pairs)
    monkeypatch.setenv("SWTPU_PACKED_WALK", "0")
    host_ls = swt.BatchAligner(mode=mode, backend="xla",
                               longseq_cells=1, tile_pairs=8).align_pairs(pairs)
    plain = swt.BatchAligner(mode=mode, backend="xla",
                             device_walk=False).align_pairs(pairs)
    for a, b, c in zip(packed, host_ls, plain):
        assert _fields(a) == _fields(b) == _fields(c)
