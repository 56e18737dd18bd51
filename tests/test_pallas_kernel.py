"""The tiled fill (ops/fill.py) vs the scan reference path: bit-exact
equivalence.

The scan path (ops/scan_dp.py) is string-exact against all 300 EMBOSS golden
fixtures; the plain-JAX tiled fill — the reference the CUDA kernel is
compared with on the GPU — must reproduce its traceback pointers and stats
cell-for-cell.
"""

import numpy as np
import pytest

from smithwaterman_tpu.config import GLOBAL, GLOCAL, LOCAL
from smithwaterman_tpu.matrices import SubstitutionMatrix
from smithwaterman_tpu.ops import batch, fill

TB = 8  # pairs per test batch

RNG = np.random.default_rng(12345)
NP_PAD = 64
MP_PAD = 128
OG, EG = -10.0, -0.5


def _fill(table, codes1, codes2, n, m, *, mode, og, eg, score_only=False):
    """ops/fill.fill_xla with host results: (tb (1, NP, B, MP) | None,
    stats (B, 8))."""
    tb, stats = fill.fill_xla(
        np.asarray(table, np.float32), codes1, codes2, n, m, mode=mode,
        og=og, eg=eg, score_only=score_only,
    )
    return (None if tb is None else np.asarray(tb)), np.asarray(stats)


def _random_batch(k=24):
    """TB pairs with assorted true lengths; returns codes + lengths."""
    n = np.array([5, 17, 64, 64, 50, 1, 33, 44], dtype=np.int32)
    m = np.array([7, 128, 50, 128, 1, 99, 13, 60], dtype=np.int32)
    codes1 = RNG.integers(0, k, size=(TB, NP_PAD)).astype(np.int32)
    codes2 = RNG.integers(0, k, size=(TB, MP_PAD)).astype(np.int32)
    return codes1, codes2, n, m


def _dense(table, codes1, codes2):
    return np.stack(
        [np.asarray(table)[np.ix_(codes1[b], codes2[b])]
         for b in range(codes1.shape[0])]
    ).astype(np.float32)


def _check(table, codes1, codes2, n, m, *, mode, og=OG, eg=EG,
           score_only=False, msg=""):
    """Fill vs scan oracle: pointers inside each pair's (n, m) region,
    LOCAL best + argmax, non-LOCAL finals."""
    tb, stats = _fill(table, codes1, codes2, n, m, mode=mode, og=og, eg=eg,
                      score_only=score_only)
    ref = batch.fill_scan(_dense(table, codes1, codes2), n, m, mode=mode,
                          og=og, eg=eg, score_only=score_only)
    assert stats.shape == (codes1.shape[0], fill.STATS_W)
    for b in range(codes1.shape[0]):
        nb, mb = int(n[b]), int(m[b])
        if mode == LOCAL:
            assert stats[b, 0] == float(ref.best[b]), f"{msg} pair {b}"
            assert int(stats[b, 1]) == int(ref.best_i[b]), f"{msg} pair {b} i"
            assert int(stats[b, 2]) == int(ref.best_j[b]), f"{msg} pair {b} j"
        else:
            np.testing.assert_array_equal(
                stats[b, 3:6], np.asarray(ref.final[b]), err_msg=f"{msg} {b}")
        if score_only:
            assert tb is None
            continue
        ours = batch.tb_pair_view(tb, b)[:nb, :mb]
        theirs = np.asarray(ref.tb[b])[1:nb + 1, 1:mb + 1]
        np.testing.assert_array_equal(ours, theirs, err_msg=f"{msg} pair {b}")
    return tb, stats, ref


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
def test_kernel_matches_scan(mode):
    sm = SubstitutionMatrix.blosum62()
    codes1, codes2, n, m = _random_batch(sm.n_symbols)
    tb, _, _ = _check(sm.table, codes1, codes2, n, m, mode=mode)
    # the plain fill's layout: one group holding the whole batch
    assert tb.shape == (1, NP_PAD, TB, MP_PAD) and tb.dtype == np.uint8


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
def test_kernel_score_only(mode):
    sm = SubstitutionMatrix.blosum62()
    codes1, codes2, n, m = _random_batch(sm.n_symbols)
    _check(sm.table, codes1, codes2, n, m, mode=mode, score_only=True)


def _zero_best_batch(sm):
    """One all-mismatch pair ('*' vs 'A') whose local best is exactly 0,
    so every valid cell ties the best."""
    codes1, codes2, n, m = _random_batch(sm.n_symbols)
    codes1 = codes1.copy()
    codes2 = codes2.copy()
    codes1[5, :] = sm.seq_to_index("*" * NP_PAD)
    codes2[5, :] = sm.seq_to_index("A" * MP_PAD)
    return codes1, codes2, n, m


def test_kernel_score_only_masked_s():
    """LOCAL score-only with a zero-best pair: padded cells never take
    the best, and the first-encounter argmax lands on (1, 1)."""
    sm = SubstitutionMatrix.blosum62()
    codes1, codes2, n, m = _zero_best_batch(sm)
    _, stats, ref = _check(sm.table, codes1, codes2, n, m, mode=LOCAL,
                           score_only=True)
    assert float(ref.best[5]) == 0.0  # the all-mismatch pair hit the tie
    assert (int(stats[5, 1]), int(stats[5, 2])) == (1, 1)


def test_kernel_traceback_masked_s():
    """LOCAL traceback with the zero-best pair: pointers, best scores AND
    argmax positions bit-identical to the scan reference."""
    sm = SubstitutionMatrix.blosum62()
    codes1, codes2, n, m = _zero_best_batch(sm)
    _, stats, ref = _check(sm.table, codes1, codes2, n, m, mode=LOCAL)
    assert float(ref.best[5]) == 0.0
    assert (int(stats[5, 1]), int(stats[5, 2])) == (1, 1)


@pytest.mark.parametrize("mode", [GLOCAL, GLOBAL])
@pytest.mark.parametrize("score_only", [False, True])
def test_kernel_interior_row_blocks(mode, score_only):
    """Final rows (glocal's free last row, the finals capture) clustered
    near the top and bottom of a tall, wide batch: rows between them hold
    no pair's last row.  Results stay bit-identical to the scan."""
    sm = SubstitutionMatrix.blosum62()
    NP, MP = 128, 4096
    codes1 = RNG.integers(0, sm.n_symbols, size=(TB, NP)).astype(np.int32)
    codes2 = RNG.integers(0, sm.n_symbols, size=(TB, MP)).astype(np.int32)
    n = np.array([5, 20, 32, 127, 128, 100, 31, 97], dtype=np.int32)
    m = np.array([4096, 60, 333, 4096, 1, 2048, 100, 7], dtype=np.int32)
    _check(sm.table, codes1, codes2, n, m, mode=mode, score_only=score_only)


@pytest.mark.parametrize("mode", [GLOCAL, GLOBAL])
def test_kernel_single_group_traceback_ungated(mode):
    """A shallow, very wide batch (NP=32, MP=16384) with final rows in
    every eighth of the rows: finals and every pointer match the scan."""
    sm = SubstitutionMatrix.blosum62()
    NP, MP = 32, 16384
    codes1 = RNG.integers(0, sm.n_symbols, size=(TB, NP)).astype(np.int32)
    codes2 = RNG.integers(0, sm.n_symbols, size=(TB, MP)).astype(np.int32)
    n = np.array([5, 8, 9, 16, 17, 24, 25, 32], dtype=np.int32)
    m = np.array([16384, 60, 333, 16384, 1, 2048, 100, 7], dtype=np.int32)
    _check(sm.table, codes1, codes2, n, m, mode=mode)


def test_fill_tiled_non_pow2_rows():
    """A row count that is not a power of two (NP=24, MP=8192): every row
    is filled."""
    sm = SubstitutionMatrix.blosum62()
    NP, MP = 24, 8192
    codes1 = RNG.integers(0, sm.n_symbols, size=(TB, NP)).astype(np.int32)
    codes2 = RNG.integers(0, sm.n_symbols, size=(TB, MP)).astype(np.int32)
    n = np.full(TB, NP, np.int32)
    m = np.array([50, 24, 8192, 100, 7, 1, 300, 129], dtype=np.int32)
    _check(sm.table, codes1, codes2, n, m, mode=LOCAL, score_only=True)


def test_float_table_path():
    """Non-integer tables fill in f32 (no quarter-unit domain) and stay
    equal to the scan on the same f32 arithmetic."""
    sm = SubstitutionMatrix.blosum62()
    table = sm.table + 0.123
    assert not fill.is_integer_table(table)
    assert not fill.quarter_exact(table, OG, EG)
    assert fill.quarter_exact(sm.table, OG, EG)
    codes1, codes2, n, m = _random_batch(sm.n_symbols)
    _check(table, codes1, codes2, n, m, mode=LOCAL)


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
@pytest.mark.parametrize("og,eg", [(0.0, 0.0), (-1.0, 0.0), (-25.0, -0.5)])
def test_kernel_degenerate_penalties(mode, og, eg):
    """Traceback-pointer equivalence at penalty edge cases.

    og=eg=0 exercises the lane-0 ties (the only case where the X
    boundary extend can win the non-LOCAL `>=` compare); eg=0 kills the
    scan's detrend slope; og=-25 makes every open lose to extends early."""
    sm = SubstitutionMatrix.blosum62()
    codes1, codes2, n, m = _random_batch(sm.n_symbols)
    _check(sm.table, codes1, codes2, n, m, mode=mode, og=og, eg=eg)


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_fuzz_random_shapes_penalties(seed):
    """Randomized fill-vs-scan equivalence: random lengths (incl. 1),
    random quarter-integer penalties, all three modes, full traceback."""
    rng = np.random.default_rng(1000 + seed)
    sm = SubstitutionMatrix.blosum62()
    n = rng.integers(1, NP_PAD + 1, size=TB).astype(np.int32)
    m = rng.integers(1, MP_PAD + 1, size=TB).astype(np.int32)
    n[0], m[0] = 1, 1
    codes1 = rng.integers(0, sm.n_symbols, size=(TB, NP_PAD)).astype(np.int32)
    codes2 = rng.integers(0, sm.n_symbols, size=(TB, MP_PAD)).astype(np.int32)
    og = -float(rng.integers(0, 65)) / 4.0
    eg = -float(rng.integers(0, 17)) / 4.0
    for mode in (LOCAL, GLOCAL, GLOBAL):
        _check(sm.table, codes1, codes2, n, m, mode=mode, og=og, eg=eg,
               msg=f"mode {mode} og={og} eg={eg}")
