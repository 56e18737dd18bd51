"""C++ traceback walker vs the pure-Python walker: identical index lists."""

import numpy as np
import pytest

from smithwaterman_tpu.config import CELL_MATCH, GLOBAL, GLOCAL, LOCAL
from smithwaterman_tpu.matrices import SubstitutionMatrix
from smithwaterman_tpu.ops import batch, traceback

RNG = np.random.default_rng(7)
TB = 8  # pairs per test batch


def _with_native(enabled, fn):
    saved = (traceback._LIB, traceback._LIB_TRIED)
    try:
        if enabled:
            traceback._LIB, traceback._LIB_TRIED = None, False
            if traceback._load_native() is None:
                pytest.skip("native walker unavailable")
        else:
            traceback._LIB, traceback._LIB_TRIED = None, True
        return fn()
    finally:
        traceback._LIB, traceback._LIB_TRIED = saved


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
def test_native_matches_python(mode):
    sm = SubstitutionMatrix.blosum62()
    n = np.array([5, 17, 64, 64, 50, 1, 33, 44], dtype=np.int32)
    m = np.array([7, 128, 50, 128, 1, 99, 13, 60], dtype=np.int32)
    codes1 = RNG.integers(0, 24, size=(TB, 64)).astype(np.int32)
    codes2 = RNG.integers(0, 24, size=(TB, 128)).astype(np.int32)
    S = np.stack([sm.dense_scores(codes1[b], codes2[b]) for b in range(TB)])
    res = batch.fill_scan(S.astype(np.float32), n, m, mode=mode, og=-10.0, eg=-0.5)

    for b in range(TB):
        tb_full = np.asarray(res.tb[b])
        tb_tiled = np.ascontiguousarray(tb_full[1:, 1:])
        if mode == LOCAL:
            if float(res.best[b]) <= 0:
                continue
            si, sj, st, loc = int(res.best_i[b]), int(res.best_j[b]), CELL_MATCH, True
        else:
            si, sj, st, loc = int(n[b]), int(m[b]), int(res.final_state[b]), False

        for walker, tb_arr in ((traceback.walk, tb_full),
                               (traceback.walk_tiled, tb_tiled)):
            py = _with_native(False, lambda: walker(tb_arr, si, sj, st, loc))
            nat = _with_native(True, lambda: walker(tb_arr, si, sj, st, loc))
            assert py == nat, f"pair {b} {walker.__name__}"
            assert len(py[0]) > 0


def test_native_strided_view():
    """walk_tiled must work on the strided per-pair views of the tiled array."""
    sm = SubstitutionMatrix.blosum62()
    n = np.full(TB, 32, np.int32)
    m = np.full(TB, 64, np.int32)
    codes1 = RNG.integers(0, 24, size=(TB, 32)).astype(np.int32)
    codes2 = RNG.integers(0, 24, size=(TB, 128)).astype(np.int32)
    S = np.stack([sm.dense_scores(codes1[b], codes2[b, :64]) for b in range(TB)])
    res = batch.fill_scan(S.astype(np.float32), n, m, mode=LOCAL, og=-10.0, eg=-0.5)
    # emulate the tiled layout: (G=1, NP, TB, MP)
    tb_all = np.stack([np.asarray(res.tb[b])[1:, 1:] for b in range(TB)], axis=1)[None]
    for b in range(TB):
        if float(res.best[b]) <= 0:
            continue
        view = batch.tb_pair_view(tb_all, b)
        assert view.strides[1] == 1 and view.strides[0] == TB * 64
        py = _with_native(
            False,
            lambda: traceback.walk_tiled(view, int(res.best_i[b]), int(res.best_j[b]), CELL_MATCH, True),
        )
        nat = _with_native(
            True,
            lambda: traceback.walk_tiled(view, int(res.best_i[b]), int(res.best_j[b]), CELL_MATCH, True),
        )
        assert py == nat


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
def test_native_band_walkers_match_python(mode):
    """The C++ band-window walk (longseq) and diagonal-band walk (banded)
    must reproduce the Python walkers' chunks/status/edge flags exactly."""
    from smithwaterman_tpu.ops import banded, longseq

    sm = SubstitutionMatrix.blosum62()
    codes1 = RNG.integers(0, 20, size=120).astype(np.int32)
    codes2 = np.concatenate([codes1[5:100], RNG.integers(0, 20, size=30)]).astype(np.int32)

    # banded walk parity
    def run_banded():
        return banded.align_banded(
            codes1, codes2, sm.table, mode=mode, og=-10.0, eg=-0.5,
            band=128,
        )
    got_native = _with_native(True, run_banded)
    got_python = _with_native(False, run_banded)
    assert got_native == got_python

    # longseq band-window walk parity (small ckpt to force several bands
    # and window re-gathers)
    c1b = codes1[None, :].repeat(8, axis=0)
    c2b = codes2[None, :].repeat(8, axis=0)
    n = np.full(8, len(codes1), np.int32)
    m = np.full(8, len(codes2), np.int32)

    def run_long():
        return longseq.align_long(
            sm.table, c1b, c2b, n, m, mode=mode, og=-10.0, eg=-0.5,
            ckpt_rows=8, window=128,
        )
    idx_nat, st_nat = _with_native(True, run_long)
    idx_py, st_py = _with_native(False, run_long)
    np.testing.assert_array_equal(st_nat, st_py)
    assert idx_nat == idx_py
