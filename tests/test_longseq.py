"""Checkpointed-fill + banded-traceback path vs the plain fill: the segment
re-fills must replay identical tie-breaks, so paths are bit-identical."""

import numpy as np
import pytest

from smithwaterman_tpu.config import CELL_MATCH, GLOBAL, GLOCAL, LOCAL
from smithwaterman_tpu.matrices import SubstitutionMatrix
from smithwaterman_tpu.ops import batch, longseq, traceback

RNG = np.random.default_rng(99)
TB = 8  # pairs per test batch
NP_PAD = 128
MP_PAD = 128
CKPT = 32  # 4 segments
OG, EG = -10.0, -0.5


def _batch(k=24):
    n = np.array([128, 100, 65, 32, 96, 1, 33, 127], dtype=np.int32)
    m = np.array([128, 40, 128, 128, 9, 100, 13, 127], dtype=np.int32)
    codes1 = RNG.integers(0, k, size=(TB, NP_PAD)).astype(np.int32)
    codes2 = RNG.integers(0, k, size=(TB, MP_PAD)).astype(np.int32)
    return codes1, codes2, n, m


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
def test_longseq_matches_plain_walk(mode):
    sm = SubstitutionMatrix.blosum62()
    codes1, codes2, n, m = _batch()

    idx_lists, stats = longseq.align_long(
        sm.table, codes1, codes2, n, m, mode=mode, og=OG, eg=EG,
        ckpt_rows=CKPT,
    )

    S_dense = np.stack(
        [sm.dense_scores(codes1[b], codes2[b]) for b in range(TB)]
    ).astype(np.float32)
    ref = batch.fill_scan(S_dense, n, m, mode=mode, og=OG, eg=EG)

    for b in range(TB):
        tbv = np.asarray(ref.tb[b])
        if mode == LOCAL:
            assert stats[b, 0] == pytest.approx(float(ref.best[b]))
            if float(ref.best[b]) <= 0:
                assert idx_lists[b] == ([], [])
                continue
            want = traceback.walk(
                tbv, int(ref.best_i[b]), int(ref.best_j[b]), CELL_MATCH, True
            )
        else:
            np.testing.assert_allclose(stats[b, 3:6], np.asarray(ref.final[b]))
            want = traceback.walk(
                tbv, int(n[b]), int(m[b]), int(ref.final_state[b]), False
            )
        assert idx_lists[b][0] == want[0], f"pair {b} idx1"
        assert idx_lists[b][1] == want[1], f"pair {b} idx2"


def test_batch_aligner_longseq_routing():
    """BatchAligner routes big buckets through the checkpointed path and
    stays bit-identical to the single-pair engine."""
    from smithwaterman_tpu import Aligner, BatchAligner

    rng = np.random.default_rng(5)
    letters = "ACDEFGHIKLMNPQRSTVWY"
    mk = lambda k: "".join(letters[i] for i in rng.integers(0, 20, k))
    base = mk(150)
    s1 = base + mk(30)
    s2 = base[10:120] + mk(40)  # related pair, lengths 180/150
    ba = BatchAligner(mode=GLOCAL, backend="xla", longseq_cells=128 * 128)
    r = ba.align_pairs([(s1, s2)])[0]
    w = Aligner(mode=GLOCAL).align(s1, s2, True)
    assert (r.score, r.aligned1, r.aligned2) == (w.score, w.aligned1, w.aligned2)


def test_longseq_walk_left_rerounds():
    """A global-mode path whose gap run exceeds the column window forces
    WALK_LEFT re-rounds (band re-fill + fresh window within one segment);
    paths must still match the plain fill bit-for-bit."""
    sm = SubstitutionMatrix.blosum62()
    npp, mpp = 32, 512
    n = np.full(TB, npp, np.int32)
    m = np.array([512, 300, 512, 200, 512, 150, 512, 512], np.int32)
    codes1 = RNG.integers(0, 20, size=(TB, npp)).astype(np.int32)
    codes2 = RNG.integers(0, 20, size=(TB, mpp)).astype(np.int32)
    idx_lists, stats = longseq.align_long(
        sm.table, codes1, codes2, n, m, mode=GLOBAL, og=OG, eg=EG,
        ckpt_rows=8, window=128,
    )
    S_dense = np.stack(
        [sm.dense_scores(codes1[b], codes2[b]) for b in range(TB)]
    ).astype(np.float32)
    ref = batch.fill_scan(S_dense, n, m, mode=GLOBAL, og=OG, eg=EG)
    for b in range(TB):
        want = traceback.walk(
            np.asarray(ref.tb[b]), int(n[b]), int(m[b]),
            int(ref.final_state[b]), False,
        )
        assert idx_lists[b][0] == want[0], f"pair {b} idx1"
        assert idx_lists[b][1] == want[1], f"pair {b} idx2"


def test_longseq_degenerate_penalties():
    """og=eg=0 through the checkpoint + seeded band re-fill: every state
    ties everywhere, so one wrong compare direction in the re-fill
    diverges from the plain walk immediately."""
    sm = SubstitutionMatrix.blosum62()
    codes1, codes2, n, m = _batch()
    idx_lists, stats = longseq.align_long(
        sm.table, codes1, codes2, n, m, mode=GLOBAL, og=0.0, eg=0.0,
        ckpt_rows=CKPT,
    )
    S_dense = np.stack(
        [sm.dense_scores(codes1[b], codes2[b]) for b in range(TB)]
    ).astype(np.float32)
    ref = batch.fill_scan(S_dense, n, m, mode=GLOBAL, og=0.0, eg=0.0)
    for b in range(TB):
        want = traceback.walk(
            np.asarray(ref.tb[b]), int(n[b]), int(m[b]),
            int(ref.final_state[b]), False,
        )
        assert idx_lists[b][0] == want[0], f"pair {b} idx1"
        assert idx_lists[b][1] == want[1], f"pair {b} idx2"


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
def test_longseq_packed_matches_host_path(mode):
    """align_long_packed's device segment walks must replay the exact same
    paths as align_long's host band walks (same band re-fill tie-breaks)."""
    from smithwaterman_tpu.ops import device_walk

    sm = SubstitutionMatrix.blosum62()
    codes1, codes2, n, m = _batch()

    idx_lists, stats = longseq.align_long(
        sm.table, codes1, codes2, n, m, mode=mode, og=OG, eg=EG,
        ckpt_rows=CKPT,
    )
    stats_d, cnt_d, mv_d = longseq.align_long_packed(
        sm.table, codes1, codes2, n, m, mode=mode, og=OG, eg=EG,
        ckpt_rows=CKPT,
    )
    stats_p = np.asarray(stats_d)
    cnt = np.asarray(cnt_d)
    mv = np.asarray(mv_d)
    np.testing.assert_allclose(stats_p, stats[:, :8])
    for b in range(TB):
        if mode == LOCAL and stats[b, 0] <= 0.0:
            assert cnt[b] == 0
            continue
        if mode == LOCAL:
            i0, j0 = int(stats[b, 1]), int(stats[b, 2])
        else:
            i0, j0 = int(n[b]), int(m[b])
        got = device_walk.moves_to_path(mv, cnt, i0, j0, b)
        assert got[0] == idx_lists[b][0], f"pair {b} idx1"
        assert got[1] == idx_lists[b][1], f"pair {b} idx2"
