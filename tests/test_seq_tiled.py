"""Sequence-tiled (column-sharded) fill vs the single-device scan fill:
scores must be bit-identical across an 8-device mesh."""

import numpy as np
import pytest

from smithwaterman_tpu.config import GLOBAL, GLOCAL, LOCAL
from smithwaterman_tpu.matrices import SubstitutionMatrix
from smithwaterman_tpu.ops import batch
from smithwaterman_tpu.parallel import make_mesh
from smithwaterman_tpu.parallel.seq_tiled import striped_fill

RNG = np.random.default_rng(17)
B, NP, MP = 3, 256, 256
OG, EG = -10.0, -0.5


def _data():
    sm = SubstitutionMatrix.blosum62()
    codes1 = RNG.integers(0, 24, size=(B, NP)).astype(np.int32)
    codes2 = RNG.integers(0, 24, size=(B, MP)).astype(np.int32)
    n = np.array([256, 200, 129], dtype=np.int32)
    m = np.array([256, 131, 256], dtype=np.int32)
    S = np.stack(
        [sm.dense_scores(codes1[b], codes2[b]) for b in range(B)]
    ).astype(np.float32)
    return S, n, m


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
def test_striped_align_strings_match_scan(mode):
    """A pair striped over 8 devices must yield the SAME alignment string
    as the single-device engine."""
    from smithwaterman_tpu.aligner import Aligner, reconstruct_alignment
    from smithwaterman_tpu.io.fasta import SeqData
    from smithwaterman_tpu.parallel.seq_tiled import striped_align

    mesh = make_mesh(8)
    sm = SubstitutionMatrix.blosum62()
    letters = np.array(list("ARNDCQEGHILKMFPSTWYVBZX"))
    codes1 = RNG.integers(0, 23, size=(B, NP)).astype(np.int32)
    codes2 = RNG.integers(0, 23, size=(B, MP)).astype(np.int32)
    n = np.array([256, 180, 111], dtype=np.int32)
    m = np.array([256, 121, 250], dtype=np.int32)
    S = np.stack(
        [sm.dense_scores(codes1[b], codes2[b]) for b in range(B)]
    ).astype(np.float32)

    idx_lists, stats = striped_align(
        S, n, m, mode=mode, og=OG, eg=EG, mesh=mesh,
        block_rows=16, ckpt_rows=64,
    )
    eng = Aligner(scoring_matrix=sm, mode=mode)
    for b in range(B):
        s1 = "".join(letters[codes1[b, : n[b]]])
        s2 = "".join(letters[codes2[b, : m[b]]])
        want = eng.align(SeqData("a", "", s1), SeqData("b", "", s2), True)
        if mode == LOCAL:
            score = float(stats[b, 0]) if stats[b, 0] > 0 else 0.0
        else:
            score = float(np.max(stats[b, 3:6]))
        got = reconstruct_alignment(
            s1, s2, idx_lists[b][0], idx_lists[b][1], score, True, mode
        )
        assert got.aligned1 == want.aligned1, f"pair {b}"
        assert got.aligned2 == want.aligned2, f"pair {b}"
        assert got.score == want.score, f"pair {b}"


def test_striped_ckpt_stats_match_scan():
    """Checkpointed striped fill reports the exact argmax (min-i, min-j
    first-encounter rule) and the same checkpoint carries the plain scan
    produces at those rows."""
    from smithwaterman_tpu.parallel.seq_tiled import striped_fill_ckpt

    mesh = make_mesh(8)
    S, n, m = _data()
    stats, (ckm, ckx, cky) = striped_fill_ckpt(
        S, n, m, mode=LOCAL, og=OG, eg=EG,
        block_rows=32, ckpt_rows=64, mesh=mesh,
    )
    stats = np.asarray(stats)
    ref = batch.fill_scan(S, n, m, mode=LOCAL, og=OG, eg=EG, score_only=False)
    for b in range(B):
        assert stats[b, 0] == float(ref.best[b])
        if float(ref.best[b]) > 0:
            assert int(stats[b, 1]) == int(ref.best_i[b])
            assert int(stats[b, 2]) == int(ref.best_j[b])


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
@pytest.mark.parametrize("block_rows", [32, 256])
def test_striped_matches_scan(mode, block_rows):
    import jax

    mesh = make_mesh(8)
    S, n, m = _data()
    got = np.asarray(
        striped_fill(
            S, n, m, mode=mode, og=OG, eg=EG, block_rows=block_rows, mesh=mesh
        )
    )
    ref = batch.fill_scan(S, n, m, mode=mode, og=OG, eg=EG, score_only=True)
    if mode == LOCAL:
        np.testing.assert_array_equal(got, np.asarray(ref.best))
    else:
        np.testing.assert_array_equal(got, np.asarray(ref.final))


def test_striped_walk_left_rerounds():
    """Striped traceback with a gap run longer than the column window:
    WALK_LEFT re-rounds re-fill the same segment through the fused
    dispatch path and must preserve the exact walk."""
    from smithwaterman_tpu.ops import traceback
    from smithwaterman_tpu.ops.batch import fill_scan
    from smithwaterman_tpu.parallel.seq_tiled import striped_align

    mesh = make_mesh(8)
    sm = SubstitutionMatrix.blosum62()
    npp, mpp = 32, 512
    codes1 = RNG.integers(0, 20, size=(B, npp)).astype(np.int32)
    codes2 = RNG.integers(0, 20, size=(B, mpp)).astype(np.int32)
    n = np.full(B, npp, np.int32)
    m = np.array([512, 300, 512], np.int32)
    S = np.stack(
        [sm.dense_scores(codes1[b], codes2[b]) for b in range(B)]
    ).astype(np.float32)
    idx_lists, stats = striped_align(
        S, n, m, mode=GLOBAL, og=OG, eg=EG, mesh=mesh,
        block_rows=8, ckpt_rows=8, window=128,
    )
    ref = fill_scan(S, n, m, mode=GLOBAL, og=OG, eg=EG)
    for b in range(B):
        want = traceback.walk(
            np.asarray(ref.tb[b]), int(n[b]), int(m[b]),
            int(ref.final_state[b]), False,
        )
        assert idx_lists[b][0] == want[0], f"pair {b} idx1"
        assert idx_lists[b][1] == want[1], f"pair {b} idx2"


def test_striped_degenerate_penalties():
    """og=eg=0 through the striped fill + banded striped re-fill: the
    boundary-state walk normalization must yield the plain fill's path."""
    from smithwaterman_tpu.ops import traceback
    from smithwaterman_tpu.ops.batch import fill_scan
    from smithwaterman_tpu.parallel.seq_tiled import striped_align

    mesh = make_mesh(8)
    sm = SubstitutionMatrix.blosum62()
    codes1 = RNG.integers(0, 24, size=(B, NP)).astype(np.int32)
    codes2 = RNG.integers(0, 24, size=(B, MP)).astype(np.int32)
    n = np.array([256, 100, 31], dtype=np.int32)
    m = np.array([256, 41, 250], dtype=np.int32)
    S = np.stack(
        [sm.dense_scores(codes1[b], codes2[b]) for b in range(B)]
    ).astype(np.float32)
    idx_lists, stats = striped_align(
        S, n, m, mode=GLOBAL, og=0.0, eg=0.0, mesh=mesh,
        block_rows=16, ckpt_rows=64,
    )
    ref = fill_scan(S, n, m, mode=GLOBAL, og=0.0, eg=0.0)
    for b in range(B):
        want = traceback.walk(
            np.asarray(ref.tb[b]), int(n[b]), int(m[b]),
            int(ref.final_state[b]), False,
        )
        assert idx_lists[b][0] == want[0], f"pair {b} idx1"
        assert idx_lists[b][1] == want[1], f"pair {b} idx2"

