"""Banded fill: exact vs the full DP when the band covers the matrix/path;
clean BandExceeded signal when the path leaves the band."""

import numpy as np
import pytest

from smithwaterman_tpu.config import CELL_MATCH, GLOBAL, GLOCAL, LOCAL
from smithwaterman_tpu.matrices import SubstitutionMatrix
from smithwaterman_tpu.ops import banded, batch, traceback

RNG = np.random.default_rng(31)
OG, EG = -10.0, -0.5
SM = SubstitutionMatrix.blosum62()


def _ref(codes1, codes2, mode):
    S = SM.dense_scores(codes1, codes2)[None].astype(np.float32)
    n = np.array([len(codes1)], np.int32)
    m = np.array([len(codes2)], np.int32)
    return batch.fill_scan(S, n, m, mode=mode, og=OG, eg=EG)


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
def test_full_width_band_exact(mode):
    """Band covering the whole matrix == the exact DP, path included."""
    codes1 = RNG.integers(0, 24, size=77).astype(np.int32)
    codes2 = RNG.integers(0, 24, size=90).astype(np.int32)
    idx1, idx2, score, edge = banded.align_banded(
        codes1, codes2, SM.table, mode=mode, og=OG, eg=EG, band=512,
    )
    assert not edge
    ref = _ref(codes1, codes2, mode)
    tbv = np.asarray(ref.tb[0])
    if mode == LOCAL:
        assert score == pytest.approx(float(ref.best[0]))
        want = traceback.walk(
            tbv, int(ref.best_i[0]), int(ref.best_j[0]), CELL_MATCH, True
        )
    else:
        assert score == pytest.approx(float(ref.final[0][int(ref.final_state[0])]))
        want = traceback.walk(tbv, 77, 90, int(ref.final_state[0]), False)
    assert (idx1, idx2) == want


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL])
def test_narrow_band_similar_sequences(mode):
    """Similar sequences: a narrow band reproduces the full-DP result."""
    base = RNG.integers(0, 20, size=600).astype(np.int32)
    codes1 = base.copy()
    codes2 = base.copy()
    codes2[100] = (codes2[100] + 1) % 20        # mismatch
    codes2 = np.delete(codes2, slice(300, 303))  # small gap
    idx1, idx2, score, edge = banded.align_banded(
        codes1, codes2, SM.table, mode=mode, og=OG, eg=EG, band=128,
    )
    ref = _ref(codes1, codes2, mode)
    tbv = np.asarray(ref.tb[0])
    if mode == LOCAL:
        assert score == pytest.approx(float(ref.best[0]))
        want = traceback.walk(
            tbv, int(ref.best_i[0]), int(ref.best_j[0]), CELL_MATCH, True
        )
    else:
        assert score == pytest.approx(float(ref.final[0][int(ref.final_state[0])]))
        want = traceback.walk(
            tbv, len(codes1), len(codes2), int(ref.final_state[0]), False
        )
    assert (idx1, idx2) == want


def test_band_constrained_flagged():
    """A path needing a detour wider than the band is flagged (banded DP is
    a heuristic: the score differs from the full DP and edge_touched warns
    the caller to widen or fall back)."""
    # equal lengths (so the band stays narrow), but the alignment needs a
    # ~200-column detour: seq2 = 200 junk then seq1's first 400 residues
    a = RNG.integers(0, 20, size=600).astype(np.int32)
    junk = ((a[:200] + 7) % 20).astype(np.int32)
    codes1 = a
    codes2 = np.concatenate([junk, a[:400]]).astype(np.int32)
    idx1, idx2, score, edge = banded.align_banded(
        codes1, codes2, SM.table, mode=GLOCAL, og=OG, eg=EG, band=128,
    )
    ref = _ref(codes1, codes2, GLOCAL)
    full = float(ref.final[0][int(ref.final_state[0])])
    assert score < full  # the narrow band constrained the result (heuristic)

    # double-band verification recovers the exact result automatically
    i1, i2, vscore, used = banded.align_banded_verified(
        codes1, codes2, SM.table, mode=GLOCAL, og=OG, eg=EG, band=128,
    )
    assert vscore == pytest.approx(full)
    want = traceback.walk(
        np.asarray(ref.tb[0]), len(codes1), len(codes2),
        int(ref.final_state[0]), False,
    )
    assert (i1, i2) == want


def test_verified_accepts_without_edge_free_walk():
    """Regression: a full-span near-diagonal path necessarily grazes the
    anchored band's corner lanes (band_offsets slope <= 1), so acceptance
    must be on W-vs-2W score agreement — not on an edge-free walk, which
    would always widen to the cap."""
    rng = np.random.default_rng(3)
    n = 512
    a = rng.integers(0, 20, size=n).astype(np.int32)
    b = a.copy()
    b[::17] = (b[::17] + 5) % 20  # point mutations, no drift
    idx1, idx2, score, used = banded.align_banded_verified(
        a, b, SM.table, mode=LOCAL, og=OG, eg=EG, band=128, max_band=512,
    )
    assert used == 256  # accepted at the first doubling, not the cap
    ref = _ref(a, b, LOCAL)
    assert score == pytest.approx(float(ref.best[0]))


def test_aligner_banded_api():
    """Aligner.align_banded: strings + score equal the exact engine when
    the band suffices."""
    from smithwaterman_tpu import Aligner, LOCAL as L

    rng = np.random.default_rng(8)
    letters = "ACDEFGHIKLMNPQRSTVWY"
    s1 = "".join(letters[i] for i in rng.integers(0, 20, 300))
    l = list(s1)
    l[50] = "W"
    del l[200:203]
    s2 = "".join(l)
    a = Aligner(mode=L)
    rb = a.align_banded(s1, s2, band=128)
    rf = a.align(s1, s2)
    assert (rb.score, rb.aligned1, rb.aligned2) == (rf.score, rf.aligned1, rf.aligned2)


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
def test_tiny_sequences(mode):
    """Band machinery degrades cleanly to the full DP for tiny inputs."""
    codes1 = RNG.integers(0, 20, size=5).astype(np.int32)
    codes2 = RNG.integers(0, 20, size=3).astype(np.int32)
    idx1, idx2, score, edge = banded.align_banded(
        codes1, codes2, SM.table, mode=mode, og=OG, eg=EG, band=64,
    )
    ref = _ref(codes1, codes2, mode)
    if mode == LOCAL:
        assert score == pytest.approx(float(ref.best[0]))
    else:
        assert score == pytest.approx(
            float(ref.final[0][int(ref.final_state[0])])
        )


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
def test_batched_banded_matches_per_pair(mode):
    """8 pairs with distinct lengths/offsets in one banded fill must each
    reproduce the single-pair banded result exactly."""
    sm = SubstitutionMatrix.blosum62()
    pairs = []
    for k in range(8):
        n = int(RNG.integers(40, 200))
        m = n + int(RNG.integers(0, 60))
        base = RNG.integers(0, 20, size=max(n, m) + 10).astype(np.int32)
        c1 = base[:n].copy()
        c2 = base[5 : 5 + m].copy()  # similar but offset sequences
        mut = RNG.integers(0, m, size=max(1, m // 10))
        c2[mut] = RNG.integers(0, 20, size=len(mut))
        pairs.append((c1, c2))

    got = banded.align_banded_batch(
        pairs, sm.table, mode=mode, og=OG, eg=EG, band=128
    )
    for k, (c1, c2) in enumerate(pairs):
        want = banded.align_banded(
            c1, c2, sm.table, mode=mode, og=OG, eg=EG, band=128,
        )
        # NB: the batch uses one shared W; recompute the single result at
        # the same W by batching alone
        same_w = banded.align_banded_batch(
            [(c1, c2)], sm.table, mode=mode, og=OG, eg=EG, band=128,
        )[0]
        assert got[k][2] == same_w[2], f"pair {k} score"
        assert got[k][0] == same_w[0], f"pair {k} idx1"
        assert got[k][1] == same_w[1], f"pair {k} idx2"
        # and the per-pair path agrees with the standalone API on score
        assert got[k][2] == want[2] or got[k][3] or want[3], f"pair {k}"


def test_full_width_band_degenerate_penalties():
    """og=eg=0 through the banded fill + on-device walker: the boundary-
    state normalization must keep the walk in-matrix (was: corrupt
    negative indices / band-exceeded flags)."""
    codes1 = RNG.integers(0, 24, size=40).astype(np.int32)
    codes2 = RNG.integers(0, 24, size=90).astype(np.int32)
    idx1, idx2, score, edge = banded.align_banded(
        codes1, codes2, SM.table, mode=GLOBAL, og=0.0, eg=0.0, band=256,
    )
    S = SM.dense_scores(codes1, codes2)[None].astype(np.float32)
    n = np.array([len(codes1)], np.int32)
    m = np.array([len(codes2)], np.int32)
    ref = batch.fill_scan(S, n, m, mode=GLOBAL, og=0.0, eg=0.0)
    want = traceback.walk(
        np.asarray(ref.tb[0]), len(codes1), len(codes2),
        int(ref.final_state[0]), False,
    )
    assert score == pytest.approx(float(np.max(np.asarray(ref.final[0]))))
    assert (idx1, idx2) == want


def test_pallas_banded_scores_match_gather_oracle():
    """The on-device banded scores (_banded_scores) must equal a plain
    per-cell table lookup across offsets and the seq2 mask."""
    import jax.numpy as jnp

    from smithwaterman_tpu.ops.banded import TBP, _banded_scores, band_offsets

    rng = np.random.default_rng(4)
    table = np.asarray(
        SubstitutionMatrix.blosum62().table, np.float32)
    K = table.shape[0]
    NP, W = 64, 128
    ns = [64, 50, 33, 8, 64, 1, 17, 40]
    ms = [160, 40, 150, 128, 9, 100, 13, 127]
    Mmax = max(ms)
    c1b = rng.integers(0, K, size=(TBP, NP)).astype(np.int32)
    c2b = np.zeros((TBP, Mmax), np.int32)
    offr = np.zeros((TBP, NP), np.int32)
    for t in range(TBP):
        c2b[t, :ms[t]] = rng.integers(0, K, size=ms[t])
        off = band_offsets(ns[t], ms[t], min(W, ms[t]))
        full = np.zeros(NP + 1, np.int32)
        full[: ns[t] + 1] = off
        full[ns[t] + 1:] = off[-1]
        offr[t] = full[1:]
    got = np.asarray(_banded_scores(
        jnp.asarray(c1b), jnp.asarray(c2b), jnp.asarray(table),
        jnp.asarray(offr), jnp.asarray(np.asarray(ms, np.int32)), W=W,
    ))
    want = np.zeros((TBP, NP, W), np.float32)
    for t in range(TBP):
        for r in range(NP):
            for w in range(W):
                col = offr[t, r] + w
                if col < ms[t]:
                    want[t, r, w] = table[c1b[t, r], c2b[t, col]]
    np.testing.assert_array_equal(got, want)
