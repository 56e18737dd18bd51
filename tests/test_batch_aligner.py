"""BatchAligner end-to-end: bucketed batches must be bit-identical to the
single-pair Aligner (and therefore to the EMBOSS goldens), on both the scan
backend and the tiled pipeline with the plain-JAX fill, and under an
8-device sharded mesh."""

import json
import os

import numpy as np
import pytest

from smithwaterman_tpu import (
    GLOBAL,
    GLOCAL,
    LOCAL,
    Aligner,
    BatchAligner,
    SubstitutionMatrix,
    load_fasta,
)
from smithwaterman_tpu.parallel import DataParallel, make_mesh

DATA = os.path.join(os.path.dirname(__file__), "data", "parity_cases.json")
with open(DATA) as f:
    CASES = json.load(f)

REF_INPUTS = "/root/reference/test/inputs"


def _suite_pairs(k=10):
    pairs = []
    for i in range(k):
        f1 = os.path.join(REF_INPUTS, f"seq{i}.1.fas")
        f2 = os.path.join(REF_INPUTS, f"seq{i}.2.fas")
        if not os.path.exists(f1):
            break
        pairs.append((load_fasta(f1)[0], load_fasta(f2)[0]))
    return pairs


def _short_pairs():
    """Mixed short pairs incl. degenerate and ambiguous cases."""
    return [
        ("HEAGAWGHEE", "PAWHEAE"),
        ("AAAAASSSSSS", "NNNNNSSSSSS"),
        ("", "ACDEF"),
        ("W", "W"),
        ("KKKK", "LLLL"),
        ("ACDJU", "ACDXX"),
        ("MKVS", "MKVS"),
    ]


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
@pytest.mark.parametrize("backend", ["scan", "xla"])
def test_batch_matches_single(mode, backend):
    pairs = _short_pairs()
    single = Aligner(mode=mode)
    ba = BatchAligner(mode=mode, backend=backend)
    got = ba.align_pairs(pairs, retain_all=True)
    for p, r in zip(pairs, got):
        want = single.align(p[0], p[1], True)
        assert r.score == pytest.approx(want.score), p
        assert r.aligned1 == want.aligned1, p
        assert r.aligned2 == want.aligned2, p


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL])
def test_batch_suite_pairs_scan(mode):
    if not os.path.isdir(REF_INPUTS):
        pytest.skip("no reference fixtures")
    pairs = _suite_pairs(6)
    single = Aligner(mode=mode)
    got = BatchAligner(mode=mode, backend="scan").align_pairs(pairs)
    for p, r in zip(pairs, got):
        want = single.align(p[0], p[1], True)
        assert (r.score, r.aligned1, r.aligned2) == (
            want.score,
            want.aligned1,
            want.aligned2,
        )


def test_score_pairs():
    pairs = _short_pairs()
    ba = BatchAligner(mode=LOCAL, backend="scan")
    scores = ba.score_pairs(pairs)
    full = [r.score for r in ba.align_pairs(pairs)]
    np.testing.assert_allclose(scores, full)


def test_scaled_matrix_batch():
    """Integer x10 matrix stays in the exact quarter-unit domain (the CUDA
    fill's int32 path) and stays exact."""
    case = CASES["scaled_local"][0]
    sm = SubstitutionMatrix.blosum62()
    sm.table = sm.table * 10.0
    ba = BatchAligner(
        scoring_matrix=sm, gap_open=100.0, gap_extend=5.0, mode=LOCAL,
        backend="xla",
    )
    assert ba._quarter
    r = ba.align_pairs([(case["seq1"], case["seq2"])], retain_all=False)[0]
    assert r.aligned1 == case["aligned1"]
    assert r.aligned2 == case["aligned2"]


def test_sharded_mesh_8_devices():
    """shard_map over an 8-device CPU mesh, plain-JAX fill per shard."""
    import jax

    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    mesh = make_mesh(8)
    dp = DataParallel(mesh)
    pairs = _short_pairs() * 12  # 84 pairs -> 2 tiles/device after padding
    ba = BatchAligner(
        mode=LOCAL, backend="xla", device_axis=dp
    )
    single = Aligner(mode=LOCAL)
    got = ba.align_pairs(pairs)
    for p, r in zip(pairs, got):
        want = single.align(p[0], p[1], True)
        assert (r.score, r.aligned1, r.aligned2) == (
            want.score,
            want.aligned1,
            want.aligned2,
        )


def test_sharded_mesh_glocal_and_scores():
    """Non-local modes + the score-only path across the 8-device mesh."""
    import jax

    assert len(jax.devices()) == 8
    dp = DataParallel(make_mesh(8))
    pairs = _short_pairs() * 5
    ba = BatchAligner(mode=GLOCAL, backend="xla", device_axis=dp)
    single = Aligner(mode=GLOCAL)
    got = ba.align_pairs(pairs)
    for p, r in zip(pairs, got):
        w = single.align(p[0], p[1], True)
        assert (r.score, r.aligned1, r.aligned2) == (w.score, w.aligned1, w.aligned2)
    scores = ba.score_pairs(pairs)
    np.testing.assert_allclose(scores, [r.score for r in got])


def test_pow2_group_chunking_matches_scan():
    """Buckets spanning multiple tile groups stream through power-of-two
    G chunks (compile-count bound); results identical to the scan path."""
    from smithwaterman_tpu.batch_aligner import _pow2_chunks

    assert _pow2_chunks(1) == [1]
    assert _pow2_chunks(3) == [2, 1]
    assert _pow2_chunks(25) == [8, 8, 8, 1]
    assert sum(_pow2_chunks(1000)) == 1000

    rng = np.random.default_rng(17)
    letters = list("ARNDCQEGHILKMFPSTWYV")
    pairs = [
        ("".join(rng.choice(letters, rng.integers(5, 30))),
         "".join(rng.choice(letters, rng.integers(5, 30))))
        for _ in range(300)
    ]
    # tile_pairs=8 forces G > 1 buckets so the multi-chunk dispatch and
    # the finish-phase stitching ACTUALLY run (with the default tile
    # ladder these short pairs all land in G == 1 buckets)
    want = BatchAligner(backend="scan").align_pairs(pairs)
    for device_walk in (True, False):  # device bundles / host-walk parts
        ba = BatchAligner(
            backend="xla", tile_pairs=8,
            device_walk=device_walk,
        )
        seen_multi = {}
        orig = ba._dispatch_tiled

        def spy(codes1, *a, _orig=orig, _seen=seen_multi, **kw):
            pend = _orig(codes1, *a, **kw)
            _seen.setdefault(pend["kind"], 0)
            _seen[pend["kind"]] += 1
            return pend

        ba._dispatch_tiled = spy
        got = ba.align_pairs(pairs)
        assert seen_multi.get("multi"), f"multi path not exercised: {seen_multi}"
        for g, w in zip(got, want):
            assert (g.aligned1, g.aligned2, g.score) == (
                w.aligned1, w.aligned2, w.score)
    # score-only through the same chunking
    gs = BatchAligner(
        backend="xla", tile_pairs=8
    ).score_pairs(pairs)
    np.testing.assert_array_equal(
        gs, BatchAligner(backend="scan").score_pairs(pairs))


def test_sharded_host_walk_fallback_matches():
    """SWTPU_DEVICE_WALK=0 equivalent: the sharded full-matrix host-walk
    path must match the sharded device-walk default."""
    dp = DataParallel(make_mesh(8))
    pairs = _short_pairs() * 3
    dev = BatchAligner(
        mode=LOCAL, backend="xla", device_axis=dp,
        device_walk=True,
    ).align_pairs(pairs)
    host = BatchAligner(
        mode=LOCAL, backend="xla", device_axis=dp,
        device_walk=False,
    ).align_pairs(pairs)
    for d, h in zip(dev, host):
        assert (d.score, d.aligned1, d.aligned2) == (
            h.score, h.aligned1, h.aligned2)


def test_sharded_pow2_chunking_matches_single():
    """Sharded buckets also stream through pow2 groups-per-shard chunks
    (compile reuse across batch sizes); results identical to Aligner."""
    rng = np.random.default_rng(23)
    letters = list("ARNDCQEGHILKMFPSTWYV")
    pairs = [
        ("".join(rng.choice(letters, rng.integers(5, 30))),
         "".join(rng.choice(letters, rng.integers(5, 30))))
        for _ in range(190)  # Gs=3 at tile 8 x 8 devices -> chunks [2, 1]
    ]
    dp = DataParallel(make_mesh(8))
    ba = BatchAligner(
        backend="xla", device_axis=dp, tile_pairs=8
    )
    seen = {}
    orig = ba._dispatch_bucket

    def spy(bk, so, _o=orig, _s=seen):
        pend = _o(bk, so)
        _s.setdefault(pend["kind"], 0)
        _s[pend["kind"]] += 1
        return pend

    ba._dispatch_bucket = spy
    got = ba.align_pairs(pairs)
    assert seen.get("multi"), f"sharded multi path not exercised: {seen}"
    single = Aligner(mode=LOCAL)
    for p, r in zip(pairs, got):
        w = single.align(p[0], p[1], True)
        assert (r.score, r.aligned1, r.aligned2) == (
            w.score, w.aligned1, w.aligned2)


def test_score_only_fused_all_modes():
    """The fused single-dispatch score-only path (kind=stats_only) must
    match the scan oracle in every mode, including multi-chunk buckets."""
    from smithwaterman_tpu import GLOCAL, LOCAL

    rng = np.random.default_rng(23)
    letters = list("ARNDCQEGHILKMFPSTWYV")
    pairs = _short_pairs() + [
        ("".join(rng.choice(letters, rng.integers(30, 120))),
         "".join(rng.choice(letters, rng.integers(30, 120))))
        for _ in range(20)
    ]
    for mode in (LOCAL, GLOBAL, GLOCAL):
        fused = BatchAligner(
            mode=mode, backend="xla", tile_pairs=8
        ).score_pairs(pairs)
        oracle = BatchAligner(mode=mode, backend="scan").score_pairs(pairs)
        np.testing.assert_array_equal(fused, oracle)
