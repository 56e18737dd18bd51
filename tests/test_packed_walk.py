"""Packed move-stream walk (ops/device_walk.walk_bundle_packed) and the
bulk native string rebuild (ops/reconstruct.py + csrc/reconstruct.cpp).

Must be bit-identical — strings, score, AND spans — to the index-bundle
device walk and the per-pair Python reconstruction
(aligner.reconstruct_alignment, parity: sequence_alignment.rs:469-551).
"""

import numpy as np
import pytest

import smithwaterman_tpu as swt
from smithwaterman_tpu.ops import reconstruct as recon

LETTERS = "ARNDCQEGHILKMFPSTWYVBZX"


def _rand_pairs(rng, n_pairs, lo=3, hi=150):
    def rseq(n):
        return "".join(rng.choice(list(LETTERS), n))

    return [
        (rseq(rng.integers(lo, hi)), rseq(rng.integers(lo, hi)))
        for _ in range(n_pairs)
    ]


def _fields(r):
    return (r.aligned1, r.aligned2, r.score,
            r.start1, r.end1, r.start2, r.end2)


def _aligner(mode, packed, monkeypatch, **kw):
    monkeypatch.setenv("SWTPU_PACKED_WALK", "1" if packed else "0")
    return swt.BatchAligner(mode=mode, backend="xla",
                            device_walk=True, **kw)


@pytest.mark.parametrize("mode", [swt.LOCAL, swt.GLOBAL, swt.GLOCAL])
@pytest.mark.parametrize("retain", [True, False])
def test_packed_matches_index_walk(mode, retain, monkeypatch):
    rng = np.random.default_rng(mode * 2 + retain + 11)
    pairs = _rand_pairs(rng, 13)
    pairs.append(("AAAA", "WWWW"))  # local: nothing aligns (score 0)
    pairs.append(("A", "A"))
    packed = _aligner(mode, True, monkeypatch).align_pairs(
        pairs, retain_all=retain)
    index = _aligner(mode, False, monkeypatch).align_pairs(
        pairs, retain_all=retain)
    for p, i in zip(packed, index):
        assert _fields(p) == _fields(i)


@pytest.mark.parametrize("mode", [swt.LOCAL, swt.GLOBAL, swt.GLOCAL])
def test_native_reconstruct_matches_python_fallback(mode, monkeypatch):
    rng = np.random.default_rng(mode + 31)
    pairs = _rand_pairs(rng, 9, lo=2, hi=80)
    pairs.append(("AAAA", "WWWW"))
    native = _aligner(mode, True, monkeypatch).align_pairs(pairs)
    monkeypatch.setattr(recon, "_lib", lambda: None)
    fallback = _aligner(mode, True, monkeypatch).align_pairs(pairs)
    for a, b in zip(native, fallback):
        assert _fields(a) == _fields(b)


def test_packed_zero_penalties_boundary_rule(monkeypatch):
    # og = eg = 0 exercises normalize_boundary_state inside the device
    # walk's move emission (PARITY.md deviation; the reference crashes)
    rng = np.random.default_rng(5)
    pairs = _rand_pairs(rng, 6, lo=2, hi=40)
    for mode in (swt.LOCAL, swt.GLOBAL, swt.GLOCAL):
        packed = _aligner(mode, True, monkeypatch,
                          gap_open=0.0, gap_extend=0.0).align_pairs(pairs)
        host = swt.BatchAligner(
            mode=mode, gap_open=0.0, gap_extend=0.0,
            backend="xla", device_walk=False,
        ).align_pairs(pairs)
        for p, h in zip(packed, host):
            assert _fields(p) == _fields(h)


def test_packed_multi_chunk_bucket(monkeypatch):
    # enough same-bucket pairs to force pow2 G-chunking (multi pend kind)
    rng = np.random.default_rng(17)
    monkeypatch.setenv("SWTPU_PACKED_WALK", "1")
    pairs = _rand_pairs(rng, 40, lo=100, hi=128)
    ba = swt.BatchAligner(mode=swt.LOCAL, backend="xla",
                          device_walk=True, tile_pairs=8)
    packed = ba.align_pairs(pairs)
    host = swt.BatchAligner(mode=swt.LOCAL, backend="xla",
                            device_walk=False).align_pairs(pairs)
    for p, h in zip(packed, host):
        assert _fields(p) == _fields(h)


@pytest.mark.parametrize("mode", [swt.LOCAL, swt.GLOBAL, swt.GLOCAL])
def test_packed_sharded_matches_host(mode, monkeypatch):
    """The SHARDED packed walk (per-shard move streams, shard-major
    stitch) must match the unsharded host walk field-exact."""
    from smithwaterman_tpu.parallel import DataParallel, make_mesh

    rng = np.random.default_rng(mode + 61)
    pairs = _rand_pairs(rng, 11, lo=3, hi=120)
    pairs.append(("AAAA", "WWWW"))
    monkeypatch.setenv("SWTPU_PACKED_WALK", "1")
    sharded = swt.BatchAligner(
        mode=mode, backend="xla",
        device_axis=DataParallel(make_mesh(8)),
    ).align_pairs(pairs)
    host = swt.BatchAligner(
        mode=mode, backend="xla", device_walk=False,
    ).align_pairs(pairs)
    for d, h in zip(sharded, host):
        assert _fields(d) == _fields(h)


def test_native_reconstruct_available():
    """Guard: the fast path actually loads in this environment (the
    equivalence test above would silently compare fallback-vs-fallback
    otherwise)."""
    assert recon._lib() is not None


@pytest.mark.parametrize("mode", [swt.LOCAL, swt.GLOBAL, swt.GLOCAL])
def test_pooled_walk_matches_host(mode, monkeypatch):
    """The POOLED mega-walk (all buckets' pairs in one loop over a
    concatenated pointer pool) must match the host walk field-exact,
    across a mixed-bucket batch."""
    rng = np.random.default_rng(mode + 5)
    # spread lengths over several buckets so one pool holds many chunks
    pairs = (_rand_pairs(rng, 8, lo=3, hi=60)
             + _rand_pairs(rng, 8, lo=70, hi=140)
             + _rand_pairs(rng, 6, lo=150, hi=250))
    pairs.append(("AAAA", "WWWW"))
    monkeypatch.setenv("SWTPU_PACKED_WALK", "1")
    monkeypatch.setenv("SWTPU_POOLED_WALK", "1")
    pooled = swt.BatchAligner(mode=mode, backend="xla",
                              tile_pairs=8).align_pairs(pairs)
    host = swt.BatchAligner(mode=mode, backend="xla",
                            device_walk=False).align_pairs(pairs)
    for p, h in zip(pooled, host):
        assert _fields(p) == _fields(h)


def test_pooled_walk_budget_splits_pools(monkeypatch):
    """A tiny HBM budget forces multiple pools per run; results must be
    unchanged and every chunk must map to some pool."""
    rng = np.random.default_rng(77)
    pairs = _rand_pairs(rng, 24, lo=100, hi=128)
    monkeypatch.setenv("SWTPU_PACKED_WALK", "1")
    monkeypatch.setenv("SWTPU_POOLED_WALK", "1")
    monkeypatch.setenv("SWTPU_TB_HBM_BYTES", str(600 << 10))
    ba = swt.BatchAligner(mode=swt.LOCAL, backend="xla",
                          tile_pairs=8)
    pooled = ba.align_pairs(pairs)
    host = swt.BatchAligner(mode=swt.LOCAL, backend="xla",
                            device_walk=False).align_pairs(pairs)
    for p, h in zip(pooled, host):
        assert _fields(p) == _fields(h)


def test_pooled_off_restores_per_chunk_walks(monkeypatch):
    monkeypatch.setenv("SWTPU_PACKED_WALK", "1")
    monkeypatch.setenv("SWTPU_POOLED_WALK", "0")
    rng = np.random.default_rng(13)
    pairs = _rand_pairs(rng, 10)
    per_chunk = swt.BatchAligner(mode=swt.GLOCAL,
                                 backend="xla").align_pairs(pairs)
    monkeypatch.setenv("SWTPU_POOLED_WALK", "1")
    pooled = swt.BatchAligner(mode=swt.GLOCAL,
                              backend="xla").align_pairs(pairs)
    for a, b in zip(per_chunk, pooled):
        assert _fields(a) == _fields(b)


def test_pooled_walk_no_retrace_on_shuffled_workload(monkeypatch):
    """The pooled walk's jit caches on the ORDERED tuple of chunk shapes.
    Two load-bearing determinism rules keep that cache hot (batch_aligner:
    buckets dispatch in shape order; chunks sort by shape inside a flush):
    without them, a shuffled call of the SAME workload re-traces the
    pooled program every time.  This pins both rules: a shuffled second
    dispatch must add ZERO new cache entries.  The pooled FILL program
    (ops/batch.fill_many) keys on the same composition — pin it too."""
    from smithwaterman_tpu.ops import batch as batch_ops
    from smithwaterman_tpu.ops import device_walk

    monkeypatch.setenv("SWTPU_PACKED_WALK", "1")
    monkeypatch.setenv("SWTPU_POOLED_WALK", "1")
    monkeypatch.setenv("SWTPU_POOLED_FILL", "1")
    rng = np.random.default_rng(7)
    # spread over several buckets so the pool really has a composition
    pairs = _rand_pairs(rng, 24, lo=3, hi=250)
    ba = swt.BatchAligner(mode=swt.LOCAL, backend="xla",
                          device_walk=True)
    def _walk_cache():
        return device_walk.walk_bundle_pooled._cache_size()

    r1 = ba.align_pairs(pairs)
    size1 = _walk_cache()
    fsize1 = batch_ops.fill_many._cache_size()
    assert size1 > 0  # the pooled path actually ran
    assert fsize1 > 0
    perm = rng.permutation(len(pairs))
    shuffled = [pairs[int(i)] for i in perm]
    r2 = ba.align_pairs(shuffled)
    size2 = _walk_cache()
    assert batch_ops.fill_many._cache_size() == fsize1, (
        "shuffled same-workload dispatch re-traced the pooled fill"
    )
    assert size2 == size1, (
        "shuffled same-workload dispatch re-traced the pooled walk "
        f"({size1} -> {size2} cache entries): a composition-determinism "
        "rule in batch_aligner (bucket dispatch order / chunk sort) broke"
    )
    # and composition order-independence must not change results
    for i, k in enumerate(perm):
        assert _fields(r2[i]) == _fields(r1[int(k)])


def test_pooled_fill_budget_rounds(monkeypatch):
    """When staged pointer bytes pass the GLOBAL pointer budget, fills and
    walks flush in rounds (fill #1, walks #1, fill #2, ...) and results
    are unchanged.  Budget is sized over the largest single chunk (so no
    longseq rerouting) but under the workload total (so >= 2 rounds)."""
    rng = np.random.default_rng(13)
    pairs = _rand_pairs(rng, 20, lo=100, hi=127) + _rand_pairs(
        rng, 20, lo=220, hi=255
    )
    # tile_pairs=8: chunks are (2|1)*8-pair groups; largest single chunk
    # is 16*256*256 = 1.05 MB of pointers (under budget, so no longseq
    # rerouting: group_tb = 8*256*256 = 524 kB), total ~2 MB (over)
    monkeypatch.setenv("SWTPU_TB_HBM_BYTES", str(1_200_000))
    ba = swt.BatchAligner(mode=swt.GLOCAL, backend="xla",
                          device_walk=True, tile_pairs=8)
    flushes = []
    orig = ba._flush_fills
    ba._flush_fills = lambda: (flushes.append(1), orig())[-1]
    pooled = ba.align_pairs(pairs)
    assert len(flushes) >= 2, "budget should force multiple fill rounds"
    monkeypatch.setenv("SWTPU_TB_HBM_BYTES", str(4 << 30))
    monkeypatch.setenv("SWTPU_POOLED_FILL", "0")
    plain = swt.BatchAligner(mode=swt.GLOCAL, backend="xla",
                             device_walk=True, tile_pairs=8).align_pairs(pairs)
    for a, b in zip(pooled, plain):
        assert _fields(a) == _fields(b)
