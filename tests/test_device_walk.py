"""On-device traceback walk (ops/device_walk.py) parity.

The device walk must be bit-identical to the host walk
(ops/traceback.walk_tiled, cited to sequence_alignment.rs:349-386) in all
three modes, including the local nothing-aligned case and the og=eg=0
boundary normalization.
"""

import numpy as np
import pytest

import smithwaterman_tpu as swt
from smithwaterman_tpu.ops import device_walk

LETTERS = "ARNDCQEGHILKMFPSTWYVBZX"


def _rand_pairs(rng, n_pairs, lo=3, hi=150):
    def rseq(n):
        return "".join(rng.choice(list(LETTERS), n))

    return [
        (rseq(rng.integers(lo, hi)), rseq(rng.integers(lo, hi)))
        for _ in range(n_pairs)
    ]


@pytest.mark.parametrize("mode", [swt.LOCAL, swt.GLOBAL, swt.GLOCAL])
def test_device_walk_matches_host_walk(mode):
    rng = np.random.default_rng(mode + 7)
    pairs = _rand_pairs(rng, 11)
    pairs.append(("AAAA", "WWWW"))  # local: nothing aligns (score 0)
    dev = swt.BatchAligner(
        mode=mode, backend="xla", device_walk=True
    ).align_pairs(pairs)
    host = swt.BatchAligner(
        mode=mode, backend="xla", device_walk=False
    ).align_pairs(pairs)
    for d, h in zip(dev, host):
        assert (d.aligned1, d.aligned2, d.score) == (
            h.aligned1, h.aligned2, h.score)


def test_device_walk_zero_penalties_boundary_rule():
    # og = eg = 0 exercises normalize_boundary_state (the reference
    # crashes here; we walk the boundary gap chain — PARITY.md deviation)
    rng = np.random.default_rng(3)
    pairs = _rand_pairs(rng, 6, lo=2, hi=40)
    for mode in (swt.LOCAL, swt.GLOBAL, swt.GLOCAL):
        dev = swt.BatchAligner(
            mode=mode, gap_open=0.0, gap_extend=0.0,
            backend="xla", device_walk=True,
        ).align_pairs(pairs)
        host = swt.BatchAligner(
            mode=mode, gap_open=0.0, gap_extend=0.0,
            backend="xla", device_walk=False,
        ).align_pairs(pairs)
        for d, h in zip(dev, host):
            assert (d.aligned1, d.aligned2, d.score) == (
                h.aligned1, h.aligned2, h.score)


def test_device_walk_score_only_unaffected():
    rng = np.random.default_rng(5)
    pairs = _rand_pairs(rng, 5)
    ba = swt.BatchAligner(backend="xla", device_walk=True)
    s = ba.score_pairs(pairs)
    ref = swt.BatchAligner(backend="scan").score_pairs(pairs)
    np.testing.assert_array_equal(s, ref)


def test_decode_bundle_roundtrip():
    B, L = 4, 10
    stats = np.arange(B * 8, dtype=np.float32).reshape(B, 8)
    i1 = np.full((L, B), device_walk.SENTINEL, np.int16)
    i2 = np.full((L, B), device_walk.SENTINEL, np.int16)
    i1[:3, 1] = [5, -1, 4]
    i2[:3, 1] = [7, 6, -1]
    s2, o1, o2 = device_walk.decode_bundle(stats, np.stack([i1, i2]))
    np.testing.assert_array_equal(s2, stats)
    a, b = device_walk.pair_path(o1, o2, 1)
    assert a == [4, -1, 5] and b == [-1, 6, 7]
    a, b = device_walk.pair_path(o1, o2, 0)
    assert a == [] and b == []


def test_walk_bundle_idx_dtype():
    """Indices pack as int16 when the padded lengths allow (halves the
    device->host transfer, mostly SENTINEL padding)."""
    import jax.numpy as jnp

    tb = jnp.zeros((1, 8, 8, 8), jnp.uint8)
    st = jnp.zeros((1, 8, 8), jnp.float32)
    n = jnp.full(8, 4, jnp.int32)
    m = jnp.full(8, 4, jnp.int32)
    stats, idx = device_walk.walk_bundle(tb, st, n, m, mode=swt.LOCAL, L=18)
    assert idx.dtype == jnp.int16 and stats.dtype == jnp.float32


def test_walk_bundle_int32_branch_matches_host_walk():
    """Padded length >= 2**15 keeps the index payload int32 (the int16
    pack would truncate); the long-axis walk must stay bit-identical to
    the host walker at row indices beyond int16 range."""
    import jax.numpy as jnp

    from smithwaterman_tpu.ops import traceback as tbmod

    G, T, NP, MP = 1, 8, 2**15 + 2048, 64
    rng = np.random.default_rng(17)
    # packed 2-bit prev fields constrained to real states (0..2): random
    # pointer mazes terminate (every step decreases i and/or j)
    fields = rng.integers(0, 3, size=(NP, T, MP, 3), dtype=np.uint8)
    tb_np = fields[..., 0] | (fields[..., 1] << 2) | (fields[..., 2] << 4)
    n = rng.integers(NP - 100, NP + 1, size=T).astype(np.int32)
    n[0] = NP  # row indices up to NP-1 > 32767: int16 would truncate
    m = rng.integers(MP - 16, MP, size=T).astype(np.int32)
    st = np.zeros((G, T, 8), np.float32)
    st[:, :, 3] = 1.0  # finalM wins the first-max state tie -> state 0
    L = device_walk.max_path_len(NP, MP)
    stats, idx = device_walk.walk_bundle(
        jnp.asarray(tb_np[None]), jnp.asarray(st), jnp.asarray(n),
        jnp.asarray(m), mode=swt.GLOBAL, L=L,
    )
    assert idx.dtype == jnp.int32
    _, i1, i2 = device_walk.decode_bundle(stats, idx)
    for k in range(T):
        a, b = device_walk.pair_path(i1, i2, k)
        ra, rb = tbmod.walk_tiled(
            tb_np[:, k, :], int(n[k]), int(m[k]), 0, local=False)
        assert a == ra and b == rb
    a0, _ = device_walk.pair_path(i1, i2, 0)
    assert max(a0) == NP - 1 > 2**15 - 1  # int16 would have truncated


def test_hbm_budget_routes_large_buckets_to_device_walk():
    """Under the device walk, former longseq-sized buckets stay on the
    plain path until the pointer array exceeds the HBM budget (the
    host-transfer cost longseq dodged is gone); outputs identical."""
    rng = np.random.default_rng(11)
    pairs = _rand_pairs(rng, 4, lo=120, hi=200)
    plain = swt.BatchAligner(backend="xla")
    assert plain.device_walk
    plain.tb_hbm_bytes = 1 << 40  # everything fits: device-walk route
    forced = swt.BatchAligner(backend="xla")
    forced.tb_hbm_bytes = 1  # nothing fits: longseq route
    a = plain.align_pairs(pairs)
    b = forced.align_pairs(pairs)
    for x, y in zip(a, b):
        assert (x.aligned1, x.aligned2, x.score) == (
            y.aligned1, y.aligned2, y.score)


def test_explicit_longseq_cells_still_forces_longseq():
    rng = np.random.default_rng(13)
    pairs = _rand_pairs(rng, 3, lo=100, hi=160)
    forced = swt.BatchAligner(
        backend="xla", longseq_cells=64 * 64
    )
    plain = swt.BatchAligner(backend="xla")
    a = forced.align_pairs(pairs)
    b = plain.align_pairs(pairs)
    for x, y in zip(a, b):
        assert (x.aligned1, x.aligned2, x.score) == (
            y.aligned1, y.aligned2, y.score)


def test_sharded_device_walk_zero_penalties():
    """og=eg=0 (normalize_boundary_state territory) through the SHARDED
    device walk must match the unsharded host walk."""
    from smithwaterman_tpu.parallel import DataParallel, make_mesh

    rng = np.random.default_rng(41)
    pairs = _rand_pairs(rng, 6, lo=2, hi=40)
    for mode in (swt.LOCAL, swt.GLOBAL, swt.GLOCAL):
        sharded = swt.BatchAligner(
            mode=mode, gap_open=0.0, gap_extend=0.0,
            backend="xla",
            device_axis=DataParallel(make_mesh(8)),
        ).align_pairs(pairs)
        host = swt.BatchAligner(
            mode=mode, gap_open=0.0, gap_extend=0.0,
            backend="xla", device_walk=False,
        ).align_pairs(pairs)
        for d, h in zip(sharded, host):
            assert (d.aligned1, d.aligned2, d.score) == (
                h.aligned1, h.aligned2, h.score)
