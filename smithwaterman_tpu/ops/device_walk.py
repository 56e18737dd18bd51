"""On-device traceback walk: pointers never leave the device.

The host walk (ops/traceback.py + csrc/traceback.cpp) needs the packed
pointer matrix on the host — a device->host copy of NP*MP bytes per pair,
~80 MB for the 100-pair reference suite, for walks that touch O(n+m) of
them.

This module walks the pointers ON DEVICE instead, all pairs of a bucket in
lockstep inside one ``lax.while_loop``, and ships back only the bundled
result: per-pair aligned-index paths (O(n+m) int32) plus the stats block —
ONE device->host array per bucket.  The reference's GPU engine makes the
same call: its traceback kernel walks flags on device and reads back just
the index arrays (opencl_sequence_alignment.rs:180-322, :765-795).

Semantics are bit-identical to ops/traceback.walk_tiled (itself cited to
sequence_alignment.rs:349-386): interior pointers from the tiled uint8
array (cell (i,j) at tb[i-1, j-1]), closed-form boundary pointers, the
normalize_boundary_state og==eg==0 rule, local STOP-at-zero, and the
first-max final-state tie for global/glocal (np.argmax parity).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CELL_GAPINX, CELL_GAPINY, CELL_MATCH, CELL_STOP, LOCAL

SENTINEL = -3  # path rows past a pair's end (distinct from -1 = gap)


def max_path_len(np_pad: int, mp_pad: int) -> int:
    """Walk-buffer row count for a bucket: the longest possible path."""
    return np_pad + mp_pad + 2


def _walk_starts(stats, n, m, mode: int):
    """Shared walk-start setup: per-pair start cell, start state, and the
    already-done mask (local zero-score pairs).  ``stats`` is the fill's
    stats block, any leading shape collapsing to B pairs."""
    st = stats.reshape(-1, stats.shape[-1])
    B = st.shape[0]
    if mode == LOCAL:
        i0 = st[:, 1].astype(jnp.int32)
        j0 = st[:, 2].astype(jnp.int32)
        s0 = jnp.full((B,), CELL_MATCH, jnp.int32)
        done0 = st[:, 0] <= 0.0  # nothing aligned (rs:346-348)
        i0 = jnp.where(done0, 0, i0)
        j0 = jnp.where(done0, 0, j0)
    else:
        i0 = n.astype(jnp.int32)
        j0 = m.astype(jnp.int32)
        s0 = jnp.argmax(st[:, 3:6], axis=1).astype(jnp.int32)  # first max
        done0 = jnp.zeros((B,), bool)
    return st, i0, j0, s0, done0


def _walk_ctx(tb):
    """Loop-invariant walk inputs, computed ONCE outside the while body.

    tb.reshape(-1) inside the loop body is NOT hoisted by XLA: it
    re-materializes the full pointer array every iteration (~100 us/iter
    for a 33 MB bucket — 12x the rest of the body, scripts/walk_lab.py
    --deep).  Callers build the context before the loop and pass it in.
    """
    G, NP, T, MP = tb.shape
    B = G * T
    flat = tb.reshape(-1)
    b = jnp.arange(B, dtype=jnp.int32)
    return flat, b // T, b % T, NP, T, MP


def _walk_step(ctx, step, i, j, s, done, *, local: bool):
    """One lockstep walk step for every pair: returns
    (emit, s_norm, r1, r2, ni, nj, ns, ndone).  Semantics are bit-identical
    to ops/traceback.walk_tiled (see module docstring).  ``ctx`` is
    :func:`_walk_ctx`'s loop-invariant tuple."""
    flat, g, t, NP, T, MP = ctx
    # normalize_boundary_state (ops/traceback.py:233-249)
    s = jnp.where((j == 0) & (i > 0), CELL_GAPINY,
                  jnp.where((i == 0) & (j > 0), CELL_GAPINX, s))
    interior = (i >= 1) & (j >= 1)
    ii = jnp.clip(i - 1, 0, NP - 1)
    jj = jnp.clip(j - 1, 0, MP - 1)
    ptr = flat[((g * NP + ii) * T + t) * MP + jj].astype(jnp.int32)
    prev_in = (ptr >> (2 * s)) & 3
    # _boundary_prev closed form (ops/traceback.py:215-230)
    origin = (i == 0) & (j == 0)
    row0 = (i == 0) & (j > 0)
    bstate = jnp.where(origin, CELL_MATCH,
                       jnp.where(row0, CELL_GAPINX, CELL_GAPINY))
    bprev = jnp.where(local & (s == bstate), CELL_STOP, bstate)
    prev = jnp.where(interior, prev_in, bprev)
    stop = local & (prev == CELL_STOP)
    emit = (~done) & (~stop)
    r1 = jnp.where(s == CELL_GAPINX, -1, i - 1)
    r2 = jnp.where(s == CELL_GAPINY, -1, j - 1)
    ni = jnp.where(emit & (s != CELL_GAPINX), i - 1, i)
    nj = jnp.where(emit & (s != CELL_GAPINY), j - 1, j)
    ns = jnp.where(emit, prev, s)
    ndone = done | stop | ((ni == 0) & (nj == 0))
    return emit, s, r1, r2, ni, nj, ns, ndone


@partial(jax.jit, static_argnames=("mode", "L"))
def walk_bundle(tb, stats, n, m, *, mode: int, L: int):
    """Walk every pair of a bucket on device.

    Args:
      tb:    (G, NP, T, MP) uint8 interior pointers (ops/fill.py layout).
      stats: (B, 8) f32 fill stats (best, best_i, best_j, finals...).
      n, m:  (B,) int32 true lengths (B = G*T).
      mode:  alignment mode (static).
      L:     max path length (static; use max_path_len(NP, MP)).

    Returns ``(stats (B, 8) f32, idx (2, L, B))``: idx[0]/idx[1] are the
    aligned index rows in walk order (host reverses), SENTINEL past each
    pair's path end.  idx is int16 when both padded lengths fit (halves
    the device->host transfer, which is mostly SENTINEL padding — L is
    the worst-case path length), int32 otherwise.

    Prefer :func:`walk_bundle_packed` (4 moves/byte — an 8-16x smaller
    transfer); this index form remains for consumers that want explicit
    index rows.
    """
    G, NP, T, MP = tb.shape
    B = G * T
    local = mode == LOCAL
    st, i0, j0, s0, done0 = _walk_starts(stats, n, m, mode)

    out1 = jnp.full((L, B), SENTINEL, jnp.int32)
    out2 = jnp.full((L, B), SENTINEL, jnp.int32)
    ctx = _walk_ctx(tb)

    def cond(c):
        step, done = c[0], c[4]
        return (step < L) & jnp.any(~done)

    def body(c):
        step, i, j, s, done, o1, o2 = c
        emit, s, r1, r2, ni, nj, ns, ndone = _walk_step(
            ctx, step, i, j, s, done, local=local
        )
        o1 = jax.lax.dynamic_update_index_in_dim(
            o1, jnp.where(emit, r1, SENTINEL), step, 0)
        o2 = jax.lax.dynamic_update_index_in_dim(
            o2, jnp.where(emit, r2, SENTINEL), step, 0)
        return step + 1, ni, nj, ns, ndone, o1, o2

    _, _, _, _, _, out1, out2 = jax.lax.while_loop(
        cond, body, (jnp.int32(0), i0, j0, s0, done0, out1, out2)
    )
    idx = jnp.stack([out1, out2])  # (2, L, B)
    if max(NP, MP) < 2**15:  # indices (and SENTINEL) fit int16
        idx = idx.astype(jnp.int16)
    return st[:, :8].astype(jnp.float32), idx


@partial(jax.jit, static_argnames=("mode", "L"))
def walk_bundle_packed(tb, stats, n, m, *, mode: int, L: int):
    """Walk every pair of a bucket on device, shipping back packed MOVES.

    The emitted per-step STATE (0..2) fully determines the path given the
    start cell (which the host already has from ``stats``/lengths), so the
    bundle is just 2 bits per step — an 8-16x smaller device->host
    transfer than the index form, and the host replays it straight into
    alignment strings (csrc/reconstruct.cpp).

    Returns ``(stats (B, 8) f32, cnt (B,) int32, moves (ceil(L/4), B)
    uint8)``: move ``t`` of pair ``k`` is ``(moves[t >> 2, k] >>
    ((t & 3) * 2)) & 3``, valid for ``t < cnt[k]`` (walk order: t = 0 is
    the path's END cell).
    """
    G, NP, T, MP = tb.shape
    B = G * T
    local = mode == LOCAL
    st, i0, j0, s0, done0 = _walk_starts(stats, n, m, mode)

    Lp = -(-L // 4) * 4
    out_s = jnp.zeros((Lp, B), jnp.uint8)
    cnt0 = jnp.zeros((B,), jnp.int32)
    ctx = _walk_ctx(tb)

    def cond(c):
        step, done = c[0], c[4]
        return (step < L) & jnp.any(~done)

    def body(c):
        step, i, j, s, done, cnt, o = c
        emit, s, _, _, ni, nj, ns, ndone = _walk_step(
            ctx, step, i, j, s, done, local=local
        )
        # boundary short-circuit: once a pair reaches i==0 or j==0 its
        # remaining moves are a deterministic terminal-gap run (GAPX
        # along the top row, GAPY along the left column), so stop
        # emitting — the rebuild re-derives the stop cell by replay and
        # synthesizes the tail (csrc/reconstruct.cpp).  Global pairs
        # with mismatched lengths walked thousands of these one per
        # iteration.  (LOCAL streams never emitted on the boundary —
        # this only retires iterations, the stream bytes are identical.)
        o = jax.lax.dynamic_update_index_in_dim(
            o, jnp.where(emit, s, 0).astype(jnp.uint8), step, 0)
        ndone = ndone | (ni == 0) | (nj == 0)
        return step + 1, ni, nj, ns, ndone, cnt + emit, o

    _, _, _, _, _, cnt, out_s = jax.lax.while_loop(
        cond, body, (jnp.int32(0), i0, j0, s0, done0, cnt0, out_s)
    )
    r = out_s.reshape(Lp // 4, 4, B)
    moves = r[:, 0] | (r[:, 1] << 2) | (r[:, 2] << 4) | (r[:, 3] << 6)
    return st[:, :8].astype(jnp.float32), cnt, moves


@partial(jax.jit, static_argnames=("mode", "L"))
def walk_bundle_pooled(tbs, statss, ns, ms, *, mode: int, L: int):
    """Walk the pairs of MANY bucket-chunks in ONE lockstep loop.

    The while_loop's per-step cost is B-INDEPENDENT (~34 us fixed per
    step whether 128 or 4096 pairs ride the loop — scripts/
    packed_walk_ab.py), so walking each chunk separately pays
    sum-of-path-lengths while one pooled walk pays only the MAX path
    length.  The chunks' pointer arrays are concatenated into one flat
    pool and each pair carries its own flat base offset / row stride /
    clip bounds; the program specializes on the chunk-shape composition
    (one compile per distinct workload composition).

    Args: tuples of per-chunk ``tb (G, NP, T, MP) u8``, ``stats``,
    ``n (B,)``, ``m (B,)``.  L covers the largest chunk
    (max_path_len, pow2-rounded by the caller).

    Returns ``(cnt (Btot,) i32, moves (ceil(L/4), Btot) u8)`` with
    walk_bundle_packed's exact move contract; pair columns follow chunk
    order (caller tracks per-chunk column offsets).  Stats stay with the
    caller per chunk.
    """
    local = mode == LOCAL
    total = sum(int(np.prod(tb.shape)) for tb in tbs)
    if total >= 1 << 31:  # flat index arithmetic is int32
        raise ValueError(
            f"pooled pointer arrays total {total} bytes >= 2^31; the "
            "caller must budget pools below the int32 gather limit"
        )
    flats, off0s, rows, npvs, mpvs = [], [], [], [], []
    i0s, j0s, s0s, dones = [], [], [], []
    off = 0
    for tb, stt, n, m in zip(tbs, statss, ns, ms):
        G, NP, T, MP = tb.shape
        B = G * T
        flats.append(tb.reshape(-1))
        b = jnp.arange(B, dtype=jnp.int32)
        off0s.append(off + (b // T) * (NP * T * MP) + (b % T) * MP)
        rows.append(jnp.full((B,), T * MP, jnp.int32))
        npvs.append(jnp.full((B,), NP, jnp.int32))
        mpvs.append(jnp.full((B,), MP, jnp.int32))
        _, i0, j0, s0, d0 = _walk_starts(stt, n, m, mode)
        i0s.append(i0)
        j0s.append(j0)
        s0s.append(s0)
        dones.append(d0)
        off += tb.size
    pool = jnp.concatenate(flats)
    off0 = jnp.concatenate(off0s)
    rowstride = jnp.concatenate(rows)
    npv = jnp.concatenate(npvs)
    mpv = jnp.concatenate(mpvs)
    i0 = jnp.concatenate(i0s)
    j0 = jnp.concatenate(j0s)
    s0 = jnp.concatenate(s0s)
    done0 = jnp.concatenate(dones)
    Btot = off0.shape[0]

    Lp = -(-L // 4) * 4
    out_s = jnp.zeros((Lp, Btot), jnp.uint8)
    cnt0 = jnp.zeros((Btot,), jnp.int32)

    def cond(c):
        step, done = c[0], c[4]
        return (step < L) & jnp.any(~done)

    def body(c):
        step, i, j, s, done, cnt, o = c
        # identical cell rules to _walk_step, pool-addressed
        s = jnp.where((j == 0) & (i > 0), CELL_GAPINY,
                      jnp.where((i == 0) & (j > 0), CELL_GAPINX, s))
        interior = (i >= 1) & (j >= 1)
        ii = jnp.clip(i - 1, 0, npv - 1)
        jj = jnp.clip(j - 1, 0, mpv - 1)
        ptr = pool[off0 + ii * rowstride + jj].astype(jnp.int32)
        prev_in = (ptr >> (2 * s)) & 3
        origin = (i == 0) & (j == 0)
        row0 = (i == 0) & (j > 0)
        bstate = jnp.where(origin, CELL_MATCH,
                           jnp.where(row0, CELL_GAPINX, CELL_GAPINY))
        bprev = jnp.where(local & (s == bstate), CELL_STOP, bstate)
        prev = jnp.where(interior, prev_in, bprev)
        stop = local & (prev == CELL_STOP)
        emit = (~done) & (~stop)
        ni = jnp.where(emit & (s != CELL_GAPINX), i - 1, i)
        nj = jnp.where(emit & (s != CELL_GAPINY), j - 1, j)
        ns = jnp.where(emit, prev, s)
        # boundary short-circuit (see walk_bundle_packed): terminal-gap
        # tails are deterministic; the rebuild synthesizes them
        ndone = done | stop | (ni == 0) | (nj == 0)
        o = jax.lax.dynamic_update_index_in_dim(
            o, jnp.where(emit, s, 0).astype(jnp.uint8), step, 0)
        return step + 1, ni, nj, ns, ndone, cnt + emit, o

    _, _, _, _, _, cnt, out_s = jax.lax.while_loop(
        cond, body, (jnp.int32(0), i0, j0, s0, done0, cnt0, out_s)
    )
    r = out_s.reshape(Lp // 4, 4, Btot)
    moves = r[:, 0] | (r[:, 1] << 2) | (r[:, 2] << 4) | (r[:, 3] << 6)
    return cnt, moves


def decode_bundle(stats, idx) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host view of a fetched walk bundle: (stats (B, 8) f32,
    idx1 (L, B), idx2 (L, B))."""
    stats = np.asarray(stats)
    idx = np.asarray(idx)
    return stats, idx[0], idx[1]


def pair_path(idx1: np.ndarray, idx2: np.ndarray, k: int):
    """Per-pair aligned index lists (left-to-right) from decoded columns."""
    c1 = idx1[:, k]
    ends = np.nonzero(c1 == SENTINEL)[0]
    cnt = int(ends[0]) if ends.size else c1.shape[0]
    return c1[:cnt][::-1].tolist(), idx2[:cnt, k][::-1].tolist()


def unpack_moves(mv_col: np.ndarray, c: int) -> np.ndarray:
    """(L4,) packed byte column -> (c,) uint8 states, walk order."""
    b = mv_col[: (c + 3) // 4]
    s = np.empty(b.shape[0] * 4, np.uint8)
    s[0::4] = b & 3
    s[1::4] = (b >> 2) & 3
    s[2::4] = (b >> 4) & 3
    s[3::4] = (b >> 6) & 3
    return s[:c]


def _states_to_path(s: np.ndarray, i0: int, j0: int):
    """Walk-order per-step states -> left-to-right aligned index lists."""
    di = (s != CELL_GAPINX).astype(np.int64)
    dj = (s != CELL_GAPINY).astype(np.int64)
    ib = i0 - np.concatenate([[0], np.cumsum(di[:-1])])
    jb = j0 - np.concatenate([[0], np.cumsum(dj[:-1])])
    r1 = np.where(s == CELL_GAPINX, -1, ib - 1)
    r2 = np.where(s == CELL_GAPINY, -1, jb - 1)
    return r1[::-1].tolist(), r2[::-1].tolist()


def moves_to_path(moves: np.ndarray, cnt: np.ndarray, i0: int, j0: int,
                  k: int):
    """Replay pair ``k``'s packed move column into left-to-right aligned
    index lists (the pure-numpy counterpart of csrc/reconstruct.cpp, used
    when the native library is unavailable)."""
    c = int(cnt[k])
    if c == 0:
        return [], []
    s = np.asarray(unpack_moves(moves[:, k], c), np.int64)
    return _states_to_path(s, i0, j0)
