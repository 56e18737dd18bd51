"""Long-sequence alignment: checkpointed fill + banded traceback re-fill.

The reference materializes full O(n*m) per-cell flags and reads them back
(opencl_sequence_alignment.rs:556-557,765-795), capping practical lengths at
its ~26k x 26k i32 limit.  This path instead:

  1. fills score-only and stores the (M, X, Y) carry rows every
     ``ckpt_rows`` rows: O(NP/ckpt_rows * MP) f32 on the device, no pointer
     bytes at all;
  2. walks the optimal path top-down in ``ckpt_rows``-row segments: each
     segment is re-filled from its checkpoint (emitting pointer bytes for
     just that band), walked, and discarded.  Re-fill replays the exact
     same cell rules, so tie-breaks — and therefore the path — are
     identical to the single-pass fill.

Both fills are the plain-JAX row scan of ops/fill.py (``fill_rows``).
Total compute is ~2x the plain fill; device memory for pointers drops from
O(n*m) to O(ckpt_rows*MP) per pair.

Layout: the batch rides one pointer "group" (``G = 1``, ``T = B``), so a
band's pointer bytes are ``(1, C, B, MP)`` — the (G, NP, T, MP) layout the
walkers read.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CELL_GAPINX, CELL_GAPINY, CELL_MATCH, CELL_STOP, LOCAL
from . import fill as fill_ops
from .fill import STATS_W, row0_carries


def default_ckpt_rows(np_pad: int) -> int:
    """Rows per checkpoint segment: the largest power of two up to 256
    that divides ``np_pad``."""
    ck = 256
    while np_pad % ck:
        ck //= 2
    return ck


WALK_DONE = 0      # path complete
WALK_UP = 1        # walked off the top of the band
WALK_LEFT = 2      # walked off the left edge of the column window


def walk_band(
    tb_band: np.ndarray,  # (C, W) uint8 window for one pair
    i_top: int,           # global row of the row ABOVE the band (= sk*C)
    j_off: int,           # global column of the window's first stored column - 1
    i: int,
    j: int,
    s: int,
    local: bool,
) -> Tuple[List[int], List[int], int, int, int, int]:
    """Walk within one band window.  ``tb_band[r, c]`` holds DP cell
    (i_top + r + 1, j_off + c + 1).  Returns
    (idx1_chunk, idx2_chunk, i, j, s, status) with chunks in walk
    (reverse-path) order and global 0-based indices."""
    from .traceback import native_walk_band, normalize_boundary_state

    native = native_walk_band(tb_band, i_top, j_off, i, j, s, local)
    if native is not None:
        return native

    r1: List[int] = []
    r2: List[int] = []
    width = tb_band.shape[1]
    while True:
        s = normalize_boundary_state(i, j, s)
        # predecessor of the current cell (closed form on true boundaries,
        # cf. traceback._boundary_prev)
        if i == 0 and j == 0:
            prev = CELL_STOP if (local and s == CELL_MATCH) else CELL_MATCH
        elif i == 0:
            prev = CELL_STOP if (local and s == CELL_GAPINX) else CELL_GAPINX
        elif j == 0:
            prev = CELL_STOP if (local and s == CELL_GAPINY) else CELL_GAPINY
        else:
            c = j - 1 - j_off
            if c < 0 or c >= width:
                return r1, r2, i, j, s, WALK_LEFT
            prev = (int(tb_band[i - i_top - 1, c]) >> (2 * s)) & 3
        if local and prev == CELL_STOP:
            return r1, r2, i, j, s, WALK_DONE
        if s == CELL_MATCH:
            r1.append(i - 1)
            r2.append(j - 1)
            i -= 1
            j -= 1
        elif s == CELL_GAPINX:
            r1.append(-1)
            r2.append(j - 1)
            j -= 1
        elif s == CELL_GAPINY:
            r1.append(i - 1)
            r2.append(-1)
            i -= 1
        else:  # pragma: no cover
            raise RuntimeError(f"invalid state {s} at ({i},{j})")
        if i == 0 and j == 0:
            return r1, r2, i, j, s, WALK_DONE
        s = prev
        if 0 < i <= i_top and j > 0:
            # walked off the top of this band; continue in the one above
            return r1, r2, i, j, s, WALK_UP


@functools.partial(jax.jit, static_argnames=("mode", "og", "eg", "C"))
def _ckpt_fill(table, codes1, codes2, n, m, *, mode: int, og: float,
               eg: float, C: int):
    """Score-only fill of the whole batch, checkpointing the carries after
    every ``C`` rows: returns (stats (B, 8), (ckm, ckx, cky)), each
    checkpoint array (NP // C, B, MP) — checkpoint k holds the carries
    after global row (k+1)*C."""
    _, stats, cks = fill_ops.fill_rows(
        fill_ops.profile(table, codes1), codes2, n, m, mode=mode, og=og,
        eg=eg, emit_tb=False, ckpt_rows=C,
    )
    return stats, cks


def _band(table, codes1, codes2, n, m, cks, sk, *, mode, og, eg, C):
    """Re-fill segment ``sk`` (global rows sk*C+1 .. sk*C+C) from its seed
    carries (checkpoint sk-1, or the closed-form row 0 at sk == 0):
    pointer bytes (1, C, B, MP)."""
    B, _ = codes1.shape
    MP = codes2.shape[1]
    c1b = jax.lax.dynamic_slice(codes1, (0, sk * C), (B, C))
    idx = jnp.maximum(sk - 1, 0)
    seed = tuple(
        jnp.where(sk == 0, r0,
                  jax.lax.dynamic_slice(ck, (idx, 0, 0), (1, B, MP))[0])
        for ck, r0 in zip(cks, row0_carries(B, MP, mode, og, eg))
    )
    tb, _, _ = fill_ops.fill_rows(
        fill_ops.profile(table, c1b), codes2, n, m, mode=mode, og=og, eg=eg,
        emit_tb=True, i0=sk * C, carry0=seed,
    )
    return tb.reshape(1, C, B, MP)


@functools.partial(jax.jit, static_argnames=("mode", "og", "eg", "W", "C"))
def _seg_fill_windows(
    table, codes1, codes2, n, m, cks, sk, gs, ts, j0s,
    *, mode: int, og: float, eg: float, W: int, C: int,
):
    """ONE device call per traceback segment: re-fill the segment's band
    and gather every active pair's (C, W) column window."""
    tb_band = _band(table, codes1, codes2, n, m, cks, sk, mode=mode, og=og,
                    eg=eg, C=C)

    def one(g, t, j0):
        sl = jax.lax.dynamic_slice(tb_band, (g, 0, t, j0), (1, C, 1, W))
        return sl[0, :, 0, :]

    return jax.vmap(one)(gs, ts, j0s)


def _device_args(table, codes1, codes2, n, m):
    return (jnp.asarray(np.asarray(table, np.float32)),
            jnp.asarray(codes1), jnp.asarray(codes2),
            jnp.asarray(np.asarray(n), jnp.int32),
            jnp.asarray(np.asarray(m), jnp.int32))


def _pad_items(items):
    """Pad a list of equal-length index tuples to a power-of-two count so
    the number of compiled programs stays O(log B).  Returns one int32
    device vector per tuple position."""
    K = len(items)
    Kp = 1 << max(0, K - 1).bit_length() if K > 1 else 1
    width = len(items[0])
    cols = [np.zeros(Kp, np.int32) for _ in range(width)]
    for k, item in enumerate(items):
        for c, v in enumerate(item):
            cols[c][k] = v
    return tuple(jnp.asarray(c) for c in cols)


def align_long(
    table,                 # (K, K) scoring table
    codes1: np.ndarray,    # (B, NP) padded codes
    codes2: np.ndarray,    # (B, MP)
    n: np.ndarray,         # (B,)
    m: np.ndarray,
    *,
    mode: int,
    og: float,
    eg: float,
    ckpt_rows: Optional[int] = None,
    window: Optional[int] = None,
):
    """Checkpoint-fill + banded-traceback alignment for one bucket, with
    the segment walks on the host.

    Returns (idx_lists, stats_np): idx_lists[k] = (idx1, idx2) aligned index
    lists, stats_np (B, 8).
    """
    B, NP = codes1.shape
    MP = codes2.shape[1]
    tbp = B
    C = ckpt_rows or default_ckpt_rows(NP)
    # column window: wide enough that a typical segment path fits (C rows
    # consume <= C columns plus gap runs)
    W = window or min(MP, -(-(2 * C + 128) // 128) * 128)
    W = min(W, MP)
    args = _device_args(table, codes1, codes2, n, m)
    stats, cks = _ckpt_fill(*args, mode=mode, og=og, eg=eg, C=C)
    stats_np = np.asarray(stats).reshape(B, STATS_W)

    # starting cell per pair
    cur: List[Optional[Tuple[int, int, int]]] = [None] * B
    chunks1: List[List[int]] = [[] for _ in range(B)]
    chunks2: List[List[int]] = [[] for _ in range(B)]
    for b in range(B):
        if mode == LOCAL:
            if stats_np[b, 0] > 0.0:
                cur[b] = (int(stats_np[b, 1]), int(stats_np[b, 2]), CELL_MATCH)
        else:
            fin = stats_np[b, 3:6]
            cur[b] = (int(n[b]), int(m[b]), int(np.argmax(fin)))

    local = mode == LOCAL
    n_segs = NP // C
    for sk in range(n_segs - 1, -1, -1):
        active = [
            b for b in range(B)
            if cur[b] is not None and sk * C < cur[b][0] <= (sk + 1) * C
        ]
        if not active:
            continue
        # ONE fused device call: band re-fill + every pending pair's
        # window gather (WALK_LEFT re-rounds re-fill too, but are rare:
        # only gap runs longer than the window need them)
        pend = [(b, *cur[b]) for b in active]
        while pend:
            items = []
            for b, i, j, s in pend:
                g, t = divmod(b, tbp)
                items.append((g, t, max(0, min(j - W, MP - W))))
            gs, ts, j0s = _pad_items(items)
            wins = np.asarray(_seg_fill_windows(
                *args, cks, jnp.int32(sk), gs, ts, j0s,
                mode=mode, og=og, eg=eg, W=W, C=C,
            ))
            nxt = []
            for k, (b, i, j, s) in enumerate(pend):
                j0 = items[k][2]
                c1, c2, i, j, s, status = walk_band(
                    wins[k], sk * C, j0, i, j, s, local
                )
                chunks1[b].extend(c1)
                chunks2[b].extend(c2)
                if status == WALK_LEFT:
                    nxt.append((b, i, j, s))
                else:
                    cur[b] = None if status == WALK_DONE else (i, j, s)
            pend = nxt

    idx_lists = []
    for b in range(B):
        if cur[b] is not None:  # pragma: no cover - walk must terminate
            raise RuntimeError(f"incomplete traceback for pair {b}: {cur[b]}")
        idx_lists.append((chunks1[b][::-1], chunks2[b][::-1]))
    return idx_lists, stats_np


@functools.partial(jax.jit, static_argnames=("mode", "og", "eg", "C", "L"))
def _packed_walk_segments(
    table, codes1, codes2, n, m, stats, cks,
    *, mode: int, og: float, eg: float, C: int, L: int,
):
    """Segment loop + lockstep in-band walk, entirely on device.

    Iterates segments top-down (sk = n_segs-1 .. 0): re-fill segment sk's
    pointer band from its checkpoint (the same band fill the host path
    uses, so tie-breaks — and therefore paths — are identical), then step
    every pair whose walk position lies in the segment until it leaves.
    Emits the per-step traceback STATES as a packed 2-bit move stream with
    walk_bundle_packed's exact contract (ops/device_walk.py), so the same
    native bulk string rebuild (csrc/reconstruct.cpp) consumes it.  The
    only host traffic is the final (L/4, B) byte bundle.
    """
    B, NP = codes1.shape
    MP = codes2.shape[1]
    tbp = B  # one pointer group: g == 0
    local = mode == LOCAL
    n_segs = NP // C
    st = stats.reshape(B, STATS_W)
    if local:
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

    bidx = jnp.arange(B, dtype=jnp.int32)
    g = bidx // tbp
    t = bidx % tbp
    Lp = -(-L // 4) * 4
    out0 = jnp.zeros((Lp, B), jnp.uint8)
    cnt0 = jnp.zeros((B,), jnp.int32)

    def seg_cond(c):
        sk, done = c[0], c[4]
        return (sk >= 0) & jnp.any(~done)

    def seg_body(c):
        sk, i, j, s, done, cnt, out = c
        band = _band(table, codes1, codes2, n, m, cks, sk, mode=mode,
                     og=og, eg=eg, C=C)
        flat = band.reshape(-1)
        base = sk * C

        # a pair is steppable in this segment when its position needs THIS
        # band (base < i <= base + C) or sits on a DP boundary (i == 0 or
        # j == 0), whose moves are closed-form and need no band read —
        # without the boundary clause a pair entering row 0 with j > 0
        # (the terminal gap chain) stalls and the walk ends incomplete
        def _act(i, j, done):
            return (~done) & ((i > base) | (i == 0) | (j == 0))

        def w_cond(wc):
            it, i, j, _, done = wc[0], wc[1], wc[2], wc[3], wc[4]
            return (it < L + 8) & jnp.any(_act(i, j, done))

        def w_body(wc):
            it, i, j, s, done, cnt, out = wc
            act = _act(i, j, done)
            # normalize_boundary_state (ops/traceback.py:233-249)
            s = jnp.where((j == 0) & (i > 0), CELL_GAPINY,
                          jnp.where((i == 0) & (j > 0), CELL_GAPINX, s))
            interior = (i >= 1) & (j >= 1)
            r = jnp.clip(i - 1 - base, 0, C - 1)
            jj = jnp.clip(j - 1, 0, MP - 1)
            ptr = flat[((g * C + r) * tbp + t) * MP + jj].astype(jnp.int32)
            prev_in = (ptr >> (2 * s)) & 3
            # _boundary_prev closed form (ops/traceback.py:215-230)
            origin = (i == 0) & (j == 0)
            row0 = (i == 0) & (j > 0)
            bstate = jnp.where(origin, CELL_MATCH,
                               jnp.where(row0, CELL_GAPINX, CELL_GAPINY))
            bprev = jnp.where(local & (s == bstate), CELL_STOP, bstate)
            prev = jnp.where(interior, prev_in, bprev)
            stop = local & (prev == CELL_STOP)
            emit = act & (~stop)
            ni = jnp.where(emit & (s != CELL_GAPINX), i - 1, i)
            nj = jnp.where(emit & (s != CELL_GAPINY), j - 1, j)
            ns = jnp.where(emit, prev, s)
            ndone = done | (act & stop) | (emit & (ni == 0) & (nj == 0))
            wr = jnp.clip(cnt, 0, Lp - 1)
            out = out.at[wr, bidx].set(
                jnp.where(emit, s, out[wr, bidx]).astype(jnp.uint8),
                mode="drop",
            )
            return it + 1, ni, nj, ns, ndone, cnt + emit, out

        _, i, j, s, done, cnt, out = jax.lax.while_loop(
            w_cond, w_body, (jnp.int32(0), i, j, s, done, cnt, out)
        )
        return sk - 1, i, j, s, done, cnt, out

    _, _, _, _, _, cnt, out = jax.lax.while_loop(
        seg_cond, seg_body,
        (jnp.int32(n_segs - 1), i0, j0, s0, done0, cnt0, out0),
    )
    r = out.reshape(Lp // 4, 4, B)
    moves = r[:, 0] | (r[:, 1] << 2) | (r[:, 2] << 4) | (r[:, 3] << 6)
    return st[:, :8].astype(jnp.float32), cnt, moves


def align_long_packed(
    table,                 # (K, K) scoring table
    codes1: np.ndarray,    # (B, NP) padded codes
    codes2: np.ndarray,    # (B, MP)
    n: np.ndarray,         # (B,)
    m: np.ndarray,
    *,
    mode: int,
    og: float,
    eg: float,
    ckpt_rows: Optional[int] = None,
):
    """Checkpoint-fill + ON-DEVICE banded traceback for one bucket.

    Same checkpoint+refill algorithm as :func:`align_long`, but the
    segment walks run on device and ship back ONE packed 2-bit move
    bundle (the exact contract of device_walk.walk_bundle_packed):
    returns device arrays ``(stats (B, 8) f32, cnt (B,) i32, moves
    (ceil(L/4), B) u8)`` — feed to ops/reconstruct.reconstruct_packed.
    """
    NP = codes1.shape[1]
    MP = codes2.shape[1]
    C = ckpt_rows or default_ckpt_rows(NP)
    args = _device_args(table, codes1, codes2, n, m)
    stats, cks = _ckpt_fill(*args, mode=mode, og=og, eg=eg, C=C)
    return _packed_walk_segments(
        *args, stats, cks, mode=mode, og=og, eg=eg, C=C, L=NP + MP + 2,
    )
