"""Banded DP fill: restrict the matrix to a diagonal band of width W.

The speed knob for very long, similar sequences (10k+ residues): per-row
work drops from O(m) to O(W).  The band follows the main diagonal with
per-row offsets ``off(i)`` (monotone, steps of 0 or 1); cells outside the
band are treated as -inf, so results equal the full DP whenever the optimal
path (and the gap-run origins feeding it) stays inside the band.  Banded DP
is inherently a heuristic: the walker flags paths pressed against the band
edge (``edge_touched``), ``align_banded_verified`` applies the standard
double-band guard (widen until two widths agree), and ``BandExceeded`` is
raised only for out-of-band reads (a corrupt fill).

The fill is a plain-JAX ``lax.scan`` over rows with up to ``TBP`` pairs
side by side, each with its own lengths and band offsets, applying the
exact cell rules of ops/scan_dp.py on band lanes — H is normalized with
*global* column indices so the in-band prefix max equals the full scan
whenever out-of-band cells cannot win.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CELL_GAPINX, CELL_GAPINY, CELL_MATCH, CELL_STOP, GLOBAL, GLOCAL, LOCAL

NEG = -1.0e30
BIGI = 2**30
TBP = 8  # pairs per banded batch (one compiled program for 1..TBP pairs)
STATS_W = 8


class BandExceeded(RuntimeError):
    """The optimal path touched the band edge; rerun wider or unbanded."""


def band_offsets(n: int, m: int, W: int) -> np.ndarray:
    """Monotone per-row band offsets with steps in {0, 1}:
    off(i) ≈ i * (m - W) / n, clamped; requires W >= m - n."""
    if W >= m:
        return np.zeros(n + 1, np.int32)
    if W < m - n:
        raise ValueError(f"band {W} cannot reach column {m} with {n} rows")
    i = np.arange(n + 1, dtype=np.int64)
    off = (i * (m - W)) // max(n, 1)
    return np.clip(off, 0, m - W).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("mode", "og", "eg"))
def fill_banded(
    S_band,  # (NP, TBP, W) f32 — per-pair banded substitution scores
    n,       # (TBP, 1) i32 — per-pair true rows
    m,       # (TBP, 1) i32 — per-pair true cols
    offs,    # (TBP, NP + 1) i32 — per-pair band offsets off(i), i = 0..NP
    *,
    mode: int,
    og: float,
    eg: float,
):
    """Banded fill of up to TBP pairs: returns (tb (NP, TBP, W) uint8,
    stats (TBP, 8) f32).  Band lane w of row i is global column
    off(i) + w + 1; LOCAL stats hold the best's band lane, not its
    column."""
    NP, tbp, W = S_band.shape
    og, eg = jnp.float32(og), jnp.float32(eg)
    if mode == GLOBAL:
        so, se = og, eg
    else:
        so, se = jnp.float32(0.0), jnp.float32(0.0)
    sent = 10.0 * og + 10.0 * eg
    nn = n.astype(jnp.int32)
    mm = m.astype(jnp.int32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (tbp, W), 1)

    def sh_r(v, fill):
        pad = jnp.broadcast_to(fill, (tbp, 1)).astype(v.dtype)
        return jnp.concatenate([pad, v[:, :-1]], axis=1)

    def sh_l(v, fill):
        pad = jnp.broadcast_to(fill, (tbp, 1)).astype(v.dtype)
        return jnp.concatenate([v[:, 1:], pad], axis=1)

    def row_step(carry, x):
        cm, cx, cy, runbest, runbest_i, stats = carry
        srow, i, off, off_prev = x
        fi = i.astype(jnp.float32)
        off = off[:, None]                 # (TBP, 1)
        dlt = off - off_prev[:, None]      # (TBP, 1) in {0, 1}
        jg = off + lane + 1                # global column of each band lane
        jgf = jg.astype(jnp.float32)

        lsc_im1 = (fi - 1.0) * se + (so - se)
        lsc_i = fi * se + (so - se)
        at_first = i == 1
        # the j=0 boundary enters through the left fill only when off == 0
        at_j0 = off == 0
        fill_m = jnp.where(at_j0, jnp.where(at_first, 0.0, lsc_im1 + sent),
                           NEG)
        fill_x = jnp.where(at_j0, jnp.where(at_first, -1.0, lsc_im1 + sent),
                           NEG)
        fill_y = jnp.where(at_j0, jnp.where(at_first, -1.0, lsc_im1), NEG)

        Mp, Xp, Yp = cm, cx, cy
        # diag (i-1, j-1): band coord w + dlt - 1
        d1m = jnp.where(dlt == 1, Mp, sh_r(Mp, fill_m))
        d1x = jnp.where(dlt == 1, Xp, sh_r(Xp, fill_x))
        d1y = jnp.where(dlt == 1, Yp, sh_r(Yp, fill_y))
        # up (i-1, j): band coord w + dlt
        upm = jnp.where(dlt == 1, sh_l(Mp, NEG), Mp)
        upx = jnp.where(dlt == 1, sh_l(Xp, NEG), Xp)
        upy = jnp.where(dlt == 1, sh_l(Yp, NEG), Yp)

        val_m = jnp.maximum(jnp.maximum(d1m, d1x), d1y) + srow
        prev_m = jnp.where(
            d1m >= d1x, jnp.where(d1m >= d1y, 0, 2),
            jnp.where(d1x >= d1y, 1, 2),
        )

        if mode == GLOCAL:
            last_col = jg == mm
            qo = jnp.where(last_col, so, og)
            qe = jnp.where(last_col, se, eg)
        else:
            qo, qe = og, eg

        if mode == LOCAL:
            c1 = upm + og >= upy + eg
            c2 = upm > upx
            c3 = upy + eg > upx + og
            val_y = jnp.where(
                c1,
                jnp.where(c2, upm + og, upx + og),
                jnp.where(c3, upy + eg, upx + og),
            )
        else:
            c1 = upm + qo > upy + qe
            c2 = upm >= upx
            c3 = upy + qe >= upx + qo
            val_y = jnp.maximum(jnp.maximum(upm + qo, upy + qe), upx + qo)
        prev_y = jnp.where(c1, jnp.where(c2, 0, 1), jnp.where(c3, 2, 1))

        if mode == LOCAL:
            val_m = jnp.maximum(val_m, 0.0)
            val_y = jnp.maximum(val_y, 0.0)

        if mode == GLOCAL:
            lr = i == nn
            po = jnp.where(lr, so, og)
            pe = jnp.where(lr, se, eg)
        else:
            po, pe = og, eg

        x0b = lsc_i + sent
        g0 = jnp.where(at_j0, lsc_i + po, NEG)
        gline = jnp.maximum(val_m, val_y) + po
        hraw = sh_r(gline, g0)
        h = hraw - (jgf - 1.0) * pe
        h = jnp.where(jg == 1, jnp.maximum(h, x0b + pe), h)
        val_x = jax.lax.cummax(h, axis=1) + (jgf - 1.0) * pe
        if mode == LOCAL:
            val_x = jnp.maximum(val_x, 0.0)

        Mm1 = sh_r(val_m, jnp.where(at_j0, lsc_i + sent, NEG))
        Xm1 = sh_r(val_x, jnp.where(at_j0, x0b, NEG))
        Ym1 = sh_r(val_y, jnp.where(at_j0, lsc_i, NEG))
        if mode == LOCAL:
            e1 = Mm1 + og >= Xm1 + eg
            e2 = Mm1 > Ym1
            e3 = Xm1 + eg > Ym1 + og
        else:
            e1 = Mm1 + po > Xm1 + pe
            e2 = Mm1 >= Ym1
            e3 = Xm1 + pe >= Ym1 + po
        prev_x = jnp.where(e1, jnp.where(e2, 0, 2), jnp.where(e3, 1, 2))

        if mode == LOCAL:
            prev_m = jnp.where(val_m == 0.0, CELL_STOP, prev_m)
            prev_x = jnp.where(val_x == 0.0, CELL_STOP, prev_x)
            prev_y = jnp.where(val_y == 0.0, CELL_STOP, prev_y)
        tb_row = (prev_m | (prev_x << 2) | (prev_y << 4)).astype(jnp.uint8)

        if mode == LOCAL:
            in_range = (jg <= mm) & (i <= nn)
            masked = jnp.where(in_range, val_m, NEG)
            upd = masked > runbest
            runbest = jnp.where(upd, masked, runbest)
            runbest_i = jnp.where(upd, i, runbest_i)
        else:
            take = (i == nn) & (jg == mm)
            fm = jnp.sum(jnp.where(take, val_m, 0.0), axis=1, keepdims=True)
            fx = jnp.sum(jnp.where(take, val_x, 0.0), axis=1, keepdims=True)
            fy = jnp.sum(jnp.where(take, val_y, 0.0), axis=1, keepdims=True)
            z = jnp.zeros((tbp, 1), jnp.float32)
            pad = jnp.zeros((tbp, STATS_W - 6), jnp.float32)
            anyt = jnp.any(take, axis=1, keepdims=True)  # per pair
            stats = jnp.where(
                anyt, jnp.concatenate([z, z, z, fm, fx, fy, pad], axis=1),
                stats,
            )
        return (val_m, val_x, val_y, runbest, runbest_i, stats), tb_row

    # row 0 carries: band lanes of row 0 start at column 1 (off(0) == 0);
    # out-of-band row-0 lanes never influence valid cells (off is monotone)
    jf1 = (lane + 1).astype(jnp.float32)
    lsc = jf1 * se + (so - se)
    carry0 = (
        lsc + sent, lsc, lsc + sent,
        jnp.full((tbp, W), NEG, jnp.float32),
        jnp.full((tbp, W), BIGI, jnp.int32),
        jnp.zeros((tbp, STATS_W), jnp.float32),
    )
    offs = offs.astype(jnp.int32)
    xs = (S_band.astype(jnp.float32), jnp.arange(1, NP + 1, dtype=jnp.int32),
          offs[:, 1:].T, offs[:, :-1].T)
    (_, _, _, runbest, runbest_i, stats), tb = jax.lax.scan(
        row_step, carry0, xs)
    if mode == LOCAL:
        gmax = jnp.max(runbest, axis=1, keepdims=True)
        cand = runbest == gmax
        min_i = jnp.min(jnp.where(cand, runbest_i, BIGI), axis=1,
                        keepdims=True)
        min_w = jnp.min(jnp.where(cand & (runbest_i == min_i), lane, BIGI),
                        axis=1, keepdims=True)
        stats = jnp.concatenate(
            [gmax, min_i.astype(jnp.float32), min_w.astype(jnp.float32),
             jnp.zeros((tbp, STATS_W - 3), jnp.float32)], axis=1,
        )
    return tb, stats


def walk_banded(
    tb: np.ndarray,   # (NP, W) uint8 for the real pair
    off: np.ndarray,  # (NP + 1,) int
    si: int,
    sj: int,
    state: int,
    local: bool,
    W: int,
    m: int,
) -> Tuple[List[int], List[int], bool]:
    """Pointer walk in band coordinates.  Raises BandExceeded if the path
    reads outside the band (corrupt fill); additionally returns
    ``edge_touched`` — True when the path visited a band-edge lane at a
    cell where out-of-band alternatives geometrically exist, i.e. the band
    may have constrained the result (banded alignment is a heuristic:
    results equal the full DP only when the optimal path fits the band)."""
    from . import traceback as traceback_ops
    from .traceback import native_walk_banded

    native = native_walk_banded(tb, off, si, sj, state, local, W, m)
    if native == ("exceeded",):
        raise BandExceeded(f"path left band starting at ({si},{sj})")
    if native is not None:
        return native

    r1: List[int] = []
    r2: List[int] = []
    edge_touched = False
    i, j, s = int(si), int(sj), int(state)
    while True:
        s = traceback_ops.normalize_boundary_state(i, j, s)
        if i >= 1 and j >= 1:
            w = j - 1 - int(off[i])
            if w < 0 or w >= W:
                raise BandExceeded(f"path left band at ({i},{j})")
            if (w == 0 and j > 1) or (w == W - 1 and j < m):
                edge_touched = True
            prev = (int(tb[i - 1, w]) >> (2 * s)) & 3
        elif i == 0 and j == 0:
            prev = CELL_STOP if (local and s == CELL_MATCH) else CELL_MATCH
        elif i == 0:
            prev = CELL_STOP if (local and s == CELL_GAPINX) else CELL_GAPINX
        else:
            prev = CELL_STOP if (local and s == CELL_GAPINY) else CELL_GAPINY
        if local and prev == CELL_STOP:
            break
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
            break
        s = prev
    r1.reverse()
    r2.reverse()
    return r1, r2, edge_touched


@functools.partial(jax.jit, static_argnames=("W", "local", "L"))
def _walk_banded_device(tb, off, si, sj, s0, m, act0, *, W: int, local: bool,
                        L: int):
    """ON-DEVICE pointer walk for the whole banded batch at once.

    The reference GPU engine backtracks on the device and ships only the
    path (opencl_sequence_alignment.rs:765-795); walking on host instead
    means shipping the entire (NP, TBP, W) pointer band over the
    host<->device link first — ~50 MB for a 12k pair at W=512.  This walk
    replicates walk_banded exactly, all TBP pairs stepping in lockstep in
    one XLA while_loop; only (TBP, L) index arrays cross the link.

    Args: tb (NP, TBP, W) uint8, off (TBP, NP+1) i32, si/sj/s0/m (TBP,)
    i32.  Returns (idx1, idx2, count, flags): indices in walk (reverse
    path) order, -1 for gaps; flags bit0 = edge_touched, bit1 = band
    exceeded (caller raises BandExceeded like the host walker).
    """
    NP, TBP_, _ = tb.shape
    tb_flat = tb.reshape(-1)
    bidx = jnp.arange(TBP_, dtype=jnp.int32)

    def cond(c):
        it, i, j, s, cnt, flags, active, i1, i2 = c
        return jnp.logical_and(jnp.any(active), it < L + 4)

    def body(c):
        it, i, j, s, cnt, flags, active, idx1, idx2 = c
        # boundary-state normalization (traceback.normalize_boundary_state)
        s = jnp.where((j == 0) & (i > 0), CELL_GAPINY, s)
        s = jnp.where((i == 0) & (j > 0), CELL_GAPINX, s)
        off_i = off[bidx, jnp.clip(i, 0, NP)]
        w = j - 1 - off_i
        in_mat = (i >= 1) & (j >= 1)
        exceeded = active & in_mat & ((w < 0) | (w >= W))
        edge = in_mat & (((w == 0) & (j > 1)) | ((w == W - 1) & (j < m)))
        flat = (
            jnp.clip(i - 1, 0, NP - 1) * (TBP_ * W)
            + bidx * W
            + jnp.clip(w, 0, W - 1)
        )
        byte = tb_flat[flat].astype(jnp.int32)
        prev_mat = (byte >> (2 * s)) & 3
        # closed-form boundary predecessors (cf. walk_banded)
        at00 = (i == 0) & (j == 0)
        top = (i == 0) & (j >= 1)
        bnd = jnp.where(at00, CELL_MATCH,
                        jnp.where(top, CELL_GAPINX, CELL_GAPINY))
        if local:
            bnd = jnp.where(bnd == s, CELL_STOP, bnd)
        prev = jnp.where(in_mat, prev_mat, bnd)
        stop_now = (prev == CELL_STOP) if local else jnp.zeros_like(active)
        do = active & ~stop_now & ~exceeded
        flags = flags | jnp.where(active & ~exceeded & edge, 1, 0)
        flags = flags | jnp.where(exceeded, 2, 0)
        e1 = jnp.where(s == CELL_GAPINX, -1, i - 1)
        e2 = jnp.where(s == CELL_GAPINY, -1, j - 1)
        wr = jnp.clip(cnt, 0, L - 1)
        idx1 = idx1.at[bidx, wr].set(
            jnp.where(do, e1, idx1[bidx, wr]), mode="drop"
        )
        idx2 = idx2.at[bidx, wr].set(
            jnp.where(do, e2, idx2[bidx, wr]), mode="drop"
        )
        di = jnp.where(s == CELL_GAPINX, 0, 1)
        dj = jnp.where(s == CELL_GAPINY, 0, 1)
        i = i - di * do
        j = j - dj * do
        cnt = cnt + do
        hit00 = (i == 0) & (j == 0)
        s = jnp.where(do & ~hit00, prev, s)
        active = do & ~hit00
        return it + 1, i, j, s, cnt, flags, active, idx1, idx2

    it = jnp.int32(0)
    cnt = jnp.zeros_like(si)
    flags = jnp.zeros_like(si)
    active = jnp.asarray(act0, jnp.bool_)
    idx1 = jnp.full((TBP_, L), -2, jnp.int32)
    idx2 = jnp.full((TBP_, L), -2, jnp.int32)
    it, i, j, s, cnt, flags, active, idx1, idx2 = jax.lax.while_loop(
        cond, body,
        (it, jnp.asarray(si, jnp.int32), jnp.asarray(sj, jnp.int32),
         jnp.asarray(s0, jnp.int32), cnt, flags, active, idx1, idx2),
    )
    # pairs still active after L+4 steps have a corrupt pointer cycle
    flags = flags | jnp.where(active, 2, 0)
    return idx1, idx2, cnt, flags


@functools.partial(jax.jit, static_argnames=("W",))
def _banded_scores(c1, c2, table, off_rows, m, *, W: int):
    """(TBP, NP, W) f32 per-pair banded scores, built on the device from
    the codes: S[b, i-1, w] = table[c1[b, i-1], c2[b, off_b(i) + w]], zero
    outside seq2 (``off_rows[b, i-1]`` is off_b(i))."""

    def one(c1_b, c2_b, off_b, m_b):
        cols = off_b[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
        cols_c = jnp.clip(cols, 0, jnp.maximum(m_b - 1, 0))
        prof = jnp.take(table, c1_b, axis=0)            # (NP, K)
        codes_w = jnp.take(c2_b, cols_c, axis=0)        # (NP, W)
        S = jnp.take_along_axis(prof, codes_w, axis=1)  # (NP, W)
        return jnp.where(cols >= m_b, 0.0, S)

    return jax.vmap(one)(c1, c2, off_rows, m)


def align_banded_batch(
    pairs,  # sequence of (codes1, codes2) int arrays, at most TBP of them
    table: np.ndarray,
    *,
    mode: int,
    og: float,
    eg: float,
    band: int,
):
    """Banded alignment of up to TBP pairs in ONE fill (each pair with its
    own lengths and band offsets).  Returns a list of (idx1, idx2, score,
    edge_touched) per pair.

    ``edge_touched`` True means the in-band-optimal path pressed against
    the band edge, so the result may differ from the full DP — widen the
    band or fall back to the exact fill.  (Banded DP is inherently a
    heuristic; it equals the full DP exactly when the optimal path fits.)
    """
    count = len(pairs)
    if not 1 <= count <= TBP:
        raise ValueError(f"{count} pairs; a banded batch holds 1..{TBP}")
    ns = [len(c1) for c1, _ in pairs]
    ms = [len(c2) for _, c2 in pairs]
    # one static (W, NP) per batch: wide/tall enough for every member
    W = -(-max(band, max(m - n for n, m in zip(ns, ms)) + 128) // 128) * 128
    if W >= max(ms):
        W = -(-max(ms) // 128) * 128
    NP = -(-max(ns) // 8) * 8
    Mmax = max(ms)

    c1b = np.zeros((TBP, NP), np.int32)
    # columns padded so the W-wide band slice stays in bounds even when W
    # rounds past the longest seq2
    Mpad = -(-max(Mmax, 1) // 128) * 128 + 128
    c2b = np.zeros((TBP, Mpad), np.int32)
    offs_full = []
    for k in range(count):
        codes1, codes2 = pairs[k]
        n, m = ns[k], ms[k]
        if n * max(m - W, 0) >= 2**31:
            raise ValueError("banded offsets exceed int32 range; reduce sizes")
        c1b[k, :n] = codes1
        c2b[k, :m] = codes2
        off_full = band_offsets(n, m, min(W, m))
        # rows beyond n keep the last offset (they never affect results)
        off = np.zeros(NP + 1, np.int32)
        off[: n + 1] = off_full
        off[n + 1:] = off_full[-1]
        if (off[1:] - off[:-1]).max(initial=0) > 1:
            raise ValueError("band slope must be <= 1")
        offs_full.append(off)
    for k in range(count, TBP):
        offs_full.append(np.zeros(NP + 1, np.int32))
    offs = np.stack(offs_full).astype(np.int32)

    nv = np.ones((TBP, 1), np.int32)
    mv = np.ones((TBP, 1), np.int32)
    nv[:count, 0] = ns
    mv[:count, 0] = ms

    # banded substitution scores built ON DEVICE from the code arrays —
    # only O(n + m) ints per pair cross the host boundary
    offs_d = jnp.asarray(offs)
    S_band = _banded_scores(
        jnp.asarray(c1b), jnp.asarray(c2b),
        jnp.asarray(np.asarray(table, np.float32)), offs_d[:, 1:],
        jnp.asarray(mv[:, 0]), W=W,
    ).transpose(1, 0, 2)
    tb, stats = fill_banded(
        S_band, jnp.asarray(nv), jnp.asarray(mv), offs_d,
        mode=mode, og=og, eg=eg,
    )
    stats_np = np.asarray(stats)

    # start cell/state per pair (host-side: tiny), then ONE on-device walk
    # for the whole batch — the pointer band itself never leaves the
    # device (see _walk_banded_device)
    si = np.zeros(TBP, np.int32)
    sj = np.zeros(TBP, np.int32)
    s0 = np.zeros(TBP, np.int32)
    score = np.zeros(TBP, np.float64)
    skip = np.zeros(TBP, bool)
    for k in range(count):
        n, m, off = ns[k], ms[k], offs_full[k]
        if mode == LOCAL:
            best = float(stats_np[k, 0])
            score[k] = best
            if best <= 0.0:
                skip[k] = True
                continue
            si[k] = int(stats_np[k, 1])
            sj[k] = int(off[si[k]]) + int(stats_np[k, 2]) + 1
            s0[k] = CELL_MATCH
        else:
            fin = stats_np[k, 3:6]
            s0[k] = int(np.argmax(fin))
            score[k] = float(fin[s0[k]])
            si[k], sj[k] = n, m
    skip[count:] = True
    # round the path-capacity bound so the compiled-program count stays
    # small across batches of varying lengths
    L = -(-(int(max(ns) + max(ms)) + 2) // 1024) * 1024
    i1, i2, cnt, flags = _walk_banded_device(
        tb,
        offs_d,
        jnp.asarray(np.where(skip, 0, si)),
        jnp.asarray(np.where(skip, 0, sj)),
        jnp.asarray(s0),
        jnp.asarray(mv[:, 0]),
        jnp.asarray(~skip),
        W=W, local=mode == LOCAL, L=L,
    )
    i1, i2, cnt, flags = jax.device_get((i1, i2, cnt, flags))

    results = []
    for k in range(count):
        if skip[k]:
            results.append(([], [], 0.0, False))
            continue
        if flags[k] & 2:
            raise BandExceeded(
                f"path left band starting at ({si[k]},{sj[k]})"
            )
        c = int(cnt[k])
        idx1 = i1[k, :c][::-1].tolist()
        idx2 = i2[k, :c][::-1].tolist()
        results.append((idx1, idx2, float(score[k]), bool(flags[k] & 1)))
    return results


def align_banded(
    codes1: np.ndarray,
    codes2: np.ndarray,
    table: np.ndarray,
    *,
    mode: int,
    og: float,
    eg: float,
    band: int,
):
    """Banded alignment of ONE pair (batch of one — see align_banded_batch).
    Returns (idx1, idx2, score, edge_touched)."""
    return align_banded_batch(
        [(np.asarray(codes1, np.int32), np.asarray(codes2, np.int32))],
        table, mode=mode, og=og, eg=eg, band=band,
    )[0]


def align_banded_verified(
    codes1: np.ndarray,
    codes2: np.ndarray,
    table: np.ndarray,
    *,
    mode: int,
    og: float,
    eg: float,
    band: int,
    max_band: Optional[int] = None,
):
    """Double-band verification: run at W and 2W and accept when the scores
    agree (the standard guard for banded DP — a band-constrained optimum
    almost surely improves when the band doubles); otherwise keep widening
    until agreement or the band covers the matrix (then the result is the
    exact full DP).  Returns (idx1, idx2, score, band_used).

    Acceptance is on score agreement alone.  ``edge_touched`` cannot be
    required to clear: ``band_offsets`` anchors the band's slack linearly
    (slope <= 1 is a fill requirement), so a full-span near-diagonal
    path — the very workload banded mode exists for — necessarily grazes
    lane 0 near the top corner (rows where off_i >= 1 put the diagonal ON
    the band's left edge) and lane W-1 near the bottom one.  The flag
    remains what triggers widening when scores disagree."""
    m = len(codes2)
    cap = max_band or m
    W = band
    prev = align_banded(
        codes1, codes2, table, mode=mode, og=og, eg=eg, band=W,
    )
    while W < cap and W < m:
        W2 = min(2 * W, max(cap, W + 1))
        cur = align_banded(
            codes1, codes2, table, mode=mode, og=og, eg=eg, band=W2,
        )
        if cur[2] == prev[2]:
            return cur[0], cur[1], cur[2], W2
        prev = cur
        W = W2
    return prev[0], prev[1], prev[2], W
