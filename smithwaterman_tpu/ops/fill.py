"""The batched DP fill: one entry point, two implementations.

:func:`fill` is what every batch path calls.  It takes int8/int32 symbol
codes, never a materialised score matrix, and returns

  * ``tb``: uint8 pointer bytes laid out ``(G, NP, T, MP)`` (cell (i, j) of
    pair ``g*T + t`` at ``tb[g, i-1, t, j-1]``; ``MP`` may be padded past
    the codes' width).  ``T`` is the implementation's choice; the walkers
    (ops/device_walk.py, ops/traceback.walk_tiled) read any ``T``.
  * ``stats``: ``(B, 8)`` f32 rows ``[best, best_i, best_j, final_M,
    final_X, final_Y, 0, 0]``; LOCAL fills the first three (best position
    first in i-major / j-minor order), GLOBAL/GLOCAL the finals at (n, m).

Backends:

  * ``"cuda"``: csrc/gpu/sw_fill.cu through ``jax.ffi`` (ops/cuda_fill.py),
    ``T = 1``;
  * ``"xla"``: :func:`fill_xla` below, a ``lax.scan`` over rows with all
    pairs of the batch side by side, ``G = 1, T = B``.

Both follow the cell rules of ops/scan_dp.py (the oracle): the same
comparison cascades, tie-breaks, boundary closed forms and STOP marks, and
the X state as a max-plus prefix scan.  Pointer bytes and stats inside each
pair's (n, m) region are identical between the two; cells past a pair's
lengths are undefined.

The plain fill is also the engine of the long-pair path (ops/longseq.py):
:func:`fill_rows` starts from seeded carries at any row and can emit the
carry rows every ``ckpt_rows`` rows.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CELL_STOP, GLOBAL, GLOCAL, LOCAL

STATS_W = 8
NEG = -1.0e30
BIGI = 2**30


def is_integer_table(table) -> bool:
    """Integer scoring table whose entries fit int8."""
    table = np.asarray(table)
    return bool(
        np.all(table == np.round(table)) and np.all(np.abs(table) <= 127)
    )


def quarter_exact(table, og: float, eg: float) -> bool:
    """Whether every DP value is a multiple of 0.25: integer table entries
    and quarter-integer penalties.  Then the fill is exact in any order of
    operations (and the CUDA kernel runs in int32 quarter units)."""
    return is_integer_table(table) and all(
        float(v) * 4.0 == round(float(v) * 4.0) for v in (og, eg)
    )


def choose_tile(count: int) -> int:
    """Pairs per padding quantum of a bucket: the smallest power of two
    holding ``count`` pairs, between 8 and 128.  Batches are padded to a
    multiple of it and dispatched in chunks of 1, 2, 4 or 8 quanta, so a
    bucket compiles at most four fill programs whatever its pair count,
    pads at most 127 pairs, and a full chunk gives the CUDA kernel 1,024
    warps (one pair each) to spread over the card."""
    tile = 8
    while tile < count and tile < 128:
        tile *= 2
    return tile


def _boundary(mode: int, og, eg):
    """(so, se, sent): start-gap penalties (free except GLOBAL) and the
    sentinel for disallowed boundary states (scan_dp._row0)."""
    if mode == GLOBAL:
        so, se = og, eg
    else:
        so, se = jnp.float32(0.0), jnp.float32(0.0)
    return so, se, 10.0 * og + 10.0 * eg


def _shift(v, fill):
    """out[:, j] = v[:, j-1]; out[:, 0] = fill (a (B, 1) column)."""
    return jnp.concatenate([jnp.broadcast_to(fill, v.shape[:1] + (1,))
                            .astype(v.dtype), v[:, :-1]], axis=1)


def row0_carries(B: int, MP: int, mode: int, og: float, eg: float):
    """Closed-form boundary row i == 0 for j = 1..MP (scan_dp._row0)."""
    og, eg = jnp.float32(og), jnp.float32(eg)
    so, se, sent = _boundary(mode, og, eg)
    jf = jnp.arange(1, MP + 1, dtype=jnp.float32)
    lsc = jf * se + (so - se)
    row = jnp.broadcast_to(lsc, (B, MP))
    return row + sent, row, row + sent


def profile(table, codes1):
    """(NP, B, K) f32 table rows of seq1's residues, rows-major for the
    row scan."""
    return jnp.take(table.astype(jnp.float32), codes1.astype(jnp.int32),
                    axis=0).transpose(1, 0, 2)


def fill_rows(prof, codes2, n, m, *, mode: int, og: float, eg: float,
              emit_tb: bool, i0=0, carry0=None,
              ckpt_rows: Optional[int] = None):
    """Fill rows ``i0+1 .. i0+R`` for every pair of a batch.

    Args:
      prof: (R, B, K) f32 table rows of the rows' seq1 residues.
      codes2: (B, MP) seq2 codes.
      n, m: (B,) int32 true lengths.
      i0: global index of the row above the first (traced int).
      carry0: (M, X, Y) values of row ``i0`` at j = 1..MP, each (B, MP);
        None for the closed-form boundary row (``i0 == 0``).
      ckpt_rows: emit the carries after every ``ckpt_rows`` rows.

    Returns ``(tb, stats, ckpts)``: tb (R, B, MP) uint8 or None, stats
    (B, 8) over the filled rows, ckpts ((R/C, B, MP) M, X, Y) or None.
    """
    R, B, _ = prof.shape
    MP = codes2.shape[1]
    og, eg = jnp.float32(og), jnp.float32(eg)
    so, se, sent = _boundary(mode, og, eg)
    local = mode == LOCAL
    n = n.astype(jnp.int32)
    m = m.astype(jnp.int32)
    c2 = codes2.astype(jnp.int32)
    jl = jax.lax.broadcasted_iota(jnp.int32, (B, MP), 1)  # lane l <-> j=l+1
    jf = (jl + 1).astype(jnp.float32)
    lanef = jl.astype(jnp.float32)
    if carry0 is None:
        carry0 = row0_carries(B, MP, mode, og, eg)
    if mode == GLOCAL:
        last_col = jl + 1 == m[:, None]
        qo = jnp.where(last_col, so, og)
        qe = jnp.where(last_col, se, eg)
    else:
        qo, qe = og, eg

    def row(carry, x):
        (Mp, Xp, Yp), acc = carry
        prow, i = x
        fi = i.astype(jnp.float32)
        lsc_im1 = (fi - 1.0) * se + (so - se)
        lsc_i = fi * se + (so - se)
        first = i == 1
        # M from (i-1, j-1); (i-1, 0) is (0, -1, -1) at the origin
        Md = _shift(Mp, jnp.where(first, 0.0, lsc_im1 + sent))
        Xd = _shift(Xp, jnp.where(first, -1.0, lsc_im1 + sent))
        Yd = _shift(Yp, jnp.where(first, -1.0, lsc_im1))
        prev_m = jnp.where(Md >= Xd, jnp.where(Md >= Yd, 0, 2),
                           jnp.where(Xd >= Yd, 1, 2))
        srow = jnp.take_along_axis(prow, c2, axis=1)
        val_m = jnp.maximum(jnp.maximum(Md, Xd), Yd) + srow
        # Y from (i-1, j)
        if local:
            c1 = Mp + og >= Yp + eg
            c2_ = Mp > Xp
            c3 = Yp + eg > Xp + og
            val_y = jnp.where(c1, jnp.where(c2_, Mp + og, Xp + og),
                              jnp.where(c3, Yp + eg, Xp + og))
        else:
            c1 = Mp + qo > Yp + qe
            c2_ = Mp >= Xp
            c3 = Yp + qe >= Xp + qo
            val_y = jnp.maximum(jnp.maximum(Mp + qo, Yp + qe), Xp + qo)
        prev_y = jnp.where(c1, jnp.where(c2_, 0, 1), jnp.where(c3, 2, 1))
        if local:
            val_m = jnp.maximum(val_m, 0.0)
            val_y = jnp.maximum(val_y, 0.0)
        # X from (i, j-1): X(j) = max_{k<j} H(k) + (j-1)*pe with
        # H(k) = G(k) - k*pe, G = max(M, Y) + po, and H(0) folding in the
        # boundary extend
        if local:
            po, pe = og, eg
        else:
            last_row = (i == n)[:, None]
            po = jnp.where(last_row, so, og)
            pe = jnp.where(last_row, se, eg)
        x0b = lsc_i + sent
        G = jnp.maximum(val_m, val_y) + po
        H0 = jnp.maximum(jnp.maximum(lsc_i + sent, lsc_i) + po, x0b + pe)
        C = jax.lax.cummax(_shift(G - jf * pe, H0), axis=1)
        val_x = C + lanef * pe
        if local:
            val_x = jnp.maximum(val_x, 0.0)
        Mm1 = _shift(val_m, lsc_i + sent)
        Xm1 = _shift(val_x, x0b)
        Ym1 = _shift(val_y, lsc_i)
        if local:
            d1 = Mm1 + og >= Xm1 + eg
            d2 = Mm1 > Ym1
            d3 = Xm1 + eg > Ym1 + og
        else:
            d1 = Mm1 + po > Xm1 + pe
            d2 = Mm1 >= Ym1
            d3 = Xm1 + pe >= Ym1 + po
        prev_x = jnp.where(d1, jnp.where(d2, 0, 2), jnp.where(d3, 1, 2))
        if local:
            prev_m = jnp.where(val_m == 0.0, CELL_STOP, prev_m)
            prev_x = jnp.where(val_x == 0.0, CELL_STOP, prev_x)
            prev_y = jnp.where(val_y == 0.0, CELL_STOP, prev_y)
            # running best per column, strict `>` keeps the first row
            rbv, rbi = acc
            valid = (jl < m[:, None]) & (i <= n)[:, None]
            upd = jnp.where(valid, val_m, NEG) > rbv
            acc = (jnp.where(upd, val_m, rbv), jnp.where(upd, i, rbi))
        else:
            at = (i == n)[:, None]
            col = (m - 1)[:, None]
            acc = tuple(
                jnp.where(at, jnp.take_along_axis(v, col, axis=1), f)
                for v, f in zip((val_m, val_x, val_y), acc)
            )
        tb = None
        if emit_tb:
            tb = (prev_m | (prev_x << 2) | (prev_y << 4)).astype(jnp.uint8)
        return ((val_m, val_x, val_y), acc), tb

    if local:
        acc0 = (jnp.full((B, MP), NEG, jnp.float32),
                jnp.full((B, MP), BIGI, jnp.int32))
    else:
        acc0 = tuple(jnp.zeros((B, 1), jnp.float32) for _ in range(3))
    C = ckpt_rows or R
    if R % C:
        raise ValueError(f"{R} rows are not a multiple of ckpt_rows {C}")
    rows_i = (jnp.asarray(i0, jnp.int32) + 1
              + jnp.arange(R, dtype=jnp.int32)).reshape(R // C, C)

    def segment(carry, x):
        carry, tb = jax.lax.scan(row, carry, x)
        return carry, (tb, carry[0])

    (carry, acc), (tb, cks) = jax.lax.scan(
        segment, (tuple(carry0), acc0),
        (prof.reshape(R // C, C, B, -1), rows_i),
    )
    if emit_tb:
        tb = tb.reshape(R, B, MP)
    stats = _stats(acc, mode, jl)
    return tb, stats, (cks if ckpt_rows else None)


def _stats(acc, mode: int, jl):
    B = jl.shape[0]
    if mode == LOCAL:
        rbv, rbi = acc
        gmax = jnp.max(rbv, axis=1, keepdims=True)
        cand = rbv == gmax
        min_i = jnp.min(jnp.where(cand, rbi, BIGI), axis=1, keepdims=True)
        min_j = jnp.min(jnp.where(cand & (rbi == min_i), jl, BIGI), axis=1,
                        keepdims=True) + 1
        head = [gmax, min_i.astype(jnp.float32), min_j.astype(jnp.float32),
                jnp.zeros((B, 3), jnp.float32)]
    else:
        head = [jnp.zeros((B, 3), jnp.float32), *acc]
    return jnp.concatenate(head + [jnp.zeros((B, 2), jnp.float32)], axis=1)


@functools.partial(jax.jit,
                   static_argnames=("mode", "og", "eg", "score_only"))
def fill_xla(table, codes1, codes2, n, m, *, mode: int, og: float,
             eg: float, score_only: bool = False):
    """Plain-JAX fill of a batch: returns (tb (1, NP, B, MP) or None,
    stats (B, 8))."""
    B, NP = codes1.shape
    tb, stats, _ = fill_rows(
        profile(table, codes1), codes2, n, m, mode=mode, og=og, eg=eg,
        emit_tb=not score_only,
    )
    if tb is not None:
        tb = tb.reshape(1, NP, B, codes2.shape[1])
    return tb, stats


def fill(table, codes1, codes2, n, m, *, backend: str, mode: int, og: float,
         eg: float, score_only: bool = False, quarter: bool = False
         ) -> Tuple[Optional[jax.Array], jax.Array]:
    """Fill a batch of pairs on the chosen backend; see the module
    docstring for the result layout.  ``quarter`` (static) says the
    table and penalties pass :func:`quarter_exact`."""
    if backend == "cuda":
        from . import cuda_fill

        return cuda_fill.fill(table, codes1, codes2, n, m, mode=mode, og=og,
                              eg=eg, score_only=score_only, quarter=quarter)
    if backend != "xla":
        raise ValueError(f"unknown fill backend {backend!r}")
    return fill_xla(table, codes1, codes2, n, m, mode=mode, og=og, eg=eg,
                    score_only=score_only)
