"""Reference DP fill: `lax.scan` over rows, vectorized across the j axis.

This is the portable exact-semantics engine.  The batched fills (ops/fill.py:
the plain-JAX row scan and the CUDA kernel) implement the same cell rules;
this module is the oracle they are tested against, and the CPU path.

Semantics parity (bit-exact, including tie-breaks) with the reference Rust
engine `fill_matrix`/`backtrack`
(/root/reference/rust/sequence_alignment/src/sequence_alignment.rs:55-387):

  * 3 states per cell: M (match), X (gap in seq1, consumes j), Y (gap in
    seq2, consumes i); prev-state pointers stored 2 bits each in one uint8.
  * M tie-break: ``M >= X``, then ``>= Y`` (rs:139-158).
  * X/Y tie-breaks differ between local (rs:213-253) and global/glocal
    (rs:164-211) — the ``>=`` vs ``>`` asymmetry is load-bearing for
    string-exact agreement with EMBOSS water/needle.
  * glocal: gap penalties switch to the free start penalties on the last
    row (for X) / last column (for Y) (rs:166-170).
  * boundary row/col: disallowed states get sentinel ``lscore + 10*og + 10*eg``
    (rs:100-117); cell (0,0) is (0, -1, -1) (rs:89-91).
  * local mode clamps all three states at 0 after selection (rs:256-260).

Design note: the reference fills cells serially; the only
j-sequential dependence in a row is the X recurrence
``X[j] = max(G[j-1], X[j-1] + pe)`` with ``G = max(M, Y) + po``.  That is a
max-plus prefix scan: ``X[j] = cummax(G[k] - k*pe)[j-1] + (j-1)*pe``.  All
scores are half-integers well inside float32's exact range, so the scan
reproduces the sequential recurrence bit-exactly, and the predecessor
pointers are recovered elementwise afterwards with the reference's exact
comparison cascades.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import CELL_STOP, GLOBAL, GLOCAL, LOCAL

# python float (not jnp): keep module import free of backend initialization
NEG = -3.0e38


class FillResult(NamedTuple):
    tb: jax.Array        # (npad+1, mpad+1) uint8 packed prev-state pointers
    best: jax.Array      # local: best M score (f32 scalar)
    best_i: jax.Array    # local: argmax row (first max, i-major) (int32)
    best_j: jax.Array    # local: argmax col within that row (int32)
    final: jax.Array     # global/glocal: (3,) scores of (M, X, Y) at (n, m)
    final_state: jax.Array  # global/glocal: argmax state (first max)


def _shift_right(v: jax.Array) -> jax.Array:
    """out[j] = v[j-1]; out[0] = v[0] (junk, always overwritten by j==0 logic)."""
    return jnp.concatenate([v[:1], v[:-1]])


def _row0(jvec, so, se, og, eg, mode):
    """Boundary row i==0 (rs:100-108) and origin cell (rs:88-93)."""
    sent = 10.0 * og + 10.0 * eg
    lsc = jvec.astype(jnp.float32) * se + (so - se)
    m0 = jnp.where(jvec == 0, 0.0, lsc + sent)
    x0 = jnp.where(jvec == 0, -1.0, lsc)
    y0 = jnp.where(jvec == 0, -1.0, lsc + sent)
    # prev: origin -> (M,M,M); row 0 -> (X,X,X)
    prev_m = jnp.where(jvec == 0, 0, 1)
    prev_x = jnp.where(jvec == 0, 0, 1)
    prev_y = jnp.where(jvec == 0, 0, 1)
    if mode == LOCAL:
        prev_m = jnp.where(m0 == 0.0, CELL_STOP, prev_m)
        prev_x = jnp.where(x0 == 0.0, CELL_STOP, prev_x)
        prev_y = jnp.where(y0 == 0.0, CELL_STOP, prev_y)
    tb0 = (prev_m | (prev_x << 2) | (prev_y << 4)).astype(jnp.uint8)
    return (m0, x0, y0), tb0


@functools.partial(
    jax.jit, static_argnames=("mode", "with_traceback")
)
def fill(S, n, m, og, eg, mode: int, with_traceback: bool = True) -> FillResult:
    """Fill the DP over a padded dense score matrix.

    Args:
      S: (npad, mpad) float32, S[i-1, j-1] = substitution score of pairing
         seq1[i-1] with seq2[j-1]; padded region arbitrary.
      n, m: true lengths (traced int32 scalars), 1 <= n <= npad, 1 <= m <= mpad.
      og, eg: negative gap open/extend penalties (traced f32 scalars).
      mode: GLOBAL / GLOCAL / LOCAL (static).
    """
    npad, mpad = S.shape
    og = jnp.float32(og)
    eg = jnp.float32(eg)
    if mode == GLOBAL:
        so, se = og, eg
    else:
        so, se = jnp.float32(0.0), jnp.float32(0.0)
    sent = 10.0 * og + 10.0 * eg

    jvec = jnp.arange(mpad + 1, dtype=jnp.int32)
    jf = jvec.astype(jnp.float32)
    (m0, x0, y0), tb0 = _row0(jvec, so, se, og, eg, mode)

    # Row-constant pieces for Y's last-column switch (glocal; rs:169-170).
    if mode == LOCAL:
        qo = jnp.full_like(jf, og)
        qe = jnp.full_like(jf, eg)
    else:
        qo = jnp.where(jvec == m, so, og)
        qe = jnp.where(jvec == m, se, eg)

    Spad = jnp.concatenate([jnp.zeros((npad, 1), jnp.float32), S], axis=1)
    ivec = jnp.arange(1, npad + 1, dtype=jnp.int32)

    def row_step(carry, inp):
        Mp, Xp, Yp = carry
        srow, i = inp
        fi = i.astype(jnp.float32)

        # ---- M state: from (i-1, j-1); tie order M >= X >= Y (rs:139-158).
        Mp1, Xp1, Yp1 = _shift_right(Mp), _shift_right(Xp), _shift_right(Yp)
        m_ge_x = Mp1 >= Xp1
        m_ge_y = Mp1 >= Yp1
        x_ge_y = Xp1 >= Yp1
        prev_m = jnp.where(m_ge_x, jnp.where(m_ge_y, 0, 2), jnp.where(x_ge_y, 1, 2))
        val_m = jnp.maximum(jnp.maximum(Mp1, Xp1), Yp1) + srow

        # ---- Y state: gap in seq2, from (i-1, j) (prev row, same j).
        if mode == LOCAL:
            # rs:233-252 — `>=` favors M-open, inner `>` favors X on ties.
            c1 = Mp + og >= Yp + eg
            c2 = Mp > Xp
            c3 = Yp + eg > Xp + og
            val_y = jnp.where(
                c1,
                jnp.where(c2, Mp + og, Xp + og),
                jnp.where(c3, Yp + eg, Xp + og),
            )
        else:
            # rs:192-211 — strict `>` for M-open vs Y-extend.
            c1 = Mp + qo > Yp + qe
            c2 = Mp >= Xp
            c3 = Yp + qe >= Xp + qo
            val_y = jnp.maximum(jnp.maximum(Mp + qo, Yp + qe), Xp + qo)
        prev_y = jnp.where(c1, jnp.where(c2, 0, 1), jnp.where(c3, 2, 1))

        if mode == LOCAL:
            val_m = jnp.maximum(val_m, 0.0)
            val_y = jnp.maximum(val_y, 0.0)

        # ---- boundary column j == 0 (rs:109-117).
        lsc_i = fi * se + (so - se)
        val_m = jnp.where(jvec == 0, lsc_i + sent, val_m)
        val_y = jnp.where(jvec == 0, lsc_i, val_y)
        prev_m = jnp.where(jvec == 0, 2, prev_m)
        prev_y = jnp.where(jvec == 0, 2, prev_y)

        # ---- X state: gap in seq1, from (i, j-1) (same row) — prefix scan.
        if mode == LOCAL:
            po, pe = og, eg
        else:
            # glocal: free gaps along the last row of seq1 (rs:166-167).
            last_row = i == n
            po = jnp.where(last_row, so, og)
            pe = jnp.where(last_row, se, eg)
        x0b = lsc_i + sent  # boundary X at (i, 0)
        G = jnp.maximum(val_m, val_y) + po
        H = G - jf * pe
        H = H.at[0].set(jnp.maximum(G[0], x0b + pe))
        C = jax.lax.cummax(H)
        val_x = _shift_right(C) + (jf - 1.0) * pe
        if mode == LOCAL:
            val_x = jnp.maximum(val_x, 0.0)
        val_x = jnp.where(jvec == 0, x0b, val_x)

        # ---- X predecessor pointers, recovered elementwise (same cascades).
        Mm1, Xm1, Ym1 = _shift_right(val_m), _shift_right(val_x), _shift_right(val_y)
        if mode == LOCAL:
            # rs:214-231
            d1 = Mm1 + og >= Xm1 + eg
            d2 = Mm1 > Ym1
            d3 = Xm1 + eg > Ym1 + og
        else:
            # rs:172-189
            d1 = Mm1 + po > Xm1 + pe
            d2 = Mm1 >= Ym1
            d3 = Xm1 + pe >= Ym1 + po
        prev_x = jnp.where(d1, jnp.where(d2, 0, 2), jnp.where(d3, 1, 2))
        prev_x = jnp.where(jvec == 0, 2, prev_x)

        if mode == LOCAL:
            prev_m = jnp.where(val_m == 0.0, CELL_STOP, prev_m)
            prev_x = jnp.where(val_x == 0.0, CELL_STOP, prev_x)
            prev_y = jnp.where(val_y == 0.0, CELL_STOP, prev_y)

        # ---- per-row outputs
        mask = (jvec >= 1) & (jvec <= m)
        masked = jnp.where(mask, val_m, NEG)
        rowmax = jnp.max(masked)
        rowarg = jnp.argmax(masked).astype(jnp.int32)
        lastcol = jnp.stack([val_m[m], val_x[m], val_y[m]])

        outs = (rowmax, rowarg, lastcol)
        if with_traceback:
            tb_row = (
                prev_m.astype(jnp.uint8)
                | (prev_x.astype(jnp.uint8) << 2)
                | (prev_y.astype(jnp.uint8) << 4)
            )
            outs = outs + (tb_row,)
        return (val_m, val_x, val_y), outs

    carry0 = (m0, x0, y0)
    carry, outs = jax.lax.scan(row_step, carry0, (Spad, ivec))
    rowmax, rowarg, lastcol = outs[:3]

    if with_traceback:
        tb = jnp.concatenate([tb0[None, :], outs[3]], axis=0)
    else:
        tb = jnp.zeros((1, 1), jnp.uint8)

    # local argmax: first row (i-major), then first column, strict `>`
    # (rs:282-295 — only the M state competes).
    rmask = ivec <= n
    rm = jnp.where(rmask, rowmax, NEG)
    bi = jnp.argmax(rm).astype(jnp.int32)
    best = rm[bi]
    best_i = bi + 1
    best_j = rowarg[bi]

    final = lastcol[n - 1]
    final_state = jnp.argmax(final).astype(jnp.int32)  # first max: M > X > Y

    return FillResult(tb, best, best_i, best_j, final, final_state)
