"""Sequence-tiled DP: one (giant) alignment striped across a device mesh.

The analogue of tensor/sequence parallelism for DP wavefronts (SURVEY.md
§2.5): the column axis of a single DP matrix is sharded over a ``('x',)``
mesh, and devices process row blocks in a software-pipelined wavefront —
device d computes row block r as soon as device d-1 has finished the same
rows.  The only cross-device traffic is each block's right-edge carry
(M, X, Y boundary values plus the max-plus prefix-scan running max C —
4 floats per row per pair), passed with ``lax.ppermute`` between neighbouring devices.

The prefix-scan composition is exact: with H[k] = G[k] - k*ge on *global*
column indices, cummax composes associatively across shards, so scores are
bit-identical to the single-device fill (tests/test_seq_tiled.py).

Full tracebacks for striped pairs (the reference always returns alignment
strings for anything it scores, opencl_sequence_alignment.rs:765-795) use
the same two-phase design as ops/longseq.py, striped:

  1. ``striped_fill_ckpt`` — score + exact global argmax, checkpointing the
     (M, X, Y) carry rows every ``ckpt_rows`` rows (sharded on columns).
  2. ``striped_align`` — walks the path top-down in ``ckpt_rows`` segments;
     each segment is re-filled from its checkpoint with ``striped_band_tb``
     (emitting packed pointer bytes across all shards), and walked on host
     with ops/longseq.walk_band.  Re-fill replays identical tie-breaks, so
     the path is bit-identical to the single-device scan fill.

Cell rules mirror ops/scan_dp.fill (every >=/> cited there to the
reference's rust source); equivalence enforced by tests/test_seq_tiled.py.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..config import CELL_MATCH, CELL_STOP, GLOBAL, GLOCAL, LOCAL
from ..ops.fill import row0_carries

NEG = -3.0e38
BIGI = 2**30


def _row_cells(
    mode, og, eg, so, se, sent,
    i,                  # () int32 — global 1-based row
    jg, jgf,            # (P, W) int32 / f32 — global column per lane
    srow,               # (P, W) f32 substitution scores of this row
    cm, cx, cy,         # (P, W) previous-row (M, X, Y)
    ebm, ebx, eby, ebc,  # (P, 1) left-edge [M, X, Y, C] at (i, col0)
    abm, abx, aby,      # (P, 1) left-edge [M, X, Y] at (i-1, col0)
    nvec, mvec,         # (P, 1) true lengths
    emit_tb: bool,
):
    """One striped DP row over local lanes — the exact cell rules of
    ops/scan_dp.fill.

    Returns (val_m, val_x, val_y, c, tb_row-or-None); ``c`` is the running
    cummax of the global-domain H (its last lane rides the edge payload).
    """
    fi = i.astype(jnp.float32) if hasattr(i, "astype") else jnp.float32(i)
    lsc_i = fi * se + (so - se)
    P, W = cm.shape

    def shift_fn(v, fill):
        return jnp.concatenate([fill, v[:, :-1]], axis=1)

    if emit_tb:
        Mp1 = shift_fn(cm, abm)
        Xp1 = shift_fn(cx, abx)
        Yp1 = shift_fn(cy, aby)
        val_m = jnp.maximum(jnp.maximum(Mp1, Xp1), Yp1) + srow
        m_ge_x = Mp1 >= Xp1
        m_ge_y = Mp1 >= Yp1
        x_ge_y = Xp1 >= Yp1
        prev_m = jnp.where(
            m_ge_x, jnp.where(m_ge_y, 0, 2), jnp.where(x_ge_y, 1, 2)
        )
    else:
        # fused max3: max3 is associative and commutes with the lane
        # shift, and the fused boundary fill is the max of the three
        # per-state fills — ONE shift instead of three, bit-identical by
        # construction
        W3 = jnp.maximum(jnp.maximum(cm, cx), cy)
        fill_w = jnp.maximum(jnp.maximum(abm, abx), aby)
        val_m = shift_fn(W3, fill_w) + srow

    if mode == GLOCAL:
        last_col = jg == mvec
        qo = jnp.where(last_col, so, og)
        qe = jnp.where(last_col, se, eg)
    else:
        qo, qe = og, eg

    if mode == LOCAL:
        # rs:233-252 — `>=` favors M-open, inner `>` favors X on ties
        if emit_tb:
            c1 = cm + og >= cy + eg
            c2 = cm > cx
            c3 = cy + eg > cx + og
        val_y = jnp.maximum(jnp.maximum(cm, cx) + og, cy + eg)
        val_m = jnp.maximum(val_m, 0.0)
        val_y = jnp.maximum(val_y, 0.0)
    else:
        # rs:192-211 — strict `>` for M-open vs Y-extend
        if emit_tb:
            c1 = cm + qo > cy + qe
            c2 = cm >= cx
            c3 = cy + qe >= cx + qo
        val_y = jnp.maximum(jnp.maximum(cm + qo, cy + qe), cx + qo)
    if emit_tb:
        prev_y = jnp.where(c1, jnp.where(c2, 0, 1), jnp.where(c3, 2, 1))

    if mode == GLOCAL:
        lr = i == nvec
        po = jnp.where(lr, so, og)
        pe = jnp.where(lr, se, eg)
    else:
        po, pe = og, eg

    # X via the global-domain prefix scan: H[k] = G[k] - k*pe
    g_edge = jnp.maximum(ebm, eby) + po  # G at col0
    gline = jnp.maximum(val_m, val_y) + po
    hraw = shift_fn(gline, g_edge)
    jgf_pe = (jgf - 1.0) * pe
    h = hraw - jgf_pe
    # The h0 fold h[0] <- max(h[0], x0b + pe) is a VALUE no-op in every
    # mode: device-0 lane 0 holds
    # g_edge = lsc_i + po and x0b + pe - g_edge = sent + pe - po
    # = 9og + 11eg <= 0 for admissible penalties, with equal values on
    # equality; non-zero shards never have global j == 1.  Skipped
    # (saves an iota-compare + select + max per row).
    c = jnp.maximum(jax.lax.cummax(h, axis=1), ebc)
    val_x = c + jgf_pe
    if mode == LOCAL:
        val_x = jnp.maximum(val_x, 0.0)

    tb_row = None
    if emit_tb:
        # X predecessor pointers, recovered elementwise; the (i, j-1)
        # values at the shard's left edge come from eb (rs:172-231)
        Mm1 = shift_fn(val_m, ebm)
        Xm1 = shift_fn(val_x, ebx)
        Ym1 = shift_fn(val_y, eby)
        if mode == LOCAL:
            d1 = Mm1 + og >= Xm1 + eg
            d2 = Mm1 > Ym1
            d3 = Xm1 + eg > Ym1 + og
        else:
            d1 = Mm1 + po > Xm1 + pe
            d2 = Mm1 >= Ym1
            d3 = Xm1 + pe >= Ym1 + po
        prev_x = jnp.where(d1, jnp.where(d2, 0, 2), jnp.where(d3, 1, 2))
        if mode == LOCAL:
            prev_m = jnp.where(val_m == 0.0, CELL_STOP, prev_m)
            prev_x = jnp.where(val_x == 0.0, CELL_STOP, prev_x)
            prev_y = jnp.where(val_y == 0.0, CELL_STOP, prev_y)
        tb_row = (prev_m | (prev_x << 2) | (prev_y << 4)).astype(jnp.uint8)

    return val_m, val_x, val_y, c, tb_row


def _build_local_fill(
    *, mode, og, eg, B, NP, MP, K, D, ax,
    ckpt_rows=None, emit_tb=False, seeded=False, track_arg=False,
):
    """Build the per-shard fill function for ``shard_map``.

    Flag combinations used by the public wrappers:
      * plain score fill: no flags (striped_fill)
      * checkpointed fill: ckpt_rows + track_arg (striped_fill_ckpt)
      * band re-fill: seeded + emit_tb (striped_band_tb)
    """
    W = MP // D
    NB = NP // K
    T = NB + D - 1
    C = ckpt_rows
    NCK = (NP // C) if C else 0
    if mode == GLOBAL:
        so, se = og, eg
    else:
        so, se = 0.0, 0.0
    sent = 10.0 * og + 10.0 * eg

    def local_fill(S_l, n_g, m_g, *rest):
        if seeded:
            i0, icm_l, icx_l, icy_l = rest
            i0 = i0.reshape(())
        else:
            i0 = jnp.int32(0)
        d = jax.lax.axis_index(ax)
        col0 = d * W                      # global column left of our lanes
        lane = jnp.arange(W, dtype=jnp.int32)
        jg = col0 + lane + 1              # global j of each local lane
        jgf = jg.astype(jnp.float32)
        nv = n_g.reshape(B, 1)
        mv = m_g.reshape(B, 1)
        is_dev0 = d == 0
        lane0_is_j1 = (jg == 1)[None, :]  # true only on device 0

        if mode == GLOCAL:
            last_col = jg[None, :] == mv
            qo = jnp.where(last_col, so, og)
            qe = jnp.where(last_col, se, eg)
        else:
            qo, qe = og, eg
        valid_j = jg[None, :] <= mv

        def lsc(fi):
            return fi * se + (so - se)

        if seeded:
            cm0, cx0, cy0 = icm_l, icx_l, icy_l
        else:
            # row-0 carries for local columns (closed form, rs:100-108)
            l0 = lsc(jgf)
            cm0 = jnp.broadcast_to(l0 + sent, (B, W))
            cx0 = jnp.broadcast_to(l0, (B, W))
            cy0 = jnp.broadcast_to(l0 + sent, (B, W))

        def dev0_edge(i):
            """Closed-form [M, X, Y, C] payload at the true j=0 boundary of
            row i (rs:109-117); C=NEG — H[0] is folded in inside row_math."""
            li = lsc(i.astype(jnp.float32))
            return jnp.broadcast_to(
                jnp.stack([li + sent, li + sent, li, jnp.float32(NEG)]),
                (B, 4),
            )

        def dev0_above(i):
            """Closed-form [M, X, Y] at (i, 0); (0,0) is the origin cell."""
            li = lsc(i.astype(jnp.float32))
            at0 = i == 0
            return jnp.broadcast_to(
                jnp.stack(
                    [
                        jnp.where(at0, 0.0, li + sent),
                        jnp.where(at0, -1.0, li + sent),
                        jnp.where(at0, -1.0, li),
                    ]
                ),
                (B, 3),
            )

        jg2 = jnp.broadcast_to(jg[None, :], (B, W))
        jgf2 = jnp.broadcast_to(jgf[None, :], (B, W))

        def row_math(i, srow, cm, cx, cy, eb, eb_above):
            """One DP row over the local lanes (_row_cells).

            eb: (B, 4) [M, X, Y, C] at (i, col0); C = running max of
                H[0..col0-1] (global domain).
            eb_above: (B, 3) [M, X, Y] at (i-1, col0).
            Returns (val_m, val_x, val_y, edge, tb_row|None).
            """
            vm, vx, vy, c, tb_row = _row_cells(
                mode, og, eg, so, se, sent, i, jg2, jgf2,
                srow, cm, cx, cy,
                eb[:, 0:1], eb[:, 1:2], eb[:, 2:3], eb[:, 3:4],
                eb_above[:, 0:1], eb_above[:, 1:2], eb_above[:, 2:3],
                nv, mv, emit_tb,
            )
            edge = jnp.stack(
                [vm[:, -1], vx[:, -1], vy[:, -1], c[:, -1]], axis=1
            )
            return vm, vx, vy, edge, tb_row

        def step(carry, t):
            (cm, cx, cy, inbox, above, runbest, runbest_i, acc,
             cks, tb_buf) = carry
            r = t - d
            active = (r >= 0) & (r < NB)
            r_c = jnp.clip(r, 0, NB - 1)
            Sblk = jax.lax.dynamic_slice(S_l, (0, r_c * K, 0), (B, K, W))

            def row_body(rc, q):
                cm, cx, cy, outbox, above_row, rb, rbi, a3, tbs = rc
                i = i0 + r_c * K + q + 1
                eb = jnp.where(is_dev0, dev0_edge(i), inbox[:, q, :])
                eb_above = jnp.where(
                    is_dev0, dev0_above(i - 1), above_row
                )
                vm, vx, vy, edge, tb_row = row_math(
                    i, Sblk[:, q, :], cm, cx, cy, eb, eb_above
                )
                outbox = outbox.at[:, q, :].set(edge)
                if mode == LOCAL:
                    mask = valid_j & (i <= nv)
                    masked = jnp.where(mask, vm, NEG)
                    if track_arg:
                        # per-lane strict `>` keeps the first (smallest) i
                        upd = masked > rb
                        rb = jnp.where(upd, masked, rb)
                        rbi = jnp.where(upd, i, rbi)
                    else:
                        rb = jnp.maximum(rb, masked)
                else:
                    take = (i == nv) & (jg[None, :] == mv)
                    a3 = a3 + jnp.stack(
                        [
                            jnp.sum(jnp.where(take, vm, 0.0), axis=1),
                            jnp.sum(jnp.where(take, vx, 0.0), axis=1),
                            jnp.sum(jnp.where(take, vy, 0.0), axis=1),
                        ],
                        axis=1,
                    )
                if emit_tb:
                    tbs = tbs.at[:, q, :].set(tb_row)
                next_above = jnp.where(
                    is_dev0, dev0_above(i), inbox[:, q, :3]
                )
                return (vm, vx, vy, outbox, next_above, rb, rbi,
                        a3, tbs), None

            outbox0 = jnp.zeros((B, K, 4), jnp.float32)
            tbs0 = (
                jnp.zeros((B, K, W), jnp.uint8)
                if emit_tb
                else jnp.zeros((), jnp.uint8)
            )
            (cm2, cx2, cy2, outbox, _, rb2, rbi2, a32, tbs), _ = (
                jax.lax.scan(
                    row_body,
                    (cm, cx, cy, outbox0, above, runbest, runbest_i,
                     acc, tbs0),
                    jnp.arange(K),
                )
            )

            cm = jnp.where(active, cm2, cm)
            cx = jnp.where(active, cx2, cx)
            cy = jnp.where(active, cy2, cy)
            runbest = jnp.where(active, rb2, runbest)
            if track_arg:
                runbest_i = jnp.where(active, rbi2, runbest_i)
            acc = jnp.where(active, a32, acc)
            above = jnp.where(active, inbox[:, K - 1, :3], above)
            if C:
                # checkpoint the carries when this block closes a segment
                at_ck = active & (((r_c + 1) * K) % C == 0)
                idx = jnp.clip((r_c + 1) * K // C - 1, 0, NCK - 1)
                ckm, ckx, cky = cks
                old = jax.lax.dynamic_slice(ckm, (0, idx, 0), (B, 1, W))
                ckm = jax.lax.dynamic_update_slice(
                    ckm, jnp.where(at_ck, cm[:, None, :], old), (0, idx, 0)
                )
                old = jax.lax.dynamic_slice(ckx, (0, idx, 0), (B, 1, W))
                ckx = jax.lax.dynamic_update_slice(
                    ckx, jnp.where(at_ck, cx[:, None, :], old), (0, idx, 0)
                )
                old = jax.lax.dynamic_slice(cky, (0, idx, 0), (B, 1, W))
                cky = jax.lax.dynamic_update_slice(
                    cky, jnp.where(at_ck, cy[:, None, :], old), (0, idx, 0)
                )
                cks = (ckm, ckx, cky)
            if emit_tb:
                old = jax.lax.dynamic_slice(
                    tb_buf, (0, r_c * K, 0), (B, K, W)
                )
                tb_buf = jax.lax.dynamic_update_slice(
                    tb_buf,
                    jnp.where(active, tbs, old),
                    (0, r_c * K, 0),
                )
            outbox = jnp.where(active, outbox, jnp.zeros_like(outbox))
            inbox = jax.lax.ppermute(
                outbox, ax, [(a, (a + 1) % D) for a in range(D)]
            )
            return (cm, cx, cy, inbox, above, runbest, runbest_i, acc,
                    cks, tb_buf), None

        # initial "above" edge: values at (i0, col0)
        if seeded:
            # the left neighbor's last-lane checkpoint carries ARE the
            # (i0, col0) values; device 0 uses the closed form
            edge_pack = jnp.stack(
                [icm_l[:, -1], icx_l[:, -1], icy_l[:, -1]], axis=1
            )
            from_left = jax.lax.ppermute(
                edge_pack, ax, [(a, (a + 1) % D) for a in range(D)]
            )
            above0 = jnp.where(is_dev0, dev0_above(i0), from_left)
        else:
            l0c = lsc(col0.astype(jnp.float32))
            above0 = jnp.broadcast_to(
                jnp.where(
                    is_dev0,
                    jnp.stack(
                        [jnp.float32(0.0), jnp.float32(-1.0), jnp.float32(-1.0)]
                    ),
                    jnp.stack([l0c + sent, l0c, l0c + sent]),
                ),
                (B, 3),
            )
        cks0 = (
            tuple(jnp.zeros((B, NCK, W), jnp.float32) for _ in range(3))
            if C
            else ((), (), ())
        )
        tb_buf0 = (
            jnp.zeros((B, NP, W), jnp.uint8) if emit_tb else jnp.zeros((), jnp.uint8)
        )
        carry0 = (
            cm0,
            cx0,
            cy0,
            jnp.zeros((B, K, 4), jnp.float32),
            above0,
            jnp.full((B, W), NEG, jnp.float32),
            jnp.full((B, W), BIGI, jnp.int32),
            jnp.zeros((B, 3), jnp.float32),
            cks0,
            tb_buf0,
        )
        carry, _ = jax.lax.scan(step, carry0, jnp.arange(T))
        (_, _, _, _, _, runbest, runbest_i, acc, cks, tb_buf) = carry

        outs = []
        if mode == LOCAL:
            if track_arg:
                # exact global argmax: max score, then min i, then min j
                # (first-encounter rule, rs:282-295)
                gmax = jax.lax.pmax(jnp.max(runbest, axis=1), ax)  # (B,)
                cand = runbest == gmax[:, None]
                ci = jnp.where(cand, runbest_i, BIGI)
                min_i = jax.lax.pmin(jnp.min(ci, axis=1), ax)
                cj = jnp.where(
                    cand & (runbest_i == min_i[:, None]), jg[None, :], BIGI
                )
                min_j = jax.lax.pmin(jnp.min(cj, axis=1), ax)
                stats = jnp.stack(
                    [
                        gmax,
                        min_i.astype(jnp.float32),
                        min_j.astype(jnp.float32),
                    ]
                    + [jnp.zeros((B,), jnp.float32)] * 5,
                    axis=1,
                )
            else:
                stats = jax.lax.pmax(jnp.max(runbest, axis=1), ax)  # (B,)
            outs.append(stats)
        else:
            fin = jax.lax.psum(acc, ax)  # (B, 3)
            if track_arg:
                zeros = jnp.zeros((B, 3), jnp.float32)
                stats = jnp.concatenate(
                    [zeros, fin, jnp.zeros((B, 2), jnp.float32)], axis=1
                )
                outs.append(stats)
            else:
                outs.append(fin)
        if C:
            outs.extend(cks)
        if emit_tb:
            outs.append(tb_buf)
        return tuple(outs) if len(outs) > 1 else outs[0]

    return local_fill


@functools.partial(
    jax.jit, static_argnames=("mode", "og", "eg", "block_rows", "mesh"),
)
def striped_fill(S, n, m, *, mode, og, eg, block_rows, mesh):
    """Score a batch of pairs with the column axis sharded over ``mesh``.

    Args:
      S: (B, NP, MP) dense f32 substitution scores (sharded or shardable
         as P(None, None, 'x'); MP must divide by the mesh size).
      n, m: (B,) int32 true lengths.
      block_rows: wavefront granularity (rows per pipeline step).
    Returns:
      LOCAL: (B,) best scores.  GLOBAL/GLOCAL: (B, 3) final (M, X, Y) at
      (n, m) — same contract as the fill's stats[3:6].
    """
    D = mesh.devices.size
    B, NP, MP = S.shape
    assert (MP // D) * D == MP, (MP, D)
    assert (NP // block_rows) * block_rows == NP, (NP, block_rows)
    ax = mesh.axis_names[0]
    fn = _build_local_fill(
        mode=mode, og=og, eg=eg, B=B, NP=NP, MP=MP, K=block_rows, D=D, ax=ax,
    )
    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(None, None, ax), P(None), P(None)),
        out_specs=P(),
        check_vma=False,
    )(S, n, m)


@functools.partial(
    jax.jit,
    static_argnames=("mode", "og", "eg", "block_rows", "ckpt_rows", "mesh"),
)
def striped_fill_ckpt(S, n, m, *, mode, og, eg, block_rows, ckpt_rows, mesh):
    """Striped score fill + exact argmax stats + carry checkpoints.

    Returns ``(stats, (ckm, ckx, cky))``: stats (B, 8) as in
    ops/fill.fill ([best, best_i, best_j, fM, fX, fY, 0, 0]);
    checkpoints (B, NP//ckpt_rows, MP) f32 sharded on columns — checkpoint k
    holds the carries after global row (k+1)*ckpt_rows.
    """
    B, NP, MP = S.shape
    D = mesh.devices.size
    K = block_rows
    assert (MP // D) * D == MP, (MP, D)
    assert (NP // K) * K == NP, (NP, K)
    assert ckpt_rows % K == 0 and NP % ckpt_rows == 0, (ckpt_rows, K, NP)
    ax = mesh.axis_names[0]
    fn = _build_local_fill(
        mode=mode, og=og, eg=eg, B=B, NP=NP, MP=MP, K=K, D=D, ax=ax,
        ckpt_rows=ckpt_rows, track_arg=True,
    )
    stats, ckm, ckx, cky = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(None, None, ax), P(None), P(None)),
        out_specs=(P(), P(None, None, ax), P(None, None, ax), P(None, None, ax)),
        check_vma=False,
    )(S, n, m)
    return stats, (ckm, ckx, cky)


@functools.partial(
    jax.jit,
    static_argnames=("mode", "og", "eg", "block_rows", "mesh"),
)
def striped_band_tb(
    S_band, n, m, i0, icm, icx, icy, *, mode, og, eg, block_rows, mesh,
):
    """Re-fill a C-row band from checkpointed carries, emitting packed
    traceback pointer bytes across all shards.

    Args:
      S_band: (B, C, MP) f32 scores for global rows i0+1 .. i0+C.
      i0: () int32 — global row above the band.
      icm/icx/icy: (B, MP) f32 carries at global row i0 (sharded on cols).
    Returns:
      tb: (B, C, MP) uint8 — tb[b, r, c] holds the packed pointers of DP
      cell (i0 + r + 1, c + 1).
    """
    B, C, MP = S_band.shape
    D = mesh.devices.size
    K = block_rows
    assert (MP // D) * D == MP, (MP, D)
    assert (C // K) * K == C, (C, K)
    ax = mesh.axis_names[0]
    fn = _build_local_fill(
        mode=mode, og=og, eg=eg, B=B, NP=C, MP=MP, K=K, D=D, ax=ax,
        emit_tb=True, seeded=True,
    )
    _, tb = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(
            P(None, None, ax), P(None), P(None), P(),
            P(None, ax), P(None, ax), P(None, ax),
        ),
        out_specs=(P(), P(None, None, ax)),
        check_vma=False,
    )(S_band, n, m, i0, icm, icx, icy)
    return tb


@functools.partial(
    jax.jit,
    static_argnames=("mode", "og", "eg", "block_rows", "mesh", "W", "C"),
)
def _striped_seg_windows(
    S, nv, mv, ckm, ckx, cky, m0, x0, y0, sk, bs, j0s,
    *, mode, og, eg, block_rows, mesh, W: int, C: int,
):
    """ONE device call per traceback segment: slice the segment's S band,
    select its seeds (checkpoint ``sk - 1`` or the closed-form row-0
    carries), run the striped band re-fill, and gather every active pair's
    (C, W) window — the only pointer bytes that leave the mesh.  Unfused,
    each of those steps was a separate dispatch round-trip per segment."""
    B, NP, MP = S.shape
    S_band = jax.lax.dynamic_slice(S, (0, sk * C, 0), (B, C, MP))
    idx = jnp.maximum(sk - 1, 0)

    def seed(ck, r0):
        s = jax.lax.dynamic_slice(ck, (0, idx, 0), (B, 1, MP))
        return jnp.where(sk == 0, r0, s[:, 0])

    icm, icx, icy = seed(ckm, m0), seed(ckx, x0), seed(cky, y0)
    tb = striped_band_tb(
        S_band, nv, mv, (sk * C).astype(jnp.int32), icm, icx, icy,
        mode=mode, og=og, eg=eg, block_rows=block_rows, mesh=mesh,
    )

    def one(b, j0):
        sl = jax.lax.dynamic_slice(tb, (b, 0, j0), (1, C, W))
        return sl[0]

    return jax.vmap(one)(bs, j0s)


def striped_align(
    S,                     # (B, NP, MP) dense f32 scores (device/shardable)
    n: np.ndarray,         # (B,)
    m: np.ndarray,
    *,
    mode: int,
    og: float,
    eg: float,
    mesh,
    block_rows: int = 8,
    ckpt_rows: Optional[int] = None,
    window: Optional[int] = None,
):
    """Full alignment of column-striped pairs over a device mesh.

    The striped answer to ops/longseq.align_long: one checkpointed striped
    fill, then per-segment striped band re-fills walked on host.  Paths are
    bit-identical to the single-device scan fill (tests/test_seq_tiled.py).

    Returns ``(idx_lists, stats_np)``: idx_lists[b] = (idx1, idx2) aligned
    0-based index lists (-1 = gap); stats_np (B, 8).
    """
    from ..ops import longseq

    B, NP, MP = S.shape
    C = ckpt_rows or max(block_rows, min(256, NP))
    while NP % C or C % block_rows:
        C -= block_rows
    W = window or min(MP, -(-(2 * C + 128) // 128) * 128)
    W = min(W, MP)
    nv = jnp.asarray(np.asarray(n), jnp.int32)
    mv = jnp.asarray(np.asarray(m), jnp.int32)

    stats, (ckm, ckx, cky) = striped_fill_ckpt(
        S, nv, mv, mode=mode, og=og, eg=eg,
        block_rows=block_rows, ckpt_rows=C, mesh=mesh,
    )
    stats_np = np.array(stats)  # writable copy
    if mode != LOCAL:
        # start coords are closed-form for global/glocal
        stats_np[:, 1] = np.asarray(n, np.float32)
        stats_np[:, 2] = np.asarray(m, np.float32)

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
    m0d, x0d, y0d = row0_carries(B, MP, mode, og, eg)
    n_segs = NP // C
    for sk in range(n_segs - 1, -1, -1):
        active = [
            b for b in range(B)
            if cur[b] is not None and sk * C < cur[b][0] <= (sk + 1) * C
        ]
        if not active:
            continue
        pend = [(b, *cur[b]) for b in active]
        while pend:
            j0s_py = [max(0, min(j - W, MP - W)) for _, _, j, _ in pend]
            bs, j0s = longseq._pad_items(
                [(b, j0) for (b, *_), j0 in zip(pend, j0s_py)]
            )
            wins = np.asarray(_striped_seg_windows(
                S, nv, mv, ckm, ckx, cky, m0d, x0d, y0d,
                jnp.int32(sk), bs, j0s,
                mode=mode, og=og, eg=eg, block_rows=block_rows, mesh=mesh,
                W=W, C=C,
            ))
            nxt = []
            for k, (b, i, j, s) in enumerate(pend):
                c1, c2, i, j, s, status = longseq.walk_band(
                    wins[k], sk * C, j0s_py[k], i, j, s, local
                )
                chunks1[b].extend(c1)
                chunks2[b].extend(c2)
                if status == longseq.WALK_LEFT:
                    nxt.append((b, i, j, s))
                else:
                    cur[b] = None if status == longseq.WALK_DONE else (i, j, s)
            pend = nxt

    idx_lists = []
    for b in range(B):
        if cur[b] is not None:  # pragma: no cover - walk must terminate
            raise RuntimeError(f"incomplete traceback for pair {b}: {cur[b]}")
        idx_lists.append((chunks1[b][::-1], chunks2[b][::-1]))
    return idx_lists, stats_np
