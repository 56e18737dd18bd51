"""Batched device pipeline: pooled fills and the scan fallback.

The reference aligns pairs one at a time in a host loop
(/root/reference/rust/sequence_alignment/src/main.rs:35-44); this pipeline
pads pairs into (npad, mpad) length buckets and fills each bucket's pairs
side by side on the device (ops/fill.py), then walks the pointers on the
device (ops/device_walk.py) or on the host (ops/traceback.walk_tiled).

A vmapped ``ops.scan_dp.fill`` provides the same contract on any backend
(CPU tests, correctness cross-checks).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import fill as fill_ops
from . import scan_dp


@functools.partial(jax.jit, static_argnames=(
    "backend", "quarter", "mode", "og", "eg", "metas",
))
def fill_many(table, flats, lens, *, backend: str, quarter: bool, mode: int,
              og: float, eg: float, metas):
    """Fills of MANY bucket-chunks in ONE dispatched program — the
    fill-side analogue of ``device_walk.walk_bundle_pooled``.

    Each chunk ships ONE flat codes buffer (``codes1.ravel() ++
    codes2.ravel()``) and every chunk's lengths ride ONE shared array, so
    a call makes one upload per chunk plus one, whatever its bucket count.

    Args:
      table: (K, K) f32 scoring table (shared by every chunk).
      flats: tuple of per-chunk 1-D int8/int32 code buffers.
      lens:  (sum of 2*B over chunks,) int32: ``n_0 ++ m_0 ++ n_1 ++ ...``.
      metas: static tuple of per-chunk ``(B, NP, MP, score_only)``.

    Returns a tuple of per-chunk ``(tb, stats)`` DEVICE arrays (tb None for
    score-only chunks).  The program specializes on the ordered chunk-shape
    composition — callers must stage chunks in a canonical order (see
    BatchAligner._stage_fill) or every shuffled call of the same workload
    re-traces.
    """
    out = []
    off = 0
    for flat, (B, NP, MP, score_only) in zip(flats, metas):
        codes1 = flat[: B * NP].reshape(B, NP)
        codes2 = flat[B * NP:].reshape(B, MP)
        n = lens[off: off + B]
        m = lens[off + B: off + 2 * B]
        off += 2 * B
        out.append(fill_ops.fill(
            table, codes1, codes2, n, m, backend=backend, mode=mode, og=og,
            eg=eg, score_only=score_only, quarter=quarter,
        ))
    return tuple(out)


_scan_batch = jax.jit(
    jax.vmap(scan_dp.fill, in_axes=(0, 0, 0, None, None, None, None)),
    static_argnums=(5, 6),
)


def fill_scan(
    S_dense,
    n: np.ndarray,
    m: np.ndarray,
    *,
    mode: int,
    og: float,
    eg: float,
    score_only: bool = False,
):
    """vmapped lax.scan fallback; returns (FillResult-of-arrays)."""
    return _scan_batch(
        jnp.asarray(S_dense),
        jnp.asarray(n, jnp.int32),
        jnp.asarray(m, jnp.int32),
        jnp.float32(og),
        jnp.float32(eg),
        mode,
        not score_only,
    )


def tb_pair_view(tb_tiled: np.ndarray, pair_idx: int) -> np.ndarray:
    """(NP, MP) interior-pointer view of one pair from a (G, NP, T, MP)
    pointer array."""
    tile = tb_tiled.shape[2]
    g, t = divmod(pair_idx, tile)
    return tb_tiled[g, :, t, :]
