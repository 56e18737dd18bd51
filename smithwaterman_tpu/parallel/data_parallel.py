"""Data-parallel fill over a device mesh.

The reference has no multi-device path (SURVEY.md §2.5); here alignment
pairs are sharded over a 1-D ``('data',)`` mesh with ``shard_map`` — each
device runs the fill (ops/fill.py) on its local pairs and, on the
device-walk route, walks them too, so the only cross-device traffic is the
initial scatter of int8 codes and the final gather of per-pair results.
Multi-host runs initialize with ``jax.distributed`` and shard the global
batch the same way.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import device_walk
from ..ops import fill as fill_ops


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D ``('data',)`` mesh over the first ``n_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("data",))


@functools.lru_cache(maxsize=64)
def _sharded_fn(mesh, backend, mode, og, eg, score_only, quarter, walk, L):
    """One sharded program: per-shard fill, then (``walk``) the per-shard
    device walk.  ``walk`` is None (return pointers + stats), "index"
    (device_walk.walk_bundle) or "packed" (walk_bundle_packed)."""

    def local(table, c1, c2, n, m):
        tb, stats = fill_ops.fill(
            table, c1, c2, n, m, backend=backend, mode=mode, og=og, eg=eg,
            score_only=score_only, quarter=quarter,
        )
        if walk is None:
            if tb is None:
                tb = jnp.zeros((1, 1, 1, 1), jnp.uint8)
            return tb, stats
        walker = (device_walk.walk_bundle_packed if walk == "packed"
                  else device_walk.walk_bundle)
        out = walker(tb, stats, n, m, mode=mode, L=L)
        return tuple(x[None] for x in out)  # leading axis: one per shard

    spec = P("data")
    n_out = 2 if walk in (None, "index") else 3
    return jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=(P(), spec, spec, spec, spec),
            out_specs=(spec,) * n_out,
            # ffi_call results carry no varying-axis info; skip the check
            check_vma=False,
        )
    )


class DataParallel:
    """Shards batch fills over a ``('data',)`` mesh."""

    def __init__(self, mesh: Optional[Mesh] = None, n_devices: Optional[int] = None):
        self.mesh = mesh if mesh is not None else make_mesh(n_devices)
        self.n_devices = self.mesh.devices.size

    def _run(self, table, codes1, codes2, n, m, *, backend, mode, og, eg,
             score_only, quarter, walk, L):
        B = codes1.shape[0]
        if B % self.n_devices:
            raise ValueError(
                f"pair count {B} not divisible by mesh size {self.n_devices}"
            )
        fn = _sharded_fn(self.mesh, backend, int(mode), float(og),
                         float(eg), bool(score_only), bool(quarter), walk,
                         int(L))
        return fn(jnp.asarray(np.asarray(table, np.float32)),
                  jnp.asarray(codes1), jnp.asarray(codes2),
                  jnp.asarray(np.asarray(n), jnp.int32),
                  jnp.asarray(np.asarray(m), jnp.int32))

    def fill(self, table, codes1, codes2, n, m, *, backend: str, mode: int,
             og: float, eg: float, score_only: bool = False,
             quarter: bool = False):
        """Sharded fill; returns HOST arrays (tb (G, NP, T, MP) or None,
        stats (B, 8)) in pair order (shard-major)."""
        tb, stats = self._run(
            table, codes1, codes2, n, m, backend=backend, mode=mode, og=og,
            eg=eg, score_only=score_only, quarter=quarter, walk=None, L=0,
        )
        tb, stats = jax.device_get((tb, stats))
        return (None if score_only else tb), np.asarray(stats)

    def fill_walk_bundle(self, table, codes1, codes2, n, m, *, backend: str,
                         mode: int, og: float, eg: float, L: int,
                         quarter: bool = False):
        """Fill + device walk, sharded; returns DEVICE arrays
        (stats (D, Bp, 8) f32, idx (D, 2, L, Bp)) — decode per shard with
        ops.device_walk.decode_bundle; global pair order = shard-major."""
        return self._run(
            table, codes1, codes2, n, m, backend=backend, mode=mode, og=og,
            eg=eg, score_only=False, quarter=quarter, walk="index", L=L,
        )

    def fill_walk_bundle_packed(self, table, codes1, codes2, n, m, *,
                                backend: str, mode: int, og: float,
                                eg: float, L: int, quarter: bool = False):
        """Fill + packed device walk, sharded; returns DEVICE arrays
        (stats (D, Bp, 8) f32, cnt (D, Bp) i32, moves (D, ceil(L/4), Bp)
        u8) — walk_bundle_packed's contract per shard, shard-major pair
        order."""
        return self._run(
            table, codes1, codes2, n, m, backend=backend, mode=mode, og=og,
            eg=eg, score_only=False, quarter=quarter, walk="packed", L=L,
        )
