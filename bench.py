#!/usr/bin/env python3
"""Benchmark: DP cell updates/s of the served fill on one GPU.

Prints ONE JSON line: the fill's GCUPS on 512 pairs of 512x512 protein DP
(BLOSUM62, go=10/ge=0.5, LOCAL, full traceback output — the reference
suite's median-length regime), stamped with the backend, JAX's device and
the card's name and power limit.  Times are host wall clock around
``block_until_ready``, best of five warm calls.  Exits 1 without a GPU.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

B, NP, MP, REPS = 512, 512, 512, 5


def measure(backend: str) -> float:
    """Best-of-REPS seconds of one warm fill call."""
    import jax
    import numpy as np

    from smithwaterman_tpu.config import LOCAL
    from smithwaterman_tpu.matrices import SubstitutionMatrix
    from smithwaterman_tpu.ops import fill

    sm = SubstitutionMatrix.blosum62()
    rng = np.random.default_rng(0)
    args = [jax.device_put(x) for x in (
        np.asarray(sm.table, np.float32),
        rng.integers(0, 20, size=(B, NP)).astype(np.int8),
        rng.integers(0, 20, size=(B, MP)).astype(np.int8),
        np.full(B, NP, np.int32), np.full(B, MP, np.int32),
    )]
    f = jax.jit(lambda t, a, b, n, m: fill.fill(
        t, a, b, n, m, backend=backend, mode=LOCAL, og=-10.0, eg=-0.5,
        quarter=fill.quarter_exact(sm.table, -10.0, -0.5)))
    jax.block_until_ready(f(*args))  # compile + warm
    best = None
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def main() -> int:
    from smithwaterman_tpu import platform

    try:
        dev = platform.require_gpu()
    except RuntimeError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        return 1
    import jax

    backend = platform.default_backend()
    dt = measure(backend)
    print(json.dumps({
        "metric": "dp_cell_updates_per_card",
        "value": round(B * NP * MP / dt / 1e9, 2),
        "unit": "GCUPS",
        "workload": f"{B}x{NP}x{MP} local traceback, fill only",
        "backend": backend,
        "seconds": dt,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": platform.card(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
