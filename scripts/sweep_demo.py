#!/usr/bin/env python3
"""Production all-vs-all sweep of the reference's full input set.

The reference's closest counterpart is the serial all-vs-all pair loop of
its CLIs (``main.rs:35-44``, ``sa_opencl/src/main.rs:298-315``) — one
alignment at a time, no resume, no metrics.  This demo runs the sweep the
production way: all 200 reference input sequences (``test/inputs/``),
upper-triangle self-sweep (19,900 pairs), score-only through the bucketed
device pipeline with job-level JSONL checkpointing (``sweep.py``) and
per-bucket observability (``utils/metrics.py``).

Validates a random sample of sweep scores against the traceback pipeline
(independent stats path through the same fill), then writes one JSON
artifact to stdout / sweep_demo.json.

Usage:  python -u scripts/sweep_demo.py [--out sweep_demo.json]
"""

import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    out = "sweep_demo.json"
    if "--out" in sys.argv:
        out = sys.argv[sys.argv.index("--out") + 1]
    limit = None
    if "--limit" in sys.argv:  # smoke-testing on CPU
        limit = int(sys.argv[sys.argv.index("--limit") + 1])

    import jax
    from smithwaterman_tpu import LOCAL, load_fasta
    from smithwaterman_tpu.batch_aligner import BatchAligner
    from smithwaterman_tpu.sweep import SweepConfig, score_matrix, sweep
    from smithwaterman_tpu.utils.metrics import StatsCollector

    backend = jax.default_backend()
    seqs = []
    for p in sorted(glob.glob("/root/reference/test/inputs/*.fas")):
        seqs.extend(load_fasta(p))
    if limit:
        seqs = seqs[:limit]
    n = len(seqs)
    n_pairs = n * (n - 1) // 2

    engine = BatchAligner(mode=LOCAL)
    engine.stats = StatsCollector()

    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "sweep.jsonl")
    t0 = time.time()
    chunks = sweep(seqs, None, engine, path,
                   SweepConfig(chunk_pairs=2048, score_only=True))
    wall = time.time() - t0
    cells = int(engine.stats.true_cells)
    run_s = float(engine.stats.run_seconds)  # before the cross-check
    M = score_matrix(seqs, None, engine, path,
                     SweepConfig(chunk_pairs=2048, score_only=True))

    # cross-check a sample against the traceback pipeline (independent
    # stats path: running-best argmax vs the walk-producing fill)
    rng = np.random.default_rng(0)
    ii = rng.integers(0, n, size=32)
    jj = rng.integers(0, n, size=32)
    sample = [(seqs[i], seqs[j]) for i, j in zip(ii, jj)]
    full = engine.align_pairs(sample)
    ok = all(
        abs(M[i, j] - r.score) < 1e-4 or (i == j)
        for i, j, r in zip(ii, jj, full)
    )

    rec = {
        "metric": "all_vs_all_sweep",
        "backend": backend,
        "sequences": n,
        "pairs": n_pairs,
        "chunks": chunks,
        "true_cells": cells,
        "wall_s": round(wall, 2),
        "pairs_per_s": round(n_pairs / wall, 1),
        "gcups_effective": round(cells / wall / 1e9, 3),
        "run_s": round(run_s, 2),
        "sample_crosscheck_ok": bool(ok),
        "note": "wall includes per-process compiles",
    }
    print(json.dumps(rec), flush=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
