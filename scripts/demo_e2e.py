#!/usr/bin/env python3
"""End-to-end feature demo: one pass over every major subsystem.

Prints a compact evidence table: mode parity, batch engine, clustering,
sweep + resume, long-sequence path, banded path, metrics. Runs anywhere:
the scan path on the CPU, the CUDA fill on a GPU.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# honor JAX_PLATFORMS=cpu through jax.config as well (see tests/conftest.py)
if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np


def main():
    import jax

    import smithwaterman_tpu as swt
    from smithwaterman_tpu.cluster import greedy_cluster
    from smithwaterman_tpu.sweep import SweepConfig, score_matrix
    from smithwaterman_tpu.utils import oracle
    from smithwaterman_tpu.utils.metrics import StatsCollector

    rows = []
    backend = jax.default_backend()
    rows.append(("backend", backend))

    # 1. golden pair, all three modes
    ok = True
    s1 = swt.load_fasta("/root/reference/test/inputs/seq3.1.fas")[0]
    s2 = swt.load_fasta("/root/reference/test/inputs/seq3.2.fas")[0]
    for mode, g in [(swt.LOCAL, "res3.dat"), (swt.GLOCAL, "needle_glocal_res3.dat"),
                    (swt.GLOBAL, "needle_res3.dat")]:
        gold = oracle.parse_emboss_dat(f"/root/reference/test/emboss_results/{g}")
        r = swt.Aligner(mode=mode).align(s1, s2)
        a = (oracle.trim_terminal(r.aligned1, r.aligned2)
             if mode == swt.LOCAL else (r.aligned1, r.aligned2))
        ok &= r.score == gold.score and a == (gold.seq1, gold.seq2)
    rows.append(("EMBOSS-exact (3 modes, golden pair)", "PASS" if ok else "FAIL"))

    # 2. batch engine + metrics
    ba = swt.BatchAligner(mode=swt.LOCAL)
    ba.stats = StatsCollector()
    pairs = [(s1, s2)] * 8
    t0 = time.time()
    res = ba.align_pairs(pairs)
    rows.append(("batch 8 pairs", f"{time.time()-t0:.1f}s, "
                 f"score={res[0].score}, waste={ba.stats.summary()['padding_waste']}"))

    # 3. clustering
    seqs = [swt.SeqData("a", "", s1.seq), swt.SeqData("a2", "", s1.seq),
            swt.SeqData("b", "", s2.seq)]
    cluster_of, members, order = greedy_cluster(seqs, ba)
    rows.append(("clustering (dup collapse)", f"{sum(1 for i, c in enumerate(cluster_of) if i == c)} reps"))

    # 4. sweep + resume
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "s.jsonl")
        mat = score_matrix(seqs, None, ba, out, SweepConfig(chunk_pairs=2))
        n2 = __import__("smithwaterman_tpu.sweep", fromlist=["sweep"]).sweep(
            seqs, None, ba, out, SweepConfig(chunk_pairs=2))
        rows.append(("sweep + resume", f"matrix {mat.shape}, resume chunks={n2}"))

    # 5. banded long pair
    rng = np.random.default_rng(1)
    letters = "ACDEFGHIKLMNPQRSTVWY"
    blen = 2000 if jax.default_backend() == "gpu" else 400
    base = "".join(letters[i] for i in rng.integers(0, 20, blen))
    l = list(base)
    del l[len(l) // 3 : len(l) // 3 + 4]
    t0 = time.time()
    rb = swt.Aligner(mode=swt.LOCAL).align_banded(base, "".join(l), band=256)
    rows.append((f"banded {blen} pair", f"{time.time()-t0:.1f}s score={rb.score}"))

    w = max(len(k) for k, _ in rows)
    for k, v in rows:
        print(f"  {k:<{w}}  {v}")


if __name__ == "__main__":
    main()
