#!/usr/bin/env python3
"""Production-scale sweep: 200 random-length sequences, upper-triangle
self-sweep (19,900 pairs), FULL traceback + retain_all, fsync'd JSONL
checkpointing — the bucketing worst case for a power-of-two ladder.

Reports the bucket ladder in use, per-bucket padding waste, the stats
summary (run_seconds-derived GCUPS), the device and the rep count.

Usage: python -u scripts/production_sweep.py [--out sweep.json]
       [--seqs 200] [--lmin 150] [--lmax 700] [--rep 2] [--ladder new|old]
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--seqs", type=int, default=200)
    ap.add_argument("--lmin", type=int, default=150)
    ap.add_argument("--lmax", type=int, default=700)
    ap.add_argument("--rep", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--chunk-scan", default=None,
                    help="comma list of chunk_pairs to scan warm (e.g. "
                         "2048,8192,19900): checkpoint granularity vs "
                         "per-call dispatch overhead tradeoff")
    ap.add_argument("--ladder", default="new", choices=("new", "old"))
    args = ap.parse_args()

    import jax

    from smithwaterman_tpu import LOCAL, SeqData
    from smithwaterman_tpu.batch_aligner import BatchAligner
    from smithwaterman_tpu.config import AlignConfig
    from smithwaterman_tpu.sweep import SweepConfig, sweep
    from smithwaterman_tpu.utils.metrics import StatsCollector

    OLD = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
    cfg = (AlignConfig(mode=LOCAL, buckets=OLD) if args.ladder == "old"
           else AlignConfig(mode=LOCAL))
    rng = np.random.default_rng(42)
    LETTERS = list("ARNDCQEGHILKMFPSTWYV")
    seqs = [
        SeqData(f"s{i}", "", "".join(rng.choice(
            LETTERS, rng.integers(args.lmin, args.lmax + 1))))
        for i in range(args.seqs)
    ]
    n = len(seqs)
    n_pairs = n * (n - 1) // 2
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(json.dumps({"device": device}), flush=True)

    engine = BatchAligner(config=cfg)

    def one_pass(chunk_pairs):
        scfg = SweepConfig(chunk_pairs=chunk_pairs, score_only=False,
                           retain_all=True)
        engine.stats = StatsCollector()
        tmp = tempfile.mkdtemp()
        path = os.path.join(tmp, "sweep.jsonl")
        t0 = time.time()
        chunks = sweep(seqs, None, engine, path, scfg)
        return time.time() - t0, chunks, engine.stats

    chunk_rows = []
    if args.chunk_scan:
        # checkpoint granularity vs per-call overhead: each sweep chunk
        # is one engine call (>= a pooled fill + class walks + a batched
        # gather), so small chunks pay per-call program overhead 10x over
        for cp in (int(x) for x in args.chunk_scan.split(",")):
            one_pass(cp)  # compile this chunking's shapes
            w, ch, st = one_pass(cp)
            row = {"chunk_pairs": cp, "chunks": ch,
                   "warm_s": round(w, 3),
                   "gcups_effective": round(st.true_cells / w / 1e9, 3),
                   "padding_waste": round(
                       1 - st.true_cells / st.padded_cells, 4)}
            chunk_rows.append(row)
            print(json.dumps(row), flush=True)

    cold_s, chunks, _ = one_pass(args.chunk)
    print(json.dumps({"cold_s": round(cold_s, 1), "chunks": chunks}),
          flush=True)
    walls, stats = [], None
    for _ in range(args.rep):
        w, _, stats = one_pass(args.chunk)
        walls.append(round(w, 3))
        print(json.dumps({"warm_s": w}), flush=True)
    best = min(walls)
    summary = stats.summary()
    rec = {
        "metric": "production_sweep",
        "pairs": n_pairs, "chunks": chunks,
        "ladder": list(cfg.buckets),
        "cold_s": round(cold_s, 1),
        "warm_walls_s": walls, "warm_best_s": best,
        "pairs_per_s": round(n_pairs / best, 1),
        "true_gcells": round(stats.true_cells / 1e9, 3),
        "gcups_effective": round(stats.true_cells / best / 1e9, 3),
        "padding_waste": summary["padding_waste"],
        "chunk_scan": chunk_rows,
        "stats": summary,
        "device": device, "reps": args.rep,
        "note": "200-seq self-sweep (len %d-%d, seed 42), full traceback"
                " + retain_all, fsync'd JSONL checkpointing every %d"
                " pairs; warm = best of %d re-passes in-process"
                % (args.lmin, args.lmax, args.chunk, args.rep),
    }
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
