#!/usr/bin/env python3
"""Phase breakdown of the end-to-end suite.

Runs the 100-pair reference suite warm in each mode, plus the 32x
(3200-pair) suite in local mode, and prints BatchAligner.phase — the
wall-time split into bucket / dispatch / gather / decode / reconstruct —
so the dominant term of the end-to-end gap is measured, not guessed.

Usage: python -u scripts/phase_probe.py [--rep N] [--modes local,...]
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np

REF = "/root/reference"


def load_pairs():
    from smithwaterman_tpu.io.fasta import load_fasta

    pairs = []
    with open(f"{REF}/test/file_list.txt") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                a = load_fasta(f"{REF}/test/{parts[0]}")[0]
                b = load_fasta(f"{REF}/test/{parts[1]}")[0]
                pairs.append((a, b))
    return pairs


def run(ba, pairs, label, score_only=False):
    t0 = time.time()
    if score_only:
        res = ba.score_pairs(pairs)
    else:
        res = ba.align_pairs(pairs)
    dt = time.time() - t0
    assert all(r is not None for r in res)
    cells = sum(len(a.seq) * len(b.seq) for a, b in pairs)
    row = {
        "metric": label,
        "wall_s": round(dt, 3),
        "gcups": round(cells / dt / 1e9, 3),
        "pairs": len(pairs),
        "phase": {k: round(v, 3) for k, v in ba.phase.items()},
        "unaccounted_s": round(dt - sum(ba.phase.values()), 3),
    }
    print(json.dumps(row), flush=True)
    return res, row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rep", type=int, default=32)
    ap.add_argument("--modes", default="local,global,glocal")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    from smithwaterman_tpu import GLOBAL, GLOCAL, LOCAL
    from smithwaterman_tpu.batch_aligner import BatchAligner

    dev = jax.devices()[0]
    print(json.dumps({"device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())}}), flush=True)
    pairs = load_pairs()
    rng = np.random.default_rng(0)
    shuf = [pairs[i] for i in rng.permutation(len(pairs))]

    rows = []
    consts = {"local": LOCAL, "global": GLOBAL, "glocal": GLOCAL}
    for mode in [m.strip() for m in args.modes.split(",") if m.strip()]:
        ba = BatchAligner(mode=consts[mode])
        run(ba, pairs, f"{mode}_cold")  # compile
        _, row = run(ba, shuf, f"{mode}_warm")
        rows.append(row)
        if mode == "local" and args.rep > 1:
            big = [pairs[i % len(pairs)] for i in range(args.rep * len(pairs))]
            ba.align_pairs(big)  # compile the chunk programs
            bigp = rng.permutation(len(big))
            big_shuf = [big[i] for i in bigp]
            _, row = run(ba, big_shuf, f"local_{args.rep}x_warm")
            rows.append(row)
            # score-only on the same batch isolates fills+S (no tb write,
            # no walk, no move fetch) from the traceback machinery
            ba.score_pairs(big)  # compile score-only programs
            _, row = run(ba, big_shuf, f"local_{args.rep}x_score_only",
                         score_only=True)
            rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
