#!/usr/bin/env python3
"""Run the full EMBOSS golden suite (100 pairs x 3 modes) and report.

Usage: python scripts/run_golden.py [--limit N] [--modes local,glocal,global]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, ".")

# honor JAX_PLATFORMS=cpu through jax.config as well (tests/conftest.py),
# so a CPU golden sweep never takes the card
if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
    import jax

    jax.config.update("jax_platforms", "cpu")

from smithwaterman_tpu import Aligner, LOCAL, GLOCAL, GLOBAL, load_fasta
from smithwaterman_tpu.utils import oracle

MODES = {"local": LOCAL, "glocal": GLOCAL, "global": GLOBAL}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--modes", default="local,glocal,global")
    ap.add_argument("--test-dir", default=oracle.REFERENCE_TEST_DIR)
    args = ap.parse_args()

    cases = oracle.discover_suite(args.test_dir)
    if args.limit:
        cases = cases[: args.limit]
    modes = args.modes.split(",")

    aligners = {name: Aligner(mode=MODES[name]) for name in modes}
    t0 = time.time()
    checked = 0
    exact = 0
    tolerated = 0
    score_mismatch = 0
    failures = []
    for case in cases:
        s1 = load_fasta(case.fasta1)[0]
        s2 = load_fasta(case.fasta2)[0]
        for name in modes:
            g = oracle.parse_emboss_dat(case.golden[name])
            r = aligners[name].align(s1, s2, True)
            a1, a2 = r.aligned1, r.aligned2
            if name == "local":
                a1, a2 = oracle.trim_terminal(a1, a2)
            ok = a1 == g.seq1 and a2 == g.seq2
            sok = g.score is None or abs(r.score - g.score) < 1e-4
            checked += 1
            if ok:
                exact += 1
            elif oracle.is_tolerated(a1, a2):
                tolerated += 1
            else:
                failures.append((case.tag, name, a1, g.seq1, a2, g.seq2))
            if not sok:
                score_mismatch += 1
                failures.append((case.tag, name + ":score", str(r.score), str(g.score), "", ""))
    dt = time.time() - t0
    print(
        f"checked={checked} exact={exact} tolerated={tolerated} "
        f"score_mismatch={score_mismatch} failures={len(failures)} time={dt:.1f}s"
    )
    for f in failures[:5]:
        print("FAIL", f[0], f[1])
        print(" ours  :", f[2][:120])
        print(" golden:", f[3][:120])
    if failures:
        sys.exit(1)
    print("OK")
    print(f"Checked {checked} results.")


if __name__ == "__main__":
    main()
