#!/usr/bin/env python3
"""32k x 32k single-pair alignment — beyond the reference's hard size cap.

The reference's accelerated engine refuses any problem with
``(la+1)*(lb+1)*3 > i32::MAX`` — about 26k x 26k
(``opencl_sequence_alignment.rs:672-674``).  This check aligns a
32768 x ~32768 protein pair with the banded fill + on-device walker
(``ops/banded.py``) and validates the result three ways, none of which
needs a full-matrix oracle:

  1. double-band verification: band W and 2W agree and the walk never
     touches the band edge — the standard banded-DP optimality guard
     (``align_banded_verified``);
  2. the emitted alignment is re-scored column-by-column on host
     (``utils.calc_score``, parity with the reference's
     ``test/calc_score.pl``) and must reproduce the fill's score;
  3. the pair is engineered (partner = mutated copy with bounded indel
     drift), so a near-diagonal high-identity alignment is known to
     exist: the result must reach that identity.

Usage:  python -u scripts/giant_pair_check.py            # GPU, 32k
        python -u scripts/giant_pair_check.py --small    # CPU, 2k
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

LETTERS = "ARNDCQEGHILKMFPSTWYV"


def make_pair(n, rng, sub_rate=0.05, indel_every=2000, indel_max=20):
    s1 = rng.integers(0, 20, size=n)
    out = []
    i = 0
    next_indel = indel_every
    while i < n:
        if i >= next_indel:
            next_indel += indel_every
            k = int(rng.integers(1, indel_max + 1))
            if rng.integers(0, 2):  # insertion into s2
                out.extend(rng.integers(0, 20, size=k).tolist())
            else:  # deletion from s2
                i += k
                continue
        c = int(s1[i])
        if rng.random() < sub_rate:
            c = int(rng.integers(0, 20))
        out.append(c)
        i += 1
    seq1 = "".join(LETTERS[c] for c in s1)
    seq2 = "".join(LETTERS[c] for c in out)
    return seq1, seq2


def main():
    small = "--small" in sys.argv
    import jax

    if small:
        jax.config.update("jax_platforms", "cpu")
    from smithwaterman_tpu.aligner import reconstruct_alignment
    from smithwaterman_tpu.config import LOCAL
    from smithwaterman_tpu.matrices import SubstitutionMatrix
    from smithwaterman_tpu.ops.banded import align_banded_verified
    from smithwaterman_tpu.utils.calc_score import recalc_score
    from smithwaterman_tpu.utils.oracle import trim_terminal

    n = 2048 if small else 32768
    band = 256 if small else 1024
    if not small:
        from smithwaterman_tpu import platform

        platform.require_gpu()

    rng = np.random.default_rng(42)
    seq1, seq2 = make_pair(n, rng)
    print(f"pair: {len(seq1)} x {len(seq2)} "
          f"({len(seq1) * len(seq2) / 1e9:.2f} G cells; reference cap "
          f"~26k x 26k)", flush=True)

    sm = SubstitutionMatrix.blosum62()
    codes1 = sm.seq_to_index(seq1)
    codes2 = sm.seq_to_index(seq2)

    t0 = time.time()
    idx1, idx2, score, band_used = align_banded_verified(
        codes1, codes2, sm.table, mode=LOCAL, og=-10.0, eg=-0.5,
        band=band, max_band=4 * band,
    )
    t_cold = time.time() - t0
    print(f"banded verified: score={score} band_used={band_used} "
          f"cold={t_cold:.1f}s", flush=True)
    ok_band = band_used <= 2 * band
    print(f"{'PASS' if ok_band else 'FAIL'} double-band agreement at "
          f"W={band_used}", flush=True)

    r = reconstruct_alignment(seq1, seq2, idx1, idx2, score, True, LOCAL)
    a1, a2 = trim_terminal(r.aligned1, r.aligned2)
    rescore = recalc_score(a1, a2, sm, 10.0, 0.5)
    ok_score = abs(rescore - score) < 1e-3
    print(f"{'PASS' if ok_score else 'FAIL'} host re-score "
          f"{rescore} vs fill {score}", flush=True)

    matches = sum(1 for x, y in zip(a1, a2) if x == y and x != "-")
    ident = matches / max(len(a1), 1)
    ok_ident = ident >= 0.85
    print(f"{'PASS' if ok_ident else 'FAIL'} identity {ident:.3f} over "
          f"{len(a1)} columns", flush=True)

    # warm timing (compiled programs reused; fresh walk)
    t0 = time.time()
    align_banded_verified(
        codes1, codes2, sm.table, mode=LOCAL, og=-10.0, eg=-0.5,
        band=band, max_band=4 * band,
    )
    print(f"warm repeat: {time.time() - t0:.2f}s", flush=True)

    ok = ok_band and ok_score and ok_ident
    print("GIANT PAIR " + ("PASS" if ok else "FAIL"), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
