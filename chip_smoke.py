#!/usr/bin/env python3
"""Smoke test of the served alignment path on NVIDIA GPUs.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # only the multi-card path (4 cards)

One card:
  1. nvidia-smi names the card, and the gpu-marked tests run (among them
     tests/data/parity_cases.json through the cuda backend), each in a
     child process started before this process starts JAX's backend.
  2. Each fill (the CUDA kernel and the plain-JAX fill) is compiled at a
     real width (512 pairs of 512x512), its memory analysis printed, and
     the two compared byte for byte.
  3. ``align_pairs`` in all three modes and ``score_pairs`` on 3,200 seeded
     protein pairs (the reference suite's length mix at 32x: 33-3,685
     residues, median ~438; the second sequence of each pair a mutated
     copy of the first): cuda and xla backends bit-identical on every
     pair; a seeded subset including the longest pairs checked against the
     scan oracle on this process's CPU device.
  4. Warm end-to-end times of cuda and xla, in turns: the 3,200-pair mix
     and 512 pairs of 512x512, LOCAL with traceback.
  5. The CLI's -list and -cluster, through ``cli.main`` in this process,
     checked against the CPU scan oracle.
  6. One pair through the long-pair path (checkpointed fill + band
     re-fill) and one 12k x 12k pair through ``Aligner.align_banded``,
     each checked against the full fill.

``--four-cards``: ``BatchAligner(device_axis=DataParallel())`` over four
cards on the same 3,200 pairs (traceback and score-only), compared with the
one-card result, and ``seq_tiled.striped_align`` of one 8k pair over the
four cards, compared with the one-card full fill.

The second-to-last stdout line is the card's name and power limit; the last
is ``{"ok": true, "device": {...}}``.  Any failed phase exits 1 without a
result line; so does a machine without a GPU, or a directory that holds
this file and nothing else of the repository.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
OG, EG = -10.0, -0.5
SEED = 20240
N_PAIRS = 3200     # the reference suite's 100 pairs at 32x
GRID = (512, 512)  # (pairs, length) of the fixed-shape workload
LONG_PAIR = 5000   # residues of the long-pair-path pair
BAND_PAIR = 12000  # residues of the banded pair
STRIPE_PAIR = 8192  # residues of the four-card striped pair
AA = "ARNDCQEGHILKMFPSTWYV"


def log(*a, **kw):
    print(*a, flush=True, **kw)


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card, read by a
    child process (this process has not started JAX's backend yet)."""
    from smithwaterman_tpu import platform

    out = platform.card()
    check(out, "nvidia-smi reported no card")
    return out.splitlines()[0]


def run_gpu_tests():
    """The gpu-marked tests in a child process (it holds the card while it
    runs; this process has not touched JAX yet)."""
    env = dict(os.environ, SWT_GPU_TESTS="1")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_gpu_hardware.py", "-m",
         "gpu", "-q", "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
    )
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-15:]
    log("gpu tests:", *tail, sep="\n  ")
    check(proc.returncode == 0, f"gpu-marked tests failed (rc {proc.returncode})")
    check(" passed" in tail[-1] and "skipped" not in tail[-1],
          "gpu-marked tests did not all run")
    log(f"gpu tests: {time.time() - t0:.1f} s")


# ---------------------------------------------------------------- workload
def protein_pairs(count, seed, np):
    """Seeded protein pairs: lengths log-normal around the reference
    suite's median (438), clipped to its range (33-3,685) with both ends
    present; the second sequence is the first with 15% substitutions and
    short indels."""
    rng = np.random.default_rng(seed)
    letters = np.array(list(AA))
    lens = np.clip(np.rint(np.exp(rng.normal(np.log(438.0), 0.75, count))),
                   33, 3685).astype(int)
    lens[0], lens[1] = 3685, 33
    pairs = []
    for L in lens:
        a = rng.integers(0, 20, L)
        b = a.copy()
        sub = rng.random(L) < 0.15
        b[sub] = rng.integers(0, 20, int(sub.sum()))
        for _ in range(rng.poisson(L / 150)):
            p, k = int(rng.integers(0, b.size)), int(rng.integers(1, 4))
            if rng.random() < 0.5 and b.size > k + 1:
                b = np.delete(b, slice(p, p + k))
            else:
                b = np.insert(b, p, rng.integers(0, 20, k))
        pairs.append(("".join(letters[a]), "".join(letters[b])))
    return pairs


def fixed_pairs(count, length, seed, np):
    """``count`` pairs of exactly ``length`` x ``length`` residues (15%
    substitutions, no indels)."""
    rng = np.random.default_rng(seed)
    letters = np.array(list(AA))
    out = []
    for _ in range(count):
        a = rng.integers(0, 20, length)
        b = a.copy()
        sub = rng.random(length) < 0.15
        b[sub] = rng.integers(0, 20, int(sub.sum()))
        out.append(("".join(letters[a]), "".join(letters[b])))
    return out


def fields(r):
    return (r.score, r.aligned1, r.aligned2, r.start1, r.end1, r.start2,
            r.end2)


def same_results(got, want, what):
    bad = [k for k, (g, w) in enumerate(zip(got, want))
           if fields(g) != fields(w)]
    check(len(got) == len(want) and not bad,
          f"{what}: {len(bad)} of {len(want)} pairs differ (first {bad[:5]})")


# ---------------------------------------------------------------- phases
def phase_fills(jax, np):
    from smithwaterman_tpu.config import GLOBAL, LOCAL
    from smithwaterman_tpu.matrices import SubstitutionMatrix
    from smithwaterman_tpu.ops import fill

    sm = SubstitutionMatrix.blosum62()
    B, L = GRID
    pairs = fixed_pairs(B, L, SEED + 1, np)
    c1 = np.stack([sm.seq_to_index(a) for a, _ in pairs]).astype(np.int8)
    c2 = np.stack([sm.seq_to_index(b) for _, b in pairs]).astype(np.int8)
    n = np.full(B, L, np.int32)
    args = [jax.device_put(x) for x in (np.asarray(sm.table, np.float32),
                                         c1, c2, n, n)]
    for mode in (LOCAL, GLOBAL):
        outs = {}
        for backend in ("cuda", "xla"):
            f = jax.jit(lambda t, a, b, nn, mm, _b=backend, _m=mode: fill.fill(
                t, a, b, nn, mm, backend=_b, mode=_m, og=OG, eg=EG,
                quarter=True))
            t0 = time.time()
            compiled = f.lower(*args).compile()
            log(f"fill {backend} mode {mode} {B}x{L}x{L}: compiled in "
                f"{time.time() - t0:.2f} s; memory {compiled.memory_analysis()}")
            outs[backend] = jax.device_get(compiled(*args))
            if mode == LOCAL:
                ts = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    jax.block_until_ready(compiled(*args))
                    ts.append(time.perf_counter() - t0)
                best = min(ts)
                log(f"fill {backend} LOCAL {B}x{L}x{L} warm: "
                    f"{[round(t * 1e3, 3) for t in ts]} ms, "
                    f"{B * L * L / best / 1e9:.1f} GCUPS (best)")
        (tc, sc), (tx, sx) = outs["cuda"], outs["xla"]
        check(np.array_equal(sc, sx), f"fill stats differ (mode {mode})")
        check(np.array_equal(tc[:, :, 0, :L], tx[0].transpose(1, 0, 2)),
              f"fill pointer bytes differ (mode {mode})")
        log(f"fill mode {mode}: cuda and xla byte-identical "
            f"({tc[:, :, 0, :L].size} pointer bytes, {sc.size} stats)")


def cpu_oracle(jax, pairs, mode):
    from smithwaterman_tpu import BatchAligner

    with jax.default_device(jax.devices("cpu")[0]):
        return BatchAligner(mode=mode, backend="scan").align_pairs(pairs)


def phase_served(jax, np, pairs):
    from smithwaterman_tpu import BatchAligner, GLOBAL, GLOCAL, LOCAL

    rng = np.random.default_rng(SEED + 2)
    longest = list(np.argsort([-(len(a) * len(b)) for a, b in pairs])[:4])
    subset = sorted(set(longest) | set(rng.choice(len(pairs), 16,
                                                  replace=False).tolist()))
    results = {}
    for mode in (LOCAL, GLOCAL, GLOBAL):
        res = {}
        for backend in ("cuda", "xla"):
            ba = BatchAligner(mode=mode, backend=backend)
            t0 = time.perf_counter()
            res[backend] = ba.align_pairs(pairs)
            t_tb = time.perf_counter() - t0
            t0 = time.perf_counter()
            scores = ba.score_pairs(pairs)
            t_so = time.perf_counter() - t0
            check(np.array_equal(scores, np.asarray(
                [r.score for r in res[backend]], np.float32)),
                f"score_pairs != align_pairs scores ({backend}, mode {mode})")
            log(f"served mode {mode} {backend}: align_pairs cold "
                f"{t_tb:.2f} s, score_pairs cold {t_so:.2f} s")
        same_results(res["cuda"], res["xla"], f"cuda vs xla, mode {mode}")
        t0 = time.perf_counter()
        want = cpu_oracle(jax, [pairs[k] for k in subset], mode)
        same_results([res["cuda"][k] for k in subset], want,
                     f"cuda vs CPU scan oracle, mode {mode}")
        log(f"served mode {mode}: {len(pairs)} pairs cuda == xla; "
            f"{len(subset)} pairs (incl. the 4 largest) == CPU scan oracle "
            f"({time.perf_counter() - t0:.1f} s)")
        results[mode] = res["cuda"]
    return results


def phase_timing(jax, np, pairs):
    from smithwaterman_tpu import BatchAligner, LOCAL

    grid = fixed_pairs(*GRID, SEED + 3, np)
    rows = []
    for name, work in ((f"mix{len(pairs)}", pairs),
                       ("{0}x{1}x{1}".format(*GRID), grid)):
        for backend in ("cuda", "xla"):
            BatchAligner(mode=LOCAL, backend=backend).align_pairs(work)  # warm
        times = {"cuda": [], "xla": []}
        phases = {}
        for backend in ("cuda", "xla", "cuda", "xla"):
            ba = BatchAligner(mode=LOCAL, backend=backend)
            t0 = time.perf_counter()
            ba.align_pairs(work)
            times[backend].append(time.perf_counter() - t0)
            phases[backend] = {k: round(v, 4) for k, v in ba.phase.items()}
        cells = sum(len(a) * len(b) for a, b in work)
        for backend, ts in times.items():
            rows.append(dict(workload=name, backend=backend,
                             seconds=[round(t, 4) for t in ts],
                             true_gcups=round(cells / min(ts) / 1e9, 2),
                             phase_s=phases[backend]))
            log(f"timing {name} LOCAL traceback {backend}: warm "
                f"{[round(t, 4) for t in ts]} s, "
                f"{cells / min(ts) / 1e9:.2f} true GCUPS (best); host "
                f"phases of the last run {phases[backend]}")
    return rows


def phase_cli(jax, np):
    from smithwaterman_tpu import BatchAligner, LOCAL, SeqData
    from smithwaterman_tpu.cli import format_score, main as cli_main
    from smithwaterman_tpu.config import MODE_MESSAGES
    from smithwaterman_tpu.cluster import greedy_cluster, write_cluster_outputs

    rng = np.random.default_rng(SEED + 4)
    letters = np.array(list(AA))
    tmp = tempfile.mkdtemp(prefix="swt_smoke_")

    def mutate(s, rate):
        a = np.array(list(s))
        hit = rng.random(a.size) < rate
        a[hit] = letters[rng.integers(0, 20, int(hit.sum()))]
        return "".join(a)

    # -list: three pairs of FASTA files, all-vs-all inside each pair
    files, pairs = [], []
    for k in range(3):
        base = ["".join(letters[rng.integers(0, 20, int(rng.integers(80, 400)))])
                for _ in range(2)]
        recs = [[(f"q{k}_{i}", s) for i, s in enumerate(base)],
                [(f"t{k}_{i}", mutate(s, 0.2)) for i, s in enumerate(base)]]
        names = []
        for side, rr in enumerate(recs):
            path = os.path.join(tmp, f"f{k}_{side}.fas")
            with open(path, "w") as f:
                f.writelines(f">{nm}\n{sq}\n" for nm, sq in rr)
            names.append(path)
        files.append(names)
        pairs += [(n1, a, n2, b) for n1, a in recs[0] for n2, b in recs[1]]
    listfile = os.path.join(tmp, "pairs.txt")
    with open(listfile, "w") as f:
        f.writelines(f"{a}\t{b}\n" for a, b in files)
    out = os.path.join(tmp, "list.out")
    cli_main(["-local", "-list", listfile, "-out", out])
    with open(out) as f:
        text = f.read()
    want = iter(cpu_oracle(jax, [(a, b) for _, a, _, b in pairs], LOCAL))
    expect = "".join(
        f"#score:{format_score(w.score)}#type:{MODE_MESSAGES[LOCAL]}"
        f">{n1}\n{w.aligned1}\n>{n2}\n{w.aligned2}\n"
        for (n1, _, n2, _), w in zip(pairs, want)
    )
    check(text == expect, "CLI -list output differs from the CPU scan oracle")
    log(f"cli -list: {len(pairs)} alignments equal the CPU scan oracle's")

    # -cluster: seeded families at CD-HIT's default identity 0.9
    seqs = []
    for fam in range(8):
        root = "".join(letters[rng.integers(0, 20, int(rng.integers(150, 500)))])
        for k in range(5):
            seqs.append(SeqData(f"fam{fam}_{k}", "", mutate(root, 0.03 * k)))
    fasta = os.path.join(tmp, "cluster_in.fas")
    with open(fasta, "w") as f:
        f.writelines(f">{s.name}\n{s.seq}\n" for s in seqs)
    got = os.path.join(tmp, "cluster_gpu.fas")
    with contextlib.redirect_stdout(io.StringIO()):
        cli_main(["-cluster", "-identity", "0.9", "-out", got, fasta])
    ref = os.path.join(tmp, "cluster_cpu.fas")
    with jax.default_device(jax.devices("cpu")[0]):
        cluster_of, members, order = greedy_cluster(
            seqs, BatchAligner(mode=LOCAL, backend="scan"), identity=0.9)
    write_cluster_outputs(ref, order, cluster_of, members)
    for suffix in ("", ".clstr"):
        with open(got + suffix) as a, open(ref + suffix) as b:
            check(a.read() == b.read(), f"CLI -cluster{suffix} output differs")
    n_rep = sum(1 for k, c in enumerate(cluster_of) if k == c)
    log(f"cli -cluster: {len(seqs)} sequences, {n_rep} clusters, outputs "
        "equal the CPU scan oracle's")


def phase_long(np):
    from smithwaterman_tpu import Aligner, BatchAligner, GLOBAL, LOCAL
    from smithwaterman_tpu.ops import longseq

    rng = np.random.default_rng(SEED + 5)
    letters = np.array(list(AA))

    def pair(n, rate, shift):
        a = rng.integers(0, 20, n)
        b = a[shift:].copy()
        hit = rng.random(b.size) < rate
        b[hit] = rng.integers(0, 20, int(hit.sum()))
        return "".join(letters[a]), "".join(letters[b])

    s1, s2 = pair(LONG_PAIR, 0.1, 37)
    calls = []
    orig = longseq.align_long_packed
    longseq.align_long_packed = lambda *a, **k: (calls.append(1), orig(*a, **k))[1]
    try:
        for mode in (LOCAL, GLOBAL):
            t0 = time.perf_counter()
            got = BatchAligner(mode=mode, backend="cuda",
                               longseq_cells=1).align_pairs([(s1, s2)])[0]
            t_long = time.perf_counter() - t0
            want = BatchAligner(mode=mode, backend="cuda").align_pairs(
                [(s1, s2)])[0]
            check(fields(got) == fields(want),
                  f"long-pair path differs from the full fill (mode {mode})")
            log(f"longseq {len(s1)}x{len(s2)} mode {mode}: equals the full "
                f"fill (score {got.score}, {t_long:.2f} s cold)")
    finally:
        longseq.align_long_packed = orig
    check(len(calls) == 2, "the long-pair path was not taken")

    s1, s2 = pair(BAND_PAIR, 0.08, 9)
    t0 = time.perf_counter()
    banded = Aligner(mode=LOCAL).align_banded(s1, s2, band=512)
    t_band = time.perf_counter() - t0
    full = BatchAligner(mode=LOCAL, backend="cuda").align_pairs([(s1, s2)])[0]
    check((banded.score, banded.aligned1, banded.aligned2)
          == (full.score, full.aligned1, full.aligned2),
          "align_banded 12k pair differs from the full fill")
    log(f"align_banded {len(s1)}x{len(s2)}: equals the full fill "
        f"(score {full.score}, {t_band:.2f} s cold)")


def one_card(jax, np):
    t0 = time.time()
    phase_fills(jax, np)
    pairs = protein_pairs(N_PAIRS, SEED, np)
    lens = np.array([len(a) for a, _ in pairs])
    log(f"workload: {len(pairs)} pairs, seq1 lengths {lens.min()}-"
        f"{lens.max()}, median {int(np.median(lens))}")
    phase_served(jax, np, pairs)
    rows = phase_timing(jax, np, pairs)
    phase_cli(jax, np)
    phase_long(np)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke_timing.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    log(f"one-card phases: {time.time() - t0:.1f} s")


def four_cards(jax, np):
    from smithwaterman_tpu import BatchAligner, LOCAL
    from smithwaterman_tpu.aligner import reconstruct_alignment
    from smithwaterman_tpu.matrices import SubstitutionMatrix
    from smithwaterman_tpu.parallel import DataParallel, make_mesh
    from smithwaterman_tpu.parallel.seq_tiled import striped_align

    check(len(jax.devices()) == 4, f"{len(jax.devices())} devices, need 4")
    t0 = time.time()
    pairs = protein_pairs(N_PAIRS, SEED, np)
    one = BatchAligner(mode=LOCAL, backend="cuda")
    want_tb = one.align_pairs(pairs)
    want_so = one.score_pairs(pairs)
    four = BatchAligner(mode=LOCAL, backend="cuda",
                        device_axis=DataParallel(make_mesh(4)))
    t1 = time.perf_counter()
    got_tb = four.align_pairs(pairs)
    t_tb = time.perf_counter() - t1
    t1 = time.perf_counter()
    got_so = four.score_pairs(pairs)
    t_so = time.perf_counter() - t1
    same_results(got_tb, want_tb, "4-card vs 1-card align_pairs")
    check(np.array_equal(got_so, want_so), "4-card vs 1-card score_pairs")
    log(f"four cards: {len(pairs)} pairs, align_pairs and score_pairs "
        f"bit-identical to one card (cold {t_tb:.2f} s / {t_so:.2f} s)")

    rng = np.random.default_rng(SEED + 6)
    letters = np.array(list(AA))
    a = rng.integers(0, 20, STRIPE_PAIR)
    b = a.copy()
    hit = rng.random(b.size) < 0.1
    b[hit] = rng.integers(0, 20, int(hit.sum()))
    s1, s2 = "".join(letters[a]), "".join(letters[b])
    sm = SubstitutionMatrix.blosum62()
    S = sm.dense_scores(sm.seq_to_index(s1), sm.seq_to_index(s2))[None]
    t1 = time.perf_counter()
    idx, stats = striped_align(
        S.astype(np.float32), np.array([len(s1)]), np.array([len(s2)]),
        mode=LOCAL,
        og=OG, eg=EG, mesh=make_mesh(4), block_rows=8,
    )
    t_st = time.perf_counter() - t1
    got = reconstruct_alignment(s1, s2, idx[0][0], idx[0][1],
                                float(stats[0, 0]), True, LOCAL)
    want = one.align_pairs([(s1, s2)])[0]
    check((got.score, got.aligned1, got.aligned2)
          == (want.score, want.aligned1, want.aligned2),
          "striped 8k pair differs from the one-card fill")
    log(f"striped {len(s1)}x{len(s2)} over 4 cards: equals the one-card fill "
        f"(score {got.score}, {t_st:.2f} s cold)")
    log(f"four-card phases: {time.time() - t0:.1f} s")


def main(argv) -> int:
    four = "--four-cards" in argv
    try:
        check(os.path.isfile(os.path.join(REPO, "smithwaterman_tpu",
                                          "__init__.py")),
              "smithwaterman_tpu is not beside chip_smoke.py")
        sys.path.insert(0, REPO)
        card = card_line()
        log(f"card: {card}")
        if not four:
            run_gpu_tests()
        import jax
        import numpy as np

        dev = jax.devices()[0]
        check(dev.platform == "gpu", f"JAX found no GPU (platform "
              f"{dev.platform})")
        log(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")
        if four:
            four_cards(jax, np)
        else:
            one_card(jax, np)
    except Exception:  # any phase failing fails the smoke test
        traceback.print_exc()
        log("chip_smoke: FAILED")
        return 1
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
