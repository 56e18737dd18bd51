#!/usr/bin/env python3
"""Run the reference's own Perl test harness against THIS engine.

Stages a work dir with the reference fixtures (symlinked) and its
``check_results.pl`` (copied verbatim, never committed here), produces all
the per-implementation result dirs the checker expects — but every one of
them generated by OUR engine:

  * res_pl/, res_py/   — oneline format (``s1 <aln>`` / ``s2 <aln>``), local
  * res_java/          — FASTA-like (``>s1`` / ``>s2``), local
  * res_rust/          — FASTA-like with ``#score:``/``#type:`` headers,
                         all three modes (seqN.1.fas.res.{local,glocal,global})

  * res_rust_ocl/, res_rust_ocl_list/ — the ACCELERATED-engine slots
    (reference: GPU engine + its -list batch mode), filled from our tiled
    device pipeline; the staged checker's ``$check_rs_ocl`` toggle
    (check_results.pl:20) is flipped on.

Then runs ``perl check_results.pl`` and demands ``OK / Checked 1200
results.`` — the reference's FULL accelerated run total (test/README.md:
19-27; 600 without the accelerated slots).

Usage: python scripts/run_harness.py [--backend scan|xla|cuda] [--workdir D]
       [--no-accel]   (600-result non-GPU layout only)
"""

import argparse
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# honor JAX_PLATFORMS=cpu through jax.config as well (tests/conftest.py)
if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
    import jax

    jax.config.update("jax_platforms", "cpu")

from smithwaterman_tpu import GLOBAL, GLOCAL, LOCAL, BatchAligner, load_fasta
from smithwaterman_tpu.cli import format_score
from smithwaterman_tpu.config import MODE_MESSAGES

REF_TEST = "/root/reference/test"
MODES = {"local": LOCAL, "glocal": GLOCAL, "global": GLOBAL}


def stage(workdir: str, accel: bool) -> None:
    os.makedirs(workdir, exist_ok=True)
    for d in ("inputs", "emboss_results"):
        dst = os.path.join(workdir, d)
        if not os.path.exists(dst):
            os.symlink(os.path.join(REF_TEST, d), dst)
    shutil.copy(os.path.join(REF_TEST, "check_results.pl"), workdir)
    dirs = ["res_pl", "res_py", "res_java", "res_rust"]
    if accel:
        dirs += ["res_rust_ocl", "res_rust_ocl_list"]
        # enable the accelerated-engine check in the STAGED copy only
        # (reference toggle: check_results.pl:20)
        path = os.path.join(workdir, "check_results.pl")
        with open(path) as f:
            src = f.read()
        src = src.replace("my $check_rs_ocl = 0;", "my $check_rs_ocl = 1;")
        with open(path, "w") as f:
            f.write(src)
    for d in dirs:
        os.makedirs(os.path.join(workdir, d), exist_ok=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default=None)
    ap.add_argument(
        "--accel-backend", default=None,
        help="backend for the res_rust_ocl slots (default: cuda on a GPU, "
        "xla elsewhere)",
    )
    ap.add_argument("--no-accel", action="store_true",
                    help="600-result non-GPU layout only")
    ap.add_argument("--workdir", default="/tmp/swt_harness")
    ap.add_argument("--limit", type=int, default=0)
    args = ap.parse_args()

    accel = not args.no_accel
    if accel and args.accel_backend is None:
        import jax

        args.accel_backend = (
            "cuda" if jax.default_backend() == "gpu" else "xla"
        )

    stage(args.workdir, accel)
    names = sorted(
        f for f in os.listdir(os.path.join(REF_TEST, "inputs"))
        if f.endswith(".1.fas")
    )
    if args.limit:
        names = names[: args.limit]
    pairs = []
    for f1 in names:
        s1 = load_fasta(os.path.join(REF_TEST, "inputs", f1))[0]
        s2 = load_fasta(os.path.join(REF_TEST, "inputs", f1.replace(".1.", ".2.")))[0]
        pairs.append((f1, s1, s2))

    t0 = time.time()
    for mode_name, mode in MODES.items():
        engine = BatchAligner(mode=mode, backend=args.backend)
        results = engine.align_pairs([(s1, s2) for _, s1, s2 in pairs], True)
        mess = MODE_MESSAGES[mode]
        for (f1, s1, s2), r in zip(pairs, results):
            fasta_like = (
                f"#score:{format_score(r.score)}\n#type:{mess}\n"
                f">{s1.name}\n{r.aligned1}\n\n>{s2.name}\n{r.aligned2}\n\n"
            )
            with open(
                os.path.join(args.workdir, "res_rust", f"{f1}.res.{mode_name}"), "w"
            ) as f:
                f.write(fasta_like)
            if mode == LOCAL:
                oneline = f"s1 {r.aligned1}\ns2 {r.aligned2}\n"
                for d in ("res_pl", "res_py"):
                    with open(os.path.join(args.workdir, d, f"{f1}.res"), "w") as f:
                        f.write(oneline)
                with open(
                    os.path.join(args.workdir, "res_java", f"{f1}.res"), "w"
                ) as f:
                    f.write(fasta_like)
        if accel:
            # accelerated-engine slots (reference: GPU engine + -list batch
            # mode) — regenerated through the tiled device pipeline
            if args.accel_backend == args.backend:
                aresults = results
            else:
                aengine = BatchAligner(mode=mode, backend=args.accel_backend)
                aresults = aengine.align_pairs(
                    [(s1, s2) for _, s1, s2 in pairs], True
                )
            for (f1, s1, s2), r in zip(pairs, aresults):
                fasta_like = (
                    f"#score:{format_score(r.score)}\n#type:{mess}\n"
                    f">{s1.name}\n{r.aligned1}\n\n>{s2.name}\n{r.aligned2}\n\n"
                )
                for d in ("res_rust_ocl", "res_rust_ocl_list"):
                    with open(
                        os.path.join(args.workdir, d, f"{f1}.res.{mode_name}"),
                        "w",
                    ) as f:
                        f.write(fasta_like)
    n_slots = 12 if accel else 6
    print(f"generated {len(pairs) * n_slots} results "
          f"in {time.time()-t0:.1f}s", flush=True)

    proc = subprocess.run(
        ["perl", "check_results.pl"],
        cwd=args.workdir,
        capture_output=True,
        text=True,
    )
    sys.stdout.write(proc.stdout[-2000:])
    sys.stderr.write(proc.stderr[-2000:])
    expected = len(pairs) * (12 if accel else 6)
    ok = proc.returncode == 0 and f"OK\nChecked {expected} results." in proc.stdout
    print("HARNESS PASS" if ok else "HARNESS FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
