#!/usr/bin/env python3
"""Multi-process scaling ladder: 1/2/4-process host-sharded sweeps.

The distributed throughput signal here is a host-sharded sweep over a
real localhost ``jax.distributed`` rendezvous on the CPU backend.
Each process owns the sweep chunks with ``chunk % nprocs == pid``
(sweep.py) — exactly the multi-host production flow; wall time is the
slowest worker's sweep region (rendezvous + compile excluded via a
warmup pass inside each worker).

Experimental controls:
  * every worker in EVERY config is pinned to exactly one distinct CPU
    core (sched_setaffinity), so a 4-process row measures distributed
    overhead + imbalance, not core contention;
  * chunk count is forced to a multiple of every process count so the
    round-robin imbalance cap (ceil/floor of chunks/nprocs) is exactly
    1.0.
The residual inefficiency then fits eff(n) = t1 / (n * tn) with
per-process fixed cost c: tn = t1/n + c  =>  eff(n) = 1 / (1 + c*n/t1).

Usage: python -u scripts/bench_two_process.py [--pairs 496] [--len 160]
       [--procs 1,2,4] [--chunks 32] [--out SCALING.json]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER_SRC = r'''
import os, sys, time
PORT, PID, NPROC, OUT_DIR, NPAIRS, SLEN, CHUNK, CORE = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]), int(sys.argv[8]),
)
# one core per worker, every config: scaling must measure distribution
# overhead, not contention for this box's 4 cores
os.sched_setaffinity(0, {CORE})
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, REPO)
import numpy as np
from smithwaterman_tpu import BatchAligner, LOCAL, SeqData
from smithwaterman_tpu.parallel import multihost
from smithwaterman_tpu.sweep import SweepConfig, sweep

if NPROC > 1:
    multihost.initialize(f"localhost:{PORT}", num_processes=NPROC,
                         process_id=PID)
    assert multihost.process_count() == NPROC

LETTERS = "ARNDCQEGHILKMFPSTWYV"
rng = np.random.default_rng(7)
nseq = 1
while nseq * (nseq - 1) // 2 < NPAIRS:
    nseq += 1
seqs = [
    SeqData(f"s{i}", "", "".join(rng.choice(list(LETTERS), SLEN)))
    for i in range(nseq)
]
engine = BatchAligner(mode=LOCAL)
# warmup: compile the bucket programs outside the timed region — with
# CHUNK-SHAPED batches: a 16-pair warmup compiled tile=16 while the
# sweep's chunks bucket to tile=32, so every process recompiled ~1 s
# INSIDE the timed region and read as a fake per-process fixed cost.
# The trailing PARTIAL chunk can tile differently — warm it too.
engine.align_pairs([(seqs[0], seqs[1])] * CHUNK, retain_all=True)
# the sweep runs the full triangle of nseq (>= NPAIRS requested pairs):
# warm the ACTUAL trailing partial chunk or its compile lands back in
# the timed region
last = (nseq * (nseq - 1) // 2) % CHUNK
if last:
    engine.align_pairs([(seqs[0], seqs[1])] * last, retain_all=True)

cfg = SweepConfig(chunk_pairs=CHUNK, score_only=False, retain_all=True,
                  process_index=PID, process_count=NPROC)
out = os.path.join(OUT_DIR, f"shard{PID}.jsonl")
t0 = time.time()
n = sweep(seqs, None, engine, out, cfg)
dt = time.time() - t0
print(f"WORKER {PID} OK chunks={n} seconds={dt:.3f}", flush=True)
'''


def run_config(nproc: int, npairs: int, slen: int, chunk: int):
    port = 0
    if nproc > 1:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    with tempfile.TemporaryDirectory() as td:
        wpath = os.path.join(td, "worker.py")
        with open(wpath, "w") as f:
            f.write(f"REPO = {REPO!r}\n" + WORKER_SRC)
        t0 = time.time()
        procs = [
            subprocess.Popen(
                [sys.executable, "-u", wpath, str(port), str(pid),
                 str(nproc), td, str(npairs), str(slen), str(chunk),
                 str(pid % os.cpu_count())],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env,
            )
            for pid in range(nproc)
        ]
        outs = [p.communicate(timeout=3600)[0] for p in procs]
        wall = time.time() - t0
        secs = []
        for pid, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"worker {pid}:\n{out}"
            line = [ln for ln in out.splitlines() if "OK chunks=" in ln][0]
            secs.append(float(line.split("seconds=")[1]))
        return wall, max(secs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=1035)
    ap.add_argument("--len", dest="slen", type=int, default=256)
    ap.add_argument("--procs", default="1,2,4")
    ap.add_argument("--chunks", type=int, default=32,
                    help="target sweep chunk count (rounded so every "
                         "proc count divides it)")
    ap.add_argument("--rep", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    nseq = 1
    while nseq * (nseq - 1) // 2 < args.pairs:
        nseq += 1
    npairs = nseq * (nseq - 1) // 2
    procs = [int(p) for p in args.procs.split(",")]
    import math
    lcm = math.lcm(*procs)
    # chunk size such that the chunk COUNT divides every process count:
    # round-robin assignment is then exactly balanced (r4's 13-chunk
    # split capped efficiency at 92.9% before any real overhead)
    chunk = max(1, npairs // args.chunks)
    while -(-npairs // chunk) % lcm:
        chunk += 1
    nchunks = -(-npairs // chunk)
    rows = []
    for nproc in procs:
        best = None
        for _ in range(args.rep):
            wall, sweep_s = run_config(nproc, args.pairs, args.slen, chunk)
            best = sweep_s if best is None else min(best, sweep_s)
        row = {
            "metric": "proc_scaling_sweep", "processes": nproc,
            "pairs": npairs, "seq_len": args.slen,
            "chunks": nchunks, "chunk_pairs": chunk,
            "sweep_seconds": round(best, 3),
            "pairs_per_second": round(npairs / best, 2),
            "cores_per_proc": 1,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    t1 = rows[0]["sweep_seconds"]
    summary = {"metric": "proc_scaling_efficiency", "rows": {}}
    cs = []
    for row in rows[1:]:
        n = row["processes"]
        tn = row["sweep_seconds"]
        eff = t1 / (n * tn)
        c = tn - t1 / n  # per-process fixed seconds this config implies
        cs.append(c)
        summary["rows"][str(n)] = {
            "efficiency": round(eff, 3),
            "imbalance_cap": 1.0 if rows[0]["chunks"] % n == 0 else round(
                (rows[0]["chunks"] // n) / (-(-rows[0]["chunks"] // n)), 3),
            "fixed_cost_s": round(c, 3),
        }
    if cs:
        c = sum(cs) / len(cs)
        # predicted multi-host efficiency at the production sweep scale
        # (fixed cost amortizes over a t1 that is ~40x larger)
        summary["fitted_model"] = {
            "t_n": "t1/n + c", "c_seconds": round(c, 3),
            "eff_2proc_at_10x_work": round(1 / (1 + 2 * c / (10 * t1)), 3),
        }
    rows.append(summary)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
