#!/usr/bin/env python3
"""Data-parallel scaling efficiency: pairs/s at 1..N devices.

On a multi-GPU host this measures real scaling; on CPU it demonstrates the
methodology over virtual devices (XLA_FLAGS=--xla_force_host_platform_device_count=N).

Usage: python scripts/bench_scaling.py [--devices 1,2,4,8] [--pairs 256]
       [--len 512] [--score-only]
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import jax
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default=None)
    ap.add_argument("--pairs", type=int, default=256)
    ap.add_argument("--len", dest="length", type=int, default=512)
    ap.add_argument("--score-only", action="store_true")
    ap.add_argument(
        "--host-devices", type=int, default=0,
        help="force N virtual CPU devices (set in-process before backend "
        "init)",
    )
    args = ap.parse_args()

    if args.host_devices:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.host_devices}"
        )
        jax.config.update("jax_platforms", "cpu")

    from smithwaterman_tpu import BatchAligner, LOCAL
    from smithwaterman_tpu.io.fasta import SeqData
    from smithwaterman_tpu.parallel import DataParallel, make_mesh

    ndev_all = len(jax.devices())
    counts = (
        [int(x) for x in args.devices.split(",")]
        if args.devices
        else sorted({1, max(1, ndev_all // 2), ndev_all})
    )
    rng = np.random.default_rng(0)
    letters = "ACDEFGHIKLMNPQRSTVWY"
    mk = lambda k: "".join(letters[i] for i in rng.integers(0, 20, k))
    pairs = [
        (SeqData(f"a{i}", "", mk(args.length)), SeqData(f"b{i}", "", mk(args.length)))
        for i in range(args.pairs)
    ]
    # the sharded pipeline: the CUDA fill on a GPU, the plain fill elsewhere
    backend = "cuda" if jax.default_backend() == "gpu" else "xla"

    base_rate = None
    rows = []
    for nd in counts:
        if nd > ndev_all:
            continue
        dp = DataParallel(make_mesh(nd)) if nd > 1 else None
        ba = BatchAligner(mode=LOCAL, backend=backend, device_axis=dp)
        run = (ba.score_pairs if args.score_only else ba.align_pairs)
        run(pairs)  # warm/compile
        t0 = time.time()
        run(pairs)
        dt = time.time() - t0
        rate = len(pairs) / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        rows.append(
            {"devices": nd, "pairs_per_s": round(rate, 2),
             "scaling_efficiency": round(eff, 3)}
        )
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
