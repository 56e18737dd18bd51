"""Multi-host path: a REAL 2-process jax.distributed rendezvous on
localhost (2 x 4 virtual CPU devices), exercising multihost.initialize(),
a cross-process collective, and the host-sharded sweep.

Spawns two fresh interpreters (jax.distributed cannot re-init in-process)
and merges their sweep shards.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_sweep(tmp_path):
    port = _free_port()
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", WORKER, str(port), str(pid), str(tmp_path)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER {pid} OK" in out, out

    # the two shards together cover every pair exactly once
    sys.path.insert(0, REPO)
    from smithwaterman_tpu.sweep import load_sweep

    rows = []
    for pid in range(2):
        rows.extend(load_sweep(str(tmp_path / f"shard{pid}.jsonl")))
    n_seqs = 6
    assert len(rows) == n_seqs * (n_seqs - 1) // 2
    assert len({(r[0], r[1]) for r in rows}) == len(rows)
