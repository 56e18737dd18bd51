"""All-vs-all alignment sweeps with job-level checkpoint/resume.

The reference's batch drivers hold everything in one process and lose all
work on a crash (SURVEY.md §5: no failure detection or resume).  This module
provides the equivalent for production sweeps: work is split into
chunks of pairs, each completed chunk is appended to a JSONL results file
with an index marker, and a restarted sweep skips every chunk already on
disk.  Multi-host runs shard chunks round-robin by process index.

Results are scores (score_only sweeps) or full alignments.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

from .batch_aligner import BatchAligner
from .io.fasta import SeqData


class IncompleteSweepError(RuntimeError):
    """A sweep results file is missing pair results (partial multi-host run
    or corrupted lines); raised instead of silently returning zero scores."""


@dataclass
class SweepConfig:
    chunk_pairs: int = 256          # pairs per checkpointed chunk
    score_only: bool = True
    retain_all: bool = False
    process_index: int = 0          # this host's index (multi-host)
    process_count: int = 1
    # attach a utils.metrics.StatsCollector to the engine for the run and
    # emit its per-bucket JSON report (GCUPS, padding waste) on stderr
    # when the sweep call finishes (SURVEY.md §5 observability)
    stats: bool = False
    # rebuild the engine's bucket ladder from the sweep inputs' length
    # distribution (config.ladder_for_lengths): padding concentrates
    # where the sequences actually are.  Each rung pair that occurs is a
    # fill compile (kept in the persistent compile cache), bounded by
    # auto_ladder_rungs.
    auto_ladder: bool = False
    auto_ladder_rungs: int = 12


def _pair_indices(n1: int, n2: Optional[int]) -> Iterator[Tuple[int, int]]:
    """All-vs-all (two sets) or upper-triangle (self sweep)."""
    if n2 is None:
        for i in range(n1):
            for j in range(i + 1, n1):
                yield (i, j)
    else:
        for i in range(n1):
            for j in range(n2):
                yield (i, j)


def _chunks(items: List, size: int) -> List[List]:
    return [items[k : k + size] for k in range(0, len(items), size)]


def sweep(
    set1: Sequence[SeqData],
    set2: Optional[Sequence[SeqData]],
    engine: BatchAligner,
    out_path: str,
    config: Optional[SweepConfig] = None,
) -> int:
    """Run (or resume) a sweep; returns the number of chunks this call
    completed.  Every line of ``out_path`` is a JSON object:
    ``{"chunk": k, "results": [[i, j, score, (aligned1, aligned2)?], ...]}``.
    """
    cfg = config or SweepConfig()
    if cfg.stats and engine.stats is None:
        from .utils.metrics import StatsCollector

        engine.stats = StatsCollector()
    if cfg.auto_ladder:
        from dataclasses import replace

        from .config import ladder_for_lengths

        lengths = [len(s.seq) for s in set1]
        if set2 is not None:
            lengths += [len(s.seq) for s in set2]
        engine.config = replace(
            engine.config,
            buckets=ladder_for_lengths(lengths,
                                       max_rungs=cfg.auto_ladder_rungs),
        )
    pairs_idx = list(_pair_indices(len(set1), None if set2 is None else len(set2)))
    chunks = _chunks(pairs_idx, cfg.chunk_pairs)

    done = set()
    if os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["chunk"])
                except (json.JSONDecodeError, KeyError):
                    # a torn write from a previous crash: that chunk reruns
                    continue
        # seal a torn final line so appended records start on a fresh line
        with open(out_path, "rb+") as f:
            f.seek(0, os.SEEK_END)
            if f.tell() > 0:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")

    other = set1 if set2 is None else set2
    completed = 0
    with open(out_path, "a") as f:
        for k, chunk in enumerate(chunks):
            if k in done:
                continue
            if k % cfg.process_count != cfg.process_index:
                continue
            pair_seqs = [(set1[i], other[j]) for i, j in chunk]
            if cfg.score_only:
                scores = engine.score_pairs(pair_seqs)
                results = [
                    [i, j, float(s)] for (i, j), s in zip(chunk, scores)
                ]
            else:
                rs = engine.align_pairs(pair_seqs, retain_all=cfg.retain_all)
                results = [
                    [i, j, r.score, r.aligned1, r.aligned2]
                    for (i, j), r in zip(chunk, rs)
                ]
            f.write(json.dumps({"chunk": k, "results": results}) + "\n")
            f.flush()
            os.fsync(f.fileno())
            completed += 1
    if cfg.stats and engine.stats is not None:
        import sys

        sys.stderr.write(engine.stats.report() + "\n")
    return completed


def iter_sweep(out_path: str) -> Iterator[List]:
    """Stream result rows from a sweep file one chunk-line at a time
    (pod-scale sweeps should not materialize every pair in memory)."""
    with open(out_path) as f:
        for line in f:
            try:
                results = json.loads(line)["results"]
            except (json.JSONDecodeError, KeyError):
                continue
            yield from results


def load_sweep(out_path: str) -> List[List]:
    """Flatten a sweep results file into one list of result rows."""
    return list(iter_sweep(out_path))


def score_matrix(
    set1: Sequence[SeqData],
    set2: Optional[Sequence[SeqData]],
    engine: BatchAligner,
    out_path: str,
    config: Optional[SweepConfig] = None,
):
    """Sweep + assemble the dense score matrix (numpy).  Self-sweeps return
    a symmetric matrix with zero diagonal."""
    import numpy as np

    cfg = config or SweepConfig()
    sweep(set1, set2, engine, out_path, cfg)
    n1 = len(set1)
    n2 = n1 if set2 is None else len(set2)
    mat = np.zeros((n1, n2), np.float32)
    expected = sum(1 for _ in _pair_indices(n1, None if set2 is None else n2))
    seen = 0
    for row in iter_sweep(out_path):
        i, j, s = int(row[0]), int(row[1]), float(row[2])
        mat[i, j] = s
        if set2 is None:
            mat[j, i] = s
        seen += 1
    if seen < expected:
        # a partial file (other hosts' shards pending, or unparseable lines)
        # must not read as all-zero scores
        raise IncompleteSweepError(
            f"sweep file {out_path} holds {seen}/{expected} pair results; "
            "run the remaining shards (or re-run sweep()) before assembling "
            "the matrix"
        )
    return mat
