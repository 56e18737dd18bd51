"""All-vs-all sweep: results, resume-after-crash, score matrix, host sharding."""

import json

import numpy as np

from smithwaterman_tpu import BatchAligner, LOCAL, SeqData
from smithwaterman_tpu.sweep import SweepConfig, load_sweep, score_matrix, sweep

SEQS = [
    SeqData(f"s{i}", "", s)
    for i, s in enumerate(
        ["HEAGAWGHEE", "PAWHEAE", "HEAGAWGHEF", "WWWPPP", "AWHEA", "GGGGG"]
    )
]


def _engine():
    return BatchAligner(mode=LOCAL, backend="scan")


def test_self_sweep_and_matrix(tmp_path):
    out = str(tmp_path / "sweep.jsonl")
    cfg = SweepConfig(chunk_pairs=4, score_only=True)
    n = sweep(SEQS, None, _engine(), out, cfg)
    assert n == -(-len(SEQS) * (len(SEQS) - 1) // 2 // 4)
    mat = score_matrix(SEQS, None, _engine(), out, cfg)
    assert mat.shape == (6, 6)
    assert np.allclose(mat, mat.T)
    # spot-check one score against the engine
    want = _engine().score_pairs([(SEQS[0], SEQS[1])])[0]
    assert mat[0, 1] == want


def test_resume_skips_done_chunks(tmp_path):
    out = str(tmp_path / "sweep.jsonl")
    cfg = SweepConfig(chunk_pairs=4, score_only=True)
    n1 = sweep(SEQS, None, _engine(), out, cfg)
    assert n1 > 0
    # resume: nothing left to do
    n2 = sweep(SEQS, None, _engine(), out, cfg)
    assert n2 == 0


def test_resume_after_torn_write(tmp_path):
    out = str(tmp_path / "sweep.jsonl")
    cfg = SweepConfig(chunk_pairs=4, score_only=True)
    sweep(SEQS, None, _engine(), out, cfg)
    lines = open(out).read().splitlines()
    # simulate a crash mid-write of the last chunk
    with open(out, "w") as f:
        f.write("\n".join(lines[:-1]) + "\n" + lines[-1][: len(lines[-1]) // 2])
    n = sweep(SEQS, None, _engine(), out, cfg)
    assert n == 1  # only the torn chunk reruns
    rows = load_sweep(out)
    assert len(rows) == len(SEQS) * (len(SEQS) - 1) // 2


def test_two_set_sweep_with_alignments(tmp_path):
    out = str(tmp_path / "ab.jsonl")
    cfg = SweepConfig(chunk_pairs=3, score_only=False)
    sweep(SEQS[:2], SEQS[2:4], _engine(), out, cfg)
    rows = load_sweep(out)
    assert len(rows) == 4
    assert all(len(r) == 5 for r in rows)  # i, j, score, a1, a2


def test_score_matrix_rejects_partial_file(tmp_path):
    """Regression: a partial sweep file (e.g. only this host's
    shard) must raise, not silently read as zero scores."""
    import pytest

    from smithwaterman_tpu.sweep import IncompleteSweepError

    out = str(tmp_path / "partial.jsonl")
    cfg = SweepConfig(chunk_pairs=2, process_index=0, process_count=2)
    with pytest.raises(IncompleteSweepError):
        score_matrix(SEQS, None, _engine(), out, cfg)


def test_process_sharding(tmp_path):
    outs = []
    for pid in range(2):
        out = str(tmp_path / f"p{pid}.jsonl")
        cfg = SweepConfig(chunk_pairs=2, process_index=pid, process_count=2)
        sweep(SEQS, None, _engine(), out, cfg)
        outs.append(out)
    chunks0 = {json.loads(l)["chunk"] for l in open(outs[0])}
    chunks1 = {json.loads(l)["chunk"] for l in open(outs[1])}
    assert chunks0.isdisjoint(chunks1)
    total = len(load_sweep(outs[0])) + len(load_sweep(outs[1]))
    assert total == len(SEQS) * (len(SEQS) - 1) // 2


def test_sweep_stats_option(tmp_path, capsys):
    """SweepConfig(stats=True) attaches a collector and emits the JSON
    report on stderr after the sweep."""
    out = str(tmp_path / "sweep.jsonl")
    cfg = SweepConfig(chunk_pairs=4, score_only=False, stats=True)
    eng = _engine()
    sweep(SEQS, None, eng, out, cfg)
    rep = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert rep["pairs"] == 15
    assert rep["padding_waste"] >= 0.0
    assert eng.stats is not None


def test_sweep_auto_ladder(tmp_path):
    """auto_ladder rebuilds the engine's bucket ladder from the inputs'
    length distribution (config.ladder_for_lengths); scores unchanged."""
    import numpy as np

    from smithwaterman_tpu import BatchAligner, LOCAL, SeqData
    from smithwaterman_tpu.sweep import SweepConfig, load_sweep, sweep

    rng = np.random.default_rng(5)
    letters = list("ARNDCQEGHILKMFPSTWYV")
    seqs = [
        SeqData(f"s{i}", "", "".join(rng.choice(
            letters, int(rng.integers(150, 400)))))
        for i in range(8)
    ]
    e1 = BatchAligner(mode=LOCAL, backend="scan")
    sweep(seqs, None, e1, str(tmp_path / "a.jsonl"),
          SweepConfig(chunk_pairs=16, auto_ladder=True,
                      auto_ladder_rungs=4))
    assert len(e1.config.buckets) <= 5
    assert max(len(s.seq) for s in seqs) <= e1.config.buckets[-1]
    e2 = BatchAligner(mode=LOCAL, backend="scan")
    sweep(seqs, None, e2, str(tmp_path / "b.jsonl"),
          SweepConfig(chunk_pairs=16))
    r1 = sorted(map(tuple, load_sweep(str(tmp_path / "a.jsonl"))))
    r2 = sorted(map(tuple, load_sweep(str(tmp_path / "b.jsonl"))))
    assert r1 == r2
