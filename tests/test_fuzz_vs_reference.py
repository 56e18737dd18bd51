"""Differential fuzzing against the reference's own Python implementation.

Runs /root/reference/smithwaterman.py as a subprocess oracle on random
pairs and demands identical local-mode scores and (terminal-trimmed)
alignment strings — an independent check beyond the fixed golden suites.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from smithwaterman_tpu import Aligner, LOCAL
from smithwaterman_tpu.utils.oracle import trim_terminal

REF = "/root/reference/smithwaterman.py"

if not os.path.exists(REF):
    pytest.skip("reference unavailable", allow_module_level=True)

LETTERS = "ACDEFGHIKLMNPQRSTVWY"
RNG = np.random.default_rng(2024)


def _ref_align(tmp_path, s1, s2):
    f1 = tmp_path / "a.fas"
    f2 = tmp_path / "b.fas"
    f1.write_text(f">s1\n{s1}\n")
    f2.write_text(f">s2\n{s2}\n")
    out = subprocess.run(
        [sys.executable, REF, str(f1), str(f2)],
        capture_output=True, text=True, timeout=120,
    )
    lines = out.stdout.splitlines()
    score = float(lines[0].split(":")[1])
    a1 = lines[1].split(" ", 1)[1]
    a2 = lines[2].split(" ", 1)[1]
    return score, a1, a2


def _rand_pair(rng):
    n = int(rng.integers(5, 80))
    m = int(rng.integers(5, 80))
    s1 = "".join(LETTERS[i] for i in rng.integers(0, 20, n))
    if rng.random() < 0.5:
        # related: mutate/indel a copy so alignments are non-trivial
        l = list(s1)
        for _ in range(int(rng.integers(1, 6))):
            p = int(rng.integers(0, len(l)))
            l[p] = LETTERS[int(rng.integers(0, 20))]
        if len(l) > 10 and rng.random() < 0.7:
            q = int(rng.integers(0, len(l) - 4))
            del l[q : q + int(rng.integers(1, 4))]
        s2 = "".join(l)[:m] if rng.random() < 0.5 else "".join(l)
        if not s2:
            s2 = "A"
    else:
        s2 = "".join(LETTERS[i] for i in rng.integers(0, 20, m))
    return s1, s2


def test_fuzz_local_vs_reference_python(tmp_path):
    aligner = Aligner(mode=LOCAL)
    for k in range(20):
        s1, s2 = _rand_pair(RNG)
        want_score, w1, w2 = _ref_align(tmp_path, s1, s2)
        r = aligner.align(s1, s2, True)
        assert r.score == pytest.approx(want_score), (k, s1, s2)
        a1, a2 = trim_terminal(r.aligned1, r.aligned2)
        t1, t2 = trim_terminal(w1, w2)
        assert (a1, a2) == (t1, t2), (k, s1, s2)


def _ref_align_custom(s1, s2, go, ge):
    """Drive the reference module in-process with custom penalties (its
    class hardcodes go=10/ge=0.5 but the attributes are plain floats,
    smithwaterman.py:65-66)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("ref_sw", REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sw = mod.SmithWaterman()
    sw.go = go
    sw.ge = ge
    a1, a2, score = sw.align(s1, s2)
    return float(score), a1, a2


@pytest.mark.parametrize("go,ge", [(7.0, 0.5), (12.5, 0.25), (5.0, 2.0)])
def test_fuzz_custom_penalties(go, ge):
    """Non-default penalties (outside the golden suite's 10/0.5)."""
    rng = np.random.default_rng(int(go * 10 + ge * 100))
    aligner = Aligner(mode=LOCAL, gap_open=go, gap_extend=ge)
    for k in range(6):
        s1, s2 = _rand_pair(rng)
        want_score, w1, w2 = _ref_align_custom(s1, s2, go, ge)
        r = aligner.align(s1, s2, True)
        assert r.score == pytest.approx(want_score), (k, go, ge, s1, s2)
        assert trim_terminal(r.aligned1, r.aligned2) == trim_terminal(w1, w2), (
            k, go, ge, s1, s2,
        )


def _ref_perl_score(s1, s2):
    """Reference Perl implementation as a score oracle (its traceback
    re-derives paths with its own tie priorities, so strings may validly
    differ on ties; scores cannot)."""
    out = subprocess.run(
        ["perl", "-e",
         'require "/root/reference/smithwaterman.pl"; '
         f'my ($r1,$r2,$s) = sw::align("{s1}","{s2}"); print $s;'],
        capture_output=True, text=True, timeout=120,
    )
    return float(out.stdout.strip())


def test_fuzz_scores_vs_reference_perl():
    rng = np.random.default_rng(777)
    aligner = Aligner(mode=LOCAL)
    for k in range(15):
        s1, s2 = _rand_pair(rng)
        assert aligner.score(s1, s2) == pytest.approx(_ref_perl_score(s1, s2)), (
            k, s1, s2,
        )


def test_fuzz_batch_device_walk_vs_reference(tmp_path):
    """The production batch path (tiled fill + on-device walk, the
    plain-JAX fill here) differentially fuzzed against the reference's
    own Python engine — random pairs, one bucketed batch call."""
    from smithwaterman_tpu import BatchAligner

    rng = np.random.default_rng(31337)
    pairs = [_rand_pair(rng) for _ in range(16)]
    ba = BatchAligner(mode=LOCAL, backend="xla")
    assert ba.device_walk
    got = ba.align_pairs(pairs)
    for k, ((s1, s2), r) in enumerate(zip(pairs, got)):
        want_score, w1, w2 = _ref_align(tmp_path, s1, s2)
        assert r.score == pytest.approx(want_score), (k, s1, s2)
        assert trim_terminal(r.aligned1, r.aligned2) == trim_terminal(
            w1, w2), (k, s1, s2)
