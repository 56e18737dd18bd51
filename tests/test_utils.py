"""calc_score + metrics utilities."""

import json

import pytest

from smithwaterman_tpu import Aligner, BatchAligner, LOCAL, GLOCAL, SubstitutionMatrix
from smithwaterman_tpu.utils.calc_score import recalc_score
from smithwaterman_tpu.utils.metrics import StatsCollector
from smithwaterman_tpu.utils.oracle import trim_terminal


def test_recalc_matches_engine_local():
    """Trimmed local alignment scores recompute exactly (calc_score.pl parity)."""
    a = Aligner(mode=LOCAL)
    for s1, s2 in [
        ("HEAGAWGHEE", "PAWHEAE"),
        ("MKVSEAALSLLVLILIITSASRSQ", "MKVSEAALSLLVLILIITSASRSQ"),
        ("WWWAAAWWW", "WWWCCCWWW"),
    ]:
        r = a.align(s1, s2, True)
        t1, t2 = trim_terminal(r.aligned1, r.aligned2)
        assert recalc_score(t1, t2) == pytest.approx(r.score)


def test_recalc_leading_gaps_free():
    # leading gap columns cost nothing; internal gap = open + extends
    sm = SubstitutionMatrix.blosum62()
    aa = sm.get_score_str("A", "A")
    assert recalc_score("--AA", "CCAA") == pytest.approx(2 * aa)
    assert recalc_score("A--A", "ACCA") == pytest.approx(2 * aa - 10.0 - 0.5)


def test_recalc_custom_penalties():
    assert recalc_score("A-A", "AAA", gap_open=5.0) == pytest.approx(
        2 * 4.0 - 5.0
    )


def test_stats_collector():
    ba = BatchAligner(mode=GLOCAL, backend="scan")
    ba.stats = StatsCollector()
    ba.align_pairs([("HEAGAWGHEE", "PAWHEAE"), ("WWW", "WWW")])
    s = ba.stats.summary()
    assert s["pairs"] == 2
    assert s["padded_gcups"] >= s["true_gcups"] > 0
    assert s["inflight_seconds"] > 0
    # throughput semantics: GCUPS divides by the
    # non-overlapped engine wall, never the sum of inflight intervals
    assert 0 < s["run_seconds"] <= s["wall_seconds"] + 1e-6
    assert s["true_gcups"] == pytest.approx(
        ba.stats.true_cells / ba.stats.run_seconds / 1e9, rel=1e-6
    )
    assert 0 <= s["padding_waste"] < 1
    json.dumps(s)  # serializable


def test_match_line_and_format():
    from smithwaterman_tpu.utils.display import format_alignment, match_line

    a1 = "HEAG-AW"
    a2 = "HE-GGAW"
    assert match_line(a1, a2) == ":: : ::"
    out = format_alignment(a1, a2, width=4)
    assert out.split("\n\n")[0] == "HEAG\n:: :\nHE-G"


def test_config_warns_on_nondyadic_penalties():
    """Non-quarter-integer penalties can diverge in the last ulp
    vs a sequential recurrence; the config must say so."""
    import warnings

    from smithwaterman_tpu.config import AlignConfig

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        AlignConfig(gap_open=10.0, gap_extend=0.5)
    assert not w
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        AlignConfig(gap_open=10.0, gap_extend=0.1)
    assert any("0.25" in str(x.message) for x in w)


def test_ladder_for_lengths():
    from smithwaterman_tpu.config import (
        DEFAULT_BUCKETS, bucket_len, ladder_for_lengths,
    )

    rng = __import__("numpy").random.default_rng(3)
    lens = rng.integers(150, 701, size=500)
    lad = ladder_for_lengths(lens, max_rungs=8)
    assert all(b % 128 == 0 or b == 64 for b in lad)
    assert len(lad) <= 9
    assert lad == tuple(sorted(lad))
    # every length fits a rung without falling off the ladder
    assert max(lens) <= lad[-1]
    # dense-region padding is bounded by one quantum at the quantiles
    waste = [bucket_len(int(x), lad) - int(x) for x in lens]
    assert sum(waste) / len(waste) < 256
    # degenerate inputs fall back to the default ladder
    assert ladder_for_lengths([]) == DEFAULT_BUCKETS
    # the default ladder itself: 128-multiple rungs through 2048
    assert all(b % 128 == 0 for b in DEFAULT_BUCKETS[1:])
