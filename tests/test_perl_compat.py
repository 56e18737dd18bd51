"""Perl-compat mode: the Perl engine's input rewrite, differentially
checked against the ACTUAL reference Perl engine.

smithwaterman.pl:82-99 uppercases, strips non-letters, then maps the
ambiguity codes [BJOUXZ] to X before aligning — the only reference
engine with this behavior (the rewrite's a-z class is dead after uc).
perl_compat replicates the INPUT rewrite; the Perl engine's other solo
quirks (terminal-pad order, zero-score walk emission) are out of scope,
so the differential compares the terminal-trimmed aligned segment plus
the score."""

import os
import shutil
import subprocess

import pytest

from smithwaterman_tpu import Aligner, BatchAligner, LOCAL
from smithwaterman_tpu.aligner import perl_sanitize
from smithwaterman_tpu.utils.oracle import trim_terminal

REF_PL = "/root/reference/smithwaterman.pl"

PAIRS = [
    ("HEAGBWGHEZ", "PAWHEAZE"),          # B/Z ambiguity codes -> X
    ("heagawghee", "PAWHEAE"),           # lowercase -> UPPERCASE (not X)
    ("MKTAYJAWOU", "MKTAXAWXX"),         # J/O/U -> X
    ("MK-TA YJ*AW2", "MKTAXAW"),         # strip non-letters too
]


def test_perl_sanitize_rule():
    assert perl_sanitize("ab1-BZJOUX*") == "AXXXXXXX"
    assert perl_sanitize("heag") == "HEAG"
    assert perl_sanitize("He-aG2z") == "HEAGX"
    assert perl_sanitize("BJOUXZ") == "XXXXXX"


@pytest.mark.skipif(
    not (shutil.which("perl") and os.path.exists(REF_PL)),
    reason="reference Perl engine unavailable",
)
@pytest.mark.parametrize("s1,s2", PAIRS)
def test_differential_vs_reference_perl(s1, s2):
    out = subprocess.run(
        ["perl", "-e",
         'require $ARGV[0]; my ($a, $b, $sc) = sw::align($ARGV[1], '
         '$ARGV[2]); print join("", @$a), "\\n", join("", @$b), '
         '"\\n", $sc, "\\n";',
         REF_PL, s1, s2],
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.splitlines()
    ref_a1, ref_a2 = trim_terminal(out[0], out[1])
    ref_score = float(out[2])
    assert ref_score > 0  # differential only meaningful off the
    # zero-score quirk (the Perl walk emits a column even at score 0)

    r = Aligner(mode=LOCAL, perl_compat=True).align(s1, s2, False)
    assert (r.aligned1, r.aligned2, r.score) == (ref_a1, ref_a2, ref_score)

    rb = BatchAligner(mode=LOCAL, backend="xla",
                      perl_compat=True).align_pairs(
        [(s1, s2)], retain_all=False)[0]
    assert (rb.aligned1, rb.aligned2, rb.score) == (
        ref_a1, ref_a2, ref_score)


def test_cli_flag_parses():
    from smithwaterman_tpu.cli import AlignmentOptions

    o = AlignmentOptions.parse(["-local", "-perl_compat", "a.fas", "b.fas"])
    assert o.perl_compat
