"""csrc/refbench.cpp parity: both C++ race-bound engines must be
string-exact vs all 300 EMBOSS goldens (100 pairs x 3 modes).

refbench is BENCHMARK scaffolding — a two-sided C++ bound of the
reference's fastest engine (Rust CPU, sequence_alignment.rs:55-550),
which has no toolchain here.  Its times are only meaningful if its
outputs are the reference's outputs; this test
pins that, so scripts/bench_vs_reference.py can trust the binary.
"""

import subprocess
from pathlib import Path

import pytest

from smithwaterman_tpu.utils import oracle

REPO = Path(__file__).resolve().parents[1]
REF_TEST = Path("/root/reference/test")
BIN = REPO / "smithwaterman_tpu" / "_native" / "refbench"

GOLDEN = {
    "local": "res{}.dat",
    "global": "needle_res{}.dat",
    "glocal": "needle_glocal_res{}.dat",
}


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    if not REF_TEST.exists():
        pytest.skip("reference test fixtures not present")
    subprocess.run(
        ["make", "-C", str(REPO / "csrc"), "refbench"],
        check=True, capture_output=True,
    )
    out = tmp_path_factory.mktemp("refbench")
    res = subprocess.run(
        [str(BIN), str(REF_TEST), "all", "--engine", "both",
         "--dump", str(out)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    assert res.stdout.count('"seconds"') == 6  # 2 engines x 3 modes
    return out


def _parse_dump(path: Path):
    """[(score, a1, a2)] in file_list.txt order."""
    recs = []
    lines = path.read_text().splitlines()
    for i in range(0, len(lines), 3):
        score = float(lines[i].split("score")[1])
        recs.append((score, lines[i + 1], lines[i + 2]))
    return recs


@pytest.mark.parametrize("engine", ["cell", "flat"])
@pytest.mark.parametrize("mode", ["local", "global", "glocal"])
def test_refbench_matches_goldens(dumps, engine, mode):
    recs = _parse_dump(dumps / f"{engine}_{mode}.txt")
    assert len(recs) == 100
    for k, (score, a1, a2) in enumerate(recs):
        g = oracle.parse_emboss_dat(
            str(REF_TEST / "emboss_results" / GOLDEN[mode].format(k))
        )
        if mode == "local":
            a1, a2 = oracle.trim_terminal(a1, a2)
        assert score == g.score, f"pair {k} score"
        assert (a1, a2) == (g.seq1, g.seq2), f"pair {k} strings"
