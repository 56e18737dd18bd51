"""CLI surface + clustering behavior (parity: sa_opencl/src/main.rs)."""

import os



import pytest

from smithwaterman_tpu import Aligner, BatchAligner, LOCAL, load_fasta
from smithwaterman_tpu.cli import AlignmentOptions, format_score, main, read_pair_list
from smithwaterman_tpu.cluster import greedy_cluster, write_cluster_outputs
from smithwaterman_tpu.io.fasta import SeqData

REF_INPUTS = "/root/reference/test/inputs"


# ---------------------------------------------------------------- options
def test_parse_two_files():
    o = AlignmentOptions.parse(["-global", "a.fas", "b.fas"])
    assert o.alignment_type == 0 and (o.file1, o.file2) == ("a.fas", "b.fas")


def test_parse_cluster():
    o = AlignmentOptions.parse(
        ["-cluster", "-identity", "0.9", "-coverage_short", "0.7",
         "-coverage_long", "0.6", "-out", "o.fas", "in.fas"]
    )
    assert o.clustering and o.c_identity == 0.9
    assert o.c_coverage_short == 0.7 and o.c_coverage_long == 0.6
    assert o.outfilename == "o.fas" and o.file1 == "in.fas"


def test_parse_errors():
    with pytest.raises(SystemExit):
        AlignmentOptions.parse(["-bogus", "a", "b"])
    with pytest.raises(SystemExit):
        AlignmentOptions.parse(["a.fas"])  # 2 files required
    with pytest.raises(SystemExit):
        AlignmentOptions.parse(["-cluster", "-list", "x"])
    with pytest.raises(SystemExit):
        AlignmentOptions.parse(["-cluster", "in.fas"])  # needs -out


def test_format_score():
    assert format_score(54.5) == "54.5"
    assert format_score(24.0) == "24"
    assert format_score(-13.0) == "-13"
    assert format_score(-366.5) == "-366.5"


def test_read_pair_list(tmp_path, capsys):
    p = tmp_path / "list.txt"
    p.write_text("a.fas\tb.fas\nc.fas d.fas\nx.fas\ty.fas\tz.fas\nbad\n")
    pairs = read_pair_list(str(p))
    # parity: the 3-column line is reported but (like the reference) skipped
    assert pairs == [("a.fas", "b.fas"), ("c.fas", "d.fas")]
    outp = capsys.readouterr().out
    assert "are used." in outp and "ignoed" in outp


# ---------------------------------------------------------------- pair mode
def test_two_file_output(tmp_path, capsys):
    if not os.path.isdir(REF_INPUTS):
        pytest.skip("no reference fixtures")
    f1 = os.path.join(REF_INPUTS, "seq0.1.fas")
    f2 = os.path.join(REF_INPUTS, "seq0.2.fas")
    main(["-local", f1, f2])
    out = capsys.readouterr().out
    s1 = load_fasta(f1)[0]
    s2 = load_fasta(f2)[0]
    r = Aligner(mode=LOCAL).align(s1, s2, True)
    expect = (
        f"#score:{format_score(r.score)}\n#type:Local alignment\n"
        f">{s1.name}\n{r.aligned1}\n\n>{s2.name}\n{r.aligned2}\n\n"
    )
    assert out == expect


def test_list_mode(tmp_path, capsys):
    if not os.path.isdir(REF_INPUTS):
        pytest.skip("no reference fixtures")
    lst = tmp_path / "pairs.txt"
    lst.write_text(
        f"{REF_INPUTS}/seq0.1.fas\t{REF_INPUTS}/seq0.2.fas\n"
        f"{REF_INPUTS}/seq1.1.fas\t{REF_INPUTS}/seq1.2.fas\n"
    )
    main(["-glocal", "-list", str(lst)])
    out = capsys.readouterr().out
    assert out.count("#score:") == 2
    assert out.count("#type:Glocal alignment") == 2


def test_usage_exit():
    with pytest.raises(SystemExit) as e:
        main(["onearg"])
    assert e.value.code == 255


# ---------------------------------------------------------------- clustering
BASE = "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRVGDGTQDNLSGAEKAVQVKVKALPDAQ"


def _cluster_input():
    return [
        SeqData("dup1", "", BASE),
        SeqData("short", "", "WWWHHH"),          # unrelated, short
        SeqData("contained", "", BASE[:60]),     # substring, lcov 60/66 >= 0.8
        SeqData("similar", "", BASE[:30] + "W" + BASE[31:]),  # 1 mismatch
        SeqData("rep", "", BASE),
        SeqData("faraway", "", "PPPPPPGGGGGGPPPPPPGGGGGGPPPPPPGGGGGGPPPPPPGGGGGGPPPPPPGGGGGG"),
    ]


def test_greedy_cluster(tmp_path):
    engine = BatchAligner(mode=LOCAL, backend="scan")
    cluster_of, members, order = greedy_cluster(_cluster_input(), engine)
    names = [s.name for s in order]
    # stable sort, length desc: dup1/similar/rep (66), faraway(60)? lengths:
    # dup1 66, similar 66, rep 66, contained 60, faraway 60, short 6
    assert names == ["dup1", "similar", "rep", "contained", "faraway", "short"]
    by_name = {s.name: i for i, s in enumerate(order)}
    rep0 = by_name["dup1"]
    # rep & dup1 identical -> collapsed; similar merged by alignment;
    # contained merged by containment; faraway/short separate
    mem0 = {order[m].name for m in members[rep0]}
    assert mem0 == {"dup1", "rep", "similar", "contained"}
    assert cluster_of[by_name["faraway"]] == by_name["faraway"]
    assert cluster_of[by_name["short"]] == by_name["short"]
    # reference quirk parity: exact duplicates keep cluster_of == self and
    # appear as representatives (main.rs:252)
    assert cluster_of[by_name["rep"]] == by_name["rep"]

    out = tmp_path / "out.fas"
    write_cluster_outputs(str(out), order, cluster_of, members)
    reps = [r.name for r in load_fasta(str(out))]
    assert reps == ["dup1", "rep", "faraway", "short"]
    clstr = (tmp_path / "out.fas.clstr").read_text().splitlines()
    assert clstr[0].split() == ["dup1", "rep", "similar", "contained"]
    assert ["faraway"] in [l.split() for l in clstr]
    assert ["short"] in [l.split() for l in clstr]


def test_cluster_cli_end_to_end(tmp_path, capsys):
    inp = tmp_path / "in.fas"
    with open(inp, "w") as f:
        for s in _cluster_input():
            f.write(f">{s.name} {s.desc}\n{s.seq}\n")
    out = tmp_path / "clusters.fas"
    main(["-cluster", "-identity", "0.8", "-out", str(out), str(inp)])
    assert out.exists() and (tmp_path / "clusters.fas.clstr").exists()
    reps = [r.name for r in load_fasta(str(out))]
    assert "dup1" in reps and "faraway" in reps


def test_extension_flags(tmp_path, capsys):
    """-gapopen/-gapextend/-matrix extensions reproduce the DNA parity case
    (the reference engines accept these; its CLIs hardcode them)."""
    import json

    with open(os.path.join(os.path.dirname(__file__), "data", "parity_cases.json")) as f:
        case = json.load(f)["dna"][0]
    f1 = tmp_path / "a.fas"
    f2 = tmp_path / "b.fas"
    f1.write_text(f">s1\n{case['seq1']}\n")
    f2.write_text(f">s2\n{case['seq2']}\n")
    main(["-local", "-matrix", "dna", "-match", "5", "-mismatch", "-4",
          "-gapopen", "10", "-gapextend", "0.5", str(f1), str(f2)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "#score:54.5"
    assert out[3] == case["aligned1"]


def test_matrix_file_flag(tmp_path, capsys):
    mat = tmp_path / "m.mat"
    mat.write_text("  A B\nA 9 -9\nB -9 9\n")
    f1 = tmp_path / "a.fas"
    f2 = tmp_path / "b.fas"
    f1.write_text(">s1\nAAB\n")
    f2.write_text(">s2\nAAB\n")
    main(["-local", "-matrix", str(mat), str(f1), str(f2)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "#score:27"


def test_out_file_quirk(tmp_path):
    """-out file output replicates the reference's missing newlines after
    #score/#type (main.rs:303-306 write_all vs :309-312 println)."""
    f1 = tmp_path / "a.fas"
    f2 = tmp_path / "b.fas"
    f1.write_text(">s1\nWWW\n")
    f2.write_text(">s2\nWWW\n")
    lst = tmp_path / "l.txt"
    lst.write_text(f"{f1}\t{f2}\n")
    out = tmp_path / "res.txt"
    main(["-local", "-list", str(lst), "-out", str(out)])
    txt = out.read_text()
    assert txt.startswith("#score:33#type:Local alignment>s1\n")


def test_cluster_empty_input(tmp_path):
    inp = tmp_path / "empty.fas"
    inp.write_text("")
    out = tmp_path / "out.fas"
    main(["-cluster", "-out", str(out), str(inp)])
    assert out.read_text() == ""
    assert (tmp_path / "out.fas.clstr").read_text() == ""


def test_stats_flag(tmp_path, capsys):
    """-stats emits the per-bucket observability report (GCUPS, padding
    waste) as one JSON line on stderr (SURVEY.md §5)."""
    import json

    f1 = tmp_path / "a.fas"
    f2 = tmp_path / "b.fas"
    f1.write_text(">s1\nHEAGAWGHEE\n")
    f2.write_text(">s2\nPAWHEAE\n")
    main(["-local", "-stats", str(f1), str(f2)])
    cap = capsys.readouterr()
    assert cap.out.startswith("#score:")
    rep = json.loads(cap.err.strip().splitlines()[-1])
    assert rep["pairs"] == 1
    assert rep["inflight_seconds"] > 0 and rep["run_seconds"] > 0
    assert "true_gcups" in rep and "padded_gcups" in rep
    (bucket,) = rep["buckets"].values()
    assert 0.0 <= bucket["padding_waste"] < 1.0


def test_band_flag(tmp_path, capsys):
    """-band W routes pairs through the double-band-verified banded path;
    on a near-diagonal pair the result equals the unbanded engine."""
    import numpy as np

    rng = np.random.default_rng(9)
    letters = list("ARNDCQEGHILKMFPSTWYV")
    s = "".join(rng.choice(letters, 400))
    s2 = s[:180] + "W" + s[183:]  # small indel drift
    f1 = tmp_path / "a.fas"
    f2 = tmp_path / "b.fas"
    f1.write_text(f">s1\n{s}\n")
    f2.write_text(f">s2\n{s2}\n")
    main(["-local", "-band", "128", str(f1), str(f2)])
    banded_out = capsys.readouterr().out
    main(["-local", str(f1), str(f2)])
    plain_out = capsys.readouterr().out
    assert banded_out == plain_out
    assert banded_out.startswith("#score:")


def test_band_with_stats(tmp_path, capsys):
    """-stats with -band records the banded pairs (the banded
    path bypasses BatchAligner, so stats must be fed explicitly — an
    all-zero report here is a regression)."""
    import json

    f1 = tmp_path / "a.fas"
    f2 = tmp_path / "b.fas"
    f1.write_text(">s1\nHEAGAWGHEEHEAGAWGHEE\n")
    f2.write_text(">s2\nHEAGAWGHEEHEAGAWGHEE\n")
    main(["-local", "-band", "8", "-stats", str(f1), str(f2)])
    cap = capsys.readouterr()
    rep = json.loads(cap.err.strip().splitlines()[-1])
    assert rep["pairs"] == 1
    assert rep["run_seconds"] > 0 and rep["true_gcups"] > 0
