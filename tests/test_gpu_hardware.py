"""On-card checks: the CUDA fill against the plain-JAX fill and the scan
oracle.  They skip without a GPU; run them on one with

    SWT_GPU_TESTS=1 python -m pytest tests/test_gpu_hardware.py -m gpu

(chip_smoke.py does, in a child process, before it starts JAX itself).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _mutated_batch(rng, B, NP, MP, K):
    """Seeded pairs whose second sequence is a mutated copy of the first,
    lengths spread over the bucket, with the 1-residue extremes."""
    n = rng.integers(1, NP + 1, B).astype(np.int32)
    m = rng.integers(1, MP + 1, B).astype(np.int32)
    n[0], m[0], n[1], m[1] = NP, MP, 1, 1
    c1 = rng.integers(0, K, (B, NP)).astype(np.int8)
    c2 = rng.integers(0, K, (B, MP)).astype(np.int8)
    for b in range(2, B, 2):
        k = int(min(n[b], m[b]))
        c2[b, :k] = c1[b, :k]
        hits = rng.integers(0, MP, MP // 8)
        c2[b, hits] = rng.integers(0, K, hits.size)
    return c1, c2, n, m


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("score_only", [False, True])
def test_cuda_fill_matches_xla_fill(gpu, mode, score_only):
    """Pointer bytes inside every pair's region and the stats rows are
    bit-identical between the CUDA kernel and the plain-JAX fill, in both
    arithmetic domains."""
    from smithwaterman_tpu.matrices import SubstitutionMatrix
    from smithwaterman_tpu.ops import fill

    sm = SubstitutionMatrix.blosum62()
    rng = np.random.default_rng(100 + mode)
    c1, c2, n, m = _mutated_batch(rng, 24, 200, 300, sm.n_symbols)
    for table, quarter in ((sm.table, True), (sm.table + 0.5, False)):
        tx, sx = fill.fill(table, c1, c2, n, m, backend="xla", mode=mode,
                           og=-10.0, eg=-0.5, score_only=score_only)
        tc, sc = fill.fill(table, c1, c2, n, m, backend="cuda", mode=mode,
                           og=-10.0, eg=-0.5, score_only=score_only,
                           quarter=quarter)
        np.testing.assert_array_equal(np.asarray(sc), np.asarray(sx))
        if score_only:
            assert tc is None and tx is None
            continue
        tx, tc = np.asarray(tx), np.asarray(tc)
        for b in range(len(n)):
            np.testing.assert_array_equal(
                tc[b, :n[b], 0, :m[b]], tx[0, :n[b], b, :m[b]],
                err_msg=f"pair {b} quarter={quarter}")


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_batch_cuda_matches_cpu_scan(gpu, mode):
    """The served path on the card (cuda backend: fill, pooled device walk,
    native rebuild) gives the strings the CPU scan oracle gives."""
    import jax

    from smithwaterman_tpu import BatchAligner

    rng = np.random.default_rng(7 + mode)
    aa = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    pairs = []
    for _ in range(60):
        a = aa[rng.integers(0, 20, int(rng.integers(5, 700)))]
        b = a.copy()
        b[rng.integers(0, b.size, max(1, b.size // 7))] = aa[
            rng.integers(0, 20, max(1, b.size // 7))]
        pairs.append(("".join(a), "".join(b[int(rng.integers(0, 9)):])))
    got = BatchAligner(mode=mode, backend="cuda").align_pairs(pairs)
    with jax.default_device(jax.devices("cpu")[0]):
        want = BatchAligner(mode=mode, backend="scan").align_pairs(pairs)
    for g, w in zip(got, want):
        assert (g.score, g.aligned1, g.aligned2) == (
            w.score, w.aligned1, w.aligned2)


def test_parity_cases_on_cuda(gpu):
    """The reference engine's own expectations (tests/data) through the
    cuda backend, every letter-table case."""
    from test_align_parity import CASES, MODES, make_matrix

    from smithwaterman_tpu import BatchAligner

    ran = 0
    for group in CASES.values():
        for case in group:
            if case["matrix"] not in ("blosum62", "mat_5_-4", "blosum62_x10"):
                continue  # position-specific: per-pair Aligner path
            ba = BatchAligner(
                scoring_matrix=make_matrix(case["matrix"]),
                gap_open=case["gap_open"], gap_extend=case["gap_extend"],
                mode=MODES[case["mode"]], backend="cuda",
            )
            r = ba.align_pairs([(case["seq1"], case["seq2"])],
                               case.get("retain_all", True))[0]
            if case["score"] is not None:
                assert r.score == pytest.approx(case["score"], abs=1e-4)
            if case["aligned1"] is not None:
                assert (r.aligned1, r.aligned2) == (
                    case["aligned1"], case["aligned2"])
            ran += 1
    assert ran >= 15


def _protein_pairs(seed, count, lo, hi):
    rng = np.random.default_rng(seed)
    aa = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    out = []
    for _ in range(count):
        a = aa[rng.integers(0, 20, int(rng.integers(lo, hi)))]
        b = a.copy()
        b[rng.integers(0, b.size, max(1, b.size // 6))] = aa[
            rng.integers(0, 20, max(1, b.size // 6))]
        out.append(("".join(a), "".join(b)))
    return out


def test_aligner_routes_to_cuda(gpu):
    """On a GPU the single-pair Aligner runs on the cuda batch pipeline and
    agrees with the CPU scan oracle in every mode."""
    import jax

    from smithwaterman_tpu import Aligner, BatchAligner, GLOBAL, GLOCAL, LOCAL

    pairs = _protein_pairs(11, 6, 20, 300)
    for mode in (LOCAL, GLOCAL, GLOBAL):
        al = Aligner(mode=mode)
        got = [al.align(a, b) for a, b in pairs]
        assert al._batch is not None and al._batch.backend == "cuda"
        with jax.default_device(jax.devices("cpu")[0]):
            want = BatchAligner(mode=mode, backend="scan").align_pairs(pairs)
        for g, w in zip(got, want):
            assert (g.score, g.aligned1, g.aligned2) == (
                w.score, w.aligned1, w.aligned2)


def test_sweep_on_cuda(gpu, tmp_path):
    """A checkpointed score sweep on the card equals the CPU scan sweep."""
    import jax

    from smithwaterman_tpu import BatchAligner, LOCAL, SeqData
    from smithwaterman_tpu.sweep import SweepConfig, score_matrix

    seqs = [SeqData(f"s{k}", "", a)
            for k, (a, _) in enumerate(_protein_pairs(12, 24, 30, 400))]
    cfg = SweepConfig(chunk_pairs=64)
    got = score_matrix(seqs, None, BatchAligner(mode=LOCAL),
                       str(tmp_path / "gpu.jsonl"), cfg)
    with jax.default_device(jax.devices("cpu")[0]):
        want = score_matrix(seqs, None,
                            BatchAligner(mode=LOCAL, backend="scan"),
                            str(tmp_path / "cpu.jsonl"), cfg)
    np.testing.assert_array_equal(got, want)
