"""The CUDA fill's Python side, on the CPU: argument domains, padding,
result layout, the choice of kernel, the FFI call it lowers to, and the
error (never a fallback) when the library cannot be built.

The kernel itself runs only on a GPU (tests/test_gpu_hardware.py).  Here a
stand-in computes the kernel's raw results with the plain-JAX fill, so
everything around the call is exercised as the GPU runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smithwaterman_tpu import BatchAligner, GLOBAL, GLOCAL, LOCAL
from smithwaterman_tpu.matrices import SubstitutionMatrix
from smithwaterman_tpu.ops import batch, cuda_fill, fill

OG, EG = -10.0, -0.5
SM = SubstitutionMatrix.blosum62()


def _fake_call(codes1, c2, n, m, tab, *, quarter, mode, score_only, attrs):
    """The kernel's raw results (tb (B, NP, MP4), stats, scratch) computed
    by the plain fill from the kernel's own arguments — so the quarter-unit
    conversion is exercised, not bypassed."""
    scale = 0.25 if quarter else 1.0
    tb, st = fill.fill_xla(
        tab.astype(jnp.float32) * scale, codes1, c2, n, m, mode=mode,
        og=float(attrs["og"]) * scale, eg=float(attrs["eg"]) * scale,
        score_only=score_only,
    )
    B = codes1.shape[0]
    raw = (jnp.zeros((1,), jnp.uint8) if score_only
           else tb[0].transpose(1, 0, 2))
    sdt = jnp.int32 if quarter else jnp.float32
    return raw, st, jnp.zeros((B, c2.shape[1], 3), sdt)


@pytest.fixture
def fake_kernel(monkeypatch):
    monkeypatch.setattr(cuda_fill, "_call", _fake_call)
    monkeypatch.setattr(cuda_fill, "ensure_registered", lambda: None)
    cuda_fill._fill_jit.clear_cache()
    yield
    cuda_fill._fill_jit.clear_cache()


def _batch(seed, B=8, NP=40, MP=66):
    rng = np.random.default_rng(seed)
    n = rng.integers(1, NP + 1, B).astype(np.int32)
    m = rng.integers(1, MP + 1, B).astype(np.int32)
    n[0], m[0] = NP, MP
    c1 = rng.integers(0, SM.n_symbols, (B, NP)).astype(np.int8)
    c2 = rng.integers(0, SM.n_symbols, (B, MP)).astype(np.int8)
    return c1, c2, n, m


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
@pytest.mark.parametrize("score_only", [False, True])
@pytest.mark.parametrize("quarter", [True, False])
def test_wrapper_layout_matches_xla(fake_kernel, mode, score_only, quarter):
    """fill(backend="cuda") returns tb (B, NP, 1, MP4) — one pair per
    group, columns padded to 4 bytes — whose pair views and stats equal
    the plain fill's."""
    c1, c2, n, m = _batch(mode * 4 + score_only * 2 + quarter)
    table = SM.table if quarter else SM.table + 0.5
    tc, sc = fill.fill(table, c1, c2, n, m, backend="cuda", mode=mode,
                       og=OG, eg=EG, score_only=score_only, quarter=quarter)
    tx, sx = fill.fill(table, c1, c2, n, m, backend="xla", mode=mode,
                       og=OG, eg=EG, score_only=score_only)
    np.testing.assert_array_equal(np.asarray(sc), np.asarray(sx))
    if score_only:
        assert tc is None and tx is None
        return
    tc, tx = np.asarray(tc), np.asarray(tx)
    assert tc.shape == (8, 40, 1, cuda_fill.padded_width(66))
    assert tc.dtype == np.uint8
    for b in range(8):
        np.testing.assert_array_equal(
            batch.tb_pair_view(tc, b)[:n[b], :m[b]],
            batch.tb_pair_view(tx, b)[:n[b], :m[b]])


@pytest.mark.parametrize("MP,want", [(1, 4), (4, 4), (5, 8), (66, 68),
                                     (128, 128)])
def test_padded_width(MP, want):
    assert cuda_fill.padded_width(MP) == want


def test_kernel_args_quarter_units():
    """Integer tables and quarter penalties go in as exact int32 quarter
    units; anything else as f32."""
    c2 = jnp.zeros((3, 6), jnp.int8)
    c2p, tab, attrs = cuda_fill.kernel_args(
        jnp.asarray(SM.table), c2, quarter=True, og=-10.0, eg=-0.75)
    assert c2p.shape == (3, 8) and c2p.dtype == jnp.int8
    assert tab.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(tab), SM.table * 4)
    assert (int(attrs["og"]), int(attrs["eg"])) == (-40, -3)
    _, tab, attrs = cuda_fill.kernel_args(
        jnp.asarray(SM.table + 0.1), c2, quarter=False, og=-10.0, eg=-0.5)
    assert tab.dtype == jnp.float32
    assert attrs["og"].dtype == np.float32


@pytest.mark.parametrize("table_k,mode,err", [
    (25, 7, "mode"),
    (128, LOCAL, "int8"),
    (120, LOCAL, "shared memory"),
])
def test_fill_rejects(table_k, mode, err):
    c1 = np.zeros((2, 8), np.int8)
    with pytest.raises(ValueError, match=err):
        cuda_fill.fill(np.zeros((table_k, table_k), np.float32), c1, c1,
                       np.ones(2, np.int32), np.ones(2, np.int32), mode=mode,
                       og=OG, eg=EG)


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(cuda_fill, "_registered", False)
    monkeypatch.setattr(cuda_fill, "find_nvcc", lambda: None)
    with pytest.raises(cuda_fill.CudaFillUnavailable, match="nvcc"):
        cuda_fill.ensure_registered()


def test_build_runs_make_gpu(monkeypatch, tmp_path):
    """The build is `make gpu` in csrc/ with the toolkit's nvcc and
    jax.ffi's headers; a failing build raises with its output."""
    lib = tmp_path / "libswfill.so"
    seen = []

    class Done:
        returncode, stdout, stderr = 0, "", ""

    def fake_run(cmd, **kw):
        seen.append((cmd, kw["cwd"]))
        lib.write_bytes(b"")
        return Done()

    monkeypatch.setattr(cuda_fill, "LIB_PATH", str(lib))
    monkeypatch.setattr(cuda_fill, "find_nvcc", lambda: "/opt/cuda/bin/nvcc")
    monkeypatch.setattr(cuda_fill.subprocess, "run", fake_run)
    assert cuda_fill.build() == str(lib)
    cmd, cwd = seen[0]
    assert cmd[:3] == ["make", "-s", "gpu"]
    assert "NVCC=/opt/cuda/bin/nvcc" in cmd
    assert f"FFI_INCLUDE={jax.ffi.include_dir()}" in cmd
    assert cwd.endswith("csrc")

    class Failed:
        returncode, stdout, stderr = 2, "", "nvcc: error"

    lib.unlink()
    monkeypatch.setattr(cuda_fill.subprocess, "run", lambda *a, **k: Failed())
    with pytest.raises(cuda_fill.CudaFillUnavailable, match="nvcc: error"):
        cuda_fill.build()


def test_cuda_backend_never_falls_back(monkeypatch):
    """A cuda BatchAligner whose library cannot be built raises; it does
    not quietly run another fill."""
    monkeypatch.setattr(cuda_fill, "_registered", False)
    monkeypatch.setattr(cuda_fill, "find_nvcc", lambda: None)
    ba = BatchAligner(mode=LOCAL, backend="cuda")
    with pytest.raises(cuda_fill.CudaFillUnavailable):
        ba.align_pairs([("HEAGAWGHEE", "PAWHEAE")])


@pytest.mark.parametrize("quarter", [True, False])
@pytest.mark.parametrize("score_only", [False, True])
def test_lowers_to_ffi_custom_call(quarter, score_only):
    """Lowered for CUDA, the fill is one FFI custom call to the target of
    its arithmetic domain, with the mode and flags as attributes."""
    c1 = jnp.zeros((4, 16), jnp.int8)
    c2 = jnp.zeros((4, 18), jnp.int8)
    n = jnp.ones(4, jnp.int32)
    f = jax.jit(lambda t, a, b, nn, mm: cuda_fill._fill_jit(
        t, a, b, nn, mm, mode=GLOCAL, og=OG, eg=EG, score_only=score_only,
        quarter=quarter))
    text = f.trace(jnp.asarray(SM.table), c1, c2, n, n).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("stablehlo.custom_call") == 1
    assert cuda_fill.TARGETS[quarter] in text
    assert cuda_fill.TARGETS[not quarter] not in text
    assert "mode = 1" in text
    assert f"traceback = {str(not score_only).lower()}" in text


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL, GLOBAL])
def test_batch_aligner_cuda_backend(fake_kernel, mode):
    """BatchAligner(backend="cuda") through the wrapper (pooled fill,
    pooled walk, native rebuild) gives the scan path's strings."""
    rng = np.random.default_rng(mode)
    aa = list("ARNDCQEGHILKMFPSTWYV")
    pairs = [("".join(rng.choice(aa, int(rng.integers(3, 90)))),
              "".join(rng.choice(aa, int(rng.integers(3, 90)))))
             for _ in range(20)]
    got = BatchAligner(mode=mode, backend="cuda").align_pairs(pairs)
    want = BatchAligner(mode=mode, backend="scan").align_pairs(pairs)
    for g, w in zip(got, want):
        assert (g.score, g.aligned1, g.aligned2) == (
            w.score, w.aligned1, w.aligned2)
