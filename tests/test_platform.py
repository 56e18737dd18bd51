"""The one place that decides the platform, the device-memory budget, the
compile cache path, and the GPU-only entry points failing off the GPU."""

import os
import shutil
import subprocess
import sys

import pytest

from smithwaterman_tpu import Aligner, BatchAligner, LOCAL, platform
from smithwaterman_tpu import batch_aligner
from smithwaterman_tpu.utils import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("plat,want", [("gpu", "cuda"), ("cpu", "scan"),
                                       ("metal", "scan")])
def test_default_backend(monkeypatch, plat, want):
    monkeypatch.setattr(platform, "platform", lambda: plat)
    assert platform.default_backend() == want
    assert batch_aligner.default_backend() == want


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret", "triton"])
def test_retired_backends_rejected(backend):
    with pytest.raises(ValueError, match="unknown backend"):
        BatchAligner(backend=backend)


def test_cpu_defaults_to_scan():
    assert BatchAligner().backend == "scan"


def test_aligner_routes_to_batch_off_cpu(monkeypatch):
    """Off the CPU, Aligner.align runs on the batch pipeline (and gives
    the scan path's answer)."""
    monkeypatch.setattr(platform, "default_backend", lambda: "xla")
    a = Aligner(mode=LOCAL)
    r = a.align("HEAGAWGHEE", "PAWHEAE")
    assert a._batch is not None and a._batch.backend == "xla"
    monkeypatch.setattr(platform, "default_backend", lambda: "scan")
    w = Aligner(mode=LOCAL).align("HEAGAWGHEE", "PAWHEAE")
    assert (r.score, r.aligned1, r.aligned2) == (w.score, w.aligned1,
                                                  w.aligned2)


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        platform.require_gpu()


def test_tb_budget_env_and_device_share(monkeypatch):
    monkeypatch.setenv("SWTPU_TB_HBM_BYTES", "12345")
    assert batch_aligner.default_tb_budget() == 12345
    monkeypatch.delenv("SWTPU_TB_HBM_BYTES")

    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 64 << 30}

    monkeypatch.setattr(batch_aligner.jax, "devices", lambda: [Dev()])
    assert batch_aligner.default_tb_budget() == (
        (64 << 30) // batch_aligner.TB_MEMORY_SHARE)


def test_tb_budget_without_device_limit(monkeypatch):
    monkeypatch.delenv("SWTPU_TB_HBM_BYTES", raising=False)

    class Dev:
        def memory_stats(self):
            return None

    monkeypatch.setattr(batch_aligner.jax, "devices", lambda: [Dev()])
    assert batch_aligner.default_tb_budget() == 4 << 30


def test_cache_dir_honours_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert jaxcache.cache_dir() == "/somewhere/else"


def test_cache_dir_default_inside_checkout(monkeypatch):
    """Without the variable the cache sits at a fixed path in the checkout
    (never the home directory), and git ignores it."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jaxcache.cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_cache_sets_only_that_dir(monkeypatch, tmp_path):
    calls = {}
    monkeypatch.delenv("SWT_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    import jax

    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    jaxcache.enable_compilation_cache()
    assert calls["jax_compilation_cache_dir"] == str(tmp_path / "c")
    assert (tmp_path / "c").is_dir()


def _run(args, cwd, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("SWT_GPU_TESTS", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_chip_smoke_fails_without_gpu():
    proc = _run([os.path.join(REPO, "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run([str(tmp_path / "chip_smoke.py")], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("script", ["bench.py", "__graft_entry__.py"])
def test_gpu_entry_points_fail_without_gpu(script):
    proc = _run([os.path.join(REPO, script)], REPO)
    assert proc.returncode != 0
    assert "no GPU" in proc.stdout + proc.stderr
