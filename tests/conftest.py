"""Test env: force the CPU backend with 8 virtual devices so multi-device
sharding logic is exercised without accelerator hardware (SURVEY.md §4).

``SWT_GPU_TESTS=1`` is the explicit opt-in for the ``gpu``-marked tests:
the platform is then left to JAX (the GPU where there is one), and the
``gpu`` fixture decides per test whether a card is present.  Without it the
backend is pinned through ``jax.config`` as well as the environment, so a
preloaded plugin cannot win."""

import os
import sys

os.environ.setdefault("SWT_NO_COMPILE_CACHE", "1")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
GPU_OPT_IN = os.environ.get("SWT_GPU_TESTS") == "1"
if not GPU_OPT_IN:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

if not GPU_OPT_IN:
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", jax.default_backend()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        if GPU_OPT_IN:
            pytest.fail("SWT_GPU_TESTS=1 but JAX found no GPU")
        pytest.skip("needs a GPU (run with SWT_GPU_TESTS=1 on a GPU host)")
    return dev


@pytest.fixture(autouse=True)
def _bound_llvm_mmap_count():
    """Keep the process under the kernel's vm.max_map_count (65530 here).

    LLVM's JIT allocates several mmap regions per compiled XLA executable
    and never coalesces them; a full suite run compiles enough programs to
    exhaust the cap ~86% in, at which point an mmap failure inside the
    next compile kills the process with SIGSEGV/SIGABRT (measured: map
    count passes 22k within 2 minutes).  jax.clear_caches() releases the
    executables' mappings (verified: 1298 -> 552 maps), so clear whenever
    the count nears the cap.  Threshold is high enough that normal runs
    clear at most a few times (each clear costs cross-module recompiles).
    """
    yield
    try:
        with open("/proc/self/maps") as f:
            n = sum(1 for _ in f)
    except OSError:  # non-linux
        return
    if n > 40000:
        jax.clear_caches()
