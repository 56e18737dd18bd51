"""The CUDA fill kernel (csrc/gpu/sw_fill.cu) as a JAX operation.

The shared library is built from the repository's sources by
``make -C csrc gpu`` (nvcc, ``sm_90a``) into ``smithwaterman_tpu/_native/``
at first use, and registered with XLA through ``jax.ffi``.  There is no
fallback: on a machine that cannot build or load the library the call
raises, so a GPU run never silently measures another fill.

Kernel contract (see the .cu file): int8 codes ``(B, NP)`` / ``(B, MP)``
with ``MP`` a multiple of 4, int32 lengths, the scoring table in shared
memory (at most 48 KiB), one warp per pair.  With ``quarter=True`` the
table and penalties go in as int32 quarter units, otherwise as f32.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GLOBAL, GLOCAL, LOCAL
from .fill import STATS_W

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB_PATH = os.path.join(_HERE, "_native", "libswfill.so")
_CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
TARGETS = {True: "swt_fill_i32", False: "swt_fill_f32"}
_SYMBOLS = {True: "SwFillI32", False: "SwFillF32"}
MAX_TABLE_BYTES = 48 * 1024
_lock = threading.Lock()
_registered = False


class CudaFillUnavailable(RuntimeError):
    """The CUDA fill library could not be built or loaded."""


def find_nvcc():
    """nvcc on PATH, else the CUDA toolkit's default location; None if
    neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def build() -> str:
    """Build the library (make is a no-op when it is newer than its
    source).  Returns its path; raises CudaFillUnavailable on failure."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise CudaFillUnavailable(
            "nvcc not found: the CUDA fill needs the CUDA toolkit to build "
            "csrc/gpu/sw_fill.cu"
        )
    proc = subprocess.run(
        ["make", "-s", "gpu", f"NVCC={nvcc}",
         f"FFI_INCLUDE={jax.ffi.include_dir()}"],
        cwd=_CSRC, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0 or not os.path.exists(LIB_PATH):
        raise CudaFillUnavailable(
            f"building the CUDA fill failed:\n{proc.stdout}{proc.stderr}"
        )
    return LIB_PATH


def ensure_registered() -> None:
    """Build, load and register the FFI targets once per process."""
    global _registered
    with _lock:
        if _registered:
            return
        path = build()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise CudaFillUnavailable(f"loading {path} failed: {e}") from e
        for quarter, target in TARGETS.items():
            jax.ffi.register_ffi_target(
                target, jax.ffi.pycapsule(getattr(lib, _SYMBOLS[quarter])),
                platform="CUDA",
            )
        _registered = True


def padded_width(MP: int) -> int:
    """Pointer-row width the kernel writes: MP rounded up to 4 bytes (it
    stores four pointer bytes at a time)."""
    return -(-MP // 4) * 4


def kernel_args(table, codes2, *, quarter: bool, og: float, eg: float):
    """Arguments in the kernel's domain: seq2 codes padded to
    :func:`padded_width`, the table and penalties in int32 quarter units
    (``quarter``) or f32."""
    B, MP = codes2.shape
    MPk = padded_width(MP)
    c2 = codes2.astype(jnp.int8)
    if MPk != MP:
        c2 = jnp.pad(c2, ((0, 0), (0, MPk - MP)))
    if quarter:
        tab = jnp.round(table.astype(jnp.float32) * 4.0).astype(jnp.int32)
        attrs = dict(og=np.int32(round(og * 4)), eg=np.int32(round(eg * 4)))
    else:
        tab = table.astype(jnp.float32)
        attrs = dict(og=np.float32(og), eg=np.float32(eg))
    return c2, tab, attrs


def _call(codes1, c2, n, m, tab, *, quarter, mode, score_only, attrs):
    """The FFI call itself (the only line that needs the library)."""
    B, NP = codes1.shape
    MPk = c2.shape[1]
    sdt = jnp.int32 if quarter else jnp.float32
    tb_shape = (B, NP, MPk) if not score_only else (1,)
    return jax.ffi.ffi_call(
        TARGETS[quarter],
        (
            jax.ShapeDtypeStruct(tb_shape, jnp.uint8),
            jax.ShapeDtypeStruct((B, STATS_W), jnp.float32),
            jax.ShapeDtypeStruct((B, MPk, 3), sdt),  # row-buffer scratch
        ),
    )(codes1, c2, n, m, tab, mode=np.int32(mode),
      traceback=np.bool_(not score_only), **attrs)


@functools.partial(jax.jit, static_argnames=(
    "mode", "og", "eg", "score_only", "quarter"))
def _fill_jit(table, codes1, codes2, n, m, *, mode, og, eg, score_only,
              quarter):
    c2, tab, attrs = kernel_args(table, codes2, quarter=quarter, og=og,
                                 eg=eg)
    tb, stats, _ = _call(
        codes1.astype(jnp.int8), c2, n.astype(jnp.int32),
        m.astype(jnp.int32), tab, quarter=quarter, mode=mode,
        score_only=score_only, attrs=attrs,
    )
    if score_only:
        return None, stats
    B, NP = codes1.shape
    return tb.reshape(B, NP, 1, tb.shape[-1]), stats


def fill(table, codes1, codes2, n, m, *, mode: int, og: float, eg: float,
         score_only: bool = False, quarter: bool = False):
    """CUDA fill of a batch: (tb (B, NP, 1, MP4) or None, stats (B, 8)).

    Validates what the kernel cannot: the mode, int8-range codes and the
    table's shared-memory footprint.  Raises CudaFillUnavailable when the
    library cannot be built or loaded."""
    if mode not in (GLOBAL, GLOCAL, LOCAL):
        raise ValueError(f"unknown alignment mode {mode}")
    K = table.shape[0]
    if K > 127:
        raise ValueError(f"{K} symbols do not fit int8 codes")
    if K * K * 4 > MAX_TABLE_BYTES:
        raise ValueError(f"a {K}x{K} table exceeds the kernel's shared memory")
    ensure_registered()
    return _fill_jit(table, codes1, codes2, n, m, mode=mode, og=float(og),
                     eg=float(eg), score_only=score_only,
                     quarter=bool(quarter))
