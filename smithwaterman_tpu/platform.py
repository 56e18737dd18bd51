"""The one place that decides what the program runs on.

``default_backend()`` picks the fill for ``BatchAligner`` (and therefore
for ``Aligner``, the CLI, sweeps and clustering):

  * ``"cuda"`` on a GPU: the CUDA fill kernel (ops/cuda_fill.py);
  * ``"scan"`` elsewhere: the vmapped row scan with host-side scores and
    walks, the CPU path the test suite runs.

``"xla"`` (the tiled device pipeline with the plain-JAX fill) runs on any
platform but is never chosen by default.
"""

from __future__ import annotations

import subprocess

BACKENDS = ("cuda", "xla", "scan")
TILED_BACKENDS = ("cuda", "xla")


def platform() -> str:
    """JAX's default platform: ``"gpu"`` or ``"cpu"``."""
    import jax

    return jax.default_backend()


def default_backend() -> str:
    return "cuda" if platform() == "gpu" else "scan"


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}"
        )
    return backend


def require_gpu():
    """The first GPU device; raises when JAX finds none (measurement paths
    never fall back to the CPU)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's devices are {[d.platform for d in devs]}"
        )
    return devs[0]


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them (one
    line per card), read without touching JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    return out
