"""Host-side traceback from packed predecessor pointers.

The device fill emits one uint8 per cell: prev-state of M in bits 0-1, of X
in bits 2-3, of Y in bits 4-5 (value 3 = local-mode "score is exactly zero,
stop here").  Walking the pointers is O(n+m) and serial, so it runs on host —
the split mirrors the reference GPU engine, which also reads packed flags back
and reconstructs strings host-side
(/root/reference/rust/sa_opencl/src/opencl_sequence_alignment.rs:765-795).

Loop semantics parity: sequence_alignment.rs:352-383.

A C++ walker (csrc/traceback.cpp, loaded via ctypes) is used when available;
the NumPy/Python fallback is semantically identical.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Tuple

import numpy as np

from ..config import CELL_GAPINX, CELL_GAPINY, CELL_MATCH, CELL_STOP

_LIB = None
_LIB_TRIED = False


_ARGTYPES = [
    ctypes.POINTER(ctypes.c_uint8),  # tb
    ctypes.c_int64,  # row stride (elements for walk, bytes for tiled)
    ctypes.c_int64,  # start i
    ctypes.c_int64,  # start j
    ctypes.c_int64,  # start state
    ctypes.c_int64,  # local flag
    ctypes.POINTER(ctypes.c_int64),  # out idx1
    ctypes.POINTER(ctypes.c_int64),  # out idx2
    ctypes.c_int64,  # out capacity
]


def _try_build(here: str) -> None:
    """Best-effort build of the native walker (csrc/Makefile)."""
    import subprocess

    csrc = os.path.join(os.path.dirname(here), "csrc")
    if not os.path.exists(os.path.join(csrc, "Makefile")):
        return
    try:
        subprocess.run(
            ["make", "-s"], cwd=csrc, timeout=60,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, check=False,
        )
    except Exception:
        pass


def _load_native():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if os.environ.get("SWT_NO_NATIVE"):
        return None
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cand = os.path.join(here, "_native", "libswtrace.so")
    # make is a no-op when the .so is newer than csrc/ (and rebuilds stale
    # libraries that predate newer entry points)
    _try_build(here)
    if os.path.exists(cand):
        try:
            lib = ctypes.CDLL(cand)
            for fn in (lib.sw_traceback, lib.sw_traceback_tiled):
                fn.restype = ctypes.c_int64
                fn.argtypes = _ARGTYPES
            i64 = ctypes.c_int64
            pi64 = ctypes.POINTER(ctypes.c_int64)
            pu8 = ctypes.POINTER(ctypes.c_uint8)
            lib.sw_walk_band.restype = i64
            lib.sw_walk_band.argtypes = [
                pu8, i64, i64, i64, pi64, i64, pi64, pi64, i64, pi64,
            ]
            lib.sw_walk_banded.restype = i64
            lib.sw_walk_banded.argtypes = [
                pu8, i64, ctypes.POINTER(ctypes.c_int32), i64, i64, i64,
                i64, i64, pi64, pi64, i64, pi64,
            ]
            _LIB = lib
        except (OSError, AttributeError):
            _LIB = None
    return _LIB


def native_walk_band(tb_band, i_top, j_off, i, j, s, local):
    """Native band-window walk; returns None when the library is
    unavailable, else (idx1_chunk, idx2_chunk, i, j, s, status) with the
    exact contract of ops/longseq.walk_band."""
    lib = _load_native()
    if lib is None or not hasattr(lib, "sw_walk_band"):
        return None
    tbc = np.ascontiguousarray(tb_band)
    C, width = tbc.shape
    cap = int(i + j + 2)
    o1 = np.empty(cap, dtype=np.int64)
    o2 = np.empty(cap, dtype=np.int64)
    ijs = np.array([i, j, s], dtype=np.int64)
    status = np.zeros(1, dtype=np.int64)
    count = lib.sw_walk_band(
        tbc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        width, i_top, j_off,
        ijs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        1 if local else 0,
        o1.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        o2.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cap,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if count < 0:
        return None  # fall back to python on error
    return (
        o1[:count].tolist(), o2[:count].tolist(),
        int(ijs[0]), int(ijs[1]), int(ijs[2]), int(status[0]),
    )


def native_walk_banded(tb, off, si, sj, state, local, W, m):
    """Native diagonal-band walk; returns None when unavailable, else
    (idx1, idx2, edge_touched) with ops/banded.walk_banded's contract.
    Raises nothing — a band violation returns the sentinel ('exceeded',)."""
    lib = _load_native()
    if lib is None or not hasattr(lib, "sw_walk_banded"):
        return None
    tbc = np.ascontiguousarray(tb)
    offc = np.ascontiguousarray(np.asarray(off, np.int32))
    cap = int(si + sj + 2)
    o1 = np.empty(cap, dtype=np.int64)
    o2 = np.empty(cap, dtype=np.int64)
    edge = np.zeros(1, dtype=np.int64)
    count = lib.sw_walk_banded(
        tbc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        W,
        offc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        si, sj, state, 1 if local else 0, m,
        o1.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        o2.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cap,
        edge.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if count == -2:
        return ("exceeded",)
    if count < 0:
        return None
    return o1[:count][::-1].tolist(), o2[:count][::-1].tolist(), bool(edge[0])


def walk(
    tb: np.ndarray, si: int, sj: int, state: int, local: bool
) -> Tuple[List[int], List[int]]:
    """Walk packed pointers from (si, sj, state); returns aligned index lists
    (−1 = gap), in left-to-right order.  Parity: sequence_alignment.rs:349-386.
    """
    lib = _load_native()
    if lib is not None:
        cap = int(si + sj + 2)
        o1 = np.empty(cap, dtype=np.int64)
        o2 = np.empty(cap, dtype=np.int64)
        tbc = np.ascontiguousarray(tb)
        count = lib.sw_traceback(
            tbc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            tbc.shape[1],
            si,
            sj,
            state,
            1 if local else 0,
            o1.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            o2.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cap,
        )
        if count >= 0:
            return o1[:count][::-1].tolist(), o2[:count][::-1].tolist()
        # fall through to python on error

    r1: List[int] = []
    r2: List[int] = []
    i, j, s = int(si), int(sj), int(state)
    while True:
        s = normalize_boundary_state(i, j, s)
        prev = (int(tb[i, j]) >> (2 * s)) & 3
        if local and prev == CELL_STOP:
            break
        if s == CELL_MATCH:
            r1.append(i - 1)
            r2.append(j - 1)
            i -= 1
            j -= 1
        elif s == CELL_GAPINX:
            r1.append(-1)
            r2.append(j - 1)
            j -= 1
        elif s == CELL_GAPINY:
            r1.append(i - 1)
            r2.append(-1)
            i -= 1
        else:  # pragma: no cover - corrupt pointer
            raise RuntimeError(f"invalid traceback state {s} at ({i},{j})")
        if i == 0 and j == 0:
            break
        s = prev
    r1.reverse()
    r2.reverse()
    return r1, r2


def _boundary_prev(i: int, j: int, s: int, local: bool) -> int:
    """Closed-form predecessor pointers on the DP boundary (row 0 / col 0).

    The batched fills (ops/fill.py) store pointers only for interior
    cells (i,j >= 1); boundary pointers are a pure function of mode
    (parity: scan_dp._row0 / row_step's j==0 branch, i.e.
    sequence_alignment.rs:88-117):
      * origin: all states point to M; local marks M as STOP (score 0).
      * row 0, j>0: all states point left (X); local X is STOP (score 0).
      * col 0, i>0: all states point up (Y); local Y is STOP (score 0).
    """
    if i == 0 and j == 0:
        return CELL_STOP if (local and s == CELL_MATCH) else CELL_MATCH
    if i == 0:
        return CELL_STOP if (local and s == CELL_GAPINX) else CELL_GAPINX
    return CELL_STOP if (local and s == CELL_GAPINY) else CELL_GAPINY


def normalize_boundary_state(i: int, j: int, s: int) -> int:
    """Defined behavior where the reference has none: with og == eg == 0
    the boundary sentinel (10*og + 10*eg, sequence_alignment.rs:102-116)
    is 0, so the `>=` extend tie rules can route the walk into state X at
    column 0 (or Y at row 0) — the reference crashes there
    (sequence_alignment.rs:368-370 panics for Y at row 0; X at column 0
    underflows its usize column).  We continue along the only coherent
    completion — the boundary gap chain — which at the only reachable
    penalty point (og = eg = 0) scores identically.  MATCH on a boundary
    is equally incoherent (there is nothing left to pair against), so any
    state on a boundary normalizes to that boundary's gap chain.  Every
    walker (Python and csrc/traceback.cpp) applies this at loop top."""
    if j == 0 and i > 0 and s != CELL_GAPINY:
        return CELL_GAPINY
    if i == 0 and j > 0 and s != CELL_GAPINX:
        return CELL_GAPINX
    return s


def walk_tiled(
    tb: np.ndarray, si: int, sj: int, state: int, local: bool
) -> Tuple[List[int], List[int]]:
    """Like :func:`walk`, but over a batched fill's interior-only pointer
    array: ``tb[i-1, j-1]`` holds the packed pointers of DP cell (i, j)."""
    lib = _load_native()
    if lib is not None and hasattr(lib, "sw_traceback_tiled") and tb.strides[1] == 1:
        cap = int(si + sj + 2)
        o1 = np.empty(cap, dtype=np.int64)
        o2 = np.empty(cap, dtype=np.int64)
        count = lib.sw_traceback_tiled(
            tb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            tb.strides[0],
            si,
            sj,
            state,
            1 if local else 0,
            o1.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            o2.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cap,
        )
        if count >= 0:
            return o1[:count][::-1].tolist(), o2[:count][::-1].tolist()

    r1: List[int] = []
    r2: List[int] = []
    i, j, s = int(si), int(sj), int(state)
    while True:
        s = normalize_boundary_state(i, j, s)
        if i >= 1 and j >= 1:
            prev = (int(tb[i - 1, j - 1]) >> (2 * s)) & 3
        else:
            prev = _boundary_prev(i, j, s, local)
        if local and prev == CELL_STOP:
            break
        if s == CELL_MATCH:
            r1.append(i - 1)
            r2.append(j - 1)
            i -= 1
            j -= 1
        elif s == CELL_GAPINX:
            r1.append(-1)
            r2.append(j - 1)
            j -= 1
        elif s == CELL_GAPINY:
            r1.append(i - 1)
            r2.append(-1)
            i -= 1
        else:  # pragma: no cover - corrupt pointer
            raise RuntimeError(f"invalid traceback state {s} at ({i},{j})")
        if i == 0 and j == 0:
            break
        s = prev
    r1.reverse()
    r2.reverse()
    return r1, r2
