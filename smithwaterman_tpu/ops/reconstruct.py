"""Bulk host reconstruction from packed device-walk move streams.

The device walk (ops/device_walk.walk_bundle_packed) ships ONE 2-bit-packed
move array per bucket; this module replays every pair's stream straight
into the final alignment strings in native code (csrc/reconstruct.cpp),
replacing the per-residue Python loops (aligner.reconstruct_alignment)
that dominated suite wall time at scale — the host-side analogue of the
reference GPU engine's string rebuild
(/root/reference/rust/sa_opencl/src/opencl_sequence_alignment.rs:836-916),
done for a whole bucket per call instead of per cell.

String/span semantics are exactly aligner.reconstruct_alignment
(parity: sequence_alignment.rs:469-551); a NumPy/Python fallback is used
when the native library is unavailable and is asserted identical in
tests/test_packed_walk.py.
"""

from __future__ import annotations

import ctypes
import sys
from typing import List, Sequence

import numpy as np

from ..config import LOCAL
from . import device_walk
from . import traceback as _tb

_RETAIN_WARNING = "The glocal or global mode will retain all letters.\n"

_BOUND = False


def _lib():
    """The shared native library, with sw_reconstruct_moves bound."""
    global _BOUND
    lib = _tb._load_native()
    if lib is None or not hasattr(lib, "sw_reconstruct_moves"):
        return None
    if not _BOUND:
        i64 = ctypes.c_int64
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        pi32 = ctypes.POINTER(ctypes.c_int32)
        pi64 = ctypes.POINTER(ctypes.c_int64)
        argtypes = [
            pu8, i64, i64,          # moves, row_stride, n_rows
            pi32, pi32, pi32,       # cnt, i0, j0
            pu8, pi64, pu8, pi64,   # seq1, off1, seq2, off2
            i64, i64, i64,          # count, local, retain
            pu8, pu8, pi64,         # out1, out2, outoff
            pi64, pi64,             # outlen, spans
        ]
        lib.sw_reconstruct_moves.restype = i64
        lib.sw_reconstruct_moves.argtypes = argtypes
        _BOUND = True
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def reconstruct_packed(
    seq1s: Sequence[str],
    seq2s: Sequence[str],
    moves: np.ndarray,
    cnt: np.ndarray,
    i0: np.ndarray,
    j0: np.ndarray,
    scores: np.ndarray,
    mode: int,
    retain_all: bool,
    col0: int = 0,
) -> List:
    """Replay a bucket's packed move streams into AlignResults.

    seq1s/seq2s are the bucket's sequences in pair order (count of them);
    moves is the (n_rows, B) packed byte array whose columns
    ``col0 .. col0+count`` belong to this bucket (pass the FULL pooled
    array + col0 rather than a sliced copy — slices of pooled bundles
    are non-contiguous), cnt/i0/j0/scores are per-pair (>= count
    entries).
    """
    from ..aligner import AlignResult, reconstruct_alignment

    count = len(seq1s)
    local = mode == LOCAL
    if not local and not retain_all:
        # parity: reconstruct_alignment warns once per pair (rs:497-499)
        sys.stderr.write(_RETAIN_WARNING * count)
        retain_all = True

    lib = _lib()
    if lib is not None and count:
        moves = np.ascontiguousarray(moves, np.uint8)
        n_rows, B = moves.shape
        assert col0 + count <= B, (col0, count, B)
        cnt32 = np.ascontiguousarray(cnt[:count], np.int32)
        i032 = np.ascontiguousarray(i0[:count], np.int32)
        j032 = np.ascontiguousarray(j0[:count], np.int32)
        b1 = [s.encode("latin-1") for s in seq1s]
        b2 = [s.encode("latin-1") for s in seq2s]
        off1 = np.zeros(count + 1, np.int64)
        off2 = np.zeros(count + 1, np.int64)
        np.cumsum([len(s) for s in b1], out=off1[1:])
        np.cumsum([len(s) for s in b2], out=off2[1:])
        seq1 = np.frombuffer(b"".join(b1), np.uint8) if off1[-1] else \
            np.zeros(1, np.uint8)
        seq2 = np.frombuffer(b"".join(b2), np.uint8) if off2[-1] else \
            np.zeros(1, np.uint8)
        lens = off1[1:] - off1[:-1] + off2[1:] - off2[:-1]
        outoff = np.zeros(count + 1, np.int64)
        np.cumsum(lens, out=outoff[1:])
        out1 = np.empty(max(int(outoff[-1]), 1), np.uint8)
        out2 = np.empty_like(out1)
        outlen = np.zeros(count, np.int64)
        spans = np.zeros((count, 4), np.int64)
        i64, i32, u8 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint8
        mv_ptr = ctypes.cast(
            moves.ctypes.data + col0, ctypes.POINTER(u8))
        rc = lib.sw_reconstruct_moves(
            mv_ptr, B, n_rows,
            _ptr(cnt32, i32), _ptr(i032, i32), _ptr(j032, i32),
            _ptr(seq1, u8), _ptr(off1, i64), _ptr(seq2, u8),
            _ptr(off2, i64), count, 1 if local else 0,
            1 if retain_all else 0, _ptr(out1, u8), _ptr(out2, u8),
            _ptr(outoff, i64), _ptr(outlen, i64), _ptr(spans, i64),
        )
        if rc == 0:
            o1b = out1.tobytes()
            o2b = out2.tobytes()
            res = []
            for k in range(count):
                lo = int(outoff[k])
                hi = lo + int(outlen[k])
                sp = spans[k]
                res.append(AlignResult(
                    o1b[lo:hi].decode("latin-1"),
                    o2b[lo:hi].decode("latin-1"),
                    float(scores[k]),
                    int(sp[0]), int(sp[1]), int(sp[2]), int(sp[3]),
                ))
            return res
        # corrupt stream / capacity error: fall through to the exact
        # Python path, which raises or reproduces faithfully

    res = []
    for k in range(count):
        idx1, idx2 = device_walk.moves_to_path(
            moves[:, col0:], cnt, int(i0[k]), int(j0[k]), k
        )
        if not local:
            # boundary short-circuit (ops/device_walk.py): non-local
            # streams may stop at the first boundary cell; synthesize the
            # deterministic terminal-gap tail the device walk skipped so
            # reconstruct_alignment sees the full path (the native
            # rebuild does the same from its replayed stop cell)
            ie = int(i0[k]) - sum(1 for x in idx1 if x >= 0)
            je = int(j0[k]) - sum(1 for x in idx2 if x >= 0)
            if ie > 0:
                idx1 = list(range(ie)) + list(idx1)
                idx2 = [-1] * ie + list(idx2)
            elif je > 0:
                idx1 = [-1] * je + list(idx1)
                idx2 = list(range(je)) + list(idx2)
        res.append(reconstruct_alignment(
            seq1s[k], seq2s[k], idx1, idx2, float(scores[k]),
            retain_all, mode,
        ))
    return res
