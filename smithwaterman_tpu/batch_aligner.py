"""BatchAligner: bucketed many-pair alignment on the device.

The replacement for the reference's host pair loops
(/root/reference/rust/sequence_alignment/src/main.rs:35-44,
/root/reference/rust/sa_opencl/src/main.rs:298-315): pairs are grouped into
(npad, mpad) length buckets (so XLA compiles a handful of static programs),
padded to a pair quantum, filled on the device, walked on the device and
rebuilt into strings on the host.  Results come back in input order and are
bit-identical to the single-pair ``Aligner``.

Backends (smithwaterman_tpu.platform decides the default):
  * ``cuda`` — tiled pipeline with the CUDA fill kernel (default on GPU)
  * ``xla``  — the same pipeline with the plain-JAX fill (any platform)
  * ``scan`` — vmapped lax.scan with host scores and host walks (default
    elsewhere)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import numpy as np

from . import platform
from .aligner import (
    AlignResult,
    _as_seqdata,
    _perl_compat_seq,
    degenerate_result,
    reconstruct_alignment,
)
from .config import LOCAL, AlignConfig, CELL_MATCH, bucket_len
from .matrices import ScoringMatrix, SubstitutionMatrix
from .ops import batch as batch_ops
from .ops import device_walk
from .ops import fill as fill_ops
from .ops import traceback


def _copy_async(arr) -> None:
    try:
        arr.copy_to_host_async()
    except (AttributeError, RuntimeError):  # non-jax arrays / cpu backend
        pass


def _host_fetchables(pend):
    """Yield (setter, device_array) for every fetchable piece of a
    dispatched bucket, so all buckets' device->host transfers run as ONE
    batched jax.device_get instead of a synchronising round trip each."""
    kind = pend.get("kind")
    if kind in ("device_walk", "device_walk_sharded"):
        for key in ("stats_d", "idx_d"):
            yield (lambda h, _p=pend, _k=key: _p.__setitem__(_k, h),
                   pend[key])
    elif kind in ("device_walk_packed", "device_walk_packed_sharded"):
        for key in ("stats_d", "cnt_d", "mv_d"):
            yield (lambda h, _p=pend, _k=key: _p.__setitem__(_k, h),
                   pend[key])
    elif kind in ("pool_chunk", "stats_only"):
        yield (lambda h, _p=pend: _p.__setitem__("stats_d", h),
               _chunk_stats(pend))
    elif kind == "pool_bundle":
        for key in ("cnt_d", "mv_d"):
            yield (lambda h, _p=pend, _k=key: _p.__setitem__(_k, h),
                   pend[key])
    elif kind == "multi":
        for _, part in pend["parts"]:
            yield from _host_fetchables(part)


def _chunk_stats(pend):
    """Device stats of a pooled-fill chunk.  _dispatch_bucket flattens
    single-chunk pend dicts with update() BEFORE the fill flush runs, so
    flush-time results land in the shared mutable ``ref`` dict and the
    flattened copy's own ``stats_d`` stays None until the host gather
    writes the fetched array back into it."""
    s = pend.get("stats_d")
    return s if s is not None else pend["ref"]["stats_d"]


def _gather_host(pending) -> None:
    """Fetch every bucket's results to host in one batched transfer,
    writing numpy arrays back into the pend structures (the finish
    phase's np.asarray calls then cost nothing)."""
    setters, arrs = [], []
    for _, pend in pending:
        for setter, arr in _host_fetchables(pend):
            setters.append(setter)
            arrs.append(arr)
            _copy_async(arr)  # start the copy; device_get then overlaps
    if not arrs:
        return
    for setter, h in zip(setters, jax.device_get(arrs)):
        setter(h)


# largest pointer array the device walk may gather from: walk_bundle's
# flat index arithmetic is int32, so one walk's tb must stay < 2^31
# elements or the gather silently wraps (corrupt paths, no error)
_WALK_MAX_TB = (1 << 31) - 1


def _decode_sharded_part(part, Bp_total: int, count: int):
    """Decode one device_walk_sharded pend/part: per-shard stats/idx
    (leading D axis) -> (stats (Bp_total, 8), idx list for the first
    ``count`` pairs).  Shard-major row order == pair order."""
    stats_sh = np.asarray(part["stats_d"])  # (D, Bp, 8)
    idx_sh = np.asarray(part["idx_d"])      # (D, 2, L, Bp)
    D = stats_sh.shape[0]
    Bp = Bp_total // D
    stats_parts, idx = [], []
    for d in range(D):
        st, o1, o2 = device_walk.decode_bundle(stats_sh[d], idx_sh[d])
        stats_parts.append(st)
        remaining = count - d * Bp
        idx.extend(
            device_walk.pair_path(o1, o2, k)
            for k in range(max(0, min(Bp, remaining)))
        )
    return np.concatenate(stats_parts, axis=0), idx


def _pow2_chunks(G: int, cap: int = 8) -> List[int]:
    """Split G tile groups into power-of-two chunk sizes <= cap (largest
    first), so fill programs (shape-specialized on G) are reused across
    arbitrary batch sizes: at most log2(cap)+1 programs per bucket."""
    out: List[int] = []
    c = cap
    while G:
        while c > G:
            c //= 2
        out.append(c)
        G -= c
    return out


def default_backend() -> str:
    return platform.default_backend()


# Share of the device's memory the resident pointer arrays may take
# (staged fills plus the walk pool that consumes them, each bounded by the
# budget, so peak pointer memory stays under half of what JAX may use).
TB_MEMORY_SHARE = 4


def default_tb_budget() -> int:
    """Pointer-memory budget in bytes: ``SWTPU_TB_HBM_BYTES`` if set, else
    1/TB_MEMORY_SHARE of the device's ``bytes_limit`` (4 GiB where the
    device reports none, e.g. the CPU)."""
    env = os.environ.get("SWTPU_TB_HBM_BYTES")
    if env:
        return int(env)
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit) // TB_MEMORY_SHARE if limit else 4 << 30


@dataclass
class _Bucket:
    np_pad: int
    mp_pad: int
    indices: List[int]          # positions in the caller's pair list
    codes1: List[np.ndarray]
    codes2: List[np.ndarray]


class BatchAligner:
    def __init__(
        self,
        scoring_matrix: Optional[ScoringMatrix] = None,
        gap_open: float = 10.0,
        gap_extend: float = 0.5,
        mode: int = LOCAL,
        config: Optional[AlignConfig] = None,
        backend: Optional[str] = None,
        device_axis=None,
        tile_pairs: Optional[int] = None,
        longseq_cells: Optional[int] = None,
        device_walk: Optional[bool] = None,
        perl_compat: bool = False,
    ):
        if config is None:
            config = AlignConfig(mode=mode, gap_open=gap_open, gap_extend=gap_extend)
        self.config = config
        self.scoring_matrix = scoring_matrix or SubstitutionMatrix.blosum62()
        self.backend = platform.check_backend(backend or default_backend())
        # replicate the Perl engine's input rewrite (aligner.perl_sanitize)
        self.perl_compat = perl_compat
        self.device_axis = device_axis  # parallel.DataParallel or None
        self.tile_pairs = tile_pairs
        # buckets with >= this many padded cells use the checkpointed-fill +
        # banded-traceback path (ops/longseq.py).  None = auto: under the
        # device walk, longseq only engages past the pointer-memory budget;
        # an explicit value forces the cell threshold regardless.
        self.longseq_cells = longseq_cells
        # on-device traceback walk (ops/device_walk.py): pointers stay on
        # device; only O(n+m) path data transfers.  Default ON (the host
        # walk + full-matrix D2H remains as the SWTPU_DEVICE_WALK=0
        # fallback).
        if device_walk is None:
            device_walk = os.environ.get("SWTPU_DEVICE_WALK", "1") == "1"
        self.device_walk = device_walk
        # packed move-stream walk (device_walk.walk_bundle_packed +
        # csrc/reconstruct.cpp bulk string rebuild): 2 bits/step D2H and no
        # per-residue Python.  SWTPU_PACKED_WALK=0 restores the index-row
        # bundle.
        self.packed_walk = os.environ.get("SWTPU_PACKED_WALK", "1") == "1"
        # pooled walk: all buckets'/chunks' walks run in ONE lockstep
        # while_loop (device_walk.walk_bundle_pooled) — per-step cost is
        # B-independent, so pooling pays max-path-length iterations
        # instead of sum-over-chunks.  SWTPU_POOLED_WALK=0 restores
        # per-chunk walks.
        self.pooled_walk = os.environ.get("SWTPU_POOLED_WALK", "1") == "1"
        # pooled fill: ALL staged chunks' fills trace into ONE dispatched
        # jit (ops/batch.fill_many) — the fill-side analogue of the pooled
        # walk.  SWTPU_POOLED_FILL=0 restores per-chunk fill dispatches.
        self.pooled_fill = os.environ.get("SWTPU_POOLED_FILL", "1") == "1"
        # per-run pooled-fill staging (see _stage_fill/_flush_fills)
        self._fill_stage: List[dict] = []
        self._fill_stage_tb = 0
        # per-run pooled-walk state (see _pool_add/_flush_pool), keyed by
        # path-length class: done pairs still pay gather volume every
        # step, so short-path chunks must not ride a long chunk's pool
        self._pool_chunks: Dict[int, List[tuple]] = {}
        self._pool_bytes: Dict[int, int] = {}
        self._pools: List[dict] = []
        # device-memory budget for resident pointer matrices (device-walk
        # route).  It bounds the GLOBAL sum of staged/live pointer chunks
        # (a budget's worth of fills flush together with the walks that
        # consume them); single chunks and single walk pools are also
        # capped at the walk's int32 gather limit (_WALK_MAX_TB).  Beyond
        # the per-chunk cap, buckets fall back to longseq checkpoint+refill.
        self.tb_hbm_bytes = (default_tb_budget()
                             if self.backend in platform.TILED_BACKENDS
                             else 4 << 30)
        # opt-in observability: assign a utils.metrics.StatsCollector
        self.stats = None
        # pointer arrays dispatched but possibly not yet walked: list of
        # (bytes, bundle-array to block on).  Bounds the SUM of concurrent
        # tb allocations across chunks/buckets (see _reserve_tb).
        self._tb_inflight: List[Tuple[int, object]] = []
        self._tb_inflight_bytes = 0
        # wall-time phase breakdown of the last _run call (seconds):
        # bucket / dispatch / gather / decode / reconstruct.  Always on —
        # a handful of time.time() calls per bucket, not per pair.
        self.phase: Dict[str, float] = {}
        table = (np.asarray(self.scoring_matrix.table, np.float32)
                 if hasattr(self.scoring_matrix, "table") else None)
        self._table = table
        # every DP value a multiple of 0.25: the CUDA fill runs in int32
        self._quarter = table is not None and fill_ops.quarter_exact(
            table, self.config.og, self.config.eg)

    @property
    def mode(self) -> int:
        return self.config.mode

    @property
    def _tiled(self) -> bool:
        return self.backend in platform.TILED_BACKENDS

    # ------------------------------------------------------------------
    def align_pairs(
        self, pairs: Sequence[Tuple], retain_all: bool = True
    ) -> List[AlignResult]:
        return self._run(pairs, retain_all=retain_all, score_only=False)

    def score_pairs(self, pairs: Sequence[Tuple]) -> np.ndarray:
        res = self._run(pairs, retain_all=True, score_only=True)
        return np.asarray([r.score for r in res], dtype=np.float32)

    # ------------------------------------------------------------------
    def _run(
        self, pairs: Sequence[Tuple], retain_all: bool, score_only: bool
    ) -> List[AlignResult]:
        import time as _time

        sm = self.scoring_matrix
        if not hasattr(sm, "table"):
            raise ValueError(
                "BatchAligner needs a letter-indexed scoring matrix; "
                "position-specific matrices are per-pair — use Aligner"
            )
        ph = self.phase = {
            "bucket": 0.0, "dispatch": 0.0, "gather": 0.0,
            "decode": 0.0, "reconstruct": 0.0,
        }
        t_run0 = _time.time()
        t0 = _time.time()
        og, eg = self.config.og, self.config.eg
        results: List[Optional[AlignResult]] = [None] * len(pairs)
        seqs: List[Tuple] = []
        buckets: Dict[Tuple[int, int], _Bucket] = {}

        for idx, (a, b) in enumerate(pairs):
            s1, s2 = _as_seqdata(a), _as_seqdata(b)
            if self.perl_compat:
                s1, s2 = _perl_compat_seq(s1), _perl_compat_seq(s2)
            seqs.append((s1, s2))
            c1 = sm.seq_to_index(s1.seq)
            c2 = sm.seq_to_index(s2.seq)
            if len(c1) == 0 or len(c2) == 0:
                results[idx] = degenerate_result(
                    s1.seq, s2.seq, self.mode, og, eg, retain_all, score_only
                )
                continue
            key = (
                bucket_len(len(c1), self.config.buckets),
                bucket_len(len(c2), self.config.buckets),
            )
            bk = buckets.get(key)
            if bk is None:
                bk = buckets[key] = _Bucket(key[0], key[1], [], [], [])
            bk.indices.append(idx)
            bk.codes1.append(c1)
            bk.codes2.append(c2)

        ph["bucket"] = _time.time() - t0
        # Two-phase pipeline: dispatch every bucket's device work first
        # (async under jax), then fetch + walk, so no bucket's transfer
        # waits behind another bucket's dispatch.
        t0 = _time.time()
        self._tb_inflight.clear()
        self._tb_inflight_bytes = 0
        self._fill_stage = []
        self._fill_stage_tb = 0
        self._pool_chunks.clear()
        self._pool_bytes.clear()
        self._pools = []
        # deterministic bucket order: pooled-walk flush partitioning (and
        # therefore the pooled program's chunk composition, its jit cache
        # key) must not depend on input order, or every shuffled call of
        # the same workload re-traces its programs
        pending = [
            (bk, self._dispatch_bucket(bk, score_only))
            for bk in sorted(
                buckets.values(), key=lambda b: (b.np_pad, b.mp_pad)
            )
        ]
        self._flush_fills()
        self._flush_pool()
        ph["dispatch"] = _time.time() - t0
        # fetch every bucket's results in ONE batched transfer before the
        # finish loop: per-bucket synchronous fetches cost a round trip
        # each and serialize without this
        t0 = _time.time()
        _gather_host(pending + [(None, p) for p in self._pools])
        ph["gather"] = _time.time() - t0
        self._tb_inflight.clear()  # everything fetched; drop device refs
        self._tb_inflight_bytes = 0
        for bk, pend in pending:
            self._finish_bucket(bk, pend, seqs, results, retain_all,
                                score_only)
        self._pools = []
        if self.stats is not None:
            # non-overlapped engine wall: the denominator every
            # StatsCollector throughput number divides by
            self.stats.run_seconds += _time.time() - t_run0
        return results  # type: ignore[return-value]

    # ------------------------------------------------------------------
    def _bucket_tile(self, count: int) -> int:
        if self.tile_pairs is not None:
            return self.tile_pairs
        return fill_ops.choose_tile(count)

    def _fill(self, codes1, codes2, n, m, score_only):
        """The batch paths' one way to the fill (ops/fill.fill)."""
        import jax.numpy as jnp

        return fill_ops.fill(
            jnp.asarray(self._table), jnp.asarray(codes1),
            jnp.asarray(codes2), jnp.asarray(n, jnp.int32),
            jnp.asarray(m, jnp.int32), backend=self.backend, mode=self.mode,
            og=self.config.og, eg=self.config.eg, score_only=score_only,
            quarter=self._quarter,
        )

    def _dispatch_bucket(self, bk, score_only):
        """Phase 1: pack codes, launch device work.  Returns a dict the
        finish phase consumes; device results are NOT forced to host here
        (except on paths that are host-synchronous by construction:
        longseq, scan, the host-walk fallbacks)."""
        import time as _time

        og, eg = self.config.og, self.config.eg
        count = len(bk.indices)
        if self.device_axis is not None:
            # size the quantum for the PER-SHARD share, not the whole batch
            nd = self.device_axis.n_devices
            tile = self._bucket_tile(-(-count // nd))
            step = tile * nd
        else:
            tile = self._bucket_tile(count)
            step = tile
        B = -(-count // step) * step
        t_fill0 = _time.time()
        NP, MP = bk.np_pad, bk.mp_pad
        # int8 codes when the alphabet fits (every letter-indexed table;
        # K ~ 25): a quarter of the int32 upload, and the CUDA fill's
        # input format
        ctype = np.int8 if self._table.shape[0] <= 127 else np.int32
        codes1 = np.zeros((B, NP), ctype)
        codes2 = np.zeros((B, MP), ctype)
        n = np.ones(B, np.int32)
        m = np.ones(B, np.int32)

        def _pack(dst, codes, lens):
            # one fancy-index scatter instead of a per-pair row loop
            total = int(lens.sum())
            if total == 0:
                return
            starts = np.zeros(count, np.int64)
            np.cumsum(lens[:-1], out=starts[1:])
            rows = np.repeat(np.arange(count), lens)
            cols = np.arange(total) - np.repeat(starts, lens)
            dst[rows, cols] = np.concatenate(codes)

        l1 = np.fromiter((len(c) for c in bk.codes1), np.int64, count)
        l2 = np.fromiter((len(c) for c in bk.codes2), np.int64, count)
        _pack(codes1, bk.codes1, l1)
        _pack(codes2, bk.codes2, l2)
        n[:count] = l1
        m[:count] = l2

        pend = {"n": n, "m": m, "B": B, "t0": t_fill0, "tile": tile}
        # Long-sequence routing.  With the on-device walk the pointer
        # matrix never crosses to the host, so the only reason to pay
        # checkpoint+refill (2x fill compute) is DEVICE memory: route to
        # longseq only when even ONE quantum's pointer array would blow
        # the budget — batches whose TOTAL exceeds it are chunked over
        # pairs instead (see _dispatch_tiled).  Without the device walk
        # (host-walk fallback) a per-pair cell threshold applies — there
        # the cost being dodged is the O(n*m) D2H pointer transfer.
        tb_bytes = bk.np_pad * B * bk.mp_pad  # uint8 pointers
        if self.longseq_cells is not None:
            too_big = bk.np_pad * bk.mp_pad >= self.longseq_cells
        elif self.device_walk:
            # _WALK_MAX_TB caps the budget even if SWTPU_TB_HBM_BYTES is
            # raised: past it the walk's int32 gather index would wrap
            group_tb = bk.np_pad * tile * bk.mp_pad
            too_big = group_tb > min(self.tb_hbm_bytes, _WALK_MAX_TB)
        else:
            too_big = bk.np_pad * bk.mp_pad >= 8192 * 4096
        use_longseq = (
            self._tiled
            and not score_only
            and self.device_axis is None
            and too_big
        )
        if use_longseq:
            from .ops import longseq

            if self.packed_walk:
                # device-side segment walks + packed move bundle
                stats_d, cnt_d, mv_d = longseq.align_long_packed(
                    self._table, codes1, codes2, n, m, mode=self.mode,
                    og=og, eg=eg,
                )
                pend.update(kind="device_walk_packed", stats_d=stats_d,
                            cnt_d=cnt_d, mv_d=mv_d, Bp=B)
            else:
                idx_ready, stats = longseq.align_long(
                    self._table, codes1, codes2, n, m, mode=self.mode,
                    og=og, eg=eg,
                )
                pend.update(kind="longseq", idx_ready=idx_ready,
                            stats=stats)
        elif self._tiled and self.device_axis is None:
            pend.update(self._dispatch_tiled(
                codes1, codes2, n, m, score_only, tile, count
            ))
        elif (
            self._tiled
            and self.device_walk
            and not score_only
            # per-shard pointer array must stay gather-indexable (int32)
            and tb_bytes // self.device_axis.n_devices <= _WALK_MAX_TB
        ):
            # sharded fill + device walk: pointers stay on their shard,
            # one small bundle per device comes back.  Chunked into
            # power-of-two quanta-per-shard units so compiled programs are
            # reused across batch sizes (shapes carry a D*chunk leading
            # axis).
            nd = self.device_axis.n_devices
            L = device_walk.max_path_len(codes1.shape[1], codes2.shape[1])
            Gs = codes1.shape[0] // (tile * nd)  # quanta per shard
            parts = []
            g0 = 0
            for gc in _pow2_chunks(Gs, cap=8):
                lo, hi = g0 * tile * nd, (g0 + gc) * tile * nd
                cnt = max(0, min(count, hi) - lo)
                args = (self._table, codes1[lo:hi], codes2[lo:hi],
                        n[lo:hi], m[lo:hi])
                kw = dict(backend=self.backend, mode=self.mode, og=og,
                          eg=eg, L=L, quarter=self._quarter)
                if self.packed_walk:
                    stats_d, cnt_d, mv_d = (
                        self.device_axis.fill_walk_bundle_packed(*args, **kw)
                    )
                    parts.append((cnt, {
                        "kind": "device_walk_packed_sharded",
                        "stats_d": stats_d, "cnt_d": cnt_d,
                        "mv_d": mv_d, "L": L, "Bp": hi - lo,
                    }))
                else:
                    stats_d, idx_d = self.device_axis.fill_walk_bundle(
                        *args, **kw
                    )
                    parts.append((cnt, {
                        "kind": "device_walk_sharded", "stats_d": stats_d,
                        "idx_d": idx_d, "L": L, "Bp": hi - lo,
                    }))
                g0 += gc
            if len(parts) == 1:
                pend.update(parts[0][1])
            else:
                pend.update(kind="multi", parts=parts)
        elif self._tiled:
            # sharded fill, host walk (score-only, or the full-matrix
            # SWTPU_DEVICE_WALK=0 fallback)
            tb, stats = self.device_axis.fill(
                self._table, codes1, codes2, n, m, backend=self.backend,
                mode=self.mode, og=og, eg=eg, score_only=score_only,
                quarter=self._quarter,
            )
            pend.update(
                kind="ready", stats=stats, walk=traceback.walk_tiled,
                get_tb=lambda k: batch_ops.tb_pair_view(tb, k),
            )
        else:
            tb_t, stats = self._fill_scan(codes1, codes2, n, m, score_only)
            pend.update(
                kind="ready", stats=stats, walk=traceback.walk,
                get_tb=lambda k: tb_t[k],
            )
        return pend

    def _finish_bucket(self, bk, pend, seqs, results, retain_all, score_only):
        import time as _time

        count = len(bk.indices)
        n, m, B = pend["n"], pend["m"], pend["B"]
        idx_ready = pend.get("idx_ready")
        walk = pend.get("walk")
        get_tb = pend.get("get_tb")
        stats = pend.get("stats")
        t_dec0 = _time.time()
        _packed_kinds = ("device_walk_packed", "device_walk_packed_sharded",
                         "pool_chunk")
        if pend["kind"] in _packed_kinds or (
            pend["kind"] == "multi"
            and pend["parts"]
            and pend["parts"][0][1]["kind"] in _packed_kinds
        ):
            parts = (pend["parts"] if pend["kind"] == "multi"
                     else [(count, pend)])
            self._finish_packed(bk, pend, parts, seqs, results, retain_all)
            return
        if pend["kind"] == "stats_only":
            stats = np.asarray(pend["stats_d"]).reshape(-1, 8)
        elif pend["kind"] == "device_walk":
            stats, o1, o2 = device_walk.decode_bundle(
                pend["stats_d"], pend["idx_d"]
            )
            idx_ready = [
                device_walk.pair_path(o1, o2, k) for k in range(count)
            ]
        elif pend["kind"] == "device_walk_sharded":
            stats, idx_ready = _decode_sharded_part(
                pend, pend.get("Bp", B), count
            )
        elif pend["kind"] == "multi":
            # power-of-two chunks (see _dispatch_tiled): resolve each
            # part, then stitch per-pair views back together.  Chunks of
            # one bucket share every dispatch condition, so mixed kinds
            # can only mean a bug upstream — fail loudly rather than
            # stitch wrong pointers.
            kinds = {part["kind"] for _, part in pend["parts"]}
            if len(kinds) != 1:
                raise RuntimeError(f"mixed chunk kinds in bucket: {kinds}")
            stats_parts = []
            idx_parts: Optional[list] = []
            tb_parts = []
            for cnt, part in pend["parts"]:
                if part["kind"] == "device_walk":
                    st, o1, o2 = device_walk.decode_bundle(
                        part["stats_d"], part["idx_d"]
                    )
                    stats_parts.append(st[:cnt])
                    idx_parts.extend(
                        device_walk.pair_path(o1, o2, k)
                        for k in range(cnt)
                    )
                elif part["kind"] == "device_walk_sharded":
                    st, idx = _decode_sharded_part(part, part["Bp"], cnt)
                    stats_parts.append(st[:cnt])
                    idx_parts.extend(idx)
                elif part["kind"] == "stats_only":  # score-only chunks
                    stats_parts.append(
                        np.asarray(part["stats_d"]).reshape(-1, 8)[:cnt]
                    )
                    idx_parts = None
                else:  # ready (host walk)
                    stats_parts.append(part["stats"][:cnt])
                    idx_parts = None
                    tb_parts.append((cnt, part["get_tb"]))
            stats = np.concatenate(stats_parts, axis=0)
            if idx_parts is not None:
                idx_ready = idx_parts
            elif tb_parts:
                walk = traceback.walk_tiled
                offsets = np.cumsum([0] + [c for c, _ in tb_parts])

                def get_tb(k, _parts=tb_parts, _off=offsets):
                    p = int(np.searchsorted(_off, k, side="right")) - 1
                    return _parts[p][1](k - int(_off[p]))

        self.phase["decode"] += _time.time() - t_dec0
        t_fill = _time.time() - pend["t0"]
        if self.stats is not None:
            bs = self.stats.bucket(bk.np_pad, bk.mp_pad)
            bs.pairs += count
            bs.padded_pairs += B
            bs.true_cells += int(np.sum(n[:count].astype(np.int64) * m[:count]))
            bs.padded_cells += B * bk.np_pad * bk.mp_pad
            bs.inflight_seconds += t_fill

        t_walk0 = _time.time()
        for k in range(count):
            idx = bk.indices[k]
            s1, s2 = seqs[idx]
            nb, mb = int(n[k]), int(m[k])
            best, best_i, best_j = stats[k, 0], int(stats[k, 1]), int(stats[k, 2])
            if self.mode == LOCAL:
                score = float(best) if best > 0.0 else 0.0
            else:
                fin = stats[k, 3:6]
                state = int(np.argmax(fin))
                score = float(fin[state])
            if score_only:
                results[idx] = AlignResult("", "", score)
                continue
            if idx_ready is not None:
                idx1, idx2 = idx_ready[k]
            elif self.mode == LOCAL:
                if best <= 0.0:
                    idx1: List[int] = []
                    idx2: List[int] = []
                else:
                    idx1, idx2 = walk(get_tb(k), best_i, best_j, CELL_MATCH, True)
            else:
                idx1, idx2 = walk(get_tb(k), nb, mb, state, False)
            results[idx] = reconstruct_alignment(
                s1.seq, s2.seq, idx1, idx2, score, retain_all, self.mode
            )
        self.phase["reconstruct"] += _time.time() - t_walk0
        if self.stats is not None:
            self.stats.bucket(bk.np_pad, bk.mp_pad).walk_seconds += (
                _time.time() - t_walk0
            )

    def _reserve_tb(self, new_bytes: int) -> None:
        """Bound the SUM of live pointer arrays across async device-walk
        dispatches: before enqueueing a fill that allocates ``new_bytes``
        of pointers, block on the oldest outstanding walk bundles until
        the total fits the budget.  Dispatch order is execution order on
        one device, so a ready bundle means its chunk's tb (the walk's only
        use of it) is dead."""
        budget = min(self.tb_hbm_bytes, _WALK_MAX_TB)
        while self._tb_inflight and (
            self._tb_inflight_bytes + new_bytes > budget
        ):
            done_bytes, h = self._tb_inflight.pop(0)
            try:
                h.block_until_ready()
            except AttributeError:  # already a host array
                pass
            self._tb_inflight_bytes -= done_bytes

    def _track_tb(self, new_bytes: int, handle) -> None:
        self._tb_inflight.append((new_bytes, handle))
        self._tb_inflight_bytes += new_bytes

    def _stage_fill(self, codes1, codes2, n, m, score_only, ref) -> None:
        """Register one chunk's fill for the pooled fill program
        (ops/batch.fill_many).  When the staged pointer bytes would pass
        the GLOBAL budget, flush fills AND walks together: the walk
        programs consume the pointer arrays, so device execution order
        (fill #1, walks #1, fill #2, ...) bounds peak resident pointers
        at ~budget + the largest pool concat.

        Staging order is the canonical dispatch order (buckets sorted by
        shape, pow2 chunks largest-first), so the pooled program's cache
        key — the ordered chunk-shape composition — is workload-
        deterministic (tests/test_packed_walk.py's shuffled-workload
        case)."""
        tb_bytes = (0 if score_only
                    else codes1.shape[0] * codes1.shape[1] * codes2.shape[1])
        if self._fill_stage and (
            self._fill_stage_tb + tb_bytes > self.tb_hbm_bytes
        ):
            self._flush_fills()
            self._flush_pool()
        # ONE flat codes buffer per chunk, device_put NOW (async): the
        # upload overlaps the host's remaining bucket/pack work
        flat = np.concatenate([codes1.ravel(), codes2.ravel()])
        self._fill_stage.append(dict(
            flat=jax.device_put(flat),
            B=codes1.shape[0], NP=codes1.shape[1], MP=codes2.shape[1],
            n=n, m=m, score_only=score_only, ref=ref,
        ))
        self._fill_stage_tb += tb_bytes

    def _flush_fills(self) -> None:
        """Dispatch ONE fill_many program over the staged chunks; write
        each chunk's device stats into its pend and hand traceback
        chunks' pointer arrays to the pooled walk."""
        stage = self._fill_stage
        if not stage:
            return
        self._fill_stage = []
        self._fill_stage_tb = 0
        import jax.numpy as jnp

        flats = tuple(st["flat"] for st in stage)
        # every chunk's lengths in ONE upload
        lens = jnp.asarray(np.concatenate(
            [np.concatenate([st["n"], st["m"]]) for st in stage]
        ), jnp.int32)
        metas = tuple(
            (st["B"], st["NP"], st["MP"], st["score_only"]) for st in stage
        )
        outs = batch_ops.fill_many(
            jnp.asarray(self._table), flats, lens, backend=self.backend,
            quarter=self._quarter, mode=self.mode, og=self.config.og,
            eg=self.config.eg, metas=metas,
        )
        for st, (tb, stats) in zip(stage, outs):
            # through ref, not pend: single-chunk pends were flattened
            # into the bucket dict by update() before this flush ran
            st["ref"]["stats_d"] = stats
            if not st["score_only"]:
                self._pool_add(st["ref"], tb, stats, st["n"], st["m"])

    def _pool_add(self, ref, tb, stats, n, m) -> None:
        """Register a fill's pointer chunk for the pooled walk in its
        path-length class; flush that class first when this chunk would
        bust the budget (peak device memory: live chunks + the pool
        concat, each bounded by the budget)."""
        budget = min(self.tb_hbm_bytes, _WALK_MAX_TB)
        nbytes = int(np.prod(tb.shape))
        Lmax = device_walk.max_path_len(tb.shape[1], tb.shape[3])
        lc = 1 << (Lmax - 1).bit_length()  # pow2 path-length class
        if (self._pool_chunks.get(lc)
                and self._pool_bytes.get(lc, 0) + nbytes > budget):
            self._flush_class(lc)
        self._pool_chunks.setdefault(lc, []).append(
            (ref, tb, stats, np.asarray(n), np.asarray(m))
        )
        self._pool_bytes[lc] = self._pool_bytes.get(lc, 0) + nbytes

    def _flush_pool(self) -> None:
        for lc in sorted(self._pool_chunks):
            self._flush_class(lc)

    def _flush_class(self, L: int) -> None:
        """Dispatch ONE pooled walk over a length class's accumulated
        chunks; chunks' ref dicts receive their pool handle + column
        range."""
        chunks = self._pool_chunks.pop(L, None)
        self._pool_bytes.pop(L, None)
        if not chunks:
            return
        import jax.numpy as jnp

        # canonical composition order: the jit cache keys on the tuple of
        # chunk shapes IN ORDER, and bucket iteration follows input order
        # — without sorting, a shuffled batch of the same buckets
        # re-traces the whole pooled program every call
        chunks.sort(key=lambda c: c[1].shape)
        cnt_d, mv_d = device_walk.walk_bundle_pooled(
            tuple(c[1] for c in chunks),
            tuple(c[2] for c in chunks),
            tuple(jnp.asarray(c[3], jnp.int32) for c in chunks),
            tuple(jnp.asarray(c[4], jnp.int32) for c in chunks),
            mode=self.mode, L=L,
        )
        pool = {"kind": "pool_bundle", "cnt_d": cnt_d, "mv_d": mv_d}
        c0 = 0
        for ref, tb, _, _, _ in chunks:
            B = tb.shape[0] * tb.shape[2]
            ref["pool"] = pool
            ref["col0"] = c0
            ref["Bc"] = B
            c0 += B
        self._pools.append(pool)

    def _finish_packed(self, bk, pend, parts, seqs, results, retain_all):
        """Finish a bucket whose walk came back as packed move streams:
        one bulk native string rebuild per chunk (ops/reconstruct.py), no
        per-residue Python."""
        import time as _time

        from .ops import reconstruct as recon

        t0 = _time.time()
        count = len(bk.indices)
        n, m = pend["n"], pend["m"]
        local = self.mode == LOCAL
        lo = 0
        for cnt, part in parts:
            if cnt == 0:
                continue
            mv_col0 = 0
            if part["kind"] == "device_walk_packed_sharded":
                # per-shard leading axis; shard-major row order == pair
                # order (cf. _decode_sharded_part)
                st = np.asarray(part["stats_d"]).reshape(-1, 8)[:cnt]
                cnt_arr = np.asarray(part["cnt_d"]).reshape(-1)
                mv_sh = np.asarray(part["mv_d"])  # (D, L4, Bp)
                mv = np.concatenate(list(mv_sh), axis=1)
            elif part["kind"] == "pool_chunk":
                ref = part["ref"]
                pool = ref["pool"]
                c0, Bc = ref["col0"], ref["Bc"]
                st = np.asarray(part["stats_d"]).reshape(-1, 8)[:cnt]
                cnt_arr = np.asarray(pool["cnt_d"])[c0:c0 + Bc]
                # full pooled array + column offset: a [:, c0:c0+Bc]
                # slice is non-contiguous and would copy per chunk
                mv = np.asarray(pool["mv_d"])
                mv_col0 = c0
            else:
                if part["kind"] != "device_walk_packed":
                    raise RuntimeError(f"unexpected kind {part['kind']}")
                st = np.asarray(part["stats_d"])[:cnt]
                cnt_arr = np.asarray(part["cnt_d"])
                mv = np.asarray(part["mv_d"])
            if local:
                scores = np.maximum(st[:, 0], 0.0)
                pos = st[:, 0] > 0.0
                i0 = np.where(pos, st[:, 1], 0).astype(np.int32)
                j0 = np.where(pos, st[:, 2], 0).astype(np.int32)
            else:
                scores = st[:, 3:6].max(axis=1)
                i0 = n[lo:lo + cnt].astype(np.int32)
                j0 = m[lo:lo + cnt].astype(np.int32)
            idxs = bk.indices[lo:lo + cnt]
            seq1s = [seqs[i][0].seq for i in idxs]
            seq2s = [seqs[i][1].seq for i in idxs]
            res = recon.reconstruct_packed(
                seq1s, seq2s, mv, cnt_arr, i0, j0, scores,
                self.mode, retain_all, col0=mv_col0,
            )
            for k, idx in enumerate(idxs):
                results[idx] = res[k]
            lo += cnt
        self.phase["reconstruct"] += _time.time() - t0
        if self.stats is not None:
            bs = self.stats.bucket(bk.np_pad, bk.mp_pad)
            bs.pairs += count
            bs.padded_pairs += pend["B"]
            bs.true_cells += int(
                np.sum(n[:count].astype(np.int64) * m[:count])
            )
            bs.padded_cells += pend["B"] * bk.np_pad * bk.mp_pad
            bs.inflight_seconds += t0 - pend["t0"]
            bs.walk_seconds += _time.time() - t0

    # ------------------------------------------------------------------
    def _dispatch_tiled(self, codes1, codes2, n, m, score_only, tile,
                        count):
        """Dispatch a bucket on the tiled pipeline (device_axis is None).

        Buckets wider than one quantum are split into power-of-two quantum
        chunks (8, 4, 2, 1): fill programs are specialized on the pair
        count, so unchunked batches would compile a NEW program per
        distinct pair count.  Chunking bounds compiles at four programs
        per (bucket, mode) and streams arbitrary batch sizes through them.

        On the device-walk route the chunk cap is additionally sized so
        ONE chunk's pointer array fits the budget, and chunks past the
        budget serialize (see _reserve_tb) — so batches of any size stream
        through bounded device memory.
        """
        G = codes1.shape[0] // tile
        cap = 8
        if self.device_walk and not score_only:
            budget = min(self.tb_hbm_bytes, _WALK_MAX_TB)
            group_tb = codes1.shape[1] * tile * codes2.shape[1]
            while cap > 1 and cap * group_tb > budget:
                cap //= 2
        if G > 1:
            parts = []
            g0 = 0
            for gc in _pow2_chunks(G, cap=cap):
                lo, hi = g0 * tile, (g0 + gc) * tile
                cnt = max(0, min(count, hi) - lo)
                parts.append((cnt, self._dispatch_chunk(
                    codes1[lo:hi], codes2[lo:hi], n[lo:hi], m[lo:hi],
                    score_only,
                )))
                g0 += gc
            return {"kind": "multi", "parts": parts}
        return self._dispatch_chunk(codes1, codes2, n, m, score_only)

    def _dispatch_chunk(self, codes1, codes2, n, m, score_only):
        """Dispatch one chunk.  Returns the pend-dict fields: a pooled
        fill/walk registration (default), a per-chunk device walk bundle,
        device stats (score-only) or host pointers (host-walk fallback)."""
        import jax.numpy as jnp

        if not score_only and self.device_walk and self.packed_walk \
                and self.pooled_walk:
            # pooled fast path: the fill is STAGED so every chunk's fill
            # rides ONE dispatched program (ops/batch.fill_many); the walk
            # is deferred to the pooled flush.  Its pool handle arrives
            # later via the shared mutable ``ref`` dict — _dispatch_bucket
            # flattens pend dicts with update(), so flush-time mutations
            # of THIS dict would be lost.  stats_d likewise lands at
            # fill-flush time.
            ref: dict = {}
            pend = {"kind": "pool_chunk", "stats_d": None,
                    "Bp": codes1.shape[0], "ref": ref}
            if self.pooled_fill:
                self._stage_fill(codes1, codes2, n, m, False, ref)
                return pend
            tb, stats = self._fill(codes1, codes2, n, m, False)
            pend["stats_d"] = stats
            self._pool_add(ref, tb, stats, n, m)
            return pend
        if score_only:
            # only the (B, 8) stats block ever exists device-side; staged
            # into the pooled fill program by default (score-only chunks
            # add no pointer bytes, so they never trigger a budget flush)
            if self.pooled_fill:
                ref_so: dict = {}
                self._stage_fill(codes1, codes2, n, m, True, ref_so)
                return {"kind": "stats_only", "stats_d": None,
                        "ref": ref_so}
            _, stats = self._fill(codes1, codes2, n, m, True)
            return {"kind": "stats_only", "stats_d": stats}
        if self.device_walk:
            tb_new = codes1.shape[0] * codes1.shape[1] * codes2.shape[1]
            self._reserve_tb(tb_new)
            tb, stats = self._fill(codes1, codes2, n, m, False)
            L = device_walk.max_path_len(codes1.shape[1], codes2.shape[1])
            nd, md = jnp.asarray(n, jnp.int32), jnp.asarray(m, jnp.int32)
            if self.packed_walk:
                stats_d, cnt_d, mv_d = device_walk.walk_bundle_packed(
                    tb, stats, nd, md, mode=self.mode, L=L,
                )
                self._track_tb(tb_new, stats_d)
                return {"kind": "device_walk_packed", "stats_d": stats_d,
                        "cnt_d": cnt_d, "mv_d": mv_d, "L": L,
                        "Bp": codes1.shape[0]}
            stats_d, idx_d = device_walk.walk_bundle(
                tb, stats, nd, md, mode=self.mode, L=L,
            )
            self._track_tb(tb_new, stats_d)
            return {"kind": "device_walk", "stats_d": stats_d,
                    "idx_d": idx_d, "L": L, "Bp": codes1.shape[0]}
        # host-walk fallback: fetch NOW so this chunk's pointer buffer
        # frees before the next chunk fills
        tb, stats = self._fill(codes1, codes2, n, m, False)
        tb_h, stats_h = jax.device_get((tb, stats))
        return {"kind": "ready", "stats": np.asarray(stats_h),
                "walk": traceback.walk_tiled,
                "get_tb": lambda k: batch_ops.tb_pair_view(tb_h, k)}

    def _fill_scan(self, codes1, codes2, n, m, score_only):
        """vmapped scan fallback; returns (tb (B, NP+1, MP+1), stats (B, 8))."""
        table = self._table
        B = codes1.shape[0]
        S = table[codes1[:, :, None], codes2[:, None, :]].astype(np.float32)
        res = batch_ops.fill_scan(
            S, n, m, mode=self.mode, og=self.config.og, eg=self.config.eg,
            score_only=score_only,
        )
        stats = np.zeros((B, 8), np.float32)
        stats[:, 0] = np.asarray(res.best)
        stats[:, 1] = np.asarray(res.best_i)
        stats[:, 2] = np.asarray(res.best_j)
        stats[:, 3:6] = np.asarray(res.final)
        tb = np.asarray(res.tb) if not score_only else None
        return tb, stats
