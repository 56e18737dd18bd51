// Bulk alignment-string reconstruction from the device walk's packed
// 2-bit move stream (ops/device_walk.py walk_bundle_packed).
//
// The device walk ships back, per bucket, ONE byte-packed array of
// traceback moves (4 moves/byte, walk order: t = 0 is the path's END
// cell) plus a per-pair move count — O((n+m)/4) bytes per pair instead
// of the reference GPU engine's full index readback
// (rust/sa_opencl/src/opencl_sequence_alignment.rs:765-795).  This
// function replays every pair's move stream straight into the final
// full-length alignment characters, replacing the per-residue Python
// loops (aligner.reconstruct_alignment, parity:
// sequence_alignment.rs:469-551) that dominated suite wall time at
// scale (~3.2M list appends on the 32x suite).
//
// Move semantics per step (state s consumed at the current cell):
//   MATCH  (0): emit (seq1[i-1], seq2[j-1]); --i; --j;
//   GAPINX (1): emit ('-',       seq2[j-1]); --j;
//   GAPINY (2): emit (seq1[i-1], '-');       --i;
// The consumed residues of each sequence form one contiguous run, so the
// aligned span is a closed form of the start and end cells: start1 = final
// i, end1 = i0 - 1 (or -1 when no step consumed seq1).

#include <cstdint>

namespace {

constexpr int64_t MATCH = 0;
constexpr int64_t GAPINX = 1;  // gap in seq1: consumes j
constexpr int64_t GAPINY = 2;  // gap in seq2: consumes i

}  // namespace

extern "C" {

// moves: (n_rows, B) row-major packed bytes, pair k = column k; the move at
//   step t of pair k is (moves[(t>>2)*row_stride + k] >> ((t&3)*2)) & 3.
// cnt/i0s/j0s: per-pair move count and walk start cell (B >= count).
// seq1/off1 (and 2): concatenated sequence bytes, off has count+1 entries.
// out1/out2: concatenated output char buffers; pair k writes at
//   outoff[k] with capacity outoff[k+1]-outoff[k] (callers size n1+n2).
// outlen: per-pair emitted length.  spans: (count, 4) start1,end1,start2,
//   end2 (-1 when nothing aligned).  local/retain mirror
//   aligner.reconstruct_alignment's mode==LOCAL / retain_all flags.
// Returns 0, or -(k+1) on a corrupt stream at pair k (caller falls back).
int64_t sw_reconstruct_moves(
    const uint8_t* moves, int64_t row_stride, int64_t n_rows,
    const int32_t* cnt, const int32_t* i0s, const int32_t* j0s,
    const uint8_t* seq1, const int64_t* off1, const uint8_t* seq2,
    const int64_t* off2, int64_t count, int64_t local_flag,
    int64_t retain_flag, uint8_t* out1, uint8_t* out2,
    const int64_t* outoff, int64_t* outlen, int64_t* spans) {
  const bool local = local_flag != 0;
  const bool retain = retain_flag != 0;
  for (int64_t k = 0; k < count; ++k) {
    const uint8_t* s1 = seq1 + off1[k];
    const uint8_t* s2 = seq2 + off2[k];
    const int64_t n1 = off1[k + 1] - off1[k];
    const int64_t n2 = off2[k + 1] - off2[k];
    const int64_t c = cnt[k];
    const int64_t i0 = i0s[k], j0 = j0s[k];
    const int64_t capacity = outoff[k + 1] - outoff[k];
    uint8_t* o1 = out1 + outoff[k];
    uint8_t* o2 = out2 + outoff[k];
    if (c > 4 * n_rows || c > capacity || i0 > n1 || j0 > n2 || i0 < 0 ||
        j0 < 0) {
      return -(k + 1);
    }
    // pass 1: replay to the path's start cell (ie, je)
    int64_t ie = i0, je = j0;
    for (int64_t t = 0; t < c; ++t) {
      const int64_t s = (moves[(t >> 2) * row_stride + k] >> ((t & 3) * 2)) & 3;
      ie -= (s != GAPINX);
      je -= (s != GAPINY);
      if (s > GAPINY || ie < 0 || je < 0) return -(k + 1);
    }
    // Non-local streams may stop at the first boundary cell (i == 0 or
    // j == 0): the device walk's boundary short-circuit skips the
    // deterministic terminal-gap tail (ops/device_walk.py), which this
    // rebuild synthesizes below from (ie, je).  Full streams replay to
    // ie == je == 0 and are unaffected.  Spans therefore come from the
    // VIRTUAL full path for non-local modes: the tail consumes the
    // remaining prefix of one sequence, so the aligned region always
    // starts at 0 (parity: the pre-shortcut walk emitted those moves
    // and produced exactly these spans).
    const bool nonlocal_tail = !local && (ie > 0 || je > 0);
    const int64_t start1 = (i0 > ie) ? ie : -1;
    const int64_t end1 = (i0 > ie) ? i0 - 1 : -1;
    const int64_t start2 = (j0 > je) ? je : -1;
    const int64_t end2 = (j0 > je) ? j0 - 1 : -1;
    int64_t* sp = spans + 4 * k;
    if (local && !retain) {
      sp[0] = start1;
      sp[1] = end1;
      sp[2] = start2;
      sp[3] = end2;
      // aligned body only, written right-to-left as the stream replays
      int64_t i = i0, j = j0;
      for (int64_t t = 0; t < c; ++t) {
        const int64_t s =
            (moves[(t >> 2) * row_stride + k] >> ((t & 3) * 2)) & 3;
        o1[c - 1 - t] = (s == GAPINX) ? '-' : s1[--i];
        o2[c - 1 - t] = (s == GAPINY) ? '-' : s2[--j];
      }
      outlen[k] = c;
      continue;
    }
    if (!nonlocal_tail && (start1 < 0 || start2 < 0)) {
      // nothing aligned: seq1 over gaps, then gaps over seq2 (rs:512-524)
      if (n1 + n2 > capacity) return -(k + 1);
      for (int64_t t = 0; t < n1; ++t) {
        o1[t] = s1[t];
        o2[t] = '-';
      }
      for (int64_t t = 0; t < n2; ++t) {
        o1[n1 + t] = '-';
        o2[n1 + t] = s2[t];
      }
      outlen[k] = n1 + n2;
      sp[0] = sp[1] = sp[2] = sp[3] = -1;
      continue;
    }
    // leading block counts: for a short-circuited non-local stream the
    // synthesized terminal-gap tail covers seq1[0..ie) (GAPY products)
    // or seq2[0..je) (GAPX products) — at most one is non-zero since the
    // walk stops at the FIRST boundary touch.  These produce exactly the
    // characters the skipped boundary moves would have emitted, in the
    // same positions.
    int64_t lead1, lead2, tl1, tl2;
    if (nonlocal_tail) {
      lead1 = ie;
      lead2 = je;
      sp[0] = (i0 > 0) ? 0 : -1;
      sp[1] = (i0 > 0) ? i0 - 1 : -1;
      sp[2] = (j0 > 0) ? 0 : -1;
      sp[3] = (j0 > 0) ? j0 - 1 : -1;
      tl1 = n1 - i0;
      tl2 = n2 - j0;
    } else {
      lead1 = start1;
      lead2 = start2;
      sp[0] = start1;
      sp[1] = end1;
      sp[2] = start2;
      sp[3] = end2;
      tl1 = n1 - 1 - end1;
      tl2 = n2 - 1 - end2;
    }
    const int64_t tail1 = tl1, tail2 = tl2;
    const int64_t len = lead1 + lead2 + c + tail1 + tail2;
    if (len > capacity) return -(k + 1);
    int64_t p = 0;
    for (int64_t t = 0; t < lead1; ++t, ++p) {
      o1[p] = s1[t];
      o2[p] = '-';
    }
    for (int64_t t = 0; t < lead2; ++t, ++p) {
      o1[p] = '-';
      o2[p] = s2[t];
    }
    {  // aligned body, right-to-left from the replayed stream
      int64_t i = i0, j = j0;
      for (int64_t t = 0; t < c; ++t) {
        const int64_t s =
            (moves[(t >> 2) * row_stride + k] >> ((t & 3) * 2)) & 3;
        o1[p + c - 1 - t] = (s == GAPINX) ? '-' : s1[--i];
        o2[p + c - 1 - t] = (s == GAPINY) ? '-' : s2[--j];
      }
      p += c;
    }
    const int64_t te1 = nonlocal_tail ? i0 - 1 : end1;
    const int64_t te2 = nonlocal_tail ? j0 - 1 : end2;
    for (int64_t t = te1 + 1; t < n1; ++t, ++p) {
      o1[p] = s1[t];
      o2[p] = '-';
    }
    for (int64_t t = te2 + 1; t < n2; ++t, ++p) {
      o1[p] = '-';
      o2[p] = s2[t];
    }
    outlen[k] = len;
  }
  return 0;
}

}  // extern "C"
