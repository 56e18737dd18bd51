// Native traceback walker for smithwaterman_tpu.
//
// The O(n+m) pointer walk is serial and branchy — the one part of the
// pipeline that belongs on the host CPU (the reference GPU engine makes the
// same split: packed flags come back from the device and the host
// reconstructs strings, rust/sa_opencl/src/opencl_sequence_alignment.rs:765-795).
// This walker consumes the packed 2-bit-per-state pointer bytes emitted by
// both device fills:
//   bits 0-1: predecessor state of M, bits 2-3: of X, bits 4-5: of Y;
//   value 3 (CELL_STOP) = local-mode "score is zero, stop".
//
// Two layouts:
//   sw_traceback        — full matrix incl. boundary row/col (scan path);
//                         row_stride in ELEMENTS.
//   sw_traceback_tiled  — interior cells only (batched fills): tb[(i-1), (j-1)]
//                         holds cell (i, j); boundary pointers are closed
//                         form (see ops/traceback.py:_boundary_prev);
//                         row_stride in BYTES (strided numpy view).
//
// Outputs are 0-based residue indices (-1 = gap) in walk order (callers
// reverse). Returns the emitted count, or -1 if capacity is exceeded.

#include <cstdint>

namespace {

constexpr int64_t MATCH = 0;
constexpr int64_t GAPINX = 1;  // gap in seq1: consumes j
constexpr int64_t GAPINY = 2;  // gap in seq2: consumes i
constexpr int64_t STOP = 3;

inline int64_t boundary_prev(int64_t i, int64_t j, int64_t s, bool local) {
  if (i == 0 && j == 0) return (local && s == MATCH) ? STOP : MATCH;
  if (i == 0) return (local && s == GAPINX) ? STOP : GAPINX;
  return (local && s == GAPINY) ? STOP : GAPINY;
}

// Defined behavior where the reference has none (ops/traceback.py
// normalize_boundary_state): with og == eg == 0 the boundary sentinel is 0
// and tie rules can route the walk into X at column 0 / Y at row 0, where
// the reference crashes (sequence_alignment.rs:368-370).  Continue along
// the boundary gap chain instead — identical score at the only reachable
// penalty point.
inline int64_t normalize_boundary_state(int64_t i, int64_t j, int64_t s) {
  if (j == 0 && i > 0 && s != GAPINY) return GAPINY;
  if (i == 0 && j > 0 && s != GAPINX) return GAPINX;
  return s;
}

template <bool kTiled>
int64_t walk(const uint8_t* tb, int64_t row_stride, int64_t si, int64_t sj,
             int64_t state, int64_t local_flag, int64_t* out1, int64_t* out2,
             int64_t cap) {
  const bool local = local_flag != 0;
  int64_t i = si, j = sj, s = state;
  int64_t count = 0;
  for (;;) {
    s = normalize_boundary_state(i, j, s);
    int64_t prev;
    if (kTiled) {
      if (i >= 1 && j >= 1) {
        prev = (tb[(i - 1) * row_stride + (j - 1)] >> (2 * s)) & 3;
      } else {
        prev = boundary_prev(i, j, s, local);
      }
    } else {
      prev = (tb[i * row_stride + j] >> (2 * s)) & 3;
    }
    if (local && prev == STOP) break;
    if (count >= cap) return -1;
    switch (s) {
      case MATCH:
        out1[count] = i - 1;
        out2[count] = j - 1;
        --i;
        --j;
        break;
      case GAPINX:
        out1[count] = -1;
        out2[count] = j - 1;
        --j;
        break;
      case GAPINY:
        out1[count] = i - 1;
        out2[count] = -1;
        --i;
        break;
      default:
        return -1;  // corrupt pointer
    }
    ++count;
    if (i == 0 && j == 0) break;
    s = prev;
  }
  return count;
}

}  // namespace

extern "C" {

int64_t sw_traceback(const uint8_t* tb, int64_t row_stride, int64_t si,
                     int64_t sj, int64_t state, int64_t local, int64_t* out1,
                     int64_t* out2, int64_t cap) {
  return walk<false>(tb, row_stride, si, sj, state, local, out1, out2, cap);
}

int64_t sw_traceback_tiled(const uint8_t* tb, int64_t row_stride_bytes,
                           int64_t si, int64_t sj, int64_t state,
                           int64_t local, int64_t* out1, int64_t* out2,
                           int64_t cap) {
  return walk<true>(tb, row_stride_bytes, si, sj, state, local, out1, out2,
                    cap);
}

// Band-window walk (semantics: ops/longseq.walk_band).  tb is a contiguous
// (C, width) uint8 window where tb[r, c] holds DP cell
// (i_top + r + 1, j_off + c + 1).  io_ijs = [i, j, s] in/out; status_out:
// 0 = path complete, 1 = walked off the top of the band, 2 = walked off
// the left edge of the column window.  Returns emitted count (walk order;
// callers reverse), -1 if capacity exceeded, -3 on a corrupt pointer.
int64_t sw_walk_band(const uint8_t* tb, int64_t width, int64_t i_top,
                     int64_t j_off, int64_t* io_ijs, int64_t local_flag,
                     int64_t* out1, int64_t* out2, int64_t cap,
                     int64_t* status_out) {
  const bool local = local_flag != 0;
  int64_t i = io_ijs[0], j = io_ijs[1], s = io_ijs[2];
  int64_t count = 0;
  auto finish = [&](int64_t status) {
    io_ijs[0] = i;
    io_ijs[1] = j;
    io_ijs[2] = s;
    *status_out = status;
    return count;
  };
  for (;;) {
    s = normalize_boundary_state(i, j, s);
    int64_t prev;
    if (i == 0 && j == 0) {
      prev = (local && s == MATCH) ? STOP : MATCH;
    } else if (i == 0) {
      prev = (local && s == GAPINX) ? STOP : GAPINX;
    } else if (j == 0) {
      prev = (local && s == GAPINY) ? STOP : GAPINY;
    } else {
      int64_t c = j - 1 - j_off;
      if (c < 0 || c >= width) return finish(2);  // WALK_LEFT
      prev = (tb[(i - i_top - 1) * width + c] >> (2 * s)) & 3;
    }
    if (local && prev == STOP) return finish(0);  // WALK_DONE
    if (count >= cap) return -1;
    switch (s) {
      case MATCH:
        out1[count] = i - 1;
        out2[count] = j - 1;
        --i;
        --j;
        break;
      case GAPINX:
        out1[count] = -1;
        out2[count] = j - 1;
        --j;
        break;
      case GAPINY:
        out1[count] = i - 1;
        out2[count] = -1;
        --i;
        break;
      default:
        return -3;  // corrupt pointer
    }
    ++count;
    if (i == 0 && j == 0) return finish(0);
    s = prev;
    if (i > 0 && i <= i_top && j > 0) return finish(1);  // WALK_UP
  }
}

// Diagonal-band walk (semantics: ops/banded.walk_banded).  tb is a
// contiguous (NP, W) uint8 plane; off is the (NP+1,) int32 per-row band
// offset; edge_out is set to 1 when the path visited a band-edge lane
// where out-of-band alternatives geometrically exist.  Returns count,
// -1 capacity, -2 band exceeded (corrupt fill), -3 corrupt pointer.
int64_t sw_walk_banded(const uint8_t* tb, int64_t W, const int32_t* off,
                       int64_t si, int64_t sj, int64_t state,
                       int64_t local_flag, int64_t m, int64_t* out1,
                       int64_t* out2, int64_t cap, int64_t* edge_out) {
  const bool local = local_flag != 0;
  int64_t i = si, j = sj, s = state;
  int64_t count = 0;
  *edge_out = 0;
  for (;;) {
    s = normalize_boundary_state(i, j, s);
    int64_t prev;
    if (i >= 1 && j >= 1) {
      int64_t w = j - 1 - static_cast<int64_t>(off[i]);
      if (w < 0 || w >= W) return -2;  // BandExceeded
      if ((w == 0 && j > 1) || (w == W - 1 && j < m)) *edge_out = 1;
      prev = (tb[(i - 1) * W + w] >> (2 * s)) & 3;
    } else if (i == 0 && j == 0) {
      prev = (local && s == MATCH) ? STOP : MATCH;
    } else if (i == 0) {
      prev = (local && s == GAPINX) ? STOP : GAPINX;
    } else {
      prev = (local && s == GAPINY) ? STOP : GAPINY;
    }
    if (local && prev == STOP) break;
    if (count >= cap) return -1;
    switch (s) {
      case MATCH:
        out1[count] = i - 1;
        out2[count] = j - 1;
        --i;
        --j;
        break;
      case GAPINX:
        out1[count] = -1;
        out2[count] = j - 1;
        --j;
        break;
      case GAPINY:
        out1[count] = i - 1;
        out2[count] = -1;
        --i;
        break;
      default:
        return -3;
    }
    ++count;
    if (i == 0 && j == 0) break;
    s = prev;
  }
  return count;
}

}  // extern "C"
