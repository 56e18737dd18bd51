// refbench: C++ stand-in for the reference's fastest engine (Rust CPU,
// rust/sequence_alignment) for the end-to-end race of scripts/bench_vs_reference.py.
//
// The image has no Rust toolchain (no rustc/cargo), so the reference's
// feature-complete serial CPU engine cannot be built and timed directly.
// This file bounds it from both sides with two C++ engines implementing the
// SAME recurrences, tie-breaks, traceback and retain_all reconstruction
// (algorithmic contract: sequence_alignment.rs:55-550, SURVEY.md §2.4):
//
//   * CellEngine — structural mirror of the Rust engine's machine behavior:
//     cells as vector<vector<Cell>> where each Cell holds two heap-allocated
//     arrays (Rust: SWCell{scores:Vec<f32>, prev:Vec<usize>},
//     sequence_alignment.rs:556-566), scoring through a virtual
//     ScoringMatrix::get_score call (Rust: Box<dyn ScoringMatrix>,
//     sequence_alignment.rs:17,127), grow-only buffer reuse across pairs
//     (:67-71).  This is what the actual Rust binary does per cell, so its
//     time is a *faithful estimate* of reference_rust_s.
//   * FlatEngine — the same algorithm on flat contiguous f32/u8 buffers with
//     direct table indexing, -O3.  Strictly faster than the Rust engine's
//     pointer-chasing layout could be: a *generous upper bound* on any
//     tuned serial CPU rewrite.
//
// Both engines' local-mode outputs are validated string-exact against the
// EMBOSS goldens by scripts/bench_vs_reference.py before their times are
// recorded.  This is BENCHMARK scaffolding, not part of the framework: the
// product DP engines are ops/scan_dp.py and ops/fill.py (+ csrc/gpu/sw_fill.cu).
//
// Usage: refbench <ref_test_dir> <mode: local|global|glocal|all>
//                 [--engine cell|flat|both] [--dump <dir>] [--reps N]
// Prints one JSON line per (engine, mode) sweep with wall seconds and a
// score checksum.

#include <algorithm>
#include <cctype>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <memory>
#include <sstream>
#include <string>
#include <vector>

namespace {

constexpr int MATCH = 0, GAPINX = 1, GAPINY = 2;
constexpr int ALIGN_GLOBAL = 0, ALIGN_GLOCAL = 1, ALIGN_LOCAL = 2;

// BLOSUM62 in half-bit units (public NCBI constant; the reference embeds the
// same table, sequence_alignment.rs:706-730).
const char* kLetters = "ARNDCQEGHILKMFPSTWYVBZX*";
const int kB62[24][24] = {
    {4,-1,-2,-2,0,-1,-1,0,-2,-1,-1,-1,-1,-2,-1,1,0,-3,-2,0,-2,-1,0,-4},
    {-1,5,0,-2,-3,1,0,-2,0,-3,-2,2,-1,-3,-2,-1,-1,-3,-2,-3,-1,0,-1,-4},
    {-2,0,6,1,-3,0,0,0,1,-3,-3,0,-2,-3,-2,1,0,-4,-2,-3,3,0,-1,-4},
    {-2,-2,1,6,-3,0,2,-1,-1,-3,-4,-1,-3,-3,-1,0,-1,-4,-3,-3,4,1,-1,-4},
    {0,-3,-3,-3,9,-3,-4,-3,-3,-1,-1,-3,-1,-2,-3,-1,-1,-2,-2,-1,-3,-3,-2,-4},
    {-1,1,0,0,-3,5,2,-2,0,-3,-2,1,0,-3,-1,0,-1,-2,-1,-2,0,3,-1,-4},
    {-1,0,0,2,-4,2,5,-2,0,-3,-3,1,-2,-3,-1,0,-1,-3,-2,-2,1,4,-1,-4},
    {0,-2,0,-1,-3,-2,-2,6,-2,-4,-4,-2,-3,-3,-2,0,-2,-2,-3,-3,-1,-2,-1,-4},
    {-2,0,1,-1,-3,0,0,-2,8,-3,-3,-1,-2,-1,-2,-1,-2,-2,2,-3,0,0,-1,-4},
    {-1,-3,-3,-3,-1,-3,-3,-4,-3,4,2,-3,1,0,-3,-2,-1,-3,-1,3,-3,-3,-1,-4},
    {-1,-2,-3,-4,-1,-2,-3,-4,-3,2,4,-2,2,0,-3,-2,-1,-2,-1,1,-4,-3,-1,-4},
    {-1,2,0,-1,-3,1,1,-2,-1,-3,-2,5,-1,-3,-1,0,-1,-3,-2,-2,0,1,-1,-4},
    {-1,-1,-2,-3,-1,0,-2,-3,-2,1,2,-1,5,0,-2,-1,-1,-1,-1,1,-3,-1,-1,-4},
    {-2,-3,-3,-3,-2,-3,-3,-3,-1,0,0,-3,0,6,-4,-2,-2,1,3,-1,-3,-3,-1,-4},
    {-1,-2,-2,-1,-3,-1,-1,-2,-2,-3,-3,-1,-2,-4,7,-1,-1,-4,-3,-2,-2,-1,-2,-4},
    {1,-1,1,0,-1,0,0,0,-1,-2,-2,0,-1,-2,-1,4,1,-3,-2,-2,0,0,0,-4},
    {0,-1,0,-1,-1,-1,-1,-2,-2,-1,-1,-1,-1,-2,-1,1,5,-2,-2,0,-1,-1,0,-4},
    {-3,-3,-4,-4,-2,-2,-3,-2,-2,-3,-2,-3,-1,1,-4,-3,-2,11,2,-3,-4,-3,-2,-4},
    {-2,-2,-2,-3,-2,-1,-2,-3,2,-1,-1,-2,-1,3,-3,-2,-2,2,7,-1,-3,-2,-1,-4},
    {0,-3,-3,-3,-1,-2,-2,-3,-3,3,1,-2,1,-1,-2,-2,0,-3,-1,4,-3,-2,-1,-4},
    {-2,-1,3,4,-3,0,1,-1,0,-3,-4,0,-3,-3,-2,0,-1,-4,-3,-3,4,1,-1,-4},
    {-1,0,0,1,-3,3,4,-2,0,-3,-3,1,-1,-3,-1,0,-1,-3,-2,-2,1,4,-1,-4},
    {0,-1,-1,-1,-2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-2,0,0,-2,-1,-1,-1,-1,-1,-4},
    {-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,1},
};

// unknown letters map to X (sequence_alignment.rs:669-679)
std::vector<int> seq_to_index(const std::string& seq) {
  int lut[256];
  for (int i = 0; i < 256; ++i) lut[i] = 22;  // 'X'
  for (int i = 0; i < 24; ++i) lut[(unsigned char)kLetters[i]] = i;
  std::vector<int> out(seq.size());
  for (size_t i = 0; i < seq.size(); ++i) out[i] = lut[(unsigned char)seq[i]];
  return out;
}

struct AlignOut {
  std::string a1, a2;
  float score = 0.0f;
};

// retain_all reconstruction shared by both engines
// (sequence_alignment.rs:469-550): unaligned termini re-attached with '-'.
AlignOut reconstruct(const std::string& s1, const std::string& s2,
                     const std::vector<int64_t>& r1,
                     const std::vector<int64_t>& r2, float score, int mode,
                     bool retain_all) {
  AlignOut out;
  out.score = score;
  int64_t start1 = -1, start2 = -1, end1 = -1, end2 = -1;
  std::string m1, m2;
  m1.reserve(r1.size());
  m2.reserve(r2.size());
  for (int64_t v : r1) {
    if (v > -1) {
      if (start1 < 0) start1 = v;
      m1.push_back(s1[v]);
      end1 = v;
    } else {
      m1.push_back('-');
    }
  }
  for (int64_t v : r2) {
    if (v > -1) {
      if (start2 < 0) start2 = v;
      m2.push_back(s2[v]);
      end2 = v;
    } else {
      m2.push_back('-');
    }
  }
  if (mode == ALIGN_LOCAL && !retain_all) {
    out.a1 = m1;
    out.a2 = m2;
    return out;
  }
  if (start1 < 0 || start2 < 0) {  // nothing aligned (rs:512-524)
    out.a1 = s1 + std::string(s2.size(), '-');
    out.a2 = std::string(s1.size(), '-') + s2;
    return out;
  }
  out.a1 = s1.substr(0, start1) + std::string(start2, '-') + m1 +
           s1.substr(end1 + 1) + std::string(s2.size() - end2 - 1, '-');
  out.a2 = std::string(start1, '-') + s2.substr(0, start2) + m2 +
           std::string(s1.size() - end1 - 1, '-') + s2.substr(end2 + 1);
  return out;
}

// ---------------------------------------------------------------------------
// CellEngine: structural mirror of the Rust engine.
// ---------------------------------------------------------------------------

struct ScoringMatrixV {  // virtual dispatch like Box<dyn ScoringMatrix>
  virtual float get_score(int a, int b) const = 0;
  virtual ~ScoringMatrixV() = default;
};
struct B62Matrix : ScoringMatrixV {
  std::vector<std::vector<float>> scores;  // Vec<Vec<f32>> like rs:629
  B62Matrix() {
    scores.assign(24, std::vector<float>(24));
    for (int i = 0; i < 24; ++i)
      for (int j = 0; j < 24; ++j) scores[i][j] = (float)kB62[i][j];
  }
  float get_score(int a, int b) const override { return scores[a][b]; }
};

struct Cell {  // SWCell{scores:Vec<f32>, prev:Vec<usize>} (rs:556-566)
  std::vector<float> scores{0.f, 0.f, 0.f};
  std::vector<int> prev{0, 0, 0};
};

class CellEngine {
 public:
  CellEngine(float go, float ge, int mode)
      : og_(go > 0 ? -go : go), eg_(ge > 0 ? -ge : ge), mode_(mode),
        sm_(new B62Matrix()) {}

  AlignOut align(const std::string& s1, const std::string& s2,
                 bool retain_all) {
    auto seq1 = seq_to_index(s1);
    auto seq2 = seq_to_index(s2);
    fill(seq1, seq2);
    std::vector<int64_t> r1, r2;
    float score = backtrack(r1, r2);
    return reconstruct(s1, s2, r1, r2, score, mode_, retain_all);
  }

 private:
  float og_, eg_;
  int mode_;
  std::unique_ptr<ScoringMatrixV> sm_;
  std::vector<std::vector<Cell>> cells_;
  size_t la_ = 0, lb_ = 0;

  void fill(const std::vector<int>& seq1, const std::vector<int>& seq2) {
    la_ = seq1.size();
    lb_ = seq2.size();
    // grow-only buffer reuse (rs:67-71)
    if (cells_.size() < la_ + 1 || cells_.empty() ||
        cells_[0].size() < lb_ + 1) {
      cells_.assign(la_ + 1, std::vector<Cell>(lb_ + 1));
    }
    const float sog = mode_ == ALIGN_GLOBAL ? og_ : 0.0f;
    const float seg = mode_ == ALIGN_GLOBAL ? eg_ : 0.0f;
    for (size_t ii = 0; ii <= la_; ++ii) {
      for (size_t jj = 0; jj <= lb_; ++jj) {
        Cell& c = cells_[ii][jj];
        if (ii == 0 && jj == 0) {  // rs:88-93
          c.scores = {0.0f, -1.0f, -1.0f};
          c.prev = {MATCH, MATCH, MATCH};
          continue;
        }
        if (ii == 0) {  // rs:100-108
          float ls = (float)jj * seg + (sog - seg);
          float bad = ls + 10.0f * og_ + 10.0f * eg_;
          c.scores = {bad, ls, bad};
          c.prev = {GAPINX, GAPINX, GAPINX};
          continue;
        }
        if (jj == 0) {  // rs:109-117
          float ls = (float)ii * seg + (sog - seg);
          float bad = ls + 10.0f * og_ + 10.0f * eg_;
          c.scores = {bad, bad, ls};
          c.prev = {GAPINY, GAPINY, GAPINY};
          continue;
        }
        const Cell& lt = cells_[ii - 1][jj - 1];
        const Cell& l = cells_[ii - 1][jj];
        const Cell& t = cells_[ii][jj - 1];
        const float mm = sm_->get_score(seq1[ii - 1], seq2[jj - 1]);

        float ms;
        int mi;  // rs:139-158: M >= X >= Y
        if (lt.scores[MATCH] >= lt.scores[GAPINX]) {
          if (lt.scores[MATCH] >= lt.scores[GAPINY]) {
            ms = lt.scores[MATCH];
            mi = MATCH;
          } else {
            ms = lt.scores[GAPINY];
            mi = GAPINY;
          }
        } else if (lt.scores[GAPINX] >= lt.scores[GAPINY]) {
          ms = lt.scores[GAPINX];
          mi = GAPINX;
        } else {
          ms = lt.scores[GAPINY];
          mi = GAPINY;
        }
        ms += mm;

        float xs, ys;
        int xi, yi;
        if (mode_ != ALIGN_LOCAL) {  // rs:164-211
          const float po = la_ - ii == 0 ? sog : og_;
          const float pe = la_ - ii == 0 ? seg : eg_;
          const float qo = lb_ - jj == 0 ? sog : og_;
          const float qe = lb_ - jj == 0 ? seg : eg_;
          if (t.scores[MATCH] + po > t.scores[GAPINX] + pe) {
            if (t.scores[MATCH] >= t.scores[GAPINY]) {
              xs = t.scores[MATCH] + po;
              xi = MATCH;
            } else {
              xs = t.scores[GAPINY] + po;
              xi = GAPINY;
            }
          } else if (t.scores[GAPINX] + pe >= t.scores[GAPINY] + po) {
            xs = t.scores[GAPINX] + pe;
            xi = GAPINX;
          } else {
            xs = t.scores[GAPINY] + po;
            xi = GAPINY;
          }
          if (l.scores[MATCH] + qo > l.scores[GAPINY] + qe) {
            if (l.scores[MATCH] >= l.scores[GAPINX]) {
              ys = l.scores[MATCH] + qo;
              yi = MATCH;
            } else {
              ys = l.scores[GAPINX] + qo;
              yi = GAPINX;
            }
          } else if (l.scores[GAPINY] + qe >= l.scores[GAPINX] + qo) {
            ys = l.scores[GAPINY] + qe;
            yi = GAPINY;
          } else {
            ys = l.scores[GAPINX] + qo;
            yi = GAPINX;
          }
        } else {  // rs:213-253
          if (t.scores[MATCH] + og_ >= t.scores[GAPINX] + eg_) {
            if (t.scores[MATCH] > t.scores[GAPINY]) {
              xs = t.scores[MATCH] + og_;
              xi = MATCH;
            } else {
              xs = t.scores[GAPINY] + og_;
              xi = GAPINY;
            }
          } else if (t.scores[GAPINX] + eg_ > t.scores[GAPINY] + og_) {
            xs = t.scores[GAPINX] + eg_;
            xi = GAPINX;
          } else {
            xs = t.scores[GAPINY] + og_;
            xi = GAPINY;
          }
          if (l.scores[MATCH] + og_ >= l.scores[GAPINY] + eg_) {
            if (l.scores[MATCH] > l.scores[GAPINX]) {
              ys = l.scores[MATCH] + og_;
              yi = MATCH;
            } else {
              ys = l.scores[GAPINX] + og_;
              yi = GAPINX;
            }
          } else if (l.scores[GAPINY] + eg_ > l.scores[GAPINX] + og_) {
            ys = l.scores[GAPINY] + eg_;
            yi = GAPINY;
          } else {
            ys = l.scores[GAPINX] + og_;
            yi = GAPINX;
          }
        }
        if (mode_ == ALIGN_LOCAL) {  // rs:256-260
          if (ms < 0) ms = 0;
          if (xs < 0) xs = 0;
          if (ys < 0) ys = 0;
        }
        c.scores[MATCH] = ms;
        c.scores[GAPINX] = xs;
        c.scores[GAPINY] = ys;
        c.prev[MATCH] = mi;
        c.prev[GAPINX] = xi;
        c.prev[GAPINY] = yi;
      }
    }
  }

  float backtrack(std::vector<int64_t>& r1, std::vector<int64_t>& r2) {
    int64_t sx = -1, sy = -1;
    float maxscore;
    int place;
    if (mode_ == ALIGN_LOCAL) {  // rs:282-295: row-major strict >, M only
      maxscore = 0.0f;
      for (size_t ii = 0; ii <= la_; ++ii)
        for (size_t jj = 0; jj <= lb_; ++jj)
          if (cells_[ii][jj].scores[MATCH] > maxscore) {
            maxscore = cells_[ii][jj].scores[MATCH];
            sx = (int64_t)ii;
            sy = (int64_t)jj;
          }
      place = MATCH;
    } else {  // rs:296-309
      sx = (int64_t)la_;
      sy = (int64_t)lb_;
      const Cell& c = cells_[la_][lb_];
      maxscore = c.scores[0];
      place = 0;
      for (int k = 1; k < 3; ++k)
        if (maxscore < c.scores[k]) {
          maxscore = c.scores[k];
          place = k;
        }
    }
    if (sx < 0) return 0.0f;
    size_t cx = (size_t)sx, cy = (size_t)sy;
    int direc = place;
    while (true) {  // rs:352-383
      int prev = cells_[cx][cy].prev[direc];
      if (mode_ == ALIGN_LOCAL && cells_[cx][cy].scores[direc] == 0.0f) break;
      if (direc == MATCH) {
        r1.push_back((int64_t)cx - 1);
        r2.push_back((int64_t)cy - 1);
        --cx;
        --cy;
      } else if (direc == GAPINX) {
        r1.push_back(-1);
        r2.push_back((int64_t)cy - 1);
        --cy;
      } else {
        r1.push_back((int64_t)cx - 1);
        r2.push_back(-1);
        --cx;
      }
      if (cx == 0 && cy == 0) break;
      direc = prev;
    }
    std::reverse(r1.begin(), r1.end());
    std::reverse(r2.begin(), r2.end());
    return maxscore;
  }
};

// ---------------------------------------------------------------------------
// FlatEngine: same algorithm, flat buffers, direct table — the upper bound.
// ---------------------------------------------------------------------------

class FlatEngine {
 public:
  FlatEngine(float go, float ge, int mode)
      : og_(go > 0 ? -go : go), eg_(ge > 0 ? -ge : ge), mode_(mode) {
    for (int i = 0; i < 24; ++i)
      for (int j = 0; j < 24; ++j) tab_[i * 24 + j] = (float)kB62[i][j];
  }

  AlignOut align(const std::string& s1, const std::string& s2,
                 bool retain_all) {
    auto seq1 = seq_to_index(s1);
    auto seq2 = seq_to_index(s2);
    fill(seq1, seq2);
    std::vector<int64_t> r1, r2;
    float score = backtrack(r1, r2);
    return reconstruct(s1, s2, r1, r2, score, mode_, retain_all);
  }

 private:
  float og_, eg_;
  int mode_;
  float tab_[24 * 24];
  // row-major (la+1) x (lb+1); three planes interleaved per cell
  std::vector<float> sc_;   // 3 floats per cell
  std::vector<uint8_t> pv_;  // packed prev: bits 0-1 M, 2-3 X, 4-5 Y
  size_t la_ = 0, lb_ = 0, stride_ = 0;
  float best_ = 0.0f;
  size_t bi_ = 0, bj_ = 0;

  inline void setcell(size_t i, size_t j, float m, float x, float y, int mi,
                      int xi, int yi) {
    float* p = &sc_[(i * stride_ + j) * 3];
    p[0] = m;
    p[1] = x;
    p[2] = y;
    pv_[i * stride_ + j] = (uint8_t)(mi | (xi << 2) | (yi << 4));
  }

  void fill(const std::vector<int>& seq1, const std::vector<int>& seq2) {
    la_ = seq1.size();
    lb_ = seq2.size();
    stride_ = lb_ + 1;
    size_t need = (la_ + 1) * stride_;
    if (sc_.size() < need * 3) {  // grow-only reuse (rs:67-71)
      sc_.resize(need * 3);
      pv_.resize(need);
    }
    const float sog = mode_ == ALIGN_GLOBAL ? og_ : 0.0f;
    const float seg = mode_ == ALIGN_GLOBAL ? eg_ : 0.0f;
    const float bad0 = 10.0f * og_ + 10.0f * eg_;
    const bool local = mode_ == ALIGN_LOCAL;
    best_ = 0.0f;
    bi_ = bj_ = 0;

    setcell(0, 0, 0.0f, -1.0f, -1.0f, MATCH, MATCH, MATCH);
    for (size_t jj = 1; jj <= lb_; ++jj) {
      float ls = (float)jj * seg + (sog - seg);
      setcell(0, jj, ls + bad0, ls, ls + bad0, GAPINX, GAPINX, GAPINX);
    }
    for (size_t ii = 1; ii <= la_; ++ii) {
      float ls = (float)ii * seg + (sog - seg);
      setcell(ii, 0, ls + bad0, ls + bad0, ls, GAPINY, GAPINY, GAPINY);
      const float* rowu = &sc_[((ii - 1) * stride_) * 3];
      float* rowc = &sc_[(ii * stride_) * 3];
      uint8_t* pvrow = &pv_[ii * stride_];
      const float* srow = &tab_[seq1[ii - 1] * 24];
      const bool lastrow = (ii == la_);
      // left neighbor state carried in registers
      float lm = rowc[0], lx = rowc[1], ly = rowc[2];
      for (size_t jj = 1; jj <= lb_; ++jj) {
        const float* lt = &rowu[(jj - 1) * 3];
        const float* t = &rowu[jj * 3];
        const float mm = srow[seq2[jj - 1]];
        float ms;
        int mi;
        if (lt[MATCH] >= lt[GAPINX]) {
          if (lt[MATCH] >= lt[GAPINY]) {
            ms = lt[MATCH];
            mi = MATCH;
          } else {
            ms = lt[GAPINY];
            mi = GAPINY;
          }
        } else if (lt[GAPINX] >= lt[GAPINY]) {
          ms = lt[GAPINX];
          mi = GAPINX;
        } else {
          ms = lt[GAPINY];
          mi = GAPINY;
        }
        ms += mm;
        float xs, ys;
        int xi, yi;
        if (!local) {
          // GAPINX advances seq2 only: sources the LEFT cell (ii, jj-1)
          // (reference cel_t) carried in registers; end-gap penalties
          // switch on the LAST ROW (seqlen_a-ii == 0, rs:166-167).
          const float po = lastrow ? sog : og_;
          const float pe = lastrow ? seg : eg_;
          // GAPINY advances seq1 only: sources the TOP cell (ii-1, jj)
          // (reference cel_l); penalties switch on the LAST COLUMN
          // (seqlen_b-jj == 0, rs:169-170).
          const float qo = (jj == lb_) ? sog : og_;
          const float qe = (jj == lb_) ? seg : eg_;
          if (lm + po > lx + pe) {
            if (lm >= ly) {
              xs = lm + po;
              xi = MATCH;
            } else {
              xs = ly + po;
              xi = GAPINY;
            }
          } else if (lx + pe >= ly + po) {
            xs = lx + pe;
            xi = GAPINX;
          } else {
            xs = ly + po;
            xi = GAPINY;
          }
          if (t[MATCH] + qo > t[GAPINY] + qe) {
            if (t[MATCH] >= t[GAPINX]) {
              ys = t[MATCH] + qo;
              yi = MATCH;
            } else {
              ys = t[GAPINX] + qo;
              yi = GAPINX;
            }
          } else if (t[GAPINY] + qe >= t[GAPINX] + qo) {
            ys = t[GAPINY] + qe;
            yi = GAPINY;
          } else {
            ys = t[GAPINX] + qo;
            yi = GAPINX;
          }
        } else {
          if (lm + og_ >= lx + eg_) {
            if (lm > ly) {
              xs = lm + og_;
              xi = MATCH;
            } else {
              xs = ly + og_;
              xi = GAPINY;
            }
          } else if (lx + eg_ > ly + og_) {
            xs = lx + eg_;
            xi = GAPINX;
          } else {
            xs = ly + og_;
            xi = GAPINY;
          }
          if (t[MATCH] + og_ >= t[GAPINY] + eg_) {
            if (t[MATCH] > t[GAPINX]) {
              ys = t[MATCH] + og_;
              yi = MATCH;
            } else {
              ys = t[GAPINX] + og_;
              yi = GAPINX;
            }
          } else if (t[GAPINY] + eg_ > t[GAPINX] + og_) {
            ys = t[GAPINY] + eg_;
            yi = GAPINY;
          } else {
            ys = t[GAPINX] + og_;
            yi = GAPINX;
          }
        }
        if (local) {
          if (ms < 0) ms = 0;
          if (xs < 0) xs = 0;
          if (ys < 0) ys = 0;
          if (ms > best_) {  // row-major strict > matches rs:286-294
            best_ = ms;
            bi_ = ii;
            bj_ = jj;
          }
        }
        float* c = &rowc[jj * 3];
        c[0] = ms;
        c[1] = xs;
        c[2] = ys;
        pvrow[jj] = (uint8_t)(mi | (xi << 2) | (yi << 4));
        lm = ms;
        lx = xs;
        ly = ys;
      }
    }
  }

  float backtrack(std::vector<int64_t>& r1, std::vector<int64_t>& r2) {
    size_t cx, cy;
    int direc;
    float maxscore;
    if (mode_ == ALIGN_LOCAL) {
      if (best_ <= 0.0f) return 0.0f;
      maxscore = best_;
      cx = bi_;
      cy = bj_;
      direc = MATCH;
    } else {
      cx = la_;
      cy = lb_;
      const float* c = &sc_[(cx * stride_ + cy) * 3];
      maxscore = c[0];
      direc = 0;
      for (int k = 1; k < 3; ++k)
        if (maxscore < c[k]) {
          maxscore = c[k];
          direc = k;
        }
    }
    while (true) {
      const size_t off = cx * stride_ + cy;
      int prev = (pv_[off] >> (2 * direc)) & 3;
      if (mode_ == ALIGN_LOCAL && sc_[off * 3 + direc] == 0.0f) break;
      if (direc == MATCH) {
        r1.push_back((int64_t)cx - 1);
        r2.push_back((int64_t)cy - 1);
        --cx;
        --cy;
      } else if (direc == GAPINX) {
        r1.push_back(-1);
        r2.push_back((int64_t)cy - 1);
        --cy;
      } else {
        r1.push_back((int64_t)cx - 1);
        r2.push_back(-1);
        --cx;
      }
      if (cx == 0 && cy == 0) break;
      direc = prev;
    }
    std::reverse(r1.begin(), r1.end());
    std::reverse(r2.begin(), r2.end());
    return maxscore;
  }
};

// ---------------------------------------------------------------------------

std::string read_first_fasta_seq(const std::string& path) {
  std::ifstream in(path);
  std::string line, seq;
  bool started = false;
  while (std::getline(in, line)) {
    if (!line.empty() && line[0] == '>') {
      if (started) break;
      started = true;
      continue;
    }
    for (char c : line)
      if (!isspace((unsigned char)c)) seq.push_back(c);
  }
  return seq;
}

struct Pair {
  std::string s1, s2;
};

template <class Engine>
double run_sweep(std::vector<Pair>& pairs, int mode, double* checksum,
                 std::vector<AlignOut>* outs, int reps) {
  double best = 1e30;
  for (int r = 0; r < reps; ++r) {
    Engine eng(10.0f, 0.5f, mode);
    double cs = 0.0;
    auto t0 = std::chrono::steady_clock::now();
    for (auto& p : pairs) {
      AlignOut o = eng.align(p.s1, p.s2, true);
      cs += o.score;
      if (outs && r == 0) outs->push_back(std::move(o));
    }
    double dt = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0)
                    .count();
    if (dt < best) best = dt;
    *checksum = cs;
  }
  return best;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr,
            "usage: refbench <ref_test_dir> <local|global|glocal|all>"
            " [--engine cell|flat|both] [--dump dir] [--reps N]\n");
    return 2;
  }
  std::string dir = argv[1];
  std::string modearg = argv[2];
  std::string engines = "both";
  std::string dumpdir;
  int reps = 1;
  for (int i = 3; i < argc; ++i) {
    if (!strcmp(argv[i], "--engine") && i + 1 < argc) engines = argv[++i];
    if (!strcmp(argv[i], "--dump") && i + 1 < argc) dumpdir = argv[++i];
    if (!strcmp(argv[i], "--reps") && i + 1 < argc) reps = atoi(argv[++i]);
  }

  std::ifstream list(dir + "/file_list.txt");
  if (!list) {
    fprintf(stderr, "cannot open %s/file_list.txt\n", dir.c_str());
    return 2;
  }
  std::vector<Pair> pairs;
  std::string line;
  uint64_t cells = 0;
  while (std::getline(list, line)) {
    std::istringstream ss(line);
    std::string f1, f2;
    if (!(ss >> f1 >> f2)) continue;
    Pair p{read_first_fasta_seq(dir + "/" + f1),
           read_first_fasta_seq(dir + "/" + f2)};
    cells += (uint64_t)p.s1.size() * p.s2.size();
    pairs.push_back(std::move(p));
  }

  std::vector<int> modes;
  if (modearg == "all")
    modes = {ALIGN_LOCAL, ALIGN_GLOBAL, ALIGN_GLOCAL};
  else if (modearg == "local")
    modes = {ALIGN_LOCAL};
  else if (modearg == "global")
    modes = {ALIGN_GLOBAL};
  else
    modes = {ALIGN_GLOCAL};
  const char* modename[] = {"global", "glocal", "local"};

  for (int mode : modes) {
    for (const std::string& eng : {std::string("cell"), std::string("flat")}) {
      if (engines != "both" && engines != eng) continue;
      double cs = 0.0;
      std::vector<AlignOut> outs;
      std::vector<AlignOut>* po = dumpdir.empty() ? nullptr : &outs;
      double dt = eng == "cell"
                      ? run_sweep<CellEngine>(pairs, mode, &cs, po, reps)
                      : run_sweep<FlatEngine>(pairs, mode, &cs, po, reps);
      printf(
          "{\"engine\": \"%s\", \"mode\": \"%s\", \"pairs\": %zu, "
          "\"cells\": %llu, \"seconds\": %.4f, \"mcups\": %.1f, "
          "\"score_checksum\": %.1f}\n",
          eng.c_str(), modename[mode], pairs.size(),
          (unsigned long long)cells, dt, cells / dt / 1e6, cs);
      fflush(stdout);
      if (po) {
        std::ofstream out(dumpdir + "/" + eng + "_" + modename[mode] +
                          ".txt");
        for (size_t i = 0; i < outs.size(); ++i)
          out << "#pair " << i << " score " << outs[i].score << "\n"
              << outs[i].a1 << "\n"
              << outs[i].a2 << "\n";
      }
    }
  }
  return 0;
}
