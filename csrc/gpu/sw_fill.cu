// Batched 3-state affine-gap DP fill for Hopper, called from JAX through the
// XLA foreign function interface (smithwaterman_tpu/ops/cuda_fill.py).
//
// One warp owns one pair.  Rows are taken in strips of 32, one row per lane;
// inside a strip the warp sweeps a wavefront across the columns: at step t
// lane l fills cell (i, j) = (base + l + 1, t - l + 1).  The values of the row
// above come from lane l - 1 by __shfl_up_sync (computed one step earlier),
// the diagonal is the up value of the previous step, and the X state's
// same-row dependence is carried in the lane's own registers.  Lane 0 reads
// the strip's top boundary (the previous strip's last row) from a per-pair
// row buffer in device memory, staged through a small shared-memory ring one
// 32-column chunk ahead.  There is no inter-block communication: blocks run
// in any order.
//
// Cell rules, tie-breaks, pointer packing and the stats row are those of
// ops/fill.py (the plain-JAX fill) and ops/scan_dp.py (the oracle):
//   * M from (i-1, j-1), ties M >= X >= Y;
//   * Y from (i-1, j), X from (i, j-1) with the LOCAL / non-LOCAL asymmetric
//     `>=` / `>` cascades; glocal frees the last row (X) and column (Y);
//   * LOCAL clamps at 0 and marks zero cells STOP (3);
//   * pointer byte = prev_m | prev_x << 2 | prev_y << 4, cell (i, j) at
//     tb[pair, i - 1, j - 1];
//   * stats row = [best, best_i, best_j, final_M, final_X, final_Y, 0, 0],
//     best position first in i-major / j-minor order.
// The X state is computed in the detrended prefix-max form the plain fill
// uses (running max of G(k) - k*pe, plus (j-1)*pe), so both fills perform
// the same operations.
//
// Two arithmetic domains: int32 in quarter units (integer tables with
// quarter-integer penalties: every value is exact, and Hopper's DPX
// instructions take the three-way max), and f32 with round-to-nearest
// intrinsics that stop the compiler from contracting into FMAs.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kGlobal = 0;
constexpr int kGlocal = 1;
constexpr int kLocal = 2;
constexpr int kStop = 3;
constexpr int kPairsPerBlock = 4;  // warps per block, one pair each
constexpr int kStatsW = 8;
constexpr unsigned kFull = 0xffffffffu;

// ---- arithmetic in the two domains -------------------------------------
__device__ __forceinline__ int add(int a, int b) { return a + b; }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int sub(int a, int b) { return a - b; }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ int mulk(int k, int v) { return k * v; }
__device__ __forceinline__ float mulk(int k, float v) {
  return __fmul_rn(static_cast<float>(k), v);
}
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmax3(int a, int b, int c) {
  return __vimax3_s32(a, b, c);
}
__device__ __forceinline__ float vmax3(float a, float b, float c) {
  return fmaxf(fmaxf(a, b), c);
}
template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<int>(int v) {
  return static_cast<float>(v) * 0.25f;  // quarter units, exact
}
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T unit();  // the value 1.0
template <> __device__ __forceinline__ int unit<int>() { return 4; }
template <> __device__ __forceinline__ float unit<float>() { return 1.0f; }
template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ int neg_inf<int>() { return INT_MIN / 2; }
template <> __device__ __forceinline__ float neg_inf<float>() { return -1.0e30f; }

// boundary score j*se + (so - se), the same two operations as the plain fill
template <typename T>
__device__ __forceinline__ T lsc(int k, T so, T se) {
  return add(mulk(k, se), sub(so, se));
}

template <typename T, int MODE, bool TB>
__global__ void __launch_bounds__(32 * kPairsPerBlock)
sw_fill_kernel(const int8_t* __restrict__ codes1,
               const int8_t* __restrict__ codes2,
               const int32_t* __restrict__ nvec,
               const int32_t* __restrict__ mvec,
               const T* __restrict__ table, int K, int B, int NP, int MP,
               T og, T eg, uint8_t* __restrict__ tb,
               float* __restrict__ stats, T* __restrict__ rowbuf) {
  extern __shared__ unsigned char smem_raw[];
  T* stab = reinterpret_cast<T*>(smem_raw);  // K*K table
  // per-warp ring of the strip's top boundary: 2 x 32 columns of (M, X, Y)
  // plus their seq2 codes
  __shared__ T ring[kPairsPerBlock][3][64];
  __shared__ int8_t ringc[kPairsPerBlock][64];

  for (int x = threadIdx.x; x < K * K; x += blockDim.x) stab[x] = table[x];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kPairsPerBlock + warp;
  if (p >= B) return;
  const int n = nvec[p];
  const int m = mvec[p];
  const int8_t* a = codes1 + static_cast<size_t>(p) * NP;
  const int8_t* b = codes2 + static_cast<size_t>(p) * MP;
  uint8_t* tbp = TB ? tb + static_cast<size_t>(p) * NP * MP : nullptr;
  T* rb = rowbuf + static_cast<size_t>(p) * MP * 3;
  T (*rg)[64] = ring[warp];
  int8_t* rgc = ringc[warp];

  const T zero = T(0);
  const T so = MODE == kGlobal ? og : zero;
  const T se = MODE == kGlobal ? eg : zero;
  const T sent = add(mulk(10, og), mulk(10, eg));

  T best = neg_inf<T>();
  int best_i = INT_MAX, best_j = INT_MAX;
  T fin_m = zero, fin_x = zero, fin_y = zero;

  for (int base = 0; base < n; base += 32) {
    const int rows = min(32, n - base);
    const int i = base + lane + 1;
    const bool row_ok = lane < rows;
    const T* trow = stab + (row_ok ? static_cast<int>(a[i - 1]) : 0) * K;
    const bool has_next = base + 32 < n;

    // top boundary chunk q (columns 32q+1 .. 32q+32) into lane registers:
    // closed-form row 0 for the first strip, else the row buffer
    T pm = zero, px = zero, py = zero;
    int pc = 0;
    auto fetch = [&](int q) {
      const int c = 32 * q + lane + 1;
      if (c <= m) {
        pc = b[c - 1];
        if (base == 0) {
          const T l = lsc(c, so, se);
          pm = add(l, sent);
          px = l;
          py = add(l, sent);
        } else {
          pm = rb[3 * (c - 1)];
          px = rb[3 * (c - 1) + 1];
          py = rb[3 * (c - 1) + 2];
        }
      }
    };
    auto stage = [&](int q) {
      const int s = (q & 1) * 32 + lane;
      rg[0][s] = pm;
      rg[1][s] = px;
      rg[2][s] = py;
      rgc[s] = static_cast<int8_t>(pc);
    };
    __syncwarp();  // previous strip's row-buffer writes and ring reads done
    fetch(0);
    stage(0);
    __syncwarp();

    // left neighbour (i, 0), diagonal (i-1, 0): closed-form boundary column
    const T l_i = lsc(i, so, se);
    T ml = add(l_i, sent), xl = add(l_i, sent), yl = l_i;
    T md, xd, yd;
    if (i == 1) {
      md = zero;
      xd = -unit<T>();
      yd = -unit<T>();
    } else {
      const T l_im1 = lsc(i - 1, so, se);
      md = add(l_im1, sent);
      xd = md;
      yd = l_im1;
    }
    T po = og, pe = eg;
    if (MODE != kLocal && i == n) {
      po = so;
      pe = se;
    }
    // X prefix max, detrended: cmax = max_k<j (G(k) - k*pe); X(1) = H(0)
    const T x0b = add(l_i, sent);
    T cmax = vmax(add(vmax(add(l_i, sent), l_i), po), add(x0b, pe));

    T om = zero, ox = zero, oy = zero;  // this lane's last cell, passed down
    int oc = 0;
    uint32_t word = 0;
    const int steps = m + rows - 1;
    for (int t = 0; t < steps; ++t) {
      if ((t & 31) == 0) fetch((t >> 5) + 1);
      T um = __shfl_up_sync(kFull, om, 1);
      T ux = __shfl_up_sync(kFull, ox, 1);
      T uy = __shfl_up_sync(kFull, oy, 1);
      int code = __shfl_up_sync(kFull, oc, 1);
      if (lane == 0 && t < m) {
        const int s = t & 63;
        um = rg[0][s];
        ux = rg[1][s];
        uy = rg[2][s];
        code = rgc[s];
      }
      const int j = t - lane + 1;
      if (row_ok && j >= 1 && j <= m) {
        const T sub_s = trow[code];
        // M from the diagonal
        int prev_m = md >= xd ? (md >= yd ? 0 : 2) : (xd >= yd ? 1 : 2);
        T vm = add(vmax3(md, xd, yd), sub_s);
        // Y from above
        T vy;
        int prev_y;
        if (MODE == kLocal) {
          const T a1 = add(um, og), a2 = add(uy, eg), a3 = add(ux, og);
          const bool c1 = a1 >= a2, c2 = um > ux, c3 = a2 > a3;
          vy = c1 ? (c2 ? a1 : a3) : (c3 ? a2 : a3);
          prev_y = c1 ? (c2 ? 0 : 1) : (c3 ? 2 : 1);
        } else {
          const bool lastc = j == m;
          const T qo = lastc ? so : og, qe = lastc ? se : eg;
          const T a1 = add(um, qo), a2 = add(uy, qe), a3 = add(ux, qo);
          const bool c1 = a1 > a2, c2 = um >= ux, c3 = a2 >= a3;
          vy = vmax3(a1, a2, a3);
          prev_y = c1 ? (c2 ? 0 : 1) : (c3 ? 2 : 1);
        }
        if (MODE == kLocal) {
          vm = vmax(vm, zero);
          vy = vmax(vy, zero);
        }
        // X from the left: fold G(j-1) into the running max
        if (j >= 2) {
          const T g = add(vmax(ml, yl), po);
          cmax = vmax(cmax, sub(g, mulk(j - 1, pe)));
        }
        T vx = add(cmax, mulk(j - 1, pe));
        if (MODE == kLocal) vx = vmax(vx, zero);
        int prev_x;
        if (MODE == kLocal) {
          const bool d1 = add(ml, og) >= add(xl, eg);
          const bool d2 = ml > yl;
          const bool d3 = add(xl, eg) > add(yl, og);
          prev_x = d1 ? (d2 ? 0 : 2) : (d3 ? 1 : 2);
        } else {
          const bool d1 = add(ml, po) > add(xl, pe);
          const bool d2 = ml >= yl;
          const bool d3 = add(xl, pe) >= add(yl, po);
          prev_x = d1 ? (d2 ? 0 : 2) : (d3 ? 1 : 2);
        }
        if (MODE == kLocal) {
          if (vm == zero) prev_m = kStop;
          if (vx == zero) prev_x = kStop;
          if (vy == zero) prev_y = kStop;
          if (vm > best) {
            best = vm;
            best_i = i;
            best_j = j;
          }
        } else if (i == n && j == m) {
          fin_m = vm;
          fin_x = vx;
          fin_y = vy;
        }
        if (TB) {
          const int sh = ((j - 1) & 3) * 8;
          word |= static_cast<uint32_t>(prev_m | (prev_x << 2) | (prev_y << 4))
                  << sh;
          if (sh == 24 || j == m) {
            *reinterpret_cast<uint32_t*>(
                tbp + static_cast<size_t>(i - 1) * MP + ((j - 1) & ~3)) = word;
            word = 0;
          }
        }
        if (has_next && lane == 31) {
          rb[3 * (j - 1)] = vm;
          rb[3 * (j - 1) + 1] = vx;
          rb[3 * (j - 1) + 2] = vy;
        }
        md = um;
        xd = ux;
        yd = uy;
        ml = vm;
        xl = vx;
        yl = vy;
        om = vm;
        ox = vx;
        oy = vy;
      }
      oc = code;
      if ((t & 31) == 31) {
        stage((t >> 5) + 1);
        __syncwarp();
      }
    }
  }

  if (MODE == kLocal) {
    // first maximum in i-major order; rows are distinct across lanes
    for (int off = 16; off > 0; off >>= 1) {
      const T ob = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, best_i, off);
      const int oj = __shfl_xor_sync(kFull, best_j, off);
      if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
        best_j = oj;
      }
    }
  } else {
    const int src = (n - 1) & 31;
    fin_m = __shfl_sync(kFull, fin_m, src);
    fin_x = __shfl_sync(kFull, fin_x, src);
    fin_y = __shfl_sync(kFull, fin_y, src);
  }
  if (lane == 0) {
    float* st = stats + static_cast<size_t>(p) * kStatsW;
    const bool local = MODE == kLocal;
    st[0] = local ? to_f32(best) : 0.0f;
    st[1] = local ? static_cast<float>(best_i) : 0.0f;
    st[2] = local ? static_cast<float>(best_j) : 0.0f;
    st[3] = local ? 0.0f : to_f32(fin_m);
    st[4] = local ? 0.0f : to_f32(fin_x);
    st[5] = local ? 0.0f : to_f32(fin_y);
    st[6] = 0.0f;
    st[7] = 0.0f;
  }
}

template <typename T, int MODE, bool TB>
cudaError_t launch_one(cudaStream_t stream, const int8_t* c1, const int8_t* c2,
                       const int32_t* n, const int32_t* m, const T* table,
                       int K, int B, int NP, int MP, T og, T eg, uint8_t* tb,
                       float* stats, T* rowbuf) {
  const int grid = (B + kPairsPerBlock - 1) / kPairsPerBlock;
  const size_t smem = static_cast<size_t>(K) * K * sizeof(T);
  sw_fill_kernel<T, MODE, TB><<<grid, 32 * kPairsPerBlock, smem, stream>>>(
      c1, c2, n, m, table, K, B, NP, MP, og, eg, tb, stats, rowbuf);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_mode(bool traceback, cudaStream_t stream, const int8_t* c1,
                        const int8_t* c2, const int32_t* n, const int32_t* m,
                        const T* table, int K, int B, int NP, int MP, T og,
                        T eg, uint8_t* tb, float* stats, T* rowbuf) {
  return traceback
             ? launch_one<T, MODE, true>(stream, c1, c2, n, m, table, K, B, NP,
                                         MP, og, eg, tb, stats, rowbuf)
             : launch_one<T, MODE, false>(stream, c1, c2, n, m, table, K, B,
                                          NP, MP, og, eg, tb, stats, rowbuf);
}

template <typename T>
ffi::Error fill_impl(cudaStream_t stream, ffi::Buffer<ffi::S8> codes1,
                     ffi::Buffer<ffi::S8> codes2, ffi::Buffer<ffi::S32> n,
                     ffi::Buffer<ffi::S32> m, const T* table, int64_t K,
                     int32_t mode, bool traceback, T og, T eg, uint8_t* tb,
                     int64_t tb_size, ffi::Result<ffi::Buffer<ffi::F32>> stats,
                     T* rowbuf) {
  const auto d1 = codes1.dimensions();
  const auto d2 = codes2.dimensions();
  if (d1.size() != 2 || d2.size() != 2 || d1[0] != d2[0]) {
    return ffi::Error::InvalidArgument("codes must be (B, NP) and (B, MP)");
  }
  const int64_t B = d1[0], NP = d1[1], MP = d2[1];
  if (MP % 4 != 0) {
    return ffi::Error::InvalidArgument("MP must be a multiple of 4");
  }
  if (traceback && tb_size != B * NP * MP) {
    return ffi::Error::InvalidArgument("pointer buffer has the wrong size");
  }
  if (K * K * static_cast<int64_t>(sizeof(T)) > 48 * 1024) {
    return ffi::Error::InvalidArgument("scoring table too large");
  }
  if (B == 0) return ffi::Error::Success();
  const int8_t* c1 = codes1.typed_data();
  const int8_t* c2 = codes2.typed_data();
  const int32_t* np_ = n.typed_data();
  const int32_t* mp_ = m.typed_data();
  float* st = stats->typed_data();
  cudaError_t err;
  switch (mode) {
    case kGlobal:
      err = launch_mode<T, kGlobal>(traceback, stream, c1, c2, np_, mp_, table,
                                    K, B, NP, MP, og, eg, tb, st, rowbuf);
      break;
    case kGlocal:
      err = launch_mode<T, kGlocal>(traceback, stream, c1, c2, np_, mp_, table,
                                    K, B, NP, MP, og, eg, tb, st, rowbuf);
      break;
    case kLocal:
      err = launch_mode<T, kLocal>(traceback, stream, c1, c2, np_, mp_, table,
                                   K, B, NP, MP, og, eg, tb, st, rowbuf);
      break;
    default:
      return ffi::Error::InvalidArgument("unknown alignment mode");
  }
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

// int32 domain: table and penalties arrive in quarter units
ffi::Error FillI32(cudaStream_t stream, ffi::Buffer<ffi::S8> codes1,
                   ffi::Buffer<ffi::S8> codes2, ffi::Buffer<ffi::S32> n,
                   ffi::Buffer<ffi::S32> m, ffi::Buffer<ffi::S32> table,
                   int32_t mode, bool traceback, int32_t og, int32_t eg,
                   ffi::Result<ffi::Buffer<ffi::U8>> tb,
                   ffi::Result<ffi::Buffer<ffi::F32>> stats,
                   ffi::Result<ffi::Buffer<ffi::S32>> rowbuf) {
  return fill_impl<int>(stream, codes1, codes2, n, m, table.typed_data(),
                        table.dimensions()[0], mode, traceback, og, eg,
                        tb->typed_data(), tb->element_count(), stats,
                        rowbuf->typed_data());
}

ffi::Error FillF32(cudaStream_t stream, ffi::Buffer<ffi::S8> codes1,
                   ffi::Buffer<ffi::S8> codes2, ffi::Buffer<ffi::S32> n,
                   ffi::Buffer<ffi::S32> m, ffi::Buffer<ffi::F32> table,
                   int32_t mode, bool traceback, float og, float eg,
                   ffi::Result<ffi::Buffer<ffi::U8>> tb,
                   ffi::Result<ffi::Buffer<ffi::F32>> stats,
                   ffi::Result<ffi::Buffer<ffi::F32>> rowbuf) {
  return fill_impl<float>(stream, codes1, codes2, n, m, table.typed_data(),
                          table.dimensions()[0], mode, traceback, og, eg,
                          tb->typed_data(), tb->element_count(), stats,
                          rowbuf->typed_data());
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SwFillI32, FillI32,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("mode")
                                  .Attr<bool>("traceback")
                                  .Attr<int32_t>("og")
                                  .Attr<int32_t>("eg")
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(SwFillF32, FillF32,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Attr<int32_t>("mode")
                                  .Attr<bool>("traceback")
                                  .Attr<float>("og")
                                  .Attr<float>("eg")
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());
