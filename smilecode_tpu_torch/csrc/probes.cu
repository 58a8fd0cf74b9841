// The probe kernels P1-P4 (Hopper, sm_90a).
//
// Replace the toy kernels of the root probe scripts, which diagnose a TPU
// compiler fault on f32 iota arrays of 32x128 and 64x128 (rolls, row-slice
// sums, block maps, a floor division):
// - P1, roll: out = np.roll(X, -a, axis) on a 2-D array, axis 0 or 1, the
//   amount taken modulo the axis length (negative or >= the length too).
//   Serves _probe_prims.py:12 k1 (axis 0), :31 k1b (axis 1) and :50 k2
//   (static a = 3).
// - P2, row-window accumulate: out[r, :] = sum_{t=lo}^{hi-1} w(t) *
//   X[base + s*t + (0 if bcast else r), :] for r < n, with s in {0, 1},
//   w(t) in {1, t}, an empty sum where lo >= hi, and rows outside X
//   contributing 0. Serves _probe_prims.py:58 k3, _probe2.py:48 k7,
//   _probe3.py:18 k8a, :28 k8b, :44 k8d, :59 k8e, _probe4.py:11 k9, :26 k10.
// - P3, affine: out = alpha * X + beta over every row. Serves _probe2.py:10
//   k4 (1, 1) and :22 k5 (2, 0), whose loops over 16-row blocks cover all
//   rows of X.
// - P4, floor division and modulo of int32 values with Python's semantics:
//   out[0, i] = (t[i] // m) * m, out[1, i] = t[i] % m (C++ truncates: -3 / 8
//   is 0 and -3 % 8 is -3, Python gives -1 and 5). Serves _probe2.py:34 k6.
//
// Where a probe reads its amount or its bounds from SMEM (k1, k1b, k3, k6,
// k7, k8b, k8d, k8e), the kernel reads them on the device from an int32
// tensor, so a launch needs no copy to the host and no sync; a static value
// (k2, k8a, k9, k10) comes by value, the pointer then null.
//
// What bounds them on the H100: the launch. The probes' arrays are 16-32 KB,
// about 0.01 us of traffic at 3.35 TB/s against ~2 us for any launch, so
// what a call costs is its host side (kernels/_build.py:launch) and one
// launch. Each is written for arrays of any size as the card wants them
// read, 16 bytes a thread on neighbouring addresses, and is measured on
// one 160x192x160 volume too (chip_smoke.py phase 25, probe_ab.py):
// - P3 stores out as float4s from its first 16-byte boundary (a scalar
//   head and tail around them), loading x as float4s too where x is then
//   16-byte aligned and as four scalars where it is not (a view 4 bytes
//   off); one float4 a thread, so 64x128 is 8 blocks.
// - P1 along axis 0 moves whole rows: a row of a multiple of 4 floats with
//   x and out 16-byte aligned is copied as float4s, one a thread. Along
//   axis 1 a block stages a span of whole rows (about kStageTarget floats,
//   at most kRollTile; contiguous in x and in out) in shared memory with
//   float4 loads, at x's alignment, then writes out[r, c] = row[(c + a) mod
//   cols] as float4 stores, so both sides stay coalesced for any amount;
//   the shared reads are four scalars a thread (4-way bank conflicts, far
//   below the card's shared bandwidth at these sizes). Other rows (axis 0
//   unaligned, axis 1 wider than the tile) take one thread per element.
// - P2 has one instance per (stride, weighted, bcast), so no term branches
//   on them. With stride 1 (not bcast), on a grid of kWinStageBlocks tiles
//   or more, a block owns kWinRows output rows of kWinCols columns: it
//   stages the x rows their window reads in shared memory once (cp.async,
//   16 bytes a copy where x allows, zeros for rows outside x; a window
//   longer than the stage in chunks of t, the sums kept in registers), then
//   each thread adds the terms of 4 rows x 4 columns, reusing each float4
//   it reads for all 4 rows, and stores float4s. On a smaller grid (the
//   scripts' arrays) the stage's wait and barrier cost about a second round
//   trip to memory, so each thread loads its float4's rows straight from x,
//   eight terms' loads issued together. With bcast a thread sums one column
//   once and stores it to every row of its block; with stride 0 each output
//   holds one x value, loaded once into a register (float4s as P3).
// - P4 loads t and stores both rows of out as int4s (scalar heads and
//   tails as P3's; row 1 as four scalars where n is not a multiple of 4),
//   divides in 32 bits (the H100 has no integer divider: a 64-bit division
//   is a long chain) and steps the quotient down once where truncation
//   rounded towards 0; |m| = 1 gives (t, 0) (t / -1 overflows at -2^31).
//   Row 1's offset is 64-bit: 2n passes 2^31 on an 80 GB card.
// At these sizes a kernel's time is its chain of dependent steps, not its
// bytes, so each thread issues its loads before anything waits on one
// (four float4s a thread in a loop whose stores each waited on their load
// measured slower on the H100 than one a thread; probe_ab.py), every
// thread reads P1's amount and P2's bounds itself (one request a warp)
// rather than wait at a barrier for them, and index arithmetic is 32-bit
// where every index fits, with a 64-bit instance otherwise.
// Products and sums are rounded one at a time (__fmul_rn, __fadd_rn, no FMA
// contraction), in the plain versions' order, so each kernel equals its
// plain version bit for bit. Products of P4's int32 quotients wrap as
// torch's and JAX's int32 products do.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kRollTile = 4096;       // P1 axis 1: the most floats of whole rows a block stages
constexpr int kStageTarget = 1024;    // P1 axis 1: floats a block stages where rows allow
constexpr int kWinRows = 32;          // P2 staged: output rows a block owns, 4 a thread
constexpr int kWinCols = 128;         // P2 stride 1: columns a block owns, 4 a thread
constexpr int kWinStage = 64;         // P2 staged: x rows the stage holds
constexpr int kWinStageBlocks = 264;  // P2 stride 1: tiles of kWinRows rows that fill the card
constexpr int kDirectBatch = 8;       // P2 direct: terms whose loads issue together
constexpr int kDirectThreads = 128;   // P2 direct: threads a block, a row of kWinCols a warp
constexpr int kWinBcastRows = 64;     // P2 bcast: output rows a block stores
constexpr long long kNarrow = (1LL << 31) - 4 * kThreads;  // an int indexes fewer elements

long long ceil_div(long long n, long long d) { return (n + d - 1) / d; }

unsigned blocks_for(long long n, long long per_block = kThreads) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

// 4-byte values from p back to its 16-byte boundary (p 4-byte aligned)
template <typename T>
__host__ __device__ __forceinline__ int misalign4(const T* p) {
  return static_cast<int>((reinterpret_cast<unsigned long long>(p) / 4) % 4);
}

// P1's amount modulo n (n > 0), in [0, n), read by every thread as it
// starts (one request a warp).
__device__ __forceinline__ int roll_amount(const int* __restrict__ amount_ptr, int amount, int n) {
  const int a = (amount_ptr ? __ldg(amount_ptr) : amount) % n;
  return a < 0 ? a + n : a;
}

// P1, any axis and alignment: one thread per output element; I is int
// where every element index fits.
template <typename I>
__global__ void roll_kernel(const float* __restrict__ x, float* __restrict__ out, int rows,
                            int cols, int axis, const int* __restrict__ amount_ptr, int amount) {
  const int a = roll_amount(amount_ptr, amount, axis == 0 ? rows : cols);
  const I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<I>(rows) * cols) return;
  I r = i / cols, c = i - r * cols;
  if (axis == 0) {
    r += a;
    if (r >= rows) r -= rows;
  } else {
    c += a;
    if (c >= cols) c -= cols;
  }
  out[i] = x[r * cols + c];
}

// P1 along axis 0, rows of cols4 float4s, x and out 16-byte aligned: one
// float4 a thread.
template <typename I>
__global__ void roll_rows_vec_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                                     int rows, int cols4, const int* __restrict__ amount_ptr,
                                     int amount) {
  const int a = roll_amount(amount_ptr, amount, rows);
  const I v = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= static_cast<I>(rows) * cols4) return;
  const I r = v / cols4, c = v - r * cols4;
  out[v] = __ldg(x + (r + a < rows ? r + a : r + a - rows) * cols4 + c);
}

// P1 along axis 1: a block takes tile_rows whole rows (at most kRollTile
// floats, one contiguous span of x and of out). Every load of the stage is
// issued before the first shared store waits on one.
__global__ void roll_cols_staged_kernel(const float* __restrict__ x, float* __restrict__ out,
                                        int rows, int cols, int tile_rows,
                                        const int* __restrict__ amount_ptr, int amount) {
  constexpr int kStageVecs = (kRollTile / 4 + 1 + kThreads - 1) / kThreads;  // float4s a thread
  __shared__ __align__(16) float tile[kRollTile + 4];
  const int a = roll_amount(amount_ptr, amount, cols);
  const long long r0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const long long g0 = r0 * cols;
  const int len = static_cast<int>(min(static_cast<long long>(tile_rows), rows - r0) * cols);
  // x's span: element j at tile[xm + j], x's 16-byte boundaries on the tile's
  const int xm = misalign4(x + g0);
  const float* xs = x + g0 - xm;  // 16-byte aligned
  float4 staged[kStageVecs];
#pragma unroll
  for (int k = 0; k < kStageVecs; ++k) {
    const int j0 = 4 * (threadIdx.x + k * kThreads) - xm;
    if (j0 >= 0 && j0 + 4 <= len)
      staged[k] = __ldg(reinterpret_cast<const float4*>(xs) + threadIdx.x + k * kThreads);
  }
#pragma unroll
  for (int k = 0; k < kStageVecs; ++k) {
    const int v = threadIdx.x + k * kThreads;
    const int j0 = 4 * v - xm;
    if (j0 >= 0 && j0 + 4 <= len) {
      *reinterpret_cast<float4*>(tile + 4 * v) = staged[k];
    } else if (j0 + 4 > 0 && j0 < len) {  // the span's first or last, partial vector
      for (int e = 0; e < 4; ++e)
        if (j0 + e >= 0 && j0 + e < len) tile[4 * v + e] = __ldg(xs + 4 * v + e);
    }
  }
  __syncthreads();
  const int om = misalign4(out + g0);
  float* os = out + g0 - om;  // 16-byte aligned
  for (int v = threadIdx.x; v * 4 < len + om; v += kThreads) {
    const int j0 = 4 * v - om;
    int r = max(j0, 0) / cols, c = max(j0, 0) - r * cols;  // of the vector's first element out
    float val[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + k;
      if (j >= 0 && j < len) {
        const int cs = c + a < cols ? c + a : c + a - cols;
        val[k] = tile[xm + r * cols + cs];
        if (++c == cols) {
          c = 0;
          ++r;
        }
      }
    }
    if (j0 >= 0 && j0 + 4 <= len) {
      *reinterpret_cast<float4*>(os + 4 * v) = make_float4(val[0], val[1], val[2], val[3]);
    } else {
      for (int k = 0; k < 4; ++k)
        if (j0 + k >= 0 && j0 + k < len) os[4 * v + k] = val[k];
    }
  }
}

// P2's bounds: read by every thread as it starts (one request a warp)
// where they lie on the device.
__device__ __forceinline__ void window_bounds(const int* __restrict__ bounds_ptr, int& lo,
                                              int& hi) {
  if (bounds_ptr) {
    lo = __ldg(bounds_ptr);
    hi = __ldg(bounds_ptr + 1);
  }
}

// P2's term t of x value v: v, or v * t rounded (the plain version's
// v * float(t)).
template <bool kWeighted>
__device__ __forceinline__ float window_term(float v, int t) {
  return kWeighted ? __fmul_rn(v, static_cast<float>(t)) : v;
}

template <bool kWeighted>
__device__ __forceinline__ void window_add4(float4& acc, const float4& v, int t) {
  acc.x = __fadd_rn(acc.x, window_term<kWeighted>(v.x, t));
  acc.y = __fadd_rn(acc.y, window_term<kWeighted>(v.y, t));
  acc.z = __fadd_rn(acc.z, window_term<kWeighted>(v.z, t));
  acc.w = __fadd_rn(acc.w, window_term<kWeighted>(v.w, t));
}

// out[r, c0 .. c0 + 4) = v for the columns below ncols (c0 + 4 <= ncols and
// 16-byte aligned: one float4 store).
__device__ __forceinline__ void store4(float* __restrict__ p, int c0, int ncols, const float4& v) {
  if (c0 + 4 <= ncols && misalign4(p) == 0) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
    for (int k = 0; k < 4; ++k)
      if (c0 + k < ncols) p[k] = e[k];
  }
}

// kBytes (16 or 4) of x to shared memory with cp.async, zeros where
// src_bytes is 0 (src is then not read).
template <int kBytes>
__device__ __forceinline__ void stage_copy(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes));
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// P2, stride 1, not bcast, on a grid of fewer than kWinStageBlocks tiles:
// one of out's float4s (4 columns of one row) a thread, a block taking
// kDirectThreads / 32 rows (row tile b mod row_tiles) and kWinCols columns
// (column tile b / row_tiles). Each thread loads its rows base + t + r
// straight from x, kDirectBatch terms at a time, every load of a batch
// issued before the first add (float4s where kAligned, else scalars; 0 for
// rows outside x), and adds them in order of t: one round trip to memory
// for a window of up to kDirectBatch terms, no stage and no barrier.
template <bool kWeighted, bool kAligned, typename I>
__global__ void row_window_direct_kernel(const float* __restrict__ x, float* __restrict__ out,
                                         int rows, int cols, int n, int base, int row_tiles,
                                         const int* __restrict__ bounds_ptr, int lo, int hi) {
  window_bounds(bounds_ptr, lo, hi);
  constexpr int kRows = kDirectThreads / 32;
  const int r = static_cast<int>(blockIdx.x % row_tiles) * kRows + threadIdx.x / 32;
  const int c = static_cast<int>(blockIdx.x / row_tiles) * kWinCols + 4 * (threadIdx.x % 32);
  if (r >= n || c >= cols) return;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long t0 = lo; t0 < hi; t0 += kDirectBatch) {
    float4 v[kDirectBatch];
#pragma unroll
    for (int u = 0; u < kDirectBatch; ++u) {
      const long long row = base + t0 + u + r;
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (t0 + u < hi && row >= 0 && row < rows) {
        const float* p = x + static_cast<I>(row) * cols + c;
        if (kAligned) {
          v[u] = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          v[u].x = __ldg(p);
          if (c + 1 < cols) v[u].y = __ldg(p + 1);
          if (c + 2 < cols) v[u].z = __ldg(p + 2);
          if (c + 3 < cols) v[u].w = __ldg(p + 3);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kDirectBatch; ++u)
      if (t0 + u < hi) window_add4<kWeighted>(acc, v[u], static_cast<int>(t0 + u));
  }
  store4(out + static_cast<I>(r) * cols + c, c, cols, acc);
}

// P2, stride 1, not bcast, on kWinStageBlocks tiles or more: out[r] =
// sum_t w(t) x[base + t + r]. Block b owns kWinRows output rows from r0 =
// (b mod row_tiles) * kWinRows and kWinCols columns from c0 = (b /
// row_tiles) * kWinCols, so blocks that share x rows run side by side. Per
// chunk of terms it stages x rows base + lo + t0 + r0 + j (j < terms + tile
// rows - 1) of its columns in shared memory with cp.async, every copy
// issued before the wait: 16 bytes a copy where x is 16-byte aligned and
// cols a multiple of 4 (kAligned), else 4; zeros for rows outside x. Then
// thread (g, q) adds, for rows r0 + 4g + k (k < 4) and columns c0 + 4q ..
// + 3, stage row j = t - lo - t0 + 4g + k in order of t, each float4 it
// reads serving its four rows, and stores float4s.
template <bool kWeighted, bool kAligned, typename I>
__global__ void row_window_tile_kernel(const float* __restrict__ x, float* __restrict__ out,
                                       int rows, int cols, int n, int base, int row_tiles,
                                       const int* __restrict__ bounds_ptr, int lo, int hi) {
  constexpr int kUnit = kAligned ? 4 : 1;  // floats a copy moves
  constexpr int kRowCopies = kWinCols / kUnit;
  __shared__ __align__(16) float stage[kWinStage * kWinCols];
  window_bounds(bounds_ptr, lo, hi);
  const int r0 = static_cast<int>(blockIdx.x % row_tiles) * kWinRows;
  const int c0 = static_cast<int>(blockIdx.x / row_tiles) * kWinCols;
  const int tile_rows = min(kWinRows, n - r0), ncols = min(kWinCols, cols - c0);
  const int q = threadIdx.x % 32, g = threadIdx.x / 32;
  const long long width = static_cast<long long>(hi) - lo;  // terms (none where <= 0)
  const int chunk = kWinStage - tile_rows + 1;               // terms a stage serves
  float4 acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long t0 = 0; t0 < width; t0 += chunk) {
    const int terms = static_cast<int>(min(width - t0, static_cast<long long>(chunk)));
    const int srows = terms + tile_rows - 1;
    const long long row0 = static_cast<long long>(base) + lo + t0 + r0;  // x row of stage row 0
    if (t0 > 0) __syncthreads();  // the last chunk's reads are done
    for (int v = threadIdx.x; v < srows * kRowCopies; v += kThreads) {
      const int j = v / kRowCopies, e = (v - j * kRowCopies) * kUnit;
      const long long gr = row0 + j;
      const bool inside = gr >= 0 && gr < rows && e < ncols;
      stage_copy<4 * kUnit>(stage + j * kWinCols + e,
                            inside ? x + static_cast<I>(gr) * cols + c0 + e : x,
                            inside ? 4 * kUnit : 0);
    }
    stage_wait();
    __syncthreads();
    const int t_first = static_cast<int>(lo + t0);
    const int j_end = min(4 * g + 3 + terms, srows);
    for (int j = 4 * g; j < j_end; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(stage + j * kWinCols + 4 * q);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int tt = j - 4 * g - k;
        if (tt >= 0 && tt < terms) window_add4<kWeighted>(acc[k], v, t_first + tt);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (4 * g + k < tile_rows && 4 * q < ncols)
      store4(out + static_cast<I>(r0 + 4 * g + k) * cols + c0 + 4 * q, 4 * q, ncols, acc[k]);
}

// P2 with bcast: every output row is the sum of x rows base + s*t. Block b
// takes columns (b mod col_tiles) * kThreads .. (one a thread) and output
// rows (b / col_tiles) * kWinBcastRows ..; each thread sums its column once,
// in order of t (stride 0: its one x value, loaded once; stride 1: eight
// rows' loads issued at a time), and stores the sum to each of its rows.
template <int kStride, bool kWeighted, typename I>
__global__ void row_window_bcast_kernel(const float* __restrict__ x, float* __restrict__ out,
                                        int rows, int cols, int n, int base, int col_tiles,
                                        const int* __restrict__ bounds_ptr, int lo, int hi) {
  const int c = static_cast<int>(blockIdx.x % col_tiles) * kThreads + threadIdx.x;
  const int r0 = static_cast<int>(blockIdx.x / col_tiles) * kWinBcastRows;
  float x0 = 0.0f;
  if (kStride == 0 && c < cols && base >= 0 && base < rows)
    x0 = __ldg(x + static_cast<I>(base) * cols + c);
  window_bounds(bounds_ptr, lo, hi);
  if (c >= cols) return;
  float acc = 0.0f;
  if (kStride == 0) {
    for (int t = lo; t < hi; ++t) acc = __fadd_rn(acc, window_term<kWeighted>(x0, t));
  } else {
    for (long long t0 = lo; t0 < hi; t0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const long long row = base + t0 + u;
        v[u] = t0 + u < hi && row >= 0 && row < rows ? __ldg(x + static_cast<I>(row) * cols + c)
                                                     : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (t0 + u < hi)
          acc = __fadd_rn(acc, window_term<kWeighted>(v[u], static_cast<int>(t0 + u)));
    }
  }
  const int r1 = min(n, r0 + kWinBcastRows);
  for (int r = r0; r < r1; ++r) out[static_cast<I>(r) * cols + c] = acc;
}

// x value i of P2's stride-0 kernel, 0 outside [valid_lo, valid_hi).
template <typename I>
__device__ __forceinline__ float flat_value(const float* __restrict__ src, I i, I valid_lo,
                                            I valid_hi) {
  return i >= valid_lo && i < valid_hi ? __ldg(src + i) : 0.0f;
}

// P2, stride 0, not bcast: out row r holds w-weighted copies of x row
// base + r, so over out's flat index i, out[i] = sum_t w(t) * src[i] with
// src = x + base * cols, 0 where i lies outside [valid_lo, valid_hi) (the
// rows outside x). One of out's float4s a thread from element head, as P3
// (kVecLoad: src + head 16-byte aligned too), its x values loaded once
// before the bounds; block 0's first threads take the head and the tail.
template <bool kWeighted, bool kVecLoad, typename I>
__global__ void row_window_flat_kernel(const float* __restrict__ src, float* __restrict__ out,
                                       I total, int head, I valid_lo, I valid_hi,
                                       const int* __restrict__ bounds_ptr, int lo, int hi) {
  const I vecs = (total - head) / 4;
  const I v = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  const I i0 = head + 4 * v;
  float4 xv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (v < vecs) {
    if (kVecLoad && i0 >= valid_lo && i0 + 4 <= valid_hi) {
      xv = __ldg(reinterpret_cast<const float4*>(src + i0));
    } else {
      xv = make_float4(flat_value(src, i0, valid_lo, valid_hi),
                       flat_value(src, i0 + 1, valid_lo, valid_hi),
                       flat_value(src, i0 + 2, valid_lo, valid_hi),
                       flat_value(src, i0 + 3, valid_lo, valid_hi));
    }
  }
  I e = -1;  // this thread's head or tail element, if any
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const I h = threadIdx.x < 4 ? threadIdx.x : head + 4 * vecs + threadIdx.x - 4;
    if (threadIdx.x < 4 ? h < head : h < total) e = h;
  }
  const float xe = e >= 0 ? flat_value(src, e, valid_lo, valid_hi) : 0.0f;
  window_bounds(bounds_ptr, lo, hi);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float acc_e = 0.0f;
  for (int t = lo; t < hi; ++t) {
    window_add4<kWeighted>(acc, xv, t);
    acc_e = __fadd_rn(acc_e, window_term<kWeighted>(xe, t));
  }
  if (v < vecs) *reinterpret_cast<float4*>(out + i0) = acc;
  if (e >= 0) out[e] = acc_e;
}

__device__ __forceinline__ float affine1(float v, float alpha, float beta) {
  return __fadd_rn(__fmul_rn(v, alpha), beta);
}

// P3: one of out's float4s a thread from element head (its first 16-byte
// boundary), x's as a float4 (kVecLoad: x + head 16-byte aligned too) or
// four scalars; block 0's first threads take the head and the tail (fewer
// than 4 each).
template <bool kVecLoad>
__global__ void affine_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                              int head, float alpha, float beta) {
  const long long vecs = (n - head) / 4;
  const long long v = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (v < vecs) {
    const float* xv = x + head + 4 * v;
    float4 t = kVecLoad ? __ldg(reinterpret_cast<const float4*>(xv))
                        : make_float4(__ldg(xv), __ldg(xv + 1), __ldg(xv + 2), __ldg(xv + 3));
    t.x = affine1(t.x, alpha, beta);
    t.y = affine1(t.y, alpha, beta);
    t.z = affine1(t.z, alpha, beta);
    t.w = affine1(t.w, alpha, beta);
    *reinterpret_cast<float4*>(out + head + 4 * v) = t;
  }
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const long long e = threadIdx.x < 4 ? threadIdx.x : head + 4 * vecs + threadIdx.x - 4;
    if (threadIdx.x < 4 ? e < head : e < n) out[e] = affine1(__ldg(x + e), alpha, beta);
  }
}

// P4 on one value: ((a // m) * m, a % m) with Python's floor semantics. The
// quotient in 32 bits (|m| >= 2: no overflow), stepped down once where
// truncation rounded towards 0; the product wraps in unsigned 32-bit
// arithmetic, as torch's and JAX's int32 do ((-2^31 // 3) * 3 gives
// 2147483647). |m| = 1 gives (a, 0): a / -1 overflows at -2^31.
__device__ __forceinline__ int2 floor_divmod1(int a, int m) {
  if (m == 1 || m == -1) return make_int2(a, 0);
  int q = a / m, r = a - q * m;
  if (r != 0 && ((r < 0) != (m < 0))) {
    q -= 1;
    r += m;
  }
  return make_int2(static_cast<int>(static_cast<unsigned>(q) * static_cast<unsigned>(m)), r);
}

// P4: four values a thread from element head (out's first 16-byte
// boundary): t as an int4 (kVecLoad: t + head 16-byte aligned too) or four
// scalars, row 0 as an int4, row 1 as an int4 where out + n + head is
// 16-byte aligned too (kVecRow1: n a multiple of 4), else four scalars;
// block 0's first threads take the head and the tail. Row 1 starts n values
// on, a 64-bit offset.
template <bool kVecLoad, bool kVecRow1, typename I>
__global__ void floor_divmod_kernel(const int* __restrict__ t, int* __restrict__ out, I n,
                                    int head, int m) {
  int* const row1 = out + static_cast<long long>(n);
  const I vecs = (n - head) / 4;
  const I v = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (v < vecs) {
    const I i = head + 4 * v;
    const int4 a = kVecLoad ? __ldg(reinterpret_cast<const int4*>(t + i))
                            : make_int4(__ldg(t + i), __ldg(t + i + 1), __ldg(t + i + 2),
                                        __ldg(t + i + 3));
    const int2 p0 = floor_divmod1(a.x, m), p1 = floor_divmod1(a.y, m);
    const int2 p2 = floor_divmod1(a.z, m), p3 = floor_divmod1(a.w, m);
    *reinterpret_cast<int4*>(out + i) = make_int4(p0.x, p1.x, p2.x, p3.x);
    if (kVecRow1) {
      *reinterpret_cast<int4*>(row1 + i) = make_int4(p0.y, p1.y, p2.y, p3.y);
    } else {
      row1[i] = p0.y;
      row1[i + 1] = p1.y;
      row1[i + 2] = p2.y;
      row1[i + 3] = p3.y;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const I e = threadIdx.x < 4 ? threadIdx.x : head + 4 * vecs + threadIdx.x - 4;
    if (threadIdx.x < 4 ? e < head : e < n) {
      const int2 p = floor_divmod1(__ldg(t + e), m);
      out[e] = p.x;
      row1[e] = p.y;
    }
  }
}

// P4's launch in index type I: the instance for t's and row 1's alignment.
template <typename I>
void launch_floor_divmod(const int* t, int* out, long long n, int head, int m, bool vec_load,
                         bool vec_row1, cudaStream_t s) {
  const long long blocks = ceil_div((n - head) / 4, kThreads);
  const unsigned grid = blocks > 0 ? static_cast<unsigned>(blocks) : 1;
  const I ni = static_cast<I>(n);
  if (vec_load && vec_row1)
    floor_divmod_kernel<true, true, I><<<grid, kThreads, 0, s>>>(t, out, ni, head, m);
  else if (vec_load)
    floor_divmod_kernel<true, false, I><<<grid, kThreads, 0, s>>>(t, out, ni, head, m);
  else if (vec_row1)
    floor_divmod_kernel<false, true, I><<<grid, kThreads, 0, s>>>(t, out, ni, head, m);
  else
    floor_divmod_kernel<false, false, I><<<grid, kThreads, 0, s>>>(t, out, ni, head, m);
}

// P2's launch for one (stride, weighted, bcast) in flags and index type I.
struct WindowArgs {
  const float* x;
  float* out;
  int rows, cols, n, base;
  const int* bounds_ptr;
  int lo, hi;
};

template <bool kWeighted, bool kAligned, bool kStaged, typename I>
void launch_tile(const WindowArgs& a, unsigned grid, int row_tiles, cudaStream_t s) {
  if constexpr (kStaged)
    row_window_tile_kernel<kWeighted, kAligned, I><<<grid, kThreads, 0, s>>>(
        a.x, a.out, a.rows, a.cols, a.n, a.base, row_tiles, a.bounds_ptr, a.lo, a.hi);
  else
    row_window_direct_kernel<kWeighted, kAligned, I><<<grid, kDirectThreads, 0, s>>>(
        a.x, a.out, a.rows, a.cols, a.n, a.base, row_tiles, a.bounds_ptr, a.lo, a.hi);
}

template <int kFlags, typename I>
int launch_window(const WindowArgs& a, cudaStream_t s) {
  constexpr int kStride = kFlags & 1;
  constexpr bool kWeighted = kFlags & 2, kBcast = kFlags & 4;
  if constexpr (kBcast) {
    const long long col_tiles = ceil_div(a.cols, kThreads);
    const long long blocks = col_tiles * ceil_div(a.n, kWinBcastRows);
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    const unsigned grid = static_cast<unsigned>(blocks);
    row_window_bcast_kernel<kStride, kWeighted, I><<<grid, kThreads, 0, s>>>(
        a.x, a.out, a.rows, a.cols, a.n, a.base, static_cast<int>(col_tiles), a.bounds_ptr, a.lo,
        a.hi);
  } else if constexpr (kStride == 0) {
    const long long total = static_cast<long long>(a.n) * a.cols;
    const long long off = static_cast<long long>(a.base) * a.cols;
    const long long valid_lo = std::clamp(-off, 0LL, total);
    const long long x_end = static_cast<long long>(a.rows) * a.cols - off;  // past x's last row
    const long long valid_hi = std::clamp(x_end, 0LL, total);
    const float* src = a.x + off;  // x's row base: dereferenced only inside [valid_lo, valid_hi)
    const int to_boundary = (4 - misalign4(a.out)) % 4;
    const int head = total < to_boundary ? static_cast<int>(total) : to_boundary;
    const long long blocks = ceil_div((total - head) / 4, kThreads);
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    const unsigned grid = blocks > 0 ? static_cast<unsigned>(blocks) : 1;
    if (misalign4(src + head) == 0)
      row_window_flat_kernel<kWeighted, true, I><<<grid, kThreads, 0, s>>>(
          src, a.out, static_cast<I>(total), head, static_cast<I>(valid_lo),
          static_cast<I>(valid_hi), a.bounds_ptr, a.lo, a.hi);
    else
      row_window_flat_kernel<kWeighted, false, I><<<grid, kThreads, 0, s>>>(
          src, a.out, static_cast<I>(total), head, static_cast<I>(valid_lo),
          static_cast<I>(valid_hi), a.bounds_ptr, a.lo, a.hi);
  } else {
    // the stage where tiles of kWinRows rows fill the card, else the direct kernel
    const long long col_tiles = ceil_div(a.cols, kWinCols);
    const bool staged = ceil_div(a.n, kWinRows) * col_tiles >= kWinStageBlocks;
    const long long row_tiles = ceil_div(a.n, staged ? kWinRows : kDirectThreads / 32);
    if (row_tiles * col_tiles > 0x7fffffff) return cudaErrorInvalidValue;
    const unsigned grid = static_cast<unsigned>(row_tiles * col_tiles);
    const int rt = static_cast<int>(row_tiles);
    const bool aligned = a.cols % 4 == 0 && misalign4(a.x) == 0;
    if (aligned && staged)
      launch_tile<kWeighted, true, true, I>(a, grid, rt, s);
    else if (aligned)
      launch_tile<kWeighted, true, false, I>(a, grid, rt, s);
    else if (staged)
      launch_tile<kWeighted, false, true, I>(a, grid, rt, s);
    else
      launch_tile<kWeighted, false, false, I>(a, grid, rt, s);
  }
  return cudaSuccess;
}

template <int kFlags>
int launch_window(const WindowArgs& a, bool narrow, cudaStream_t s) {
  return narrow ? launch_window<kFlags, int>(a, s) : launch_window<kFlags, long long>(a, s);
}

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Each returns cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for arguments it does not take. Nothing is launched
// for an empty output.

// P1: x, out (rows, cols) float32; amount_ptr an int32 on the device, or
// null for the by-value amount.
extern "C" int smilecode_probe_roll(const float* x, float* out, int rows, int cols, int axis,
                                    const int* amount_ptr, int amount, void* stream) {
  if (rows < 0 || cols < 0 || (axis != 0 && axis != 1)) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(rows) * cols;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = n < (1LL << 31) - kThreads;  // every element index fits an int
  if (axis == 0 && cols % 4 == 0 && misalign4(x) == 0 && misalign4(out) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* out4 = reinterpret_cast<float4*>(out);
    if (narrow)
      roll_rows_vec_kernel<int><<<blocks_for(n / 4), kThreads, 0, s>>>(x4, out4, rows, cols / 4,
                                                                       amount_ptr, amount);
    else
      roll_rows_vec_kernel<long long><<<blocks_for(n / 4), kThreads, 0, s>>>(
          x4, out4, rows, cols / 4, amount_ptr, amount);
  } else if (axis == 1 && cols <= kRollTile) {
    const int tile_rows = cols < kStageTarget ? kStageTarget / cols : 1;
    roll_cols_staged_kernel<<<blocks_for(rows, tile_rows), kThreads, 0, s>>>(
        x, out, rows, cols, tile_rows, amount_ptr, amount);
  } else if (narrow) {
    roll_kernel<int><<<blocks_for(n), kThreads, 0, s>>>(x, out, rows, cols, axis, amount_ptr,
                                                        amount);
  } else {
    roll_kernel<long long><<<blocks_for(n), kThreads, 0, s>>>(x, out, rows, cols, axis,
                                                              amount_ptr, amount);
  }
  return launched();
}

// P2: x (rows, cols), out (n, cols) float32; flags = stride (0 or 1) | 2 if
// weighted | 4 if bcast; bounds_ptr two int32 (lo, hi) on the device, or
// null for the by-value bounds.
extern "C" int smilecode_probe_row_window(const float* x, float* out, int rows, int cols, int n,
                                          int base, int flags, const int* bounds_ptr, int lo,
                                          int hi, void* stream) {
  if (rows < 0 || cols < 0 || n < 0 || flags < 0 || flags > 7) return cudaErrorInvalidValue;
  if (static_cast<long long>(n) * cols == 0) return cudaSuccess;
  const WindowArgs a{x, out, rows, cols, n, base, bounds_ptr, lo, hi};
  const bool narrow = static_cast<long long>(std::max(rows, n)) * cols < kNarrow;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = cudaSuccess;
  switch (flags) {
    case 0: code = launch_window<0>(a, narrow, s); break;
    case 1: code = launch_window<1>(a, narrow, s); break;
    case 2: code = launch_window<2>(a, narrow, s); break;
    case 3: code = launch_window<3>(a, narrow, s); break;
    case 4: code = launch_window<4>(a, narrow, s); break;
    case 5: code = launch_window<5>(a, narrow, s); break;
    case 6: code = launch_window<6>(a, narrow, s); break;
    default: code = launch_window<7>(a, narrow, s); break;
  }
  return code != cudaSuccess ? code : launched();
}

// P3: x, out of n float32 values, each 4-byte aligned.
extern "C" int smilecode_probe_affine(const float* x, float* out, long long n, float alpha,
                                      float beta, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int to_boundary = (4 - misalign4(out)) % 4;
  const int head = n < to_boundary ? static_cast<int>(n) : to_boundary;
  const unsigned blocks = blocks_for((n - head) / 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (misalign4(x + head) == 0)
    affine_kernel<true><<<blocks > 0 ? blocks : 1, kThreads, 0, s>>>(x, out, n, head, alpha, beta);
  else
    affine_kernel<false><<<blocks > 0 ? blocks : 1, kThreads, 0, s>>>(x, out, n, head, alpha, beta);
  return launched();
}

// P4: t of n int32, out (2, n) int32; m != 0.
extern "C" int smilecode_probe_floor_divmod(const int* t, int* out, long long n, int m,
                                            void* stream) {
  if (n < 0 || m == 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int to_boundary = (4 - misalign4(out)) % 4;
  const int head = n < to_boundary ? static_cast<int>(n) : to_boundary;
  const bool vec_load = misalign4(t + head) == 0, vec_row1 = misalign4(out + n + head) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < kNarrow)
    launch_floor_divmod<int>(t, out, n, head, m, vec_load, vec_row1, s);
  else
    launch_floor_divmod<long long>(t, out, n, head, m, vec_load, vec_row1, s);
  return launched();
}
