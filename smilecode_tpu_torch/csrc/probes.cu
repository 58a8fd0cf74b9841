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
// launch. P2 and P4 take one thread per output element. P1 and P3 are
// written for arrays of any size as the card wants them read, 16 bytes a
// thread on neighbouring addresses:
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
// At these sizes a kernel's time is its chain of dependent steps, not its
// bytes, so each thread issues its loads before anything waits on one
// (four float4s a thread in a loop whose stores each waited on their load
// measured slower on the H100 than one a thread; probe_ab.py), every
// thread reads P1's amount itself (one request a warp) rather than wait at
// a barrier for one, and index arithmetic is 32-bit where it fits (a
// 64-bit division is a long chain of instructions).
// Products and sums are rounded one at a time (__fmul_rn, __fadd_rn, no FMA
// contraction), in the plain versions' order, so each kernel equals its
// plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRollTile = 4096;     // P1 axis 1: the most floats of whole rows a block stages
constexpr int kStageTarget = 1024;  // P1 axis 1: floats a block stages where rows allow

unsigned blocks_for(long long n, long long per_block = kThreads) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

// floats from p back to its 16-byte boundary (p 4-byte aligned)
__host__ __device__ __forceinline__ int misalign4(const float* p) {
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

__global__ void row_window_kernel(const float* __restrict__ x, float* __restrict__ out, int rows,
                                  int cols, int n, int base, int stride, int weighted, int bcast,
                                  const int* __restrict__ bounds_ptr, int lo, int hi) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= static_cast<long long>(n) * cols) return;
  if (bounds_ptr) {
    lo = __ldg(bounds_ptr);
    hi = __ldg(bounds_ptr + 1);
  }
  const long long r = i / cols, c = i % cols;
  float acc = 0.0f;
  for (int t = lo; t < hi; ++t) {
    const long long row = base + static_cast<long long>(stride) * t + (bcast ? 0 : r);
    const float v = (row >= 0 && row < rows) ? x[row * cols + c] : 0.0f;
    acc = __fadd_rn(acc, weighted ? __fmul_rn(v, static_cast<float>(t)) : v);
  }
  out[i] = acc;
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

__global__ void floor_divmod_kernel(const int* __restrict__ t, int* __restrict__ out, int n,
                                    int m) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long a = t[i];
  long long q = a / m, r = a % m;
  if (r != 0 && ((r < 0) != (m < 0))) {  // truncation rounded towards 0: step down once
    q -= 1;
    r += m;
  }
  out[i] = static_cast<int>(static_cast<unsigned>(q * m));  // wraps as torch's int32 product
  out[n + i] = static_cast<int>(r);
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

// P2: x (rows, cols), out (n, cols) float32; bounds_ptr two int32 (lo, hi)
// on the device, or null for the by-value bounds.
extern "C" int smilecode_probe_row_window(const float* x, float* out, int rows, int cols, int n,
                                          int base, int stride, int weighted, int bcast,
                                          const int* bounds_ptr, int lo, int hi, void* stream) {
  if (rows < 0 || cols < 0 || n < 0) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(n) * cols;
  if (total == 0) return cudaSuccess;
  row_window_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, rows, cols, n, base, stride, weighted, bcast, bounds_ptr, lo, hi);
  return launched();
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
extern "C" int smilecode_probe_floor_divmod(const int* t, int* out, int n, int m, void* stream) {
  if (n < 0 || m == 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  floor_divmod_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, out,
                                                                                        n, m);
  return launched();
}
