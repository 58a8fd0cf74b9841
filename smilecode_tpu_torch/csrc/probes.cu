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
// What bounds them on the H100: the launch. The arrays are 16-32 KB, about
// 0.01 us of traffic at 3.35 TB/s, so one thread per output element, no
// shared memory and none of the TPU's blocking. Products and sums are
// rounded one at a time (__fmul_rn, __fadd_rn, no FMA contraction), in the
// plain versions' order, so each kernel equals its plain version bit for
// bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

// a modulo n with a non-negative result (Python's a % n for n > 0)
__device__ __forceinline__ long long wrap(long long a, long long n) { return ((a % n) + n) % n; }

__global__ void roll_kernel(const float* __restrict__ x, float* __restrict__ out, int rows,
                            int cols, int axis, const int* __restrict__ amount_ptr, int amount) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= static_cast<long long>(rows) * cols) return;
  const long long a = amount_ptr ? __ldg(amount_ptr) : amount;
  long long r = i / cols, c = i % cols;
  if (axis == 0)
    r = wrap(r + a, rows);
  else
    c = wrap(c + a, cols);
  out[i] = x[r * cols + c];
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

__global__ void affine_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                              float alpha, float beta) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i < n) out[i] = __fadd_rn(__fmul_rn(x[i], alpha), beta);
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
  roll_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, rows, cols, axis, amount_ptr, amount);
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

// P3: x, out of n float32 values.
extern "C" int smilecode_probe_affine(const float* x, float* out, long long n, float alpha,
                                      float beta, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  affine_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n,
                                                                                  alpha, beta);
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
