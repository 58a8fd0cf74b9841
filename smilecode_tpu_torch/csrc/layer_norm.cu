// LayerNorm over the last axis of contiguous rows, float32, and its backward
// (Hopper, sm_90a).
//
// K8 smilecode_layer_norm_fwd / _bwd replace no TPU kernel: the JAX package
// leaves ModeT's ProjectionLayer norm (flax nn.LayerNorm) to XLA. For R rows
// of N values z (N = 1-256), gamma and beta (N), eps, all in float32:
//   mean = sum_j z_j / N,  var = sum_j (z_j - mean)^2 / N,  rstd = rsqrt(var + eps),
//   y_j  = (z_j - mean) rstd gamma_j + beta_j,
// and, from dy, with xh_j = (z_j - mean) rstd and g_j = dy_j gamma_j,
//   dz_j = rstd (g_j - mean_j(g) - xh_j mean_j(g xh)),
//   dgamma_j = sum_rows dy_j xh_j,  dbeta_j = sum_rows dy_j,
// g_j rounded once wherever it is used (a row of one value, where xh = 0 and
// mean(g) = g, then gets dz = 0 exactly).
// The backward reads z and recomputes mean and rstd (the forward stores
// neither). dgamma and dbeta are summed per block in a fixed order (a
// butterfly of shuffles per warp, then the warps in turn) into partials, and
// the partials by layer_norm_rows_reduce_kernel in a fixed order: no atomics,
// so two calls give the same bits.
//
// What bounds it on the H100: bytes. Per value the forward reads 4 bytes and
// writes 4 and the backward reads 8 and writes 4, for a handful of operations:
// far below the card's 20 operations a byte. ModeT's rows are 6 wide at its
// two finest levels (4 915 200 and 614 400 rows a volume), and a 24-byte row
// is no vector of 16. So a block stages a tile of T consecutive rows (T a
// multiple of 32, about 4096 values: 512 rows of 6) in shared memory with
// coalesced 16-byte loads (scalar ones where a pointer is not 16-byte aligned,
// and for the tile's last values when their count is no multiple of 4), one
// thread takes one row there, and the tile goes out the same way. Instances
// for ModeT's widths 6, 12, 24 and 48 keep the loops over a row unrolled; any
// other width runs the same code with N a run-time value.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxN = 256;           // the widest row
constexpr int kTileValues = 4096;    // values of a staged tile, about
constexpr int kMaxRows = 512;        // the most rows (threads) of a block
constexpr int kWarp = 32;

// rows of a tile for width N: about kTileValues values, a multiple of 32 from
// 32 to kMaxRows; `kernels/layer_norm.py:tile_rows` computes the same
bool valid_rows(int N, int T) {
  return T >= kWarp && T <= kMaxRows && T % kWarp == 0 && T * N <= 2 * kTileValues;
}

bool aligned(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;  // the default; above it, for the current card
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// count values from src (global) to dst (shared): 16-byte vectors where VEC
// (src 16-byte aligned), the rest as scalars
template <bool VEC>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int count) {
  int i = threadIdx.x;
  if constexpr (VEC) {
    const int nv = count / 4;
    for (; i < nv; i += blockDim.x) {
      reinterpret_cast<float4*>(dst)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
    }
    i = 4 * nv + threadIdx.x;
  }
  for (; i < count; i += blockDim.x) dst[i] = __ldg(src + i);
}

template <bool VEC>
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float* src, int count) {
  int i = threadIdx.x;
  if constexpr (VEC) {
    const int nv = count / 4;
    for (; i < nv; i += blockDim.x) {
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    }
    i = 4 * nv + threadIdx.x;
  }
  for (; i < count; i += blockDim.x) dst[i] = src[i];
}

// mean and rstd of the N values at p, in two passes
template <int NC>
__device__ __forceinline__ void moments(const float* p, int N, float eps, float& mean,
                                        float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < (NC ? NC : N); ++j) s += p[j];
  mean = s / N;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < (NC ? NC : N); ++j) {
    const float d = p[j] - mean;
    q = fmaf(d, d, q);
  }
  rstd = rsqrtf(q / N + eps);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y from z (R rows of N); block b takes rows [b T, b T + T), a thread a row.
// NC: N at compile time (0: the run-time n)
template <int NC, bool VEC>
__global__ void __launch_bounds__(kMaxRows)
    layer_norm_rows_fwd_kernel(const float* __restrict__ z, const float* __restrict__ gamma,
                               const float* __restrict__ beta, float* __restrict__ y,
                               long long R, int n, int T, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int N = NC ? NC : n;
  float* tile = smem;              // [T][N]: z, then y
  float* gb = smem + T * N;        // gamma [N], beta [N]
  const long long r0 = static_cast<long long>(blockIdx.x) * T;
  const int rows = static_cast<int>(R - r0 < T ? R - r0 : T);
  const long long base = r0 * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    gb[j] = __ldg(gamma + j);
    gb[N + j] = __ldg(beta + j);
  }
  load_tile<VEC>(tile, z + base, rows * N);
  __syncthreads();
  if (threadIdx.x < rows) {
    float* p = tile + threadIdx.x * N;
    float mean, rstd;
    moments<NC>(p, N, eps, mean, rstd);
#pragma unroll
    for (int j = 0; j < (NC ? NC : N); ++j) p[j] = fmaf((p[j] - mean) * rstd, gb[j], gb[N + j]);
  }
  __syncthreads();
  store_tile<VEC>(y + base, tile, rows * N);
}

// dz from dy and z, as the forward's tiles; the block's sums of dy xh and dy
// per column go to part[j][block] and part[N + j][block]
template <int NC, bool VEC>
__global__ void __launch_bounds__(kMaxRows)
    layer_norm_rows_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ z,
                               const float* __restrict__ gamma, float* __restrict__ dz,
                               float* __restrict__ part, long long R, int n, int T, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int N = NC ? NC : n;
  float* zt = smem;                // [T][N]: z, then xh
  float* gt = zt + T * N;          // [T][N]: dy, then dz
  float* gam = gt + T * N;         // [N]
  float* wsum = gam + N;           // [T / 32][2N]: each warp's sums of dy xh, then of dy
  const long long r0 = static_cast<long long>(blockIdx.x) * T;
  const int rows = static_cast<int>(R - r0 < T ? R - r0 : T);
  const long long base = r0 * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) gam[j] = __ldg(gamma + j);
  load_tile<VEC>(zt, z + base, rows * N);
  load_tile<VEC>(gt, dy + base, rows * N);
  __syncthreads();
  const int r = threadIdx.x, lane = r % kWarp, warp = r / kWarp;
  const bool live = r < rows;
  float* p = zt + r * N;
  float* q = gt + r * N;
  float rstd = 0.f, mg = 0.f, mgx = 0.f;
  if (live) {
    float mean, sg = 0.f, sgx = 0.f;
    moments<NC>(p, N, eps, mean, rstd);
#pragma unroll
    for (int j = 0; j < (NC ? NC : N); ++j) {
      const float xh = (p[j] - mean) * rstd;
      const float g = __fmul_rn(q[j], gam[j]);  // rounded as below: no contraction
      sg += g;
      sgx = fmaf(g, xh, sgx);
      p[j] = xh;
    }
    mg = sg / N;
    mgx = sgx / N;
  }
  // every lane runs the loop (the shuffles), a row past the tile with zeros
#pragma unroll
  for (int j = 0; j < (NC ? NC : N); ++j) {
    const float d = live ? q[j] : 0.f;
    const float xh = live ? p[j] : 0.f;
    const float sx = warp_sum(d * xh), sd = warp_sum(d);
    if (lane == 0) {
      wsum[warp * 2 * N + j] = sx;
      wsum[warp * 2 * N + N + j] = sd;
    }
    if (live) q[j] = rstd * (__fmul_rn(d, gam[j]) - mg - xh * mgx);
  }
  __syncthreads();
  const int warps = blockDim.x / kWarp;
  for (int c = threadIdx.x; c < 2 * N; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += wsum[w * 2 * N + c];
    part[static_cast<long long>(c) * gridDim.x + blockIdx.x] = s;
  }
  store_tile<VEC>(dz + base, gt, rows * N);
}

// dgamma[j] and dbeta[j] from the nb partials of columns j and N + j: block
// c sums part[c][:] (each thread a strided run, then the warps' butterflies,
// then the warps in turn)
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
    layer_norm_rows_reduce_kernel(const float* __restrict__ part, float* __restrict__ dgamma,
                                  float* __restrict__ dbeta, int nb, int N) {
  __shared__ float ws[kReduceThreads / kWarp];
  const int c = blockIdx.x;
  const float* src = part + static_cast<long long>(c) * nb;
  float s = 0.f;
  for (int b = threadIdx.x; b < nb; b += kReduceThreads) s += src[b];
  s = warp_sum(s);
  if (threadIdx.x % kWarp == 0) ws[threadIdx.x / kWarp] = s;
  __syncthreads();
  if (threadIdx.x) return;
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kReduceThreads / kWarp; ++w) t += ws[w];
  if (c < N) {
    dgamma[c] = t;
  } else {
    dbeta[c - N] = t;
  }
}

size_t fwd_smem(int N, int T) { return sizeof(float) * (static_cast<size_t>(T) * N + 2 * N); }

size_t bwd_smem(int N, int T) {
  return sizeof(float) * (2 * static_cast<size_t>(T) * N + N + (T / kWarp) * 2 * N);
}

long long blocks(long long R, int T) { return (R + T - 1) / T; }

template <int NC, bool VEC>
cudaError_t forward(const float* z, const float* gamma, const float* beta, float* y, long long R,
                    int N, int T, float eps, cudaStream_t st) {
  const size_t smem = fwd_smem(N, T);
  const cudaError_t err = allow_smem(layer_norm_rows_fwd_kernel<NC, VEC>, smem);
  if (err != cudaSuccess) return err;
  layer_norm_rows_fwd_kernel<NC, VEC><<<static_cast<unsigned>(blocks(R, T)), T, smem, st>>>(
      z, gamma, beta, y, R, N, T, eps);
  return cudaGetLastError();
}

template <int NC, bool VEC>
cudaError_t backward(const float* dy, const float* z, const float* gamma, float* dz, float* part,
                     float* dgamma, float* dbeta, long long R, int N, int T, float eps,
                     cudaStream_t st) {
  const size_t smem = bwd_smem(N, T);
  cudaError_t err = allow_smem(layer_norm_rows_bwd_kernel<NC, VEC>, smem);
  if (err != cudaSuccess) return err;
  const long long nb = blocks(R, T);
  layer_norm_rows_bwd_kernel<NC, VEC><<<static_cast<unsigned>(nb), T, smem, st>>>(
      dy, z, gamma, dz, part, R, N, T, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layer_norm_rows_reduce_kernel<<<2 * N, kReduceThreads, 0, st>>>(part, dgamma, dbeta,
                                                                  static_cast<int>(nb), N);
  return cudaGetLastError();
}

// the instance for width N: ModeT's 6, 12, 24, 48 at compile time, any other
// at run time
template <bool VEC, typename F>
cudaError_t by_width(int N, F&& f) {
  switch (N) {
    case 6: return f(std::integral_constant<int, 6>{}, std::bool_constant<VEC>{});
    case 12: return f(std::integral_constant<int, 12>{}, std::bool_constant<VEC>{});
    case 24: return f(std::integral_constant<int, 24>{}, std::bool_constant<VEC>{});
    case 48: return f(std::integral_constant<int, 48>{}, std::bool_constant<VEC>{});
    default: return f(std::integral_constant<int, 0>{}, std::bool_constant<VEC>{});
  }
}

bool valid(long long R, int N, int T) {
  return R >= 1 && N >= 1 && N <= kMaxN && valid_rows(N, T) && blocks(R, T) < (1LL << 31);
}

}  // namespace

// y (R, N) from z (R, N), gamma and beta (N); T rows a block
extern "C" int smilecode_layer_norm_fwd(const float* z, const float* gamma, const float* beta,
                                        float* y, long long R, int N, int T, float eps,
                                        void* stream) {
  if (!valid(R, N, T)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto nc, auto vec) {
    return forward<decltype(nc)::value, decltype(vec)::value>(z, gamma, beta, y, R, N, T, eps,
                                                             st);
  };
  return aligned(z) && aligned(y) ? by_width<true>(N, run) : by_width<false>(N, run);
}

// dz (R, N), dgamma and dbeta (N) from dy and z (R, N) and gamma; part is
// scratch of 2 N ceil(R / T) floats
extern "C" int smilecode_layer_norm_bwd(const float* dy, const float* z, const float* gamma,
                                        float* dz, float* part, float* dgamma, float* dbeta,
                                        long long R, int N, int T, float eps, void* stream) {
  if (!valid(R, N, T)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto nc, auto vec) {
    return backward<decltype(nc)::value, decltype(vec)::value>(dy, z, gamma, dz, part, dgamma,
                                                              dbeta, R, N, T, eps, st);
  };
  return aligned(dy) && aligned(z) && aligned(dz) ? by_width<true>(N, run)
                                                  : by_width<false>(N, run);
}
