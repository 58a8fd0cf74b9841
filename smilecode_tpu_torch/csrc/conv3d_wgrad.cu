// Weight and bias gradient of a 3x3x3, stride-1, padding-1 convolution in
// float32 (Hopper, sm_90a).
//
// K6 smilecode_conv3d_wgrad replaces no TPU kernel: the JAX package leaves
// every convolution and its gradient to XLA (flax nn.Conv,
// smilecode_tpu/ops/blocks.py). On the H100 the port's f32 convolutions run
// on cuDNN, whose weight gradient for the NDHWC (channels_last_3d) layout and
// the 1-128 channels of ModeT and the baselines is `wgrad2d_grouped_direct`,
// at about 0.3% of its bound (PERF.md). K6 takes that weight gradient; the
// forward and the input gradient stay on cuDNN.
//
// For x (B, D, H, W, Cin) and the output cotangent dy (B, D, H, W, Cout),
// both contiguous float32:
//   dW[co, ci, kd, kh, kw] = sum_{b, d, h, w} dy[b, d, h, w, co]
//                            * x[b, d + kd - 1, h + kh - 1, w + kw - 1, ci]
//   db[co]                 = sum_{b, d, h, w} dy[b, d, h, w, co]
// with x zero outside the volume: a product of M = Cout rows by N = 27 Cin
// columns over K = the B D H W voxels, the im2col done in shared memory and
// never in device memory. Every voxel and every tap is summed, in float32
// FMAs (no tensor cores, so no TF32).
//
// What bounds it on the H100: the float32 FMAs (2 Cout 27 Cin operations a
// voxel against (Cin + Cout) 4 bytes read; at ModeT's full resolution,
// Cin 4-8 and Cout 8, 54-108 operations a byte against the card's 20).
// The design keeps the FMA pipes fed from shared memory:
// - A block owns a (TM output, TN input) channel tile and all 27 taps, and
//   walks bricks of output voxels: block p of the grid's x takes bricks p,
//   p + P, ... For each brick it stages the brick's dy (TM channels) and
//   the brick's x with its one-voxel halo (TN channels) in shared memory
//   with cp.async, zero-filled outside the volume, double-buffered: the next
//   brick's copies fly while this one is summed.
// - A warp holds a group of TT taps; its 32 lanes take 32 voxels at a time,
//   each lane a register tile of TM x TT x TN accumulators. Per voxel a lane
//   reads TM dy values and TT rows of TN x values as 16-, 8- or 4-byte
//   vectors (consecutive voxels on consecutive lanes, so the reads are free
//   of bank conflicts) and issues TM TT TN FMAs. (TM, TN) follow Cout and
//   Cin: the largest of 8, 4, 2, 1 and of 4, 2, 1 that divide them; TT is
//   27, 9 or 3 so that a lane holds 27-108 accumulators.
// - After its last brick a block adds its lanes (a butterfly over the warp)
//   and its warps of the same taps in a fixed order, and writes one partial
//   of its tile. A second kernel sums the P partials of every value in a
//   fixed order and writes dW in the port's weight layout, channels_last_3d
//   ((Cout, kd, kh, kw, Cin) in memory), and db.
//   No atomics: two calls on the same inputs give the same bits, and the
//   sum over millions of voxels is a sum of short sums.
// `smilecode_conv3d_wgrad_plan` picks the brick and P (whole waves of
// blocks, from the occupancy of the instance, with at most kMaxBricks bricks
// a block) and the workspace the wrapper allocates.

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 27;
constexpr int kWarp = 32;
constexpr int kBrickVoxels = 1024;  // output voxels a brick aims at
constexpr int kMaxBricks = 16;      // bricks a block sums: a lane's chain of FMAs stays short

// the tile of one lane and the warps of a block, from its (TM, TN) channel tile
template <int TM, int TN>
struct Tile {
  static constexpr int TT = TM * TN <= 4 ? 27 : (TM * TN <= 8 ? 9 : 3);  // taps a lane holds
  static constexpr int CG = kTaps / TT;                                   // tap groups
  static constexpr int VW = CG == 1 ? 8 : (CG == 3 ? 3 : 1);              // warps per tap group
  static constexpr int kWarps = CG * VW;
  static constexpr int kThreads = kWarps * kWarp;
  static constexpr int VM = TM < 4 ? TM : 4;  // dy values per shared-memory vector
  static constexpr int GM = TM / VM;          // dy vectors a voxel
  static constexpr int R = TM * kTaps * TN + TM;  // values of a block's partial (dW tile, db)
};

struct Geo {
  int B, D, H, W, Cin, Cout;
  int BD, BH, BW;           // brick of output voxels
  int nbd, nbh, nbw, n_bricks;
  int rs, ps, HV;           // halo row and plane strides, halo voxels: (BD+2)(BH+2)(BW+2)
  int BV, BVp;              // brick voxels, rounded up to a whole warp
  int P, ci_tiles, tiles;   // partials, channel tiles
  long long E;              // values of one partial: Cout 27 Cin + Cout
};

Geo geometry(int B, int D, int H, int W, int Cin, int Cout, int tm, int tn, int BD, int BH,
             int BW, int P) {
  Geo g;
  g.B = B; g.D = D; g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout;
  g.BD = BD; g.BH = BH; g.BW = BW;
  g.nbd = (D + BD - 1) / BD; g.nbh = (H + BH - 1) / BH; g.nbw = (W + BW - 1) / BW;
  g.n_bricks = B * g.nbd * g.nbh * g.nbw;
  g.rs = BW + 2; g.ps = (BH + 2) * g.rs; g.HV = (BD + 2) * g.ps;
  g.BV = BD * BH * BW; g.BVp = (g.BV + kWarp - 1) / kWarp * kWarp;
  g.P = P;
  g.ci_tiles = Cin / tn; g.tiles = (Cout / tm) * g.ci_tiles;
  g.E = static_cast<long long>(Cout) * kTaps * Cin + Cout;
  return g;
}

template <int TM, int TN>
__host__ __device__ inline int stage_floats(const Geo& g) {  // one stage: dy then x, a multiple of 4 floats
  return (g.BVp * TM + g.HV * TN + 3) / 4 * 4;
}

template <int TM, int TN>
size_t smem_bytes(const Geo& g) {
  using T = Tile<TM, TN>;
  const long long stages = 2LL * stage_floats<TM, TN>(g) + g.BVp;  // two stages, offsets
  const long long red = static_cast<long long>(T::VW) * T::R;
  return static_cast<size_t>(stages > red ? stages : red) * sizeof(float);
}

// the first U bytes at src into dst, or U zero bytes where !valid (src not read)
template <int U>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? U : 0;
  if constexpr (U == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(U),
                 "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group landed
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// brick q's dy (GM vectors of VM channels from co0, [GM][BVp][VM]) and x
// with its halo (TN channels from ci0, [HV][TN]) into one stage
template <int TM, int TN>
__device__ void stage(const float* __restrict__ x, const float* __restrict__ dy, float* dys,
                      float* xs, int q, int co0, int ci0, const Geo& g) {
  using T = Tile<TM, TN>;
  int t = q;
  const int bw = t % g.nbw;
  t /= g.nbw;
  const int bh = t % g.nbh;
  t /= g.nbh;
  const int bd = t % g.nbd;
  const long long b = t / g.nbd;
  const int d0 = bd * g.BD, h0 = bh * g.BH, w0 = bw * g.BW;
  for (int i = threadIdx.x; i < g.BVp * T::GM; i += T::kThreads) {
    const int v = i / T::GM, k = i % T::GM;
    const int r = v / g.BW;
    const int d = d0 + r / g.BH, h = h0 + r % g.BH, w = w0 + v % g.BW;
    const bool in = v < g.BV && d < g.D && h < g.H && w < g.W;
    const float* src =
        in ? dy + (((b * g.D + d) * g.H + h) * g.W + w) * g.Cout + co0 + k * T::VM : dy;
    cp_async<T::VM * 4>(dys + (k * g.BVp + v) * T::VM, src, in);
  }
  const int hrow = g.BH + 2;
  for (int i = threadIdx.x; i < g.HV; i += T::kThreads) {
    const int r = i / g.rs;
    const int d = d0 + r / hrow - 1, h = h0 + r % hrow - 1, w = w0 + i % g.rs - 1;
    const bool in = static_cast<unsigned>(d) < static_cast<unsigned>(g.D) &&
                    static_cast<unsigned>(h) < static_cast<unsigned>(g.H) &&
                    static_cast<unsigned>(w) < static_cast<unsigned>(g.W);
    const float* src = in ? x + (((b * g.D + d) * g.H + h) * g.W + w) * g.Cin + ci0 : x;
    cp_async<TN * 4>(xs + i * TN, src, in);
  }
}

template <int TM, int TN>
__global__ void __launch_bounds__(Tile<TM, TN>::kThreads, 1)
    wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy, float* __restrict__ ws,
                 const Geo g, int want_bias) {
  using T = Tile<TM, TN>;
  constexpr int TT = T::TT;
  extern __shared__ __align__(16) float smem[];
  const int sf = stage_floats<TM, TN>(g);
  int* hoff = reinterpret_cast<int*>(smem + 2 * sf);
  const int co0 = (blockIdx.y / g.ci_tiles) * TM, ci0 = (blockIdx.y % g.ci_tiles) * TN;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int cg = warp % T::CG, vw = warp / T::CG;
  const int tap0 = cg * TT;
  const bool bias = want_bias && ci0 == 0 && cg == 0;  // one warp group sums db
  // a tap (kd, kh, kw) of the group sits (kd ps + kh rs + kw) halo voxels
  // after the voxel's (0, 0, 0) neighbour; tap0 is a multiple of TT
  const int base = (tap0 / 9) * g.ps + ((tap0 / 3) % 3) * g.rs;
  const int pso = g.ps * TN, rso = g.rs * TN;

  // halo index of each brick voxel's (0, 0, 0) neighbour (0 for the padding)
  for (int v = threadIdx.x; v < g.BVp; v += T::kThreads) {
    int off = 0;
    if (v < g.BV) {
      const int r = v / g.BW;
      off = ((r / g.BH) * (g.BH + 2) + r % g.BH) * g.rs + v % g.BW;
    }
    hoff[v] = off;
  }

  float acc[TM][TT][TN];
  float bacc[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    bacc[m] = 0.f;
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[m][t][n] = 0.f;
  }

  int buf = 0;
  if (static_cast<int>(blockIdx.x) < g.n_bricks)
    stage<TM, TN>(x, dy, smem, smem + g.BVp * TM, blockIdx.x, co0, ci0, g);
  cp_async_commit();
  for (int q = blockIdx.x; q < g.n_bricks; q += g.P) {
    if (q + g.P < g.n_bricks) {
      float* nxt = smem + (buf ^ 1) * sf;
      stage<TM, TN>(x, dy, nxt, nxt + g.BVp * TM, q + g.P, co0, ci0, g);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float* dys = smem + buf * sf;
    const float* xs = dys + g.BVp * TM + base * TN;
#pragma unroll 1
    for (int v = vw * kWarp + lane; v < g.BVp; v += kWarp * T::VW) {
      const float* xv = xs + hoff[v] * TN;
      float dv[TM];
#pragma unroll
      for (int k = 0; k < T::GM; ++k) lds<T::VM>(dys + (k * g.BVp + v) * T::VM, dv + k * T::VM);
      if (bias) {
#pragma unroll
        for (int m = 0; m < TM; ++m) bacc[m] += dv[m];
      }
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        float xt[TN];
        lds<TN>(xv + (t / 9) * pso + ((t / 3) % 3) * rso + (t % 3) * TN, xt);
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[m][t][n] = fmaf(dv[m], xt[n], acc[m][t][n]);
      }
    }
    __syncthreads();
    buf ^= 1;
  }

  // the warp's lanes, a butterfly (the same order in every lane); then the
  // block's warps of one tap group, in order, into this block's partial
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
      for (int n = 0; n < TN; ++n)
#pragma unroll
        for (int o = 16; o; o >>= 1) acc[m][t][n] += __shfl_xor_sync(0xffffffffu, acc[m][t][n], o);
    if (bias) {
#pragma unroll
      for (int o = 16; o; o >>= 1) bacc[m] += __shfl_xor_sync(0xffffffffu, bacc[m], o);
    }
  }
  float* red = smem + vw * T::R;  // the stages are free: the last brick's sync has passed
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
      for (int n = 0; n < TN; ++n)
        if ((((m * TT + t) * TN + n) & (kWarp - 1)) == lane)
          red[(m * kTaps + tap0 + t) * TN + n] = acc[m][t][n];
    if (bias && lane == m) red[TM * kTaps * TN + m] = bacc[m];
  }
  __syncthreads();
  float* out = ws + static_cast<long long>(blockIdx.x) * g.E;
  const int nb = (want_bias && ci0 == 0) ? T::R : T::R - TM;
  for (int i = threadIdx.x; i < nb; i += T::kThreads) {
    float s = smem[i];
#pragma unroll
    for (int k = 1; k < T::VW; ++k) s += smem[k * T::R + i];
    if (i < TM * kTaps * TN) {
      const int m = i / (kTaps * TN), r = i % (kTaps * TN);
      out[(static_cast<long long>(co0 + m) * kTaps + r / TN) * g.Cin + ci0 + r % TN] = s;
    } else {
      out[static_cast<long long>(g.Cout) * kTaps * g.Cin + co0 + (i - TM * kTaps * TN)] = s;
    }
  }
}

// dW and db: each value the sum of its P partials, in order (S lanes a value,
// each taking every S-th partial, then a butterfly); a partial's dW is
// already (Cout, kd, kh, kw, Cin), channels_last_3d's order
template <int S>
__global__ void wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                                    float* __restrict__ db, long long E, int P, int Cout) {
  const long long nw = E - Cout;
  const long long e = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / S;
  const int lane = threadIdx.x % S;
  if (e >= (db ? E : nw)) return;  // the S lanes of a value leave together
  float s = 0.f;
#pragma unroll 8
  for (int p = lane; p < P; p += S) s += ws[p * E + e];
  if constexpr (S > 1) {
#pragma unroll
    for (int o = S / 2; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  if (lane) return;
  if (e < nw) {
    dw[e] = s;
  } else {
    db[e - nw] = s;
  }
}

int tile_m(int cout) { return cout % 8 == 0 ? 8 : cout % 4 == 0 ? 4 : cout % 2 == 0 ? 2 : 1; }
int tile_n(int cin) { return cin % 4 == 0 ? 4 : cin % 2 == 0 ? 2 : 1; }

// the instance's occupancy (blocks a SM) where occ is given, else its launch
template <int TM, int TN>
cudaError_t instance(const Geo& g, const float* x, const float* dy, float* ws, int want_bias,
                     cudaStream_t stream, int* occ) {
  using T = Tile<TM, TN>;
  static int smem_set = 0;  // the largest dynamic shared memory allowed so far
  const size_t smem = smem_bytes<TM, TN>(g);
  if (static_cast<int>(smem) > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_kernel<TM, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = static_cast<int>(smem);
  }
  if (occ)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, wgrad_kernel<TM, TN>, T::kThreads,
                                                         smem);
  wgrad_kernel<TM, TN><<<dim3(g.P, g.tiles), T::kThreads, smem, stream>>>(x, dy, ws, g, want_bias);
  return cudaGetLastError();
}

cudaError_t dispatch(const Geo& g, const float* x, const float* dy, float* ws, int want_bias,
                     cudaStream_t stream, int* occ) {
  switch (tile_m(g.Cout) * 8 + tile_n(g.Cin)) {
#define K6_CASE(TM, TN) \
  case TM * 8 + TN:     \
    return instance<TM, TN>(g, x, dy, ws, want_bias, stream, occ);
    K6_CASE(1, 1) K6_CASE(1, 2) K6_CASE(1, 4)
    K6_CASE(2, 1) K6_CASE(2, 2) K6_CASE(2, 4)
    K6_CASE(4, 1) K6_CASE(4, 2) K6_CASE(4, 4)
    K6_CASE(8, 1) K6_CASE(8, 2) K6_CASE(8, 4)
#undef K6_CASE
  }
  return cudaErrorInvalidValue;
}

// the largest divisor of n in [lo, hi], or 0
int divisor_in(int n, int lo, int hi) {
  for (int d = hi; d >= lo && d >= 1; --d)
    if (n % d == 0) return d;
  return 0;
}

}  // namespace

// plan = {BD, BH, BW, P, workspace floats} for a call on the current device
extern "C" int smilecode_conv3d_wgrad_plan(int B, int D, int H, int W, int Cin, int Cout,
                                           long long* plan, void* stream) {
  (void)stream;
  if (B < 1 || D < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1) return cudaErrorInvalidValue;
  const int tm = tile_m(Cout), tn = tile_n(Cin);
  int BW = divisor_in(W, 16, 32);
  if (!BW) BW = W < 32 ? W : 32;
  int BH = divisor_in(H, 4, 8);
  if (!BH) BH = H < 8 ? H : 8;
  int BD = kBrickVoxels / (BW * BH);
  BD = BD < 1 ? 1 : (BD > D ? D : BD);
  if (const int d = divisor_in(D, (BD + 1) / 2, BD)) BD = d;
  Geo g = geometry(B, D, H, W, Cin, Cout, tm, tn, BD, BH, BW, 1);
  int occ = 0;
  for (;;) {  // a brick whose two stages fit
    occ = 0;
    const cudaError_t err = dispatch(g, nullptr, nullptr, nullptr, 1, nullptr, &occ);
    if (err != cudaSuccess && err != cudaErrorInvalidValue) return err;
    if (occ > 0 || BD == 1) break;
    cudaGetLastError();  // a refused shared-memory size: a smaller brick
    BD = (BD + 1) / 2;
    g = geometry(B, D, H, W, Cin, Cout, tm, tn, BD, BH, BW, 1);
  }
  if (occ < 1) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // whole waves of blocks, each summing at most kMaxBricks bricks
  long long wave = static_cast<long long>(sms) * occ / g.tiles;
  wave = wave < 1 ? 1 : wave;
  const long long per_wave = wave * kMaxBricks;
  long long P = wave * ((g.n_bricks + per_wave - 1) / per_wave);
  P = P > g.n_bricks ? g.n_bricks : P;
  plan[0] = BD; plan[1] = BH; plan[2] = BW; plan[3] = P; plan[4] = P * g.E;
  return cudaSuccess;
}

// dW (Cout, Cin, 3, 3, 3) in float32, channels_last_3d, and, where db is not
// null, db (Cout), from x (B, D, H, W, Cin) and dy (B, D, H, W, Cout),
// contiguous and 16-byte aligned; ws holds P partials of E = Cout 27 Cin +
// Cout floats; (BD, BH, BW, P) from the plan
extern "C" int smilecode_conv3d_wgrad(const float* x, const float* dy, float* ws, float* dw,
                                      float* db, int B, int D, int H, int W, int Cin, int Cout,
                                      int BD, int BH, int BW, int P, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo g = geometry(B, D, H, W, Cin, Cout, tile_m(Cout), tile_n(Cin), BD, BH, BW, P);
  cudaError_t err = dispatch(g, x, dy, ws, db != nullptr, st, nullptr);
  if (err != cudaSuccess) return err;
  const long long values = db ? g.E : g.E - Cout;
  if (P >= 32) {
    const long long blocks = (values * 32 + 255) / 256;
    wgrad_reduce_kernel<32><<<static_cast<unsigned>(blocks), 256, 0, st>>>(ws, dw, db, g.E, P,
                                                                            Cout);
  } else {
    const long long blocks = (values + 255) / 256;
    wgrad_reduce_kernel<1><<<static_cast<unsigned>(blocks), 256, 0, st>>>(ws, dw, db, g.E, P,
                                                                           Cout);
  }
  return cudaGetLastError();
}
