// Weight and bias gradient of a 3x3x3, stride-1, padding-1 convolution in
// float32 (Hopper, sm_90a).
//
// K6 smilecode_conv3d_wgrad replaces no TPU kernel: the JAX package leaves
// every convolution and its gradient to XLA (flax nn.Conv,
// smilecode_tpu/ops/blocks.py). On the H100 the port's f32 convolutions run
// on cuDNN, whose weight gradient for the NDHWC (channels_last_3d) layout and
// the 1-128 channels of ModeT and the baselines is `wgrad2d_grouped_direct`
// or `wgrad_alg1_nd`, at a few percent of its bound or less (PERF.md). K6
// takes that weight gradient; the forward and the input gradient stay on
// cuDNN.
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
// voxel against (Cin + Cout) 4 bytes read; 54-108 operations a byte at
// ModeT's full resolution, thousands at PR++'s 43- to 91-wide convs, against
// the card's 20). The design keeps the FMA pipes fed from shared memory:
// - A block owns a (TM output, TN input) channel tile and all 27 taps, and
//   walks bricks of output voxels: block p of the grid's y takes bricks p,
//   p + P, ... For each brick it stages the brick's dy (TM channels) and
//   the brick's x with its one-voxel halo (TN channels) in shared memory
//   with cp.async, zero-filled outside the volume; the next brick's copies
//   fly while this one is summed. The grid's x is the channel tile, so the
//   blocks that share a brick run together and, at wide channel counts, a
//   brick's x and dy come from L2 after their first read.
// - A warp holds a group of TT taps; its 32 lanes take 32 voxels at a time,
//   each lane a register tile of TM x TT x TN accumulators. Per voxel a lane
//   reads TM dy values and TT rows of TN x values as 16-, 8- or 4-byte
//   vectors (consecutive voxels on consecutive lanes, so the reads are free
//   of bank conflicts) and issues TM TT TN FMAs. TT is 27, 9 or 3 so that a
//   lane holds 27-108 accumulators.
// - (TM, TN) follow the channel counts: an even count takes the largest of
//   8, 4, 2 (TM) or 4, 2 (TN) that divides it; an odd count of 3 or more a
//   ragged tile of 8 (TM, from 5 up) or 4, whose last tile along that axis
//   is masked (59 -> 59 runs as 8 x 15 tiles of 8 x 4); a count of 1, 1.
// - A voxel's channels start 16-byte aligned only where the count is a
//   multiple of 4. Where a tile does not divide its count, each voxel's piece
//   of TM or TN channels is copied as the 16-byte chunks that cover it into a
//   raw slot, and a realign pass moves it to the aligned layout the lanes
//   read, zero-filling channels past the count and voxels outside the
//   volume. One stage and the raw slots fit in shared memory: the next
//   brick's chunks fly while this brick is summed, the realign pass between
//   the two. Where the tiles divide, the copies land in two aligned stages
//   directly.
// - After its last brick a block adds its lanes (a butterfly over the warp)
//   and its warps of the same taps in a fixed order, and writes one partial
//   of its tile (nothing past Cout or Cin). A second kernel sums the P
//   partials of every value in a fixed order and writes dW in the port's
//   weight layout, channels_last_3d ((Cout, kd, kh, kw, Cin) in memory), and
//   db. No atomics: two calls on the same inputs give the same bits, and the
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
constexpr int kMaxPartials = 65535;  // the grid's y

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
  // floats of a raw slot: the 16-byte chunks that cover TM (RD) or TN (RX)
  // values starting anywhere in a chunk
  static constexpr int RD = (TM + 6) / 4 * 4;
  static constexpr int RX = (TN + 6) / 4 * 4;
};

struct Geo {
  int B, D, H, W, Cin, Cout;
  int BD, BH, BW;           // brick of output voxels
  int nbd, nbh, nbw, n_bricks;
  int rs, ps, HV;           // halo row and plane strides, halo voxels: (BD+2)(BH+2)(BW+2)
  int BV, BVp;              // brick voxels, rounded up to a whole warp
  int P, ci_tiles, tiles;   // partials, channel tiles
  int realign;              // a tile does not divide its count: raw slots and a realign pass
  long long E;              // values of one partial: Cout 27 Cin + Cout
  long long nx, ndy;        // floats of x and dy
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
  g.ci_tiles = (Cin + tn - 1) / tn; g.tiles = (Cout + tm - 1) / tm * g.ci_tiles;
  g.realign = Cin % tn != 0 || Cout % tm != 0;
  g.E = static_cast<long long>(Cout) * kTaps * Cin + Cout;
  const long long vox = static_cast<long long>(B) * D * H * W;
  g.nx = vox * Cin; g.ndy = vox * Cout;
  return g;
}

template <int TM, int TN>
__host__ __device__ inline int stage_floats(const Geo& g) {  // dy then x, a multiple of 4 floats
  return (g.BVp * TM + g.HV * TN + 3) / 4 * 4;
}

template <int TM, int TN>
__host__ __device__ inline int second_floats(const Geo& g) {  // the second stage, or the raw slots
  using T = Tile<TM, TN>;
  return g.realign ? g.BVp * T::RD + g.HV * T::RX : stage_floats<TM, TN>(g);
}

template <int TM, int TN>
size_t smem_bytes(const Geo& g) {
  using T = Tile<TM, TN>;
  // stages or stage and raw slots; hoff; the cells
  const long long stages = static_cast<long long>(stage_floats<TM, TN>(g)) +
                           second_floats<TM, TN>(g) + 3LL * g.BVp + 2LL * g.HV;
  const long long red = static_cast<long long>(T::VW) * T::R;
  return static_cast<size_t>(stages > red ? stages : red) * sizeof(float);
}

// U bytes from src into dst, of which the first n are read and the rest
// zero-filled (src not read where n is 0)
template <int U>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (U == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(U),
                 "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

template <int N>
__device__ __forceinline__ void sts(float* p, const float* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// A voxel of the brick or of its halo, the same in every brick: its offset
// in voxels from the brick's first voxel, and its coordinates in the brick
// (the halo's from the corner of the halo), packed d | h << 11 | w << 22; -1
// for the padding voxels past BV
struct Cell {
  int rel, at;
};

__device__ __forceinline__ int cell_at(int d, int h, int w) { return d | h << 11 | w << 22; }

// the brick voxels' and halo voxels' cells
__device__ void cells(Cell* vt, Cell* ht, int threads, const Geo& g) {
  const long long hw = static_cast<long long>(g.H) * g.W;
  for (int v = threadIdx.x; v < g.BVp; v += threads) {
    const int r = v / g.BW, d = r / g.BH, h = r % g.BH, w = v % g.BW;
    vt[v] = v < g.BV ? Cell{static_cast<int>(d * hw + h * g.W + w), cell_at(d, h, w)}
                     : Cell{0, -1};
  }
  const int hrow = g.BH + 2;
  for (int i = threadIdx.x; i < g.HV; i += threads) {
    const int r = i / g.rs, d = r / hrow, h = r % hrow, w = i % g.rs;
    ht[i] = Cell{static_cast<int>((d - 1) * hw + (h - 1) * g.W + w - 1), cell_at(d, h, w)};
  }
}

struct Brick {
  long long vox0;   // its first voxel
  int d0, h0, w0;
};

__device__ __forceinline__ Brick brick(int q, const Geo& g) {
  Brick k;
  int t = q;
  k.w0 = (t % g.nbw) * g.BW;
  t /= g.nbw;
  k.h0 = (t % g.nbh) * g.BH;
  t /= g.nbh;
  k.d0 = (t % g.nbd) * g.BD;
  const long long b = t / g.nbd;
  k.vox0 = ((b * g.D + k.d0) * g.H + k.h0) * g.W + k.w0;
  return k;
}

// whether a brick voxel lies in the volume (false for the padding)
__device__ __forceinline__ bool inside(const Cell& c, const Brick& k, const Geo& g) {
  return c.at >= 0 && k.d0 + (c.at & 2047) < g.D && k.h0 + ((c.at >> 11) & 2047) < g.H &&
         k.w0 + (c.at >> 22) < g.W;
}

// whether a halo voxel lies in the volume
__device__ __forceinline__ bool inside_halo(const Cell& c, const Brick& k, const Geo& g) {
  return static_cast<unsigned>(k.d0 + (c.at & 2047) - 1) < static_cast<unsigned>(g.D) &&
         static_cast<unsigned>(k.h0 + ((c.at >> 11) & 2047) - 1) < static_cast<unsigned>(g.H) &&
         static_cast<unsigned>(k.w0 + (c.at >> 22) - 1) < static_cast<unsigned>(g.W);
}

// brick q's dy (GM vectors of VM channels from co0, [GM][BVp][VM]) and x
// with its halo (TN channels from ci0, [HV][TN]) into one stage; the tiles
// divide Cout and Cin, so every vector is aligned and in range
template <int TM, int TN>
__device__ void stage(const float* __restrict__ x, const float* __restrict__ dy, float* dys,
                      float* xs, const Cell* vt, const Cell* ht, int q, int co0, int ci0,
                      const Geo& g) {
  using T = Tile<TM, TN>;
  const Brick k = brick(q, g);
  for (int v = threadIdx.x; v < g.BVp; v += T::kThreads) {
    const Cell c = vt[v];
    const bool in = inside(c, k, g);
    const float* src = in ? dy + (k.vox0 + c.rel) * g.Cout + co0 : dy;
#pragma unroll
    for (int j = 0; j < T::GM; ++j)
      cp_async<T::VM * 4>(dys + (j * g.BVp + v) * T::VM, src + (in ? j * T::VM : 0),
                          in ? T::VM * 4 : 0);
  }
  for (int i = threadIdx.x; i < g.HV; i += T::kThreads) {
    const Cell c = ht[i];
    const bool in = inside_halo(c, k, g);
    cp_async<TN * 4>(xs + i * TN, in ? x + (k.vox0 + c.rel) * g.Cin + ci0 : x, in ? TN * 4 : 0);
  }
}

// the 16-byte chunks that cover the LEN floats at offset o of a tensor of n
// floats into a raw slot of C chunks, the bytes past n zero-filled
template <int LEN, int C>
__device__ __forceinline__ void chunks(float* slot, const float* base, long long o, long long n) {
  const long long a = o & ~3LL;
  const int need = (static_cast<int>(o & 3) + LEN + 3) >> 2;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (j < need) {
      const long long left = n - a - 4 * j;
      const int bytes = left >= 4 ? 16 : (left > 0 ? static_cast<int>(left) * 4 : 0);
      cp_async<16>(slot + 4 * j, bytes ? base + a + 4 * j : base, bytes);
    }
  }
}

// brick q's pieces as the chunks that cover them into the raw slots: each
// brick voxel's TM dy channels from co0 ([BVp][RD]), each halo voxel's TN x
// channels from ci0 ([HV][RX]); voxels outside the volume not read
template <int TM, int TN>
__device__ void stage_raw(const float* __restrict__ x, const float* __restrict__ dy, float* rdy,
                          float* rx, const Cell* vt, const Cell* ht, int q, int co0, int ci0,
                          const Geo& g) {
  using T = Tile<TM, TN>;
  const Brick k = brick(q, g);
  for (int v = threadIdx.x; v < g.BVp; v += T::kThreads) {
    const Cell c = vt[v];
    if (inside(c, k, g))
      chunks<TM, T::RD / 4>(rdy + v * T::RD, dy, (k.vox0 + c.rel) * g.Cout + co0, g.ndy);
  }
  for (int i = threadIdx.x; i < g.HV; i += T::kThreads) {
    const Cell c = ht[i];
    if (inside_halo(c, k, g))
      chunks<TN, T::RX / 4>(rx + i * T::RX, x, (k.vox0 + c.rel) * g.Cin + ci0, g.nx);
  }
}

// the N values that start s floats into a raw slot of R floats
template <int N, int R>
__device__ __forceinline__ void pick(const float* slot, int s, float* out) {
  float raw[R];
#pragma unroll
  for (int c = 0; c < R; c += 4) lds<4>(slot + c, raw + c);
#pragma unroll
  for (int m = 0; m < N; ++m) {
    float t = raw[m];
#pragma unroll
    for (int j = 1; j < 4; ++j)
      if (m + j < R && s == j) t = raw[m + j];
    out[m] = t;
  }
}

// brick q's pieces from the raw slots into a stage's aligned layout (as
// `stage` writes it), zero past Cout or Cin and outside the volume
template <int TM, int TN>
__device__ void realign(const float* rdy, const float* rx, float* dys, float* xs, const Cell* vt,
                        const Cell* ht, int q, int co0, int ci0, const Geo& g) {
  using T = Tile<TM, TN>;
  const Brick k = brick(q, g);
  for (int v = threadIdx.x; v < g.BVp; v += T::kThreads) {
    const Cell c = vt[v];
    const bool in = inside(c, k, g);
    float dv[TM];
    pick<TM, T::RD>(rdy + v * T::RD, static_cast<int>(((k.vox0 + c.rel) * g.Cout + co0) & 3), dv);
#pragma unroll
    for (int m = 0; m < TM; ++m) dv[m] = in && co0 + m < g.Cout ? dv[m] : 0.f;
#pragma unroll
    for (int j = 0; j < T::GM; ++j) sts<T::VM>(dys + (j * g.BVp + v) * T::VM, dv + j * T::VM);
  }
  for (int i = threadIdx.x; i < g.HV; i += T::kThreads) {
    const Cell c = ht[i];
    const bool in = inside_halo(c, k, g);
    float xv[TN];
    pick<TN, T::RX>(rx + i * T::RX, static_cast<int>(((k.vox0 + c.rel) * g.Cin + ci0) & 3), xv);
#pragma unroll
    for (int n = 0; n < TN; ++n) xv[n] = in && ci0 + n < g.Cin ? xv[n] : 0.f;
    sts<TN>(xs + i * TN, xv);
  }
}

// voxel v's TM dy values and the TT taps' rows of TN x values of its group
template <int TM, int TN>
__device__ __forceinline__ void load_voxel(const float* dys, const float* xs, const int* hoff,
                                           int v, int bvp, int pso, int rso,
                                           float (&dv)[TM], float (&xt)[Tile<TM, TN>::TT][TN]) {
  using T = Tile<TM, TN>;
#pragma unroll
  for (int c = 0; c < T::GM; ++c) lds<T::VM>(dys + (c * bvp + v) * T::VM, dv + c * T::VM);
  const float* xv = xs + hoff[v] * TN;
#pragma unroll
  for (int t = 0; t < T::TT; ++t)
    lds<TN>(xv + (t / 9) * pso + ((t / 3) % 3) * rso + (t % 3) * TN, xt[t]);
}

template <int TM, int TN>
__device__ __forceinline__ void fma_voxel(const float (&dv)[TM],
                                          const float (&xt)[Tile<TM, TN>::TT][TN],
                                          float (&acc)[TM][Tile<TM, TN>::TT][TN],
                                          float (&bb)[TM], bool bias) {
  if (bias) {
#pragma unroll
    for (int m = 0; m < TM; ++m) bb[m] += dv[m];
  }
#pragma unroll
  for (int t = 0; t < Tile<TM, TN>::TT; ++t)
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[m][t][n] = fmaf(dv[m], xt[t][n], acc[m][t][n]);
}

template <int TM, int TN>
__global__ void __launch_bounds__(Tile<TM, TN>::kThreads, 1)
    wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy, float* __restrict__ ws,
                 const Geo g, int want_bias) {
  using T = Tile<TM, TN>;
  constexpr int TT = T::TT;
  extern __shared__ __align__(16) float smem[];
  const int sf = stage_floats<TM, TN>(g);
  float* const rdy = smem + sf;  // realign: the raw slots after the one stage
  float* const rx = rdy + g.BVp * T::RD;
  int* hoff = reinterpret_cast<int*>(smem + sf + second_floats<TM, TN>(g));
  Cell* vt = reinterpret_cast<Cell*>(hoff + g.BVp);  // BVp is even: 8-byte aligned
  Cell* ht = vt + g.BVp;
  const int co0 = (blockIdx.x / g.ci_tiles) * TM, ci0 = (blockIdx.x % g.ci_tiles) * TN;
  const int p = blockIdx.y;
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
  cells(vt, ht, T::kThreads, g);
  __syncthreads();

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
  if (g.realign)
    stage_raw<TM, TN>(x, dy, rdy, rx, vt, ht, p, co0, ci0, g);
  else
    stage<TM, TN>(x, dy, smem, smem + g.BVp * TM, vt, ht, p, co0, ci0, g);
  cp_async_commit();
  for (int q = p; q < g.n_bricks; q += g.P) {
    cp_async_wait_all();
    __syncthreads();
    float* const cur = smem + buf * sf;
    if (g.realign) {
      realign<TM, TN>(rdy, rx, cur, cur + g.BVp * TM, vt, ht, q, co0, ci0, g);
      __syncthreads();
    }
    if (q + g.P < g.n_bricks) {
      if (g.realign) {
        stage_raw<TM, TN>(x, dy, rdy, rx, vt, ht, q + g.P, co0, ci0, g);
      } else {
        float* const nxt = smem + (buf ^ 1) * sf;
        stage<TM, TN>(x, dy, nxt, nxt + g.BVp * TM, vt, ht, q + g.P, co0, ci0, g);
      }
    }
    cp_async_commit();
    const float* dys = cur;
    const float* xs = cur + g.BVp * TM + base * TN;
    float bb[TM];  // db over this brick's voxels, added to bacc after it: a sum of short sums
#pragma unroll
    for (int m = 0; m < TM; ++m) bb[m] = 0.f;
#pragma unroll 1
    for (int v = vw * kWarp + lane; v < g.BVp; v += kWarp * T::VW) {
      float dv[TM], xt[TT][TN];
      load_voxel<TM, TN>(dys, xs, hoff, v, g.BVp, pso, rso, dv, xt);
      fma_voxel<TM, TN>(dv, xt, acc, bb, bias);
    }
    if (bias) {
#pragma unroll
      for (int m = 0; m < TM; ++m) bacc[m] += bb[m];
    }
    __syncthreads();
    if (!g.realign) buf ^= 1;
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
  float* out = ws + static_cast<long long>(p) * g.E;
  const int nb = (want_bias && ci0 == 0) ? T::R : T::R - TM;
  for (int i = threadIdx.x; i < nb; i += T::kThreads) {
    float s = smem[i];
#pragma unroll
    for (int k = 1; k < T::VW; ++k) s += smem[k * T::R + i];
    if (i < TM * kTaps * TN) {
      const int m = i / (kTaps * TN), r = i % (kTaps * TN);
      if (co0 + m < g.Cout && ci0 + r % TN < g.Cin)
        out[(static_cast<long long>(co0 + m) * kTaps + r / TN) * g.Cin + ci0 + r % TN] = s;
    } else if (co0 + i - TM * kTaps * TN < g.Cout) {
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

// the channel tiles: an even count the largest of 8, 4, 2 (TM) or 4, 2 (TN)
// that divides it; an odd count of 3 or more a ragged 8 (TM from 5) or 4;
// a count of 1, 1
int tile_m(int cout) {
  if (cout % 2 && cout > 1) return cout >= 5 ? 8 : 4;
  return cout % 8 == 0 ? 8 : cout % 4 == 0 ? 4 : cout % 2 == 0 ? 2 : 1;
}
int tile_n(int cin) {
  if (cin % 2 && cin > 1) return 4;
  return cin % 4 == 0 ? 4 : cin % 2 == 0 ? 2 : 1;
}

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
  wgrad_kernel<TM, TN><<<dim3(g.tiles, g.P), T::kThreads, smem, stream>>>(x, dy, ws, g, want_bias);
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
  for (;;) {  // a brick whose stages (or stage and raw slots) fit
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
  if (static_cast<long long>(BD + 2) * H * W > 2147483647LL) return cudaErrorInvalidValue;
  // P partials, each block summing at most kMaxBricks bricks: the fewest
  // waves of blocks times the bricks of a block, with a quarter of a brick
  // for a block's set-up and reduction; the smaller P of two that tie
  const long long slots = static_cast<long long>(sms) * occ;
  const int hi = g.n_bricks < kMaxPartials ? g.n_bricks : kMaxPartials;
  const int lo = (g.n_bricks + kMaxBricks - 1) / kMaxBricks < hi
                     ? (g.n_bricks + kMaxBricks - 1) / kMaxBricks : hi;
  long long P = lo, best = -1;
  for (int p = lo; p <= hi; ++p) {
    const long long waves = (static_cast<long long>(g.tiles) * p + slots - 1) / slots;
    const long long cost = waves * (4LL * ((g.n_bricks + p - 1) / p) + 1);
    if (best < 0 || cost < best) best = cost, P = p;
  }
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
