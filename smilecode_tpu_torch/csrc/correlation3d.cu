// Windowed 3D correlation of PR++ (Dual-PRNet++) and its adjoint, float32
// (Hopper, sm_90a).
//
// K7 smilecode_correlation3d_fwd / _bwd replace no TPU kernel: the JAX
// package computes the correlation with XLA ops
// (smilecode_tpu/models/prnet.py:correlation3d), and the port's plain version
// (kernels/correlation3d.py:correlation3d_plain) builds 27 products of the
// whole feature map and sums each over the channels. For mov and fix
// (B, D, H, W, C), contiguous float32:
//   BM  = box(mov)                     on the volume,
//   BFp = box(fix) at p - 2            on the volume padded by 2 per side,
//   out[v, 9i + 3j + k] = sum_c BM[v, c] BFp[v + 2 (i, j, k), c] / 27,
// box the zero-padded 3^3 box sum: channel 9i + 3j + k pairs mov at v with
// fix at v + (2i - 2, 2j - 2, 2k - 2). The adjoint, in gather form:
//   dBM[v]  = sum_o g[v, o] BFp[v + 2o] / 27,
//   dBFp[p] = sum_o g[p - 2o, o] BM[p - 2o] / 27 (v = p - 2o in the volume),
//   d_mov = box(dBM), d_fix[x] = box(dBFp) at x + 2,
// the box sum being its own adjoint. Every voxel, displacement and channel
// is computed, in float32 FMAs; no atomics, so two calls give the same bits.
//
// What bounds it on the H100: bytes. Per voxel the correlation reads 2C
// values and writes 27 (54 C operations): at PR++'s C = 8-32 about two
// operations a byte against the card's 20. Each of the 27 displacements
// reads a whole row of C values, so the design serves those reads from
// shared memory:
// - correlation3d_box_kernel: a block owns a tile of 32 columns by TH rows
//   (TH C <= 128) and all channels, and walks a run of planes along D. Each
//   input plane is copied once into shared memory with its one-voxel halo
//   (cp.async, zero outside the input; the next plane's copy flies while
//   this one is summed), summed along W and then H there, and the plane
//   sums roll through registers, so the D sum costs two additions. One
//   kernel does all four boxes: BM, BFp, d_mov, d_fix (an input and an
//   output of different extents and an offset between their origins).
// - The three gathers (correlation3d_fwd_kernel, _bwd_mov_kernel,
//   _bwd_fix_kernel): a block owns 8 rows (a warp each) by 32 columns, a
//   thread a voxel, and walks a run of planes and, in each, the channels in
//   chunks (two vectors; bwd_fix one). For each (plane, chunk) it copies
//   the rows that the tile's 27 displacements reach, 3 planes x 12 rows x
//   36 columns (the tile and its 4-voxel reach), into shared memory with
//   cp.async, zero outside, double-buffered: the next copy flies while this
//   one is read. A warp's read of one displacement is then 32 consecutive
//   staged rows. fwd keeps the 27 sums of its voxel in registers over the
//   chunks and writes the block's results through shared memory as whole
//   rows; bwd_mov copies g's rows of the plane once; bwd_fix copies, for
//   the tile's source voxels p - 2o, the 9 channels of g that each
//   displacement plane needs, and reads BM's rows in place of BFp's.
// Rows of C values move as float4s where C is a multiple of 4 and every
// pointer 16-byte aligned (PR++'s C = 8, 16, 32), else as scalars.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kTW = 32;                        // columns (W) of a tile
constexpr int kTH = kThreads / kWarp;          // rows (H) of a gather tile: a warp each
constexpr int kCorr = 27;                      // displacements
constexpr int kBoxItems = 16;                  // floats of a box tile a thread holds
constexpr int kReach = 4;                      // a displacement moves up to 4 voxels
constexpr int kRowsT = kTH + kReach;           // rows of a gather's staged tile
constexpr int kColsT = kTW + kReach;           // columns of a gather's staged tile
constexpr int kTileRows = 3 * kRowsT * kColsT;  // rows a gather stages a (plane, chunk)
constexpr int kGatherBlocks = 2112;           // a gather's grid: 16 blocks per SM of 132

template <int VW>
struct Vec;
template <>
struct Vec<4> {
  float4 v;
  __device__ __forceinline__ void zero() { v = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void load(const float* p) { v = __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ __forceinline__ void lds(const float* p) { v = *reinterpret_cast<const float4*>(p); }
  __device__ __forceinline__ void store(float* p) const { *reinterpret_cast<float4*>(p) = v; }
  __device__ __forceinline__ float dot(const Vec& o) const {
    return fmaf(v.w, o.v.w, fmaf(v.z, o.v.z, fmaf(v.y, o.v.y, v.x * o.v.x)));
  }
  __device__ __forceinline__ void fma(float s, const Vec& o) {
    v.x = fmaf(s, o.v.x, v.x); v.y = fmaf(s, o.v.y, v.y);
    v.z = fmaf(s, o.v.z, v.z); v.w = fmaf(s, o.v.w, v.w);
  }
  __device__ __forceinline__ void add(const Vec& o) {
    v.x += o.v.x; v.y += o.v.y; v.z += o.v.z; v.w += o.v.w;
  }
  __device__ __forceinline__ void div(float s) {
    v.x /= s; v.y /= s; v.z /= s; v.w /= s;
  }
};
template <>
struct Vec<1> {
  float v;
  __device__ __forceinline__ void zero() { v = 0.f; }
  __device__ __forceinline__ void load(const float* p) { v = __ldg(p); }
  __device__ __forceinline__ void lds(const float* p) { v = *p; }
  __device__ __forceinline__ void store(float* p) const { *p = v; }
  __device__ __forceinline__ float dot(const Vec& o) const { return v * o.v; }
  __device__ __forceinline__ void fma(float s, const Vec& o) { v = fmaf(s, o.v, v); }
  __device__ __forceinline__ void add(const Vec& o) { v += o.v; }
  __device__ __forceinline__ void div(float s) { v /= s; }
};

__device__ __forceinline__ bool inside(int i, int n) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n);
}

// U bytes from src (global) to dst (shared), or U zero bytes where !valid
// (src is then not read)
template <int U>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? U : 0;
  if constexpr (U == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(U),
                 "r"(n));
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows of a box tile: TH C <= 128, at most 16
__host__ __device__ inline int box_rows(int C) {
  const int th = 128 / C;
  return th < 1 ? 1 : (th > 16 ? 16 : th);
}

// out[b, p, :] = sum over d in {-1, 0, 1}^3 of in[b, p + off + d, :], in zero
// outside (Di, Hi, Wi); out (B, Do, Ho, Wo, C). Block: columns blockIdx.x,
// rows blockIdx.y, batch and a run of `planes` output planes blockIdx.z.
template <int VW>
__global__ void __launch_bounds__(kThreads)
    correlation3d_box_kernel(const float* __restrict__ in, float* __restrict__ out, int Di,
                             int Hi, int Wi, int Do, int Ho, int Wo, int C, int off, int planes,
                             int runs) {
  extern __shared__ __align__(16) float smem[];
  const int th = box_rows(C);
  const int nq = C / VW;                       // vectors a voxel
  const int rawc = kTW + 2;                    // raw tile columns
  const int n_raw = (th + 2) * rawc * nq;      // vectors of a staged input plane
  float* raw[2] = {smem, smem + n_raw * VW};   // [th + 2][kTW + 2][C], two planes
  float* rows = smem + 2 * n_raw * VW;         // [th + 2][kTW][C]: W sums
  const int w0 = blockIdx.x * kTW, h0 = blockIdx.y * th;
  const int b = blockIdx.z / runs, d0 = (blockIdx.z % runs) * planes;
  const int d1 = min(d0 + planes, Do);
  const int items = th * kTW * nq;             // vectors of an output tile plane
  constexpr int kItems = kBoxItems / VW;       // vectors a thread holds
  Vec<VW> r0[kItems], r1[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    r0[k].zero();
    r1[k].zero();
  }
  const long long plane_in = static_cast<long long>(Hi) * Wi * C;
  const long long plane_out = static_cast<long long>(Ho) * Wo * C;
  // copy input plane di's tile with its halo into buf (zero outside the input)
  auto copy_plane = [&](int di, float* buf) {
    const bool din = inside(di, Di);
    const float* src = in + static_cast<long long>(b) * Di * plane_in;
    for (int i = threadIdx.x; i < n_raw; i += kThreads) {
      const int q = i % nq, c = (i / nq) % rawc, r = i / (nq * rawc);
      const int h = h0 + off - 1 + r, w = w0 + off - 1 + c;
      const bool ok = din && inside(h, Hi) && inside(w, Wi);
      cp_async<4 * VW>(buf + i * VW,
                       ok ? src + di * plane_in + (static_cast<long long>(h) * Wi + w) * C + q * VW
                          : src,
                       ok);
    }
    cp_commit();
  };
  int di = d0 + off - 1;
  copy_plane(di, raw[0]);
  for (int s = 0; di <= d1 + off; ++s, ++di) {
    if (di < d1 + off) {
      copy_plane(di + 1, raw[(s + 1) & 1]);  // flies while this plane is summed
    } else {
      cp_commit();
    }
    cp_wait_but_newest();
    __syncthreads();
    const float* cur = raw[s & 1];
    for (int i = threadIdx.x; i < (th + 2) * kTW * nq; i += kThreads) {
      const int q = i % nq, c = (i / nq) % kTW, r = i / (nq * kTW);
      const float* p = cur + (r * rawc + c) * C + q * VW;
      Vec<VW> a, x;
      a.lds(p);
      x.lds(p + C);
      a.add(x);
      x.lds(p + 2 * C);
      a.add(x);
      a.store(rows + (r * kTW + c) * C + q * VW);
    }
    __syncthreads();
    const int d = d0 + s - 2;  // the output plane that di completes
    float* dst = out + (static_cast<long long>(b) * Do + (d < 0 ? 0 : d)) * plane_out;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < items) {
        const int q = i % nq, c = (i / nq) % kTW, r = i / (nq * kTW);
        const float* p = rows + (r * kTW + c) * C + q * VW;
        Vec<VW> a, x;
        a.lds(p);
        x.lds(p + kTW * C);
        a.add(x);
        x.lds(p + 2 * kTW * C);
        a.add(x);  // the plane's 3 x 3 sum
        if (s >= 2 && h0 + r < Ho && w0 + c < Wo) {
          Vec<VW> o = r0[k];
          o.add(r1[k]);
          o.add(a);
          o.store(dst + (static_cast<long long>(h0 + r) * Wo + w0 + c) * C + q * VW);
        }
        r0[k] = r1[k];
        r1[k] = a;
      }
    }
  }
}

// Copy channels [c0, c0 + CV VW) of the rows a gather tile reaches into
// tile[CV][3][kRowsT][kColsT][VW] (a vector's rows together): plane
// z0 + i dz, row y0 + r, column x0 + c of src (Zs, Ys, Xs, C), zero outside
// it and past C; then commit the copies as a group.
template <int VW, int CV>
__device__ __forceinline__ void copy_tile(float* tile, const float* __restrict__ src, int Zs,
                                          int Ys, int Xs, int C, int z0, int dz, int y0, int x0,
                                          int c0) {
  for (int i = threadIdx.x; i < kTileRows * CV; i += kThreads) {
    const int u = i % CV, row = i / CV;
    const int c = row % kColsT, r = (row / kColsT) % kRowsT, pi = row / (kColsT * kRowsT);
    const int z = z0 + pi * dz, y = y0 + r, x = x0 + c, ch = c0 + u * VW;
    const bool ok = inside(z, Zs) && inside(y, Ys) && inside(x, Xs) && ch < C;
    cp_async<4 * VW>(tile + (u * kTileRows + row) * VW,
                     ok ? src + ((static_cast<long long>(z) * Ys + y) * Xs + x) * C + ch : src, ok);
  }
  cp_commit();
}

// Copy the rows of 27 values of a gather tile's voxels (8 rows of 32 from
// row0 + h0 W + w0 of src) into rows[kTH * kTW][27], zero outside; as
// 16-byte vectors where `vec` (W a multiple of 4, src 16-byte aligned: each
// row of voxels is then a whole number of aligned vectors), else as floats.
__device__ __forceinline__ void copy_rows27(float* rows, const float* __restrict__ src,
                                            long long row0, int h0, int w0, int H, int W,
                                            bool vec) {
  const int n = min(kTW, W - w0) * kCorr;  // floats of a row of voxels
  if (vec) {
    for (int i = threadIdx.x; i < kTH * kTW * kCorr / 4; i += kThreads) {
      const int rr = i / (kTW * kCorr / 4), q = (i % (kTW * kCorr / 4)) * 4;
      const bool ok = h0 + rr < H && q < n;
      cp_async<16>(rows + rr * kTW * kCorr + q,
                   ok ? src + (row0 + static_cast<long long>(h0 + rr) * W + w0) * kCorr + q : src,
                   ok);
    }
  } else {
    for (int i = threadIdx.x; i < kTH * kTW * kCorr; i += kThreads) {
      const int rr = i / (kTW * kCorr), q = i % (kTW * kCorr);
      const bool ok = h0 + rr < H && q < n;
      cp_async<4>(rows + i,
                  ok ? src + (row0 + static_cast<long long>(h0 + rr) * W + w0) * kCorr + q : src,
                  ok);
    }
  }
  cp_commit();
}

// the staged row of displacement o for the voxel at tile row r, column c
// (`back` false: rows v + 2o from the tile's origin; true: rows p - 2o, the
// origin 4 rows and columns before the tile, planes z0 - 2i)
__device__ __forceinline__ int tile_row(int o, int r, int c, bool back) {
  const int i = o / 9, j = (o / 3) % 3, k = o % 3;
  return back ? ((i * kRowsT + r + kReach - 2 * j) * kColsT + c + kReach - 2 * k)
              : ((i * kRowsT + r + 2 * j) * kColsT + c + 2 * k);
}

// the block's run of planes [z0, z1) of nz, and its batch
struct Run {
  int b, z0, z1;
  __device__ Run(int nz, int planes, int runs)
      : b(blockIdx.z / runs), z0((blockIdx.z % runs) * planes),
        z1(min((blockIdx.z % runs) * planes + planes, nz)) {}
};

// out[v, 27] over a run of planes of one tile of 8 rows by 32 columns
template <int VW>
__global__ void __launch_bounds__(kThreads)
    correlation3d_fwd_kernel(const float* __restrict__ bm, const float* __restrict__ bfp,
                             float* __restrict__ out, int D, int H, int W, int C, int planes,
                             int runs, int vec) {
  constexpr int CV = 2, kChunk = CV * VW;  // vectors, floats a (plane, chunk) stages
  extern __shared__ __align__(16) float smem[];
  float* tile[2] = {smem, smem + kTileRows * kChunk};  // BFp, two (plane, chunk)s
  float* stage = smem + 2 * kTileRows * kChunk;        // [kTH * kTW][27]: the results
  const Run run(D, planes, runs);
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const int r = threadIdx.x / kWarp, col = threadIdx.x % kWarp, h = h0 + r, w = w0 + col;
  const int Dp = D + 4, Hp = H + 4, Wp = W + 4;
  const float* src = bfp + static_cast<long long>(run.b) * Dp * Hp * Wp * C;
  const int nc = (C + kChunk - 1) / kChunk, steps = (run.z1 - run.z0) * nc;
  copy_tile<VW, CV>(tile[0], src, Dp, Hp, Wp, C, run.z0, 2, h0, w0, 0);
  float acc[kCorr];
  for (int t = 0; t < steps; ++t) {
    const int d = run.z0 + t / nc, c0 = (t % nc) * kChunk;
    if (t + 1 < steps) {
      copy_tile<VW, CV>(tile[(t + 1) & 1], src, Dp, Hp, Wp, C, run.z0 + (t + 1) / nc, 2, h0, w0,
                        ((t + 1) % nc) * kChunk);
    } else {
      cp_commit();
    }
    Vec<VW> mv[CV];
#pragma unroll
    for (int u = 0; u < CV; ++u) {
      if (h < H && w < W && c0 + u * VW < C) {
        mv[u].load(bm + (((static_cast<long long>(run.b) * D + d) * H + h) * W + w) * C + c0 +
                   u * VW);
      } else {
        mv[u].zero();
      }
    }
    if (c0 == 0) {
#pragma unroll
      for (int o = 0; o < kCorr; ++o) acc[o] = 0.f;
    }
    cp_wait_but_newest();
    __syncthreads();
    const float* cur = tile[t & 1];
#pragma unroll
    for (int o = 0; o < kCorr; ++o) {
      const int row = tile_row(o, r, col, false);
#pragma unroll
      for (int u = 0; u < CV; ++u) {
        Vec<VW> fv;
        fv.lds(cur + (u * kTileRows + row) * VW);
        acc[o] += mv[u].dot(fv);
      }
    }
    if (c0 + kChunk >= C) {  // the plane's last chunk: its results, as whole rows
#pragma unroll
      for (int o = 0; o < kCorr; ++o) stage[threadIdx.x * kCorr + o] = acc[o] / 27.f;
      __syncthreads();
      const long long row0 = ((static_cast<long long>(run.b) * D + d) * H) * W;
      const int n = min(kTW, W - w0) * kCorr;
      if (vec) {
        for (int i = threadIdx.x; i < kTH * kTW * kCorr / 4; i += kThreads) {
          const int rr = i / (kTW * kCorr / 4), q = (i % (kTW * kCorr / 4)) * 4;
          if (h0 + rr < H && q < n) {
            *reinterpret_cast<float4*>(out + (row0 + static_cast<long long>(h0 + rr) * W + w0) *
                                                 kCorr + q) =
                *reinterpret_cast<const float4*>(stage + rr * kTW * kCorr + q);
          }
        }
      } else {
        for (int i = threadIdx.x; i < kTH * kTW * kCorr; i += kThreads) {
          const int rr = i / (kTW * kCorr), q = i % (kTW * kCorr);
          if (h0 + rr < H && q < n) {
            out[(row0 + static_cast<long long>(h0 + rr) * W + w0) * kCorr + q] = stage[i];
          }
        }
      }
    }
    __syncthreads();  // tile[t & 1] and the stage are free again
  }
}

// dBM[v] = sum_o g[v, o] BFp[v + 2o] / 27 over a run of planes of one tile
// of 8 rows by 32 columns
template <int VW>
__global__ void __launch_bounds__(kThreads)
    correlation3d_bwd_mov_kernel(const float* __restrict__ g, const float* __restrict__ bfp,
                                 float* __restrict__ dbm, int D, int H, int W, int C, int planes,
                                 int runs, int vec) {
  constexpr int CV = 2, kChunk = CV * VW;
  extern __shared__ __align__(16) float smem[];
  float* tile[2] = {smem, smem + kTileRows * kChunk};  // BFp, two (plane, chunk)s
  float* gst = smem + 2 * kTileRows * kChunk;          // [kTH * kTW][27]: the plane's g
  const Run run(D, planes, runs);
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const int r = threadIdx.x / kWarp, col = threadIdx.x % kWarp, h = h0 + r, w = w0 + col;
  const int Dp = D + 4, Hp = H + 4, Wp = W + 4;
  const float* src = bfp + static_cast<long long>(run.b) * Dp * Hp * Wp * C;
  const int nc = (C + kChunk - 1) / kChunk, steps = (run.z1 - run.z0) * nc;
  copy_tile<VW, CV>(tile[0], src, Dp, Hp, Wp, C, run.z0, 2, h0, w0, 0);
  for (int t = 0; t < steps; ++t) {
    const int d = run.z0 + t / nc, c0 = (t % nc) * kChunk;
    const long long row0 = ((static_cast<long long>(run.b) * D + d) * H) * W;
    if (c0 == 0) copy_rows27(gst, g, row0, h0, w0, H, W, vec);  // the plane's g
    if (t + 1 < steps) {
      copy_tile<VW, CV>(tile[(t + 1) & 1], src, Dp, Hp, Wp, C, run.z0 + (t + 1) / nc, 2, h0, w0,
                        ((t + 1) % nc) * kChunk);
    } else {
      cp_commit();
    }
    cp_wait_but_newest();
    __syncthreads();
    if (h < H && w < W) {
      const float* cur = tile[t & 1];
      Vec<VW> acc[CV];
#pragma unroll
      for (int u = 0; u < CV; ++u) acc[u].zero();
#pragma unroll
      for (int o = 0; o < kCorr; ++o) {
        const int row = tile_row(o, r, col, false);
        const float gv = gst[threadIdx.x * kCorr + o];
#pragma unroll
        for (int u = 0; u < CV; ++u) {
          Vec<VW> fv;
          fv.lds(cur + (u * kTileRows + row) * VW);
          acc[u].fma(gv, fv);
        }
      }
#pragma unroll
      for (int u = 0; u < CV; ++u) {
        if (c0 + u * VW < C) {
          acc[u].div(27.f);
          acc[u].store(dbm + (row0 + static_cast<long long>(h) * W + w) * C + c0 + u * VW);
        }
      }
    }
    __syncthreads();  // tile[t & 1] and g's stage are free again
  }
}

// dBFp[p] = sum_o g[p - 2o, o] BM[p - 2o] / 27 over a run of padded planes
// of one tile of 8 rows by 32 columns
template <int VW>
__global__ void __launch_bounds__(kThreads)
    correlation3d_bwd_fix_kernel(const float* __restrict__ g, const float* __restrict__ bm,
                                 float* __restrict__ dbfp, int D, int H, int W, int C, int planes,
                                 int runs) {
  extern __shared__ __align__(16) float smem[];
  float* tile[2] = {smem, smem + kTileRows * VW};  // BM, two (plane, vector)s
  float* gs = smem + 2 * kTileRows * VW;            // [3][kRowsT][kColsT][9]: g's 9i..9i+8
  const int Dp = D + 4, Hp = H + 4, Wp = W + 4;
  const Run run(Dp, planes, runs);
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const int r = threadIdx.x / kWarp, col = threadIdx.x % kWarp, ph = h0 + r, pw = w0 + col;
  const float* src = bm + static_cast<long long>(run.b) * D * H * W * C;
  const float* gb = g + static_cast<long long>(run.b) * D * H * W * kCorr;
  const int nv = C / VW, steps = (run.z1 - run.z0) * nv;
  // BM's rows at planes pd - 2i (i = 0, 1, 2), from row h0 - 4 and column w0 - 4
  copy_tile<VW, 1>(tile[0], src, D, H, W, C, run.z0, -2, h0 - kReach, w0 - kReach, 0);
  for (int t = 0; t < steps; ++t) {
    const int pd = run.z0 + t / nv, c0 = (t % nv) * VW;
    if (c0 == 0) {  // g at the tile's source voxels, the channels each plane pd - 2i needs
      for (int i = threadIdx.x; i < kTileRows * 9; i += kThreads) {
        const int oo = i % 9, c = (i / 9) % kColsT, rr = (i / (9 * kColsT)) % kRowsT;
        const int pi = i / (9 * kColsT * kRowsT);
        const int vd = pd - 2 * pi, vh = h0 - kReach + rr, vw = w0 - kReach + c;
        const bool ok = inside(vd, D) && inside(vh, H) && inside(vw, W);
        cp_async<4>(gs + i, ok ? gb + ((static_cast<long long>(vd) * H + vh) * W + vw) * kCorr +
                                     9 * pi + oo
                               : gb,
                    ok);
      }
      cp_commit();
    }
    if (t + 1 < steps) {
      copy_tile<VW, 1>(tile[(t + 1) & 1], src, D, H, W, C, run.z0 + (t + 1) / nv, -2,
                       h0 - kReach, w0 - kReach, ((t + 1) % nv) * VW);
    } else {
      cp_commit();
    }
    cp_wait_but_newest();
    __syncthreads();
    if (ph < Hp && pw < Wp) {
      const float* cur = tile[t & 1];
      Vec<VW> acc;
      acc.zero();
#pragma unroll
      for (int o = 0; o < kCorr; ++o) {
        const int row = tile_row(o, r, col, true);
        Vec<VW> mv;
        mv.lds(cur + row * VW);
        acc.fma(gs[row * 9 + o % 9], mv);
      }
      acc.div(27.f);
      acc.store(dbfp + (((static_cast<long long>(run.b) * Dp + pd) * Hp + ph) * Wp + pw) * C + c0);
    }
    __syncthreads();  // tile[t & 1] and g's stage are free again
  }
}

bool aligned(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;  // the default; above it, for the current card
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int VW>
size_t gather_smem(int cv, int extra) {  // two staged (plane, cv vectors)s and `extra` floats
  return (static_cast<size_t>(kTileRows) * 2 * cv * VW + extra) * sizeof(float);
}

// runs of planes along D that spread a gather's grid of `tiles` tiles of B
// volumes of `nz` planes over about kGatherBlocks blocks: (planes, runs)
void plane_runs(long long tiles, int nz, int& planes, int& runs) {
  runs = static_cast<int>((kGatherBlocks + tiles - 1) / tiles);
  runs = runs < 1 ? 1 : (runs > nz ? nz : runs);
  planes = (nz + runs - 1) / runs;
  runs = (nz + planes - 1) / planes;
}

template <int VW>
cudaError_t box(const float* in, float* out, int B, int Di, int Hi, int Wi, int Do, int Ho,
                int Wo, int C, int off, cudaStream_t st) {
  const int th = box_rows(C);
  const size_t smem =
      static_cast<size_t>(2 * (th + 2) * (kTW + 2) + (th + 2) * kTW) * C * sizeof(float);
  const cudaError_t err = allow_smem(correlation3d_box_kernel<VW>, smem);
  if (err != cudaSuccess) return err;
  const int tw = (Wo + kTW - 1) / kTW, tiles_h = (Ho + th - 1) / th;
  // about 8 blocks per SM of the card's 132: runs of planes along D
  const long long tiles = static_cast<long long>(tw) * tiles_h * B;
  int runs = static_cast<int>((1056 + tiles - 1) / tiles);
  runs = runs < 1 ? 1 : (runs > Do ? Do : runs);
  const int planes = (Do + runs - 1) / runs;
  runs = (Do + planes - 1) / planes;
  const dim3 grid(tw, tiles_h, B * runs);
  correlation3d_box_kernel<VW><<<grid, kThreads, smem, st>>>(in, out, Di, Hi, Wi, Do, Ho, Wo, C,
                                                             off, planes, runs);
  return cudaGetLastError();
}

template <int VW>
cudaError_t forward(const float* mov, const float* fix, float* bm, float* bfp, float* out, int B,
                    int D, int H, int W, int C, cudaStream_t st) {
  cudaError_t err = box<VW>(mov, bm, B, D, H, W, D, H, W, C, 0, st);
  if (err == cudaSuccess) err = box<VW>(fix, bfp, B, D, H, W, D + 4, H + 4, W + 4, C, -2, st);
  const size_t smem = gather_smem<VW>(2, kThreads * kCorr);
  if (err == cudaSuccess) err = allow_smem(correlation3d_fwd_kernel<VW>, smem);
  if (err != cudaSuccess) return err;
  const int tw = (W + kTW - 1) / kTW, tiles_h = (H + kTH - 1) / kTH;
  int planes, runs;
  plane_runs(static_cast<long long>(tw) * tiles_h * B, D, planes, runs);
  correlation3d_fwd_kernel<VW><<<dim3(tw, tiles_h, B * runs), kThreads, smem, st>>>(
      bm, bfp, out, D, H, W, C, planes, runs, W % 4 == 0 && aligned(out));
  return cudaGetLastError();
}

template <int VW>
cudaError_t backward(const float* g, const float* bm, const float* bfp, float* dbm, float* dbfp,
                     float* dmov, float* dfix, int B, int D, int H, int W, int C,
                     cudaStream_t st) {
  const size_t smem_mov = gather_smem<VW>(2, kThreads * kCorr);
  const size_t smem_fix = gather_smem<VW>(1, kTileRows * 9);
  cudaError_t err = allow_smem(correlation3d_bwd_mov_kernel<VW>, smem_mov);
  if (err == cudaSuccess) err = allow_smem(correlation3d_bwd_fix_kernel<VW>, smem_fix);
  if (err != cudaSuccess) return err;
  int tw = (W + kTW - 1) / kTW, tiles_h = (H + kTH - 1) / kTH, planes, runs;
  plane_runs(static_cast<long long>(tw) * tiles_h * B, D, planes, runs);
  correlation3d_bwd_mov_kernel<VW><<<dim3(tw, tiles_h, B * runs), kThreads, smem_mov, st>>>(
      g, bfp, dbm, D, H, W, C, planes, runs, W % 4 == 0 && aligned(g));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tw = (W + 4 + kTW - 1) / kTW;
  tiles_h = (H + 4 + kTH - 1) / kTH;
  plane_runs(static_cast<long long>(tw) * tiles_h * B, D + 4, planes, runs);
  correlation3d_bwd_fix_kernel<VW><<<dim3(tw, tiles_h, B * runs), kThreads, smem_fix, st>>>(
      g, bm, dbfp, D, H, W, C, planes, runs);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = box<VW>(dbm, dmov, B, D, H, W, D, H, W, C, 0, st);
  if (err == cudaSuccess) err = box<VW>(dbfp, dfix, B, D + 4, H + 4, W + 4, D, H, W, C, 2, st);
  return err;
}

bool vectors(int C, const void* const* ptrs, int n) {
  if (C % 4) return false;
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16) return false;
  }
  return true;
}

bool valid(int B, int D, int H, int W, int C) {
  return B >= 1 && D >= 1 && H >= 1 && W >= 1 && C >= 1 && C <= 128 &&
         static_cast<long long>(B) * (D + 4) < 65536 &&
         static_cast<long long>(B) * D * H * W < (1LL << 31);
}

}  // namespace

// out (B, D, H, W, 27) from mov and fix (B, D, H, W, C); bm (B, D, H, W, C)
// and bfp (B, D + 4, H + 4, W + 4, C) are written for the backward.
extern "C" int smilecode_correlation3d_fwd(const float* mov, const float* fix, float* bm,
                                           float* bfp, float* out, int B, int D, int H, int W,
                                           int C, void* stream) {
  if (!valid(B, D, H, W, C)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {mov, fix, bm, bfp, out};
  return vectors(C, ptrs, 5) ? forward<4>(mov, fix, bm, bfp, out, B, D, H, W, C, st)
                             : forward<1>(mov, fix, bm, bfp, out, B, D, H, W, C, st);
}

// d_mov and d_fix (B, D, H, W, C) from g (B, D, H, W, 27) and the forward's
// bm and bfp; dbm and dbfp are scratch of bm's and bfp's sizes.
extern "C" int smilecode_correlation3d_bwd(const float* g, const float* bm, const float* bfp,
                                           float* dbm, float* dbfp, float* dmov, float* dfix,
                                           int B, int D, int H, int W, int C, void* stream) {
  if (!valid(B, D, H, W, C)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {bm, bfp, dbm, dbfp, dmov, dfix};
  return vectors(C, ptrs, 6) ? backward<4>(g, bm, bfp, dbm, dbfp, dmov, dfix, B, D, H, W, C, st)
                             : backward<1>(g, bm, bfp, dbm, dbfp, dmov, dfix, B, D, H, W, C, st);
}
