// Adjoint of the trilinear warp (Hopper, sm_90a).
//
// K5 smilecode_warp3d_trilinear_bwd replaces the TPU kernels
// smilecode_tpu/kernels/warp3d_v4.py:_warp_v4_dflow_kernel and
// smilecode_tpu/kernels/warp3d_v3.py:_warp_v3_dflow_kernel (d_flow), fused
// with the d_src scatter that the TPU path leaves to XLA
// (smilecode_tpu/models/modet_planes.py:_warp_hw_bwd). Forward (K2,
// warp3d.cu): out[x, c] = sum over the 8 corners of w_corner(coord) *
// src[corner, c], coord = (grid + flow) * rescale, w = 0 for a corner outside
// the volume. For the output cotangent g:
//   d_coord_a = sum_corners (+-1 on axis a) * (the other two axes' weights)
//               * [corner in volume] * sum_c g_c * src[corner, c]
//   d_flow_a  = d_coord_a * rescale_a
//   d_src[corner, c] += w_corner * g_c        (atomic add; only when asked)
// which is the derivative that autodiff of the gather oracle gives
// (smilecode_tpu/ops/warp.py:warp_coords), with floor's derivative 0.
//
// D-origin mode (K2's, warp3d.cu): coord_d = fd + flow_d + d0 on a source of
// SD slices, scale 1; d_flow stays the output's (local), and d_src covers
// all SD slices (SD/FD times K2's output: the caller reduce-scatters it over
// the shards, smilecode_tpu/parallel/modet_planes_sp.py:259-270).
//
// Layout: src, d_src (B, SD, SH, SW, C) contiguous; flow, d_flow
// (B, FD, FH, FW, 3) float32; g (B, FD, FH, FW, C). src and g share one
// storage type T, float32 or bf16 (io_types.cuh); d_flow and d_src are
// float32 whatever T is. d_src must be zeroed by the caller; pass null to
// skip the scatter (a source that needs no gradient).
//
// With bf16 src and g (the bf16 feature path) both are read as float32 and
// d_flow is float32, as G and H give float32 d-coordinates
// (warp3d_v4.py:521, :537). The d_src scatter of a bf16 source still adds
// into a float32 buffer, which the caller casts to bf16 once: a bf16
// atomicAdd would make the sum depend on the order of the additions at an
// 8-bit mantissa. The TPU path leaves d_src to XLA's scatter
// (models/modet_planes.py:305-308), so this accumulation type is the
// port's choice.
//
// What bounds it on the H100: memory and the scatter's atomics. Per output
// voxel it reads 8 corner rows of src and one row of g, and with d_src adds
// 8 * C values into the corner rows. The corner offsets, weights and
// derivative coefficients are computed once per voxel (corner order and
// weight products as in K2); per corner the kernel first reduces
// sum_c g_c * src_c, so d_flow costs 8 multiply-adds per channel. The TPU's
// window budgets and guard ladder have no counterpart. As in K2:
// - Vector path (a row a whole number of 16-byte vectors; src, g and d_src
//   16-byte aligned): G lanes per output voxel, each reading one 16-byte
//   vector of g and of each corner row; the group's first lane computes the
//   corner offsets and weights and __shfl_sync's them to the others, as in
//   K2. Each lane forms its partial sum_c g_c * src[corner, c] over its own
//   vectors; the group adds the 8 partials with __shfl_xor_sync and its
//   first lane writes d_flow. The
//   scatter is one 16-byte vector atomic (atomicAdd(float4*, float4), global
//   memory, sm_90) per 4 float32 values: per lane and corner one for a
//   float32 vector, two for a bf16 vector of 8. That is a quarter of the
//   atomic instructions of a scalar scatter, and a warp's atomics into one
//   corner row are contiguous.
// - Scalar path (C=1, C=3, odd rows, misaligned views): one thread per
//   voxel, scalar atomics. A thread's own rows are C * 4 bytes apart from
//   its neighbours', so atomics made per channel would make each warp
//   instruction touch up to 32 sectors. Instead the warp transposes its
//   scatter: lane j takes values j, j + 32, ... of the warp's 32 * C values
//   of g, one contiguous span, with the corner offset and weight of the
//   voxel each belongs to from __shfl_sync. For a smooth flow neighbouring
//   voxels' corner rows are neighbours too, so each atomic instruction then
//   covers about 32 contiguous floats, as a channels-first scatter would
//   (C=3 at 160x192x160 on the H100: 0.80 ms per call with per-channel
//   atomics, 0.37 transposed).
// Indices are 32-bit where every element index of the call fits; a 64-bit
// instance serves larger tensors.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "io_types.cuh"

namespace {

using smilecode::kVec16;
using smilecode::ldg_f32;
using smilecode::ldg_vec16;

constexpr int kThreads = 256;
// the largest element index a 32-bit instance meets, with room for one block
// past the end
constexpr long long kNarrow = (1LL << 31) - (1LL << 16);

struct Geom {
  int SD, SH, SW, C, FD, FH, FW;
  int d0;  // D origin: output slice fd samples at source depth coordinate fd + d0 + flow
  float scale_d, scale_h, scale_w;
};

// The 8 corners of output voxel vox, whose flow row is (f0, f1, f2):
// element offset of each corner's row in src (-1 outside the volume), its
// weight, and the fractional coordinates t.
template <typename I>
__device__ __forceinline__ void corners(const Geom& g, I vox, float f0, float f1, float f2,
                                        I (&off)[8], float (&wt)[8], float (&t)[3]) {
  // vox = ((b*FD + fd)*FH + fh)*FW + fw
  I v = vox;
  const int fw = static_cast<int>(v % g.FW);
  v /= g.FW;
  const int fh = static_cast<int>(v % g.FH);
  v /= g.FH;
  const int fd = static_cast<int>(v % g.FD);
  const I b = v / g.FD;
  const float cd = (static_cast<float>(fd) + f0 + static_cast<float>(g.d0)) * g.scale_d;
  const float ch = (static_cast<float>(fh) + f1) * g.scale_h;
  const float cw = (static_cast<float>(fw) + f2) * g.scale_w;
  const float d0 = floorf(cd), h0 = floorf(ch), w0 = floorf(cw);
  t[0] = cd - d0;
  t[1] = ch - h0;
  t[2] = cw - w0;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int od = corner >> 2, oh = (corner >> 1) & 1, ow = corner & 1;
    const float id = d0 + od, ih = h0 + oh, iw = w0 + ow;
    const bool inb = id >= 0.f && id <= g.SD - 1 && ih >= 0.f && ih <= g.SH - 1 &&
                     iw >= 0.f && iw <= g.SW - 1;
    wt[corner] = (od ? t[0] : 1.f - t[0]) * (oh ? t[1] : 1.f - t[1]) * (ow ? t[2] : 1.f - t[2]);
    off[corner] = inb ? (((b * g.SD + static_cast<I>(id)) * g.SH + static_cast<I>(ih)) * g.SW +
                         static_cast<I>(iw)) * g.C
                      : I(-1);
  }
}

// d_flow of one voxel from the per-corner sums gv = sum_c g_c * src[corner, c]
template <typename I>
__device__ __forceinline__ void d_flow_row(const Geom& g, const I (&off)[8], const float (&t)[3],
                                           const float (&gv)[8], float* df) {
  float ad = 0.f, ah = 0.f, aw = 0.f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    if (off[corner] < 0) continue;
    const int od = corner >> 2, oh = (corner >> 1) & 1, ow = corner & 1;
    const float wd = od ? t[0] : 1.f - t[0], wh = oh ? t[1] : 1.f - t[1],
                ww = ow ? t[2] : 1.f - t[2];
    ad += (od ? 1.f : -1.f) * wh * ww * gv[corner];
    ah += wd * (oh ? 1.f : -1.f) * ww * gv[corner];
    aw += wd * wh * (ow ? 1.f : -1.f) * gv[corner];
  }
  df[0] = ad * g.scale_d;
  df[1] = ah * g.scale_h;
  df[2] = aw * g.scale_w;
}

// Vector path: 2^lanes_log2 lanes per output voxel, 16-byte loads, vector
// atomics.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
warp3d_bwd_vector_kernel(const T* __restrict__ src, const float* __restrict__ flow,
                         const T* __restrict__ g, float* __restrict__ d_src,
                         float* __restrict__ d_flow, Geom geo, int lanes_log2, I n_vox) {
  constexpr int N = kVec16<T>;
  const I t = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  const I vox = t >> lanes_log2;
  const int lanes = 1 << lanes_log2;
  const int lane = static_cast<int>(t & (lanes - 1));
  // no early return: every lane of a warp takes part in the shuffles below
  const bool valid = vox < n_vox;
  I off[8];
  float wt[8], tt[3], gv[8];
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    off[corner] = -1;
    wt[corner] = gv[corner] = 0.f;
  }
  if (valid && lane == 0) {
    const float* f = flow + vox * 3;
    corners(geo, vox, __ldg(f), __ldg(f + 1), __ldg(f + 2), off, wt, tt);
  }
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    off[corner] = __shfl_sync(0xffffffffu, off[corner], 0, lanes);
    wt[corner] = __shfl_sync(0xffffffffu, wt[corner], 0, lanes);
  }
  if (valid) {
    const T* gp = g + vox * geo.C;
    for (int v = lane * N; v < geo.C; v += lanes * N) {
      float gc[N];
      ldg_vec16(gp + v, gc);
      float x[8][N];
#pragma unroll
      for (int corner = 0; corner < 8; ++corner)
        if (off[corner] >= 0) ldg_vec16(src + off[corner] + v, x[corner]);
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) {
        if (off[corner] < 0) continue;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < N; ++e) s += gc[e] * x[corner][e];
        gv[corner] += s;
        if (d_src) {
#pragma unroll
          for (int e = 0; e < N; e += 4)
            atomicAdd(reinterpret_cast<float4*>(d_src + off[corner] + v + e),
                      make_float4(wt[corner] * gc[e], wt[corner] * gc[e + 1],
                                  wt[corner] * gc[e + 2], wt[corner] * gc[e + 3]));
        }
      }
    }
  }
  for (int m = 1; m < lanes; m <<= 1) {
#pragma unroll
    for (int corner = 0; corner < 8; ++corner)
      gv[corner] += __shfl_xor_sync(0xffffffffu, gv[corner], m);
  }
  if (valid && lane == 0) d_flow_row(geo, off, tt, gv, d_flow + vox * 3);
}

// Scalar path: one thread per output voxel; the scatter is transposed across
// the warp (see the note at the top).
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
warp3d_bwd_scalar_kernel(const T* __restrict__ src, const float* __restrict__ flow,
                         const T* __restrict__ g, float* __restrict__ d_src,
                         float* __restrict__ d_flow, Geom geo, I n_vox) {
  const int lane = threadIdx.x & 31;
  const I warp_first = static_cast<I>(blockIdx.x) * kThreads + (threadIdx.x - lane);
  const I vox = warp_first + lane;
  // no early return: every lane of a warp takes part in the scatter's shuffles
  const bool valid = vox < n_vox;
  I off[8];
  float wt[8], tt[3], gv[8];
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    off[corner] = -1;
    wt[corner] = gv[corner] = 0.f;
  }
  if (valid) {
    const float* f = flow + vox * 3;
    corners(geo, vox, __ldg(f), __ldg(f + 1), __ldg(f + 2), off, wt, tt);
    const T* gp = g + vox * geo.C;
    for (int c = 0; c < geo.C; ++c) {
      const float gc = ldg_f32(gp + c);
#pragma unroll
      for (int corner = 0; corner < 8; ++corner)
        if (off[corner] >= 0) gv[corner] += gc * ldg_f32(src + off[corner] + c);
    }
  }
  if (d_src) {
    // lane j takes values j, j + 32, ... of the warp's 32 * C values of g
    // (the rows of its 32 voxels, one span) and adds w * g_c at the corner
    // row of the voxel that value belongs to
    for (int e = lane; e < 32 * geo.C; e += 32) {
      const int from = e / geo.C, c = e - from * geo.C;
      const I row = warp_first + from;
      const float gc = row < n_vox ? ldg_f32(g + row * geo.C + c) : 0.f;
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) {
        const I o = __shfl_sync(0xffffffffu, off[corner], from);
        const float w = __shfl_sync(0xffffffffu, wt[corner], from);
        if (o >= 0) atomicAdd(d_src + o + c, w * gc);
      }
    }
  }
  if (valid) d_flow_row(geo, off, tt, gv, d_flow + vox * 3);
}

template <typename T, typename I>
void launch(const T* src, const float* flow, const T* g, float* d_src, float* d_flow,
            const Geom& geo, int lanes, long long n_vox, cudaStream_t stream) {
  if (lanes > 0) {
    const long long blocks = (n_vox * lanes + kThreads - 1) / kThreads;
    warp3d_bwd_vector_kernel<T, I><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        src, flow, g, d_src, d_flow, geo, __builtin_ctz(static_cast<unsigned>(lanes)),
        static_cast<I>(n_vox));
  } else {
    const long long blocks = (n_vox + kThreads - 1) / kThreads;
    warp3d_bwd_scalar_kernel<T, I><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        src, flow, g, d_src, d_flow, geo, static_cast<I>(n_vox));
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// lanes: 0 for the scalar path, else the vector path's lanes per voxel, a
// power of two up to 32 that divides the row's 16-byte vector count.
template <typename T>
int bwd(const T* src, const float* flow, const T* g, float* d_src, float* d_flow, long long B,
        int SD, int SH, int SW, int C, int lanes, int FD, int FH, int FW, int d0, float scale_d,
        float scale_h, float scale_w, void* stream) {
  const long long n_vox = B * FD * FH * FW;
  if (n_vox <= 0) return static_cast<int>(cudaSuccess);
  if (lanes != 0) {
    const bool aligned = aligned16(src) && aligned16(g) && (!d_src || aligned16(d_src));
    if (lanes < 0 || lanes > 32 || (lanes & (lanes - 1)) || C % kVec16<T> ||
        (C / kVec16<T>) % lanes || !aligned)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geom geo{SD, SH, SW, C, FD, FH, FW, d0, scale_d, scale_h, scale_w};
  const long long src_elems = B * SD * SH * SW * static_cast<long long>(C);
  const long long out_elems = n_vox * (C > 3 ? C : 3);  // g, or the flow's 3 per voxel
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_elems < kNarrow && out_elems < kNarrow)
    launch<T, int>(src, flow, g, d_src, d_flow, geo, lanes, n_vox, s);
  else
    launch<T, long long>(src, flow, g, d_src, d_flow, geo, lanes, n_vox, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a lane count the pointers or C do not allow.
// d0: the D origin (0 but in D-origin mode).
extern "C" int smilecode_warp3d_trilinear_bwd(const float* src, const float* flow,
                                              const float* g, float* d_src, float* d_flow,
                                              long long B, int SD, int SH, int SW, int C,
                                              int lanes, int FD, int FH, int FW, int d0,
                                              float scale_d, float scale_h, float scale_w,
                                              void* stream) {
  return bwd<float>(src, flow, g, d_src, d_flow, B, SD, SH, SW, C, lanes, FD, FH, FW, d0,
                    scale_d, scale_h, scale_w, stream);
}

extern "C" int smilecode_warp3d_trilinear_bwd_bf16(const __nv_bfloat16* src, const float* flow,
                                                   const __nv_bfloat16* g, float* d_src,
                                                   float* d_flow, long long B, int SD, int SH,
                                                   int SW, int C, int lanes, int FD, int FH,
                                                   int FW, int d0, float scale_d, float scale_h,
                                                   float scale_w, void* stream) {
  return bwd<__nv_bfloat16>(src, flow, g, d_src, d_flow, B, SD, SH, SW, C, lanes, FD, FH, FW, d0,
                            scale_d, scale_h, scale_w, stream);
}
