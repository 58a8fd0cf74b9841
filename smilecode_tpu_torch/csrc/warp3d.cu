// Trilinear warp forward (Hopper, sm_90a).
//
// Replaces the TPU kernels smilecode_tpu/kernels/warp3d_v4.py:_warp_v4_kernel
// and smilecode_tpu/kernels/warp3d_v3.py:_warp_v3_kernel, and computes the
// function of the frozen smilecode_tpu/kernels/warp3d.py:_warp_kernel:
// sample a C-channel volume at grid + flow (voxel units, align_corners=True),
// zeros outside. When the flow's spatial shape differs from the source's,
// coordinates are scaled by (S-1)/max(F-1, 1) per axis, as grid_sample's
// normalised coordinates imply. Exact for every flow: there is no window
// budget, so nothing like the TPU guard ladder is needed.
//
// D-origin mode (the D-sharded step; smilecode_tpu/parallel/
// modet_planes_sp.py:202-253 runs D and E on an all-gathered source at
// global d): an integer d0 is added to the depth coordinate, coord =
// (fd + flow_d + d0, fh + flow_h, fw + flow_w), into a source whose depth
// SD is the gathered one; the scale is then 1 on every axis (the wrapper
// never takes the coarser-source rescale for a depth that only differs).
//
// Layout: src (B, SD, SH, SW, C) contiguous, float32 or bf16 (T, see
// io_types.cuh); flow (B, FD, FH, FW, 3) float32 (dd, dh, dw); out
// (B, FD, FH, FW, C) in T. With a bf16 source (ModeT's feature warps on the
// bf16 path) coordinates, corner weights and the sum stay float32 and only
// the output is rounded, as the JAX kernels write float32
// (warp3d_v4.py:281, :329) and their caller casts back
// (models/modet_planes.py:256).
//
// What bounds it on the H100: memory. Each output voxel makes 8
// data-dependent reads of a C-channel row and writes one. Per output voxel
// the 8 corner offsets and weights (corner order (od, oh, ow) and weight
// products as in smilecode_tpu/ops/warp.py:warp_coords) are computed once
// and reused for every channel. Channels-last storage puts neighbouring
// voxels' rows C * sizeof(T) bytes apart, so one thread per voxel looping
// over channels makes every load and store of a warp touch 32 sectors, and
// at the coarse levels (C=64 at 20x24x20, C=128 at 10x12x10) leaves most
// SMs idle. The design:
// - Vector path, where a row is a whole number of 16-byte vectors and src
//   and out are 16-byte aligned: a group of G lanes shares one output voxel
//   (G chosen by the wrapper: the largest power of two up to 32 dividing
//   the row's vector count; a lane loops over the rest). Each lane reads one
//   16-byte vector of each corner row and writes one 16-byte vector of the
//   output, so a warp's loads of one corner are whole 32-byte sectors of
//   neighbouring rows and its stores are contiguous, and the coarse levels
//   get G times the threads. The group's first lane computes the corner
//   offsets and weights and __shfl_sync's them to the others (5-7% faster
//   on the H100 at G=2 and 4 than every lane computing them from a
//   broadcast flow read).
// - Scalar path (C=1, C=3, odd rows, misaligned views): one thread per
//   voxel, 32-40 registers. Two alternatives measured slower on the H100 at
//   C=1 and C=3: staging the block's flow and output rows through shared
//   memory (its barriers cost more than the strided 12-byte rows, whose
//   lines L1 serves to the next load anyway), and 4 voxels per thread for
//   more loads in flight (its ~100 registers cost more occupancy than the
//   loads gained).
// Indices are 32-bit where every element index of the call fits (all of the
// repo's shapes); a 64-bit instance serves larger tensors.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "io_types.cuh"

namespace {

using smilecode::from_f32;
using smilecode::kVec16;
using smilecode::ldg_f32;
using smilecode::ldg_vec16;
using smilecode::st_vec16;

constexpr int kThreads = 256;
// the largest element index a 32-bit instance meets, with room for one block
// past the end
constexpr long long kNarrow = (1LL << 31) - (1LL << 16);

struct Geom {
  int SD, SH, SW, C, FD, FH, FW;
  int d0;  // D origin: output slice fd samples at source depth coordinate fd + d0 + flow
  float scale_d, scale_h, scale_w;
};

// The 8 corners of output voxel vox, whose flow row is f: element offset of
// each corner's row in src (-1 outside the volume) and its weight.
template <typename I>
__device__ __forceinline__ void corners(const Geom& g, I vox, float f0, float f1, float f2,
                                        I (&off)[8], float (&wt)[8]) {
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
  const float td = cd - d0, th = ch - h0, tw = cw - w0;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int od = corner >> 2, oh = (corner >> 1) & 1, ow = corner & 1;
    const float id = d0 + od, ih = h0 + oh, iw = w0 + ow;
    // float compares: NaN or huge coordinates are simply out of volume
    const bool inb = id >= 0.f && id <= g.SD - 1 && ih >= 0.f && ih <= g.SH - 1 &&
                     iw >= 0.f && iw <= g.SW - 1;
    wt[corner] = (od ? td : 1.f - td) * (oh ? th : 1.f - th) * (ow ? tw : 1.f - tw);
    off[corner] = inb ? (((b * g.SD + static_cast<I>(id)) * g.SH + static_cast<I>(ih)) * g.SW +
                         static_cast<I>(iw)) * g.C
                      : I(-1);
  }
}

// Vector path: 2^lanes_log2 lanes per output voxel, 16-byte loads and stores.
// No early return before the shuffles: every lane of a warp takes part.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
warp3d_fwd_vector_kernel(const T* __restrict__ src, const float* __restrict__ flow,
                         T* __restrict__ out, Geom g, int lanes_log2, I n_vox) {
  constexpr int N = kVec16<T>;
  const I t = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  const I vox = t >> lanes_log2;
  const int lanes = 1 << lanes_log2;
  const int lane = static_cast<int>(t & (lanes - 1));
  const bool valid = vox < n_vox;
  I off[8];
  float wt[8];
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    off[corner] = -1;
    wt[corner] = 0.f;
  }
  if (valid && lane == 0) {
    const float* f = flow + vox * 3;
    corners(g, vox, __ldg(f), __ldg(f + 1), __ldg(f + 2), off, wt);
  }
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    off[corner] = __shfl_sync(0xffffffffu, off[corner], 0, lanes);
    wt[corner] = __shfl_sync(0xffffffffu, wt[corner], 0, lanes);
  }
  if (!valid) return;
  T* o = out + vox * g.C;
  for (int v = lane * N; v < g.C; v += lanes * N) {
    float x[8][N];
#pragma unroll
    for (int corner = 0; corner < 8; ++corner)
      if (off[corner] >= 0) ldg_vec16(src + off[corner] + v, x[corner]);
    float acc[N];
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = 0.f;
#pragma unroll
    for (int corner = 0; corner < 8; ++corner)
      if (off[corner] >= 0) {
#pragma unroll
        for (int e = 0; e < N; ++e) acc[e] += wt[corner] * x[corner][e];
      }
    st_vec16(o + v, acc);
  }
}

// Scalar path: one thread per output voxel.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
warp3d_fwd_scalar_kernel(const T* __restrict__ src, const float* __restrict__ flow,
                         T* __restrict__ out, Geom g, I n_vox) {
  const I vox = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (vox >= n_vox) return;
  const float* f = flow + vox * 3;
  I off[8];
  float wt[8];
  corners(g, vox, __ldg(f), __ldg(f + 1), __ldg(f + 2), off, wt);
  T* o = out + vox * g.C;
  for (int c = 0; c < g.C; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int corner = 0; corner < 8; ++corner)
      if (off[corner] >= 0) acc += wt[corner] * ldg_f32(src + off[corner] + c);
    o[c] = from_f32<T>(acc);
  }
}

template <typename T, typename I>
void launch(const T* src, const float* flow, T* out, const Geom& g, int lanes, long long n_vox,
            cudaStream_t stream) {
  if (lanes > 0) {
    const long long blocks = (n_vox * lanes + kThreads - 1) / kThreads;
    warp3d_fwd_vector_kernel<T, I><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        src, flow, out, g, __builtin_ctz(static_cast<unsigned>(lanes)), static_cast<I>(n_vox));
  } else {
    const long long blocks = (n_vox + kThreads - 1) / kThreads;
    warp3d_fwd_scalar_kernel<T, I><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        src, flow, out, g, static_cast<I>(n_vox));
  }
}

// lanes: 0 for the scalar path, else the vector path's lanes per voxel, a
// power of two up to 32 that divides the row's 16-byte vector count.
template <typename T>
int fwd(const T* src, const float* flow, T* out, long long B, int SD, int SH, int SW, int C,
        int lanes, int FD, int FH, int FW, int d0, float scale_d, float scale_h, float scale_w,
        void* stream) {
  const long long n_vox = B * FD * FH * FW;
  if (n_vox <= 0) return static_cast<int>(cudaSuccess);
  if (lanes != 0) {
    const bool aligned = reinterpret_cast<std::uintptr_t>(src) % 16 == 0 &&
                         reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
    if (lanes < 0 || lanes > 32 || (lanes & (lanes - 1)) || C % kVec16<T> ||
        (C / kVec16<T>) % lanes || !aligned)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geom g{SD, SH, SW, C, FD, FH, FW, d0, scale_d, scale_h, scale_w};
  const long long src_elems = B * SD * SH * SW * static_cast<long long>(C);
  const long long out_elems = n_vox * (C > 3 ? C : 3);  // out, or the flow's 3 per voxel
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_elems < kNarrow && out_elems < kNarrow)
    launch<T, int>(src, flow, out, g, lanes, n_vox, s);
  else
    launch<T, long long>(src, flow, out, g, lanes, n_vox, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a lane count the pointers or C do not allow.
// d0: the D origin (0 but in D-origin mode).
extern "C" int smilecode_warp3d_trilinear_fwd(const float* src, const float* flow, float* out,
                                              long long B, int SD, int SH, int SW, int C,
                                              int lanes, int FD, int FH, int FW, int d0,
                                              float scale_d, float scale_h, float scale_w,
                                              void* stream) {
  return fwd<float>(src, flow, out, B, SD, SH, SW, C, lanes, FD, FH, FW, d0, scale_d, scale_h,
                    scale_w, stream);
}

extern "C" int smilecode_warp3d_trilinear_fwd_bf16(const __nv_bfloat16* src, const float* flow,
                                                   __nv_bfloat16* out, long long B, int SD,
                                                   int SH, int SW, int C, int lanes, int FD,
                                                   int FH, int FW, int d0, float scale_d,
                                                   float scale_h, float scale_w, void* stream) {
  return fwd<__nv_bfloat16>(src, flow, out, B, SD, SH, SW, C, lanes, FD, FH, FW, d0, scale_d,
                            scale_h, scale_w, stream);
}
