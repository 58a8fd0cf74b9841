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
//   d_src[corner, c] += w_corner * g_c        (atomicAdd; only when asked)
// which is the derivative that autodiff of the gather oracle gives
// (smilecode_tpu/ops/warp.py:warp_coords), with floor's derivative 0.
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
// What bounds it on the H100: memory latency, as in K2: 8 data-dependent
// reads of C contiguous floats per output voxel, plus 8*C atomic adds when
// d_src is wanted. One thread per output voxel computes the corner offsets,
// weights and derivative coefficients once (corner order and weight products
// as in K2) and reuses them for every channel; per corner it first reduces
// sum_c g_c * src_c, so d_flow costs 8 multiply-adds per channel. Atomics go
// to C contiguous floats per corner, and a smooth flow keeps a warp's
// atomics within a few cache lines; the TPU's window budgets and guard
// ladder have no counterpart.

#include <cuda_runtime.h>
#include <math.h>

#include "io_types.cuh"

namespace {

using smilecode::ldg_f32;
using smilecode::to_f32;

template <typename T>
__global__ void __launch_bounds__(256)
warp3d_trilinear_bwd_kernel(const T* __restrict__ src, const float* __restrict__ flow,
                            const T* __restrict__ g, float* __restrict__ d_src,
                            float* __restrict__ d_flow, int SD, int SH, int SW, int C, int FD,
                            int FH, int FW, float scale_d, float scale_h, float scale_w,
                            long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  // idx = ((b*FD + fd)*FH + fh)*FW + fw
  long long v = idx;
  const int fw = static_cast<int>(v % FW);
  v /= FW;
  const int fh = static_cast<int>(v % FH);
  v /= FH;
  const int fd = static_cast<int>(v % FD);
  const long long b = v / FD;

  const float* f = flow + idx * 3;
  const float cd = (static_cast<float>(fd) + f[0]) * scale_d;
  const float ch = (static_cast<float>(fh) + f[1]) * scale_h;
  const float cw = (static_cast<float>(fw) + f[2]) * scale_w;
  const float d0 = floorf(cd), h0 = floorf(ch), w0 = floorf(cw);
  const float td = cd - d0, th = ch - h0, tw = cw - w0;

  long long off[8];
  float wt[8], gv[8];
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int od = corner >> 2, oh = (corner >> 1) & 1, ow = corner & 1;
    const float id = d0 + od, ih = h0 + oh, iw = w0 + ow;
    const bool inb = id >= 0.f && id <= SD - 1 && ih >= 0.f && ih <= SH - 1 &&
                     iw >= 0.f && iw <= SW - 1;
    wt[corner] = (od ? td : 1.f - td) * (oh ? th : 1.f - th) * (ow ? tw : 1.f - tw);
    off[corner] = inb ? (((b * SD + static_cast<long long>(id)) * SH +
                          static_cast<long long>(ih)) * SW + static_cast<long long>(iw)) * C
                      : -1;
    gv[corner] = 0.f;
  }
  const T* gp = g + idx * C;
  for (int c = 0; c < C; ++c) {
    const float gc = to_f32(gp[c]);
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      if (off[corner] < 0) continue;
      gv[corner] += gc * ldg_f32(src + off[corner] + c);
      if (d_src) atomicAdd(d_src + off[corner] + c, wt[corner] * gc);
    }
  }
  float ad = 0.f, ah = 0.f, aw = 0.f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    if (off[corner] < 0) continue;
    const int od = corner >> 2, oh = (corner >> 1) & 1, ow = corner & 1;
    const float wd = od ? td : 1.f - td, wh = oh ? th : 1.f - th, ww = ow ? tw : 1.f - tw;
    ad += (od ? 1.f : -1.f) * wh * ww * gv[corner];
    ah += wd * (oh ? 1.f : -1.f) * ww * gv[corner];
    aw += wd * wh * (ow ? 1.f : -1.f) * gv[corner];
  }
  float* df = d_flow + idx * 3;
  df[0] = ad * scale_d;
  df[1] = ah * scale_h;
  df[2] = aw * scale_w;
}

template <typename T>
int bwd(const T* src, const float* flow, const T* g, float* d_src, float* d_flow, long long B,
        int SD, int SH, int SW, int C, int FD, int FH, int FW, float scale_d, float scale_h,
        float scale_w, void* stream) {
  const long long total = B * FD * FH * FW;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  warp3d_trilinear_bwd_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, flow, g, d_src, d_flow, SD, SH, SW, C, FD, FH, FW, scale_d, scale_h, scale_w, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched).
extern "C" int smilecode_warp3d_trilinear_bwd(const float* src, const float* flow,
                                              const float* g, float* d_src, float* d_flow,
                                              long long B, int SD, int SH, int SW, int C,
                                              int FD, int FH, int FW, float scale_d,
                                              float scale_h, float scale_w, void* stream) {
  return bwd<float>(src, flow, g, d_src, d_flow, B, SD, SH, SW, C, FD, FH, FW, scale_d,
                    scale_h, scale_w, stream);
}

extern "C" int smilecode_warp3d_trilinear_bwd_bf16(const __nv_bfloat16* src, const float* flow,
                                                   const __nv_bfloat16* g, float* d_src,
                                                   float* d_flow, long long B, int SD, int SH,
                                                   int SW, int C, int FD, int FH, int FW,
                                                   float scale_d, float scale_h, float scale_w,
                                                   void* stream) {
  return bwd<__nv_bfloat16>(src, flow, g, d_src, d_flow, B, SD, SH, SW, C, FD, FH, FW, scale_d,
                            scale_h, scale_w, stream);
}
