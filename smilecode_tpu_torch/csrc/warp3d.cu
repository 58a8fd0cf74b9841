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
// Layout: src (B, SD, SH, SW, C) contiguous, float32 or bf16 (T, see
// io_types.cuh); flow (B, FD, FH, FW, 3) float32 (dd, dh, dw); out
// (B, FD, FH, FW, C) in T. With a bf16 source (ModeT's feature warps on the
// bf16 path) coordinates, corner weights and the sum stay float32 and only
// the output is rounded, as the JAX kernels write float32
// (warp3d_v4.py:281, :329) and their caller casts back
// (models/modet_planes.py:256).
//
// What bounds it on the H100: memory latency. Each output voxel makes 8
// data-dependent reads of C contiguous floats. One thread per output voxel
// computes the 8 corner offsets and weights once (corner order (od, oh, ow)
// and weight products as in smilecode_tpu/ops/warp.py:warp_coords) and
// reuses them for every channel; channels-last makes each corner read C
// contiguous values, and neighbouring threads read neighbouring corners, so
// a smooth flow keeps a warp's reads within a few cache lines per corner.

#include <cuda_runtime.h>
#include <math.h>

#include "io_types.cuh"

namespace {

using smilecode::from_f32;
using smilecode::ldg_f32;

template <typename T>
__global__ void __launch_bounds__(256)
warp3d_trilinear_fwd_kernel(const T* __restrict__ src, const float* __restrict__ flow,
                            T* __restrict__ out, int SD, int SH, int SW, int C,
                            int FD, int FH, int FW, float scale_d, float scale_h,
                            float scale_w, long long total) {
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
  float wt[8];
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int od = corner >> 2, oh = (corner >> 1) & 1, ow = corner & 1;
    const float id = d0 + od, ih = h0 + oh, iw = w0 + ow;
    // float compares: NaN or huge coordinates are simply out of volume
    const bool inb = id >= 0.f && id <= SD - 1 && ih >= 0.f && ih <= SH - 1 &&
                     iw >= 0.f && iw <= SW - 1;
    wt[corner] = (od ? td : 1.f - td) * (oh ? th : 1.f - th) * (ow ? tw : 1.f - tw);
    off[corner] = inb ? (((b * SD + static_cast<long long>(id)) * SH +
                          static_cast<long long>(ih)) * SW + static_cast<long long>(iw)) * C
                      : -1;
  }
  T* o = out + idx * C;
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int corner = 0; corner < 8; ++corner)
      if (off[corner] >= 0) acc += wt[corner] * ldg_f32(src + off[corner] + c);
    o[c] = from_f32<T>(acc);
  }
}

template <typename T>
int fwd(const T* src, const float* flow, T* out, long long B, int SD, int SH, int SW, int C,
        int FD, int FH, int FW, float scale_d, float scale_h, float scale_w, void* stream) {
  const long long total = B * FD * FH * FW;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  warp3d_trilinear_fwd_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, flow, out, SD, SH, SW, C, FD, FH, FW, scale_d, scale_h, scale_w, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched).
extern "C" int smilecode_warp3d_trilinear_fwd(const float* src, const float* flow, float* out,
                                              long long B, int SD, int SH, int SW, int C,
                                              int FD, int FH, int FW, float scale_d,
                                              float scale_h, float scale_w, void* stream) {
  return fwd<float>(src, flow, out, B, SD, SH, SW, C, FD, FH, FW, scale_d, scale_h, scale_w,
                    stream);
}

extern "C" int smilecode_warp3d_trilinear_fwd_bf16(const __nv_bfloat16* src, const float* flow,
                                                   __nv_bfloat16* out, long long B, int SD,
                                                   int SH, int SW, int C, int FD, int FH, int FW,
                                                   float scale_d, float scale_h, float scale_w,
                                                   void* stream) {
  return fwd<__nv_bfloat16>(src, flow, out, B, SD, SH, SW, C, FD, FH, FW, scale_d, scale_h,
                            scale_w, stream);
}
