// Storage types of the kernels' feature tensors (Hopper, sm_90a).
//
// Every kernel is a template on its storage type T: float, or __nv_bfloat16
// (the bf16 feature path of ModeT, `compute_dtype="bfloat16"`). A bf16
// tensor is read into float32 and written back rounded to nearest even;
// every product, sum, exp and softmax stays float32, as the TPU kernels
// compute on bf16 inputs (smilecode_tpu/kernels/modet_attn.py:72-77,
// warp3d_v4.py:281). For T = float every helper is the identity, so the
// float32 instances compute exactly what they computed before templating.
//
// A bf16 row of 6 values (one (voxel, head) of q or k at head_dim 6) is 12
// bytes and only 4-byte aligned, so loads are scalar: 16-byte vector loads
// are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace smilecode {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// load through the read-only data cache, as float32 (a bf16 value is the
// high half of the float32 with the same bits)
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// float32 -> T, round to nearest even
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T's precision, kept in float32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

}  // namespace smilecode
