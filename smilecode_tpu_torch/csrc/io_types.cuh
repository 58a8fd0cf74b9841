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
// bytes and only 4-byte aligned, so the attention kernels load scalars. The
// warp kernels (K2, K5) read and write rows of C channels as 16-byte vectors
// where C * sizeof(T) is a multiple of 16 and the pointers are 16-byte
// aligned: ldg_vec16 / st_vec16 below, kVec16<T> values each.

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

// values of T in one 16-byte vector
template <typename T>
constexpr int kVec16 = 16 / sizeof(T);

// 16 bytes at p (16-byte aligned) through the read-only data cache, as
// float32: a float4, or 8 bf16 values (element 2i is the low half of 32-bit
// word i)
__device__ __forceinline__ void ldg_vec16(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void ldg_vec16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 bytes of T at p (16-byte aligned) from float32 values, bf16 rounded to
// nearest even as from_f32
__device__ __forceinline__ void st_vec16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st_vec16(__nv_bfloat16* p, const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace smilecode
