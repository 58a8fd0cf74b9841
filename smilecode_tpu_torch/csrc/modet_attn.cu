// Fused 3x3x3 neighborhood attention forward for ModeT (Hopper, sm_90a).
//
// Replaces the TPU kernel smilecode_tpu/kernels/modet_attn.py:_attn_kernel
// (entry modet_attention_pallas / modet_attention_planes). Computes, for each
// (batch, voxel, head):
//   logit_t = (q*scale) . k[x + o_t] + rpb[head, t]   (k zero outside: an
//             out-of-volume neighbour keeps logit rpb[head, t], like the
//             reference's nnf.pad and jnp.pad)
//   out     = sum_t softmax(logit)_t * o_t,  o_t = (od-1, oh-1, ow-1),
//             t = (od*3 + oh)*3 + ow
// The 27-wide attention tensor is never stored.
//
// Layout: q, k (B, D, H, W, heads, hd) contiguous, float32 or bf16 (T, see
// io_types.cuh); rpb (heads, 27) float32 or null; out (B, D, H, W, heads*3)
// in T. With bf16 q and k the logits, the online softmax and the
// accumulators stay float32 and only the output is rounded to bf16, as the
// JAX forward casts its float32 result to q's dtype (modet_attn.py:180);
// q is scaled in its own type first, as there (`qs * dtype(scale)`, :132).
//
// What bounds it on the H100: memory and latency. Each (voxel, head) reads
// 27 neighbour k vectors of hd floats (27*hd*4 B, 648 B at hd=6) but only
// hd*4 B of them are new per voxel: the rest are re-reads that L1/L2 serve.
// The design keeps that reuse in the caches rather than staging a halo tile:
// one thread per (voxel, head), neighbouring threads on neighbouring heads
// and w, so a warp's 27 window reads fall on a few contiguous rows; q sits in
// registers (hd bounded by the template MAX_HD, predicated above hd); the
// softmax is online over the 27 tokens, so no logit array is kept; the offset
// contraction is three +/- accumulators.

#include <cuda_runtime.h>
#include <math.h>

#include "io_types.cuh"

namespace {

using smilecode::from_f32;
using smilecode::ldg_f32;
using smilecode::round_to;
using smilecode::to_f32;

template <typename T, int MAX_HD>
__global__ void __launch_bounds__(256)
modet_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const float* __restrict__ rpb, T* __restrict__ out,
                      int D, int H, int W, int heads, int hd, float scale,
                      long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  // idx = (((b*D + d)*H + h)*W + w)*heads + head
  const int head = static_cast<int>(idx % heads);
  long long v = idx / heads;
  const int w = static_cast<int>(v % W);
  v /= W;
  const int h = static_cast<int>(v % H);
  v /= H;
  const int d = static_cast<int>(v % D);
  const long long b = v / D;

  const long long row = static_cast<long long>(heads) * hd;  // values per voxel
  const T* qp = q + idx * hd;
  const float qscale = round_to<T>(scale);
  float qr[MAX_HD];
#pragma unroll
  for (int i = 0; i < MAX_HD; ++i) qr[i] = (i < hd) ? round_to<T>(to_f32(qp[i]) * qscale) : 0.f;

  const T* kb = k + b * D * H * W * row + static_cast<long long>(head) * hd;
  const float* rp = rpb ? rpb + head * 27 : nullptr;

  float m = -INFINITY, s = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
  for (int t = 0; t < 27; ++t) {
    const int od = t / 9 - 1, oh = (t / 3) % 3 - 1, ow = t % 3 - 1;
    const int nd = d + od, nh = h + oh, nw = w + ow;
    float logit = 0.f;
    if (nd >= 0 && nd < D && nh >= 0 && nh < H && nw >= 0 && nw < W) {
      const T* kp = kb + ((static_cast<long long>(nd) * H + nh) * W + nw) * row;
#pragma unroll
      for (int i = 0; i < MAX_HD; ++i)
        if (i < hd) logit += qr[i] * ldg_f32(kp + i);
    }
    if (rp) logit += __ldg(rp + t);
    const float mn = fmaxf(m, logit);
    const float corr = expf(m - mn);  // 0 on the first token (m = -inf)
    const float e = expf(logit - mn);
    s = s * corr + e;
    a0 = a0 * corr + e * od;
    a1 = a1 * corr + e * oh;
    a2 = a2 * corr + e * ow;
    m = mn;
  }
  T* op = out + idx * 3;
  op[0] = from_f32<T>(a0 / s);
  op[1] = from_f32<T>(a1 / s);
  op[2] = from_f32<T>(a2 / s);
}

template <typename T, int MAX_HD>
void launch(const T* q, const T* k, const float* rpb, T* out, int D, int H, int W, int heads,
            int hd, float scale, long long total, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  modet_attn_fwd_kernel<T, MAX_HD><<<blocks, threads, 0, stream>>>(
      q, k, rpb, out, D, H, W, heads, hd, scale, total);
}

template <typename T>
int fwd(const T* q, const T* k, const float* rpb, T* out, long long B, int D, int H, int W,
        int heads, int hd, float scale, void* stream) {
  const long long total = B * D * H * W * heads;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 8) {
    launch<T, 8>(q, k, rpb, out, D, H, W, heads, hd, scale, total, st);
  } else if (hd <= 16) {
    launch<T, 16>(q, k, rpb, out, D, H, W, heads, hd, scale, total, st);
  } else if (hd <= 32) {
    launch<T, 32>(q, k, rpb, out, D, H, W, heads, hd, scale, total, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched).
extern "C" int smilecode_modet_attn_fwd(const float* q, const float* k, const float* rpb,
                                        float* out, long long B, int D, int H, int W,
                                        int heads, int hd, float scale, void* stream) {
  return fwd<float>(q, k, rpb, out, B, D, H, W, heads, hd, scale, stream);
}

extern "C" int smilecode_modet_attn_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                             const float* rpb, __nv_bfloat16* out, long long B,
                                             int D, int H, int W, int heads, int hd, float scale,
                                             void* stream) {
  return fwd<__nv_bfloat16>(q, k, rpb, out, B, D, H, W, heads, hd, scale, stream);
}
