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
// in T. In halo-k mode (koff = 1, attn_tile.cuh) k is (B, D+2, H, W, heads,
// hd), its border slices the neighbour shards' (the D-sharded step). With bf16 q and k the logits, the softmax and the
// accumulators stay float32 and only the output is rounded to bf16, as the
// JAX forward casts its float32 result to q's dtype (modet_attn.py:180);
// q is scaled in its own type first, as there (`qs * dtype(scale)`, :132).
//
// What bounds it on the H100: memory. A (voxel, head) reads its q row and
// writes 3 values; its 27 neighbour k rows are 27 reads of one staged tile.
// Measured on the H100 (PERF.md), it runs at ~0.4 of that bound at level 1:
// the 27 shared-memory row reads (~3.2 GB per level-1 call, f32) and the
// logit and softmax instructions, not device memory, set its pace, which is
// also why bf16 is no faster. The design (attn_tile.cuh): a block stages the
// k neighbourhood of its brick in a shared-memory ring, zero-filled outside
// the volume, copied with cp.async one d-slice ahead of the compute; one
// thread per (voxel, head) of a slice walks the brick's d range, reading
// each neighbour row from shared memory (two values per load where hd is
// even) with no bounds checks; the 27 logits stay in registers for the
// softmax (max, then one exp2 each, `exp_minus`); the offset contraction is
// three +/- accumulators.

#include <cuda_runtime.h>
#include <math.h>

#include "attn_tile.cuh"
#include "io_types.cuh"

namespace {

using namespace smilecode::attn;
using smilecode::from_f32;
using smilecode::round_to;

template <typename T, int MAX_HD, bool PAIRS>
__global__ void __launch_bounds__(kMaxThreads)
modet_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const float* __restrict__ rpb, T* __restrict__ out, Brick g,
                      float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* bias = reinterpret_cast<float*>(smem + kRing * g.slot_elems * sizeof(T));
  const Origin o = origin(g, g.D);
  const long long bd = static_cast<long long>(o.b) * g.D;
  const long long bk = static_cast<long long>(o.b) * g.kD;
  stage_prologue(ring, bias, k, rpb, bk, o, g);
  const Seat me = seat(o.h0, o.w0, g);
  const float qscale = round_to<T>(scale);
  const float* bs = bias + me.head * 27;
  const long long step = static_cast<long long>(g.H) * g.W * g.heads;  // rows per d-slice
  long long idx = (((bd + o.d0) * g.H + me.h) * g.W + me.w) * g.heads + me.head;
  float qn[MAX_HD];  // the q row of the slice to come
  if (me.active) fetch_row<T, MAX_HD>(qn, q + idx * g.hd, g.hd);

  for (int d = o.d0; d < o.d1; ++d, idx += step) {
    const int j = d - o.d0;  // slots j, j+1, j+2 hold slices d-1, d, d+1
    if (d + 2 <= o.d1) load_slice(ring + ((j + 3) % kRing) * g.slot_elems, k, bk, d + 2, o.h0, o.w0, g);
    cp_async_commit();
    if (me.active) {
      float qr[MAX_HD];
      scale_q<T, MAX_HD>(qr, qn, qscale);
      if (d + 1 < o.d1) fetch_row<T, MAX_HD>(qn, q + (idx + step) * g.hd, g.hd);
      const T* slots[3];
#pragma unroll
      for (int od = 0; od < 3; ++od) slots[od] = ring + ((j + od) % kRing) * g.slot_elems + me.own;
      float lg[27];
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < 27; ++t) {
        lg[t] = logit<T, MAX_HD, PAIRS>(qr, slots[t / 9] + token_offset(t % 9, g), g.hd, bs[t]);
        m = fmaxf(m, lg[t]);
      }
      float s = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
      const float m_log2e = m * kLog2e;
#pragma unroll
      for (int t = 0; t < 27; ++t) {
        const float e = exp_minus(lg[t], m_log2e);
        s += e;
        a0 += e * (t / 9 - 1);
        a1 += e * ((t / 3) % 3 - 1);
        a2 += e * (t % 3 - 1);
      }
      T* op = out + idx * 3;
      op[0] = from_f32<T>(a0 / s);
      op[1] = from_f32<T>(a1 / s);
      op[2] = from_f32<T>(a2 / s);
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

template <typename T, int MAX_HD, bool PAIRS>
int launch(const T* q, const T* k, const float* rpb, T* out, long long B, const Brick& g,
           float scale, cudaStream_t stream) {
  const size_t smem = kRing * g.slot_elems * sizeof(T) + g.heads * 27 * sizeof(float);
  if (smem > static_cast<size_t>(kSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = modet_attn_fwd_kernel<T, MAX_HD, PAIRS>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid_of(B, g, g.D), g.bh * g.bw * g.heads, smem, stream>>>(q, k, rpb, out, g, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd(const T* q, const T* k, const float* rpb, T* out, long long B, int D, int H, int W,
        int heads, int hd, float scale, int bh, int bw, int cd, int unit, int koff, void* stream) {
  if (B * D * H * W * heads == 0) return static_cast<int>(cudaSuccess);
  Brick g;
  if (B < 0 || !make_brick<T>(g, D, H, W, heads, hd, bh, bw, cd, unit, k, koff))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pairs = hd % 2 == 0;
  if (hd <= 8) {
    return pairs ? launch<T, 8, true>(q, k, rpb, out, B, g, scale, st)
                 : launch<T, 8, false>(q, k, rpb, out, B, g, scale, st);
  } else if (hd <= 16) {
    return pairs ? launch<T, 16, true>(q, k, rpb, out, B, g, scale, st)
                 : launch<T, 16, false>(q, k, rpb, out, B, g, scale, st);
  } else if (hd <= 32) {
    return pairs ? launch<T, 32, true>(q, k, rpb, out, B, g, scale, st)
                 : launch<T, 32, false>(q, k, rpb, out, B, g, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a brick (bh, bw, cd) or copy width (unit bytes)
// the shapes or k's address do not allow (kernels/modet_attn.py:attn_geometry).
// koff: 0, or 1 for halo-k mode (k of D+2 slices).
extern "C" int smilecode_modet_attn_fwd(const float* q, const float* k, const float* rpb,
                                        float* out, long long B, int D, int H, int W,
                                        int heads, int hd, float scale, int bh, int bw, int cd,
                                        int unit, int koff, void* stream) {
  return fwd<float>(q, k, rpb, out, B, D, H, W, heads, hd, scale, bh, bw, cd, unit, koff,
                    stream);
}

extern "C" int smilecode_modet_attn_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                             const float* rpb, __nv_bfloat16* out, long long B,
                                             int D, int H, int W, int heads, int hd, float scale,
                                             int bh, int bw, int cd, int unit, int koff,
                                             void* stream) {
  return fwd<__nv_bfloat16>(q, k, rpb, out, B, D, H, W, heads, hd, scale, bh, bw, cd, unit, koff,
                            stream);
}
