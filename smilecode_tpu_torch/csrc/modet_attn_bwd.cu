// Backward of the fused 3x3x3 neighborhood attention for ModeT (Hopper, sm_90a).
//
// K3 smilecode_modet_attn_bwd_dq replaces the TPU kernel
// smilecode_tpu/kernels/modet_attn.py:_bwd1_kernel; K4
// smilecode_modet_attn_bwd_dk replaces _bwd2_kernel (its dshift=1 form: dk of
// the unpadded k). Forward (K1, modet_attn.cu):
//   logit_t = (q*scale) . k[x + o_t] + rpb[head, t]   (k zero outside)
//   out     = sum_t p_t * o_t,  p = softmax(logit),  o_t = (od-1, oh-1, ow-1)
// Backward for the output cotangent g (3 per voxel and head):
//   da_t = o_t . g,  dl_t = p_t * (da_t - sum_u p_u da_u)
//   dq[x]  = scale * sum_t dl_t[x] * k[x + o_t]           (K3)
//   dk[x]  = scale * sum_t dl_t[x - o_t] * q[x - o_t]     (K4, a gather: no atomics)
//   drpb[head, t] = sum_x dl_t[x]                          (K3 per block, torch sums blocks)
// An out-of-volume neighbour stays in the softmax (logit rpb), so its dl_t
// goes into drpb, but it has no k to give dq nor a k slot to receive dk.
//
// Layout: q, k, dq, dk (B, D, H, W, heads, hd) contiguous; rpb (heads, 27)
// float32 or null; g (B, D, H, W, heads, 3); dl (B, D, H, W, heads, 27)
// (written by K3, read by K4); drpb_part (gridDim.x, heads, 27) float32.
// q, k, g, dq, dl and dk share one storage type T, float32 or bf16
// (io_types.cuh). With bf16 the softmax is recomputed in float32 from the
// bf16 q and k (q scaled in bf16 as the forward scales it); dl, dq and the
// drpb partials come from the float32 dl, and only the stored dl, dq and dk
// are rounded to bf16: the JAX backward stores dl in its io dtype
// (modet_attn.py:245, :450) and casts dq and dk back to the input dtype
// (:360), while drpb stays float32. K4 reads the rounded dl, as C does.
//
// What bounds them on the H100: memory. K3 reads q, g and the 27 k
// neighbours (cache-served, as in K1) and writes dq plus the 27-float dl
// row of each (voxel, head): dl dominates (531 MB at level 1 of a
// 160x192x160 pair). K3 stages its block's dl rows in shared memory and
// writes them back as one contiguous, coalesced span (a block's 256 rows
// are adjacent in memory); the same tile gives the block's drpb partial
// with a fixed summation order, so drpb is deterministic. K4 is one
// thread per (voxel, head) gathering 27 dl values and q rows of its inverse
// window, like K1's forward window.

#include <cuda_runtime.h>
#include <math.h>

#include "io_types.cuh"

namespace {

using smilecode::from_f32;
using smilecode::ldg_f32;
using smilecode::round_to;
using smilecode::to_f32;

constexpr int kThreads = 256;
constexpr int kPitch = kThreads + 1;  // shared tile row pitch: conflict-free column reads

template <typename T, int MAX_HD>
__global__ void __launch_bounds__(kThreads)
modet_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const float* __restrict__ rpb, const T* __restrict__ g,
                         T* __restrict__ dq, T* __restrict__ dl,
                         float* __restrict__ drpb_part, int D, int H, int W, int heads,
                         int hd, float scale, long long total) {
  __shared__ float tile[27 * kPitch];  // tile[t * kPitch + thread] = dl_t
  const long long blk0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long idx = blk0 + threadIdx.x;
  const bool active = idx < total;
  float lg[27];  // logits, then exp, then dl
#pragma unroll
  for (int t = 0; t < 27; ++t) lg[t] = 0.f;

  if (active) {
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
    for (int i = 0; i < MAX_HD; ++i)  // as K1
      qr[i] = (i < hd) ? round_to<T>(to_f32(qp[i]) * qscale) : 0.f;
    const T* kb = k + b * D * H * W * row + static_cast<long long>(head) * hd;
    const float* rp = rpb ? rpb + head * 27 : nullptr;

    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < 27; ++t) {
      const int nd = d + t / 9 - 1, nh = h + (t / 3) % 3 - 1, nw = w + t % 3 - 1;
      float logit = 0.f;
      if (nd >= 0 && nd < D && nh >= 0 && nh < H && nw >= 0 && nw < W) {
        const T* kp = kb + ((static_cast<long long>(nd) * H + nh) * W + nw) * row;
#pragma unroll
        for (int i = 0; i < MAX_HD; ++i)
          if (i < hd) logit += qr[i] * ldg_f32(kp + i);
      }
      if (rp) logit += __ldg(rp + t);
      lg[t] = logit;
      m = fmaxf(m, logit);
    }
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 27; ++t) {
      lg[t] = expf(lg[t] - m);
      s += lg[t];
    }
    const float inv = 1.f / s;
    const float g0 = to_f32(g[idx * 3]), g1 = to_f32(g[idx * 3 + 1]), g2 = to_f32(g[idx * 3 + 2]);
    float ssum = 0.f;  // sum_u p_u da_u
#pragma unroll
    for (int t = 0; t < 27; ++t) {
      const float da = (t / 9 - 1) * g0 + ((t / 3) % 3 - 1) * g1 + (t % 3 - 1) * g2;
      ssum += lg[t] * inv * da;
    }
    float acc[MAX_HD];
#pragma unroll
    for (int i = 0; i < MAX_HD; ++i) acc[i] = 0.f;
#pragma unroll
    for (int t = 0; t < 27; ++t) {
      const int nd = d + t / 9 - 1, nh = h + (t / 3) % 3 - 1, nw = w + t % 3 - 1;
      const float da = (t / 9 - 1) * g0 + ((t / 3) % 3 - 1) * g1 + (t % 3 - 1) * g2;
      const float dlt = lg[t] * inv * (da - ssum);
      lg[t] = dlt;
      if (nd >= 0 && nd < D && nh >= 0 && nh < H && nw >= 0 && nw < W) {
        const T* kp = kb + ((static_cast<long long>(nd) * H + nh) * W + nw) * row;
#pragma unroll
        for (int i = 0; i < MAX_HD; ++i)
          if (i < hd) acc[i] += dlt * ldg_f32(kp + i);
      }
    }
    T* dqp = dq + idx * hd;
#pragma unroll
    for (int i = 0; i < MAX_HD; ++i)
      if (i < hd) dqp[i] = from_f32<T>(scale * acc[i]);
  }

#pragma unroll
  for (int t = 0; t < 27; ++t) tile[t * kPitch + threadIdx.x] = lg[t];  // 0 when inactive
  __syncthreads();

  // the block's dl rows are one contiguous span of n*27 values
  const int n = total - blk0 < kThreads ? static_cast<int>(total - blk0) : kThreads;
  T* dlb = dl + blk0 * 27;
  for (int j = threadIdx.x; j < n * 27; j += kThreads)
    dlb[j] = from_f32<T>(tile[(j % 27) * kPitch + j / 27]);

  if (drpb_part) {
    // partial[head, t] = sum of dl_t over this block's rows of that head,
    // rows in ascending order: (blk0 + i) % heads == head
    const int first = static_cast<int>(blk0 % heads);
    float* part = drpb_part + static_cast<long long>(blockIdx.x) * heads * 27;
    for (int o = threadIdx.x; o < heads * 27; o += kThreads) {
      const int head = o / 27, t = o % 27;
      float sum = 0.f;
      for (int i = (head - first + heads) % heads; i < n; i += heads) sum += tile[t * kPitch + i];
      part[o] = sum;
    }
  }
}

template <typename T, int MAX_HD>
__global__ void __launch_bounds__(kThreads)
modet_attn_bwd_dk_kernel(const T* __restrict__ q, const T* __restrict__ dl,
                         T* __restrict__ dk, int D, int H, int W, int heads, int hd,
                         float scale, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int head = static_cast<int>(idx % heads);
  long long v = idx / heads;
  const int w = static_cast<int>(v % W);
  v /= W;
  const int h = static_cast<int>(v % H);
  v /= H;
  const int d = static_cast<int>(v % D);
  const long long b = v / D;

  // the source voxel x - o_t, as a (voxel, head) row index
  const long long base = b * D * H * W;
  float acc[MAX_HD];
#pragma unroll
  for (int i = 0; i < MAX_HD; ++i) acc[i] = 0.f;
#pragma unroll
  for (int t = 0; t < 27; ++t) {
    const int sd = d - (t / 9 - 1), sh = h - ((t / 3) % 3 - 1), sw = w - (t % 3 - 1);
    if (sd >= 0 && sd < D && sh >= 0 && sh < H && sw >= 0 && sw < W) {
      const long long src = (base + (static_cast<long long>(sd) * H + sh) * W + sw) * heads + head;
      const float dlt = ldg_f32(dl + src * 27 + t);
      const T* qp = q + src * hd;
#pragma unroll
      for (int i = 0; i < MAX_HD; ++i)
        if (i < hd) acc[i] += dlt * ldg_f32(qp + i);
    }
  }
  T* dkp = dk + idx * hd;
#pragma unroll
  for (int i = 0; i < MAX_HD; ++i)
    if (i < hd) dkp[i] = from_f32<T>(scale * acc[i]);
}

unsigned blocks_for(long long total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

template <typename T>
int bwd_dq(const T* q, const T* k, const float* rpb, const T* g, T* dq, T* dl, float* drpb_part,
           long long B, int D, int H, int W, int heads, int hd, float scale, void* stream) {
  const long long total = B * D * H * W * heads;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(total);
  if (hd <= 8) {
    modet_attn_bwd_dq_kernel<T, 8><<<blocks, kThreads, 0, st>>>(
        q, k, rpb, g, dq, dl, drpb_part, D, H, W, heads, hd, scale, total);
  } else if (hd <= 16) {
    modet_attn_bwd_dq_kernel<T, 16><<<blocks, kThreads, 0, st>>>(
        q, k, rpb, g, dq, dl, drpb_part, D, H, W, heads, hd, scale, total);
  } else if (hd <= 32) {
    modet_attn_bwd_dq_kernel<T, 32><<<blocks, kThreads, 0, st>>>(
        q, k, rpb, g, dq, dl, drpb_part, D, H, W, heads, hd, scale, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dk(const T* q, const T* dl, T* dk, long long B, int D, int H, int W, int heads, int hd,
           float scale, void* stream) {
  const long long total = B * D * H * W * heads;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(total);
  if (hd <= 8) {
    modet_attn_bwd_dk_kernel<T, 8><<<blocks, kThreads, 0, st>>>(q, dl, dk, D, H, W, heads, hd,
                                                                 scale, total);
  } else if (hd <= 16) {
    modet_attn_bwd_dk_kernel<T, 16><<<blocks, kThreads, 0, st>>>(q, dl, dk, D, H, W, heads, hd,
                                                                  scale, total);
  } else if (hd <= 32) {
    modet_attn_bwd_dk_kernel<T, 32><<<blocks, kThreads, 0, st>>>(q, dl, dk, D, H, W, heads, hd,
                                                                  scale, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point returns cudaGetLastError() after the launch (0 = launched).
extern "C" int smilecode_modet_attn_bwd_dq(const float* q, const float* k, const float* rpb,
                                           const float* g, float* dq, float* dl,
                                           float* drpb_part, long long B, int D, int H, int W,
                                           int heads, int hd, float scale, void* stream) {
  return bwd_dq<float>(q, k, rpb, g, dq, dl, drpb_part, B, D, H, W, heads, hd, scale, stream);
}

extern "C" int smilecode_modet_attn_bwd_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                                const float* rpb, const __nv_bfloat16* g,
                                                __nv_bfloat16* dq, __nv_bfloat16* dl,
                                                float* drpb_part, long long B, int D, int H,
                                                int W, int heads, int hd, float scale,
                                                void* stream) {
  return bwd_dq<__nv_bfloat16>(q, k, rpb, g, dq, dl, drpb_part, B, D, H, W, heads, hd, scale,
                               stream);
}

extern "C" int smilecode_modet_attn_bwd_dk(const float* q, const float* dl, float* dk,
                                           long long B, int D, int H, int W, int heads,
                                           int hd, float scale, void* stream) {
  return bwd_dk<float>(q, dl, dk, B, D, H, W, heads, hd, scale, stream);
}

extern "C" int smilecode_modet_attn_bwd_dk_bf16(const __nv_bfloat16* q, const __nv_bfloat16* dl,
                                                __nv_bfloat16* dk, long long B, int D, int H,
                                                int W, int heads, int hd, float scale,
                                                void* stream) {
  return bwd_dk<__nv_bfloat16>(q, dl, dk, B, D, H, W, heads, hd, scale, stream);
}
