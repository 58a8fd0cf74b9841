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
// Layout: q, k, dq, dk (B, D, H, W, heads, hd) float32 contiguous; rpb
// (heads, 27) or null; g (B, D, H, W, heads, 3); dl (B, D, H, W, heads, 27)
// float32 (written by K3, read by K4); drpb_part (gridDim.x, heads, 27).
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

namespace {

constexpr int kThreads = 256;
constexpr int kPitch = kThreads + 1;  // shared tile row pitch: conflict-free column reads

template <int MAX_HD>
__global__ void __launch_bounds__(kThreads)
modet_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ rpb, const float* __restrict__ g,
                         float* __restrict__ dq, float* __restrict__ dl,
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

    const long long row = static_cast<long long>(heads) * hd;  // floats per voxel
    const float* qp = q + idx * hd;
    float qr[MAX_HD];
#pragma unroll
    for (int i = 0; i < MAX_HD; ++i) qr[i] = (i < hd) ? qp[i] * scale : 0.f;  // as K1
    const float* kb = k + b * D * H * W * row + static_cast<long long>(head) * hd;
    const float* rp = rpb ? rpb + head * 27 : nullptr;

    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < 27; ++t) {
      const int nd = d + t / 9 - 1, nh = h + (t / 3) % 3 - 1, nw = w + t % 3 - 1;
      float logit = 0.f;
      if (nd >= 0 && nd < D && nh >= 0 && nh < H && nw >= 0 && nw < W) {
        const float* kp = kb + ((static_cast<long long>(nd) * H + nh) * W + nw) * row;
#pragma unroll
        for (int i = 0; i < MAX_HD; ++i)
          if (i < hd) logit += qr[i] * __ldg(kp + i);
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
    const float g0 = g[idx * 3], g1 = g[idx * 3 + 1], g2 = g[idx * 3 + 2];
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
        const float* kp = kb + ((static_cast<long long>(nd) * H + nh) * W + nw) * row;
#pragma unroll
        for (int i = 0; i < MAX_HD; ++i)
          if (i < hd) acc[i] += dlt * __ldg(kp + i);
      }
    }
    float* dqp = dq + idx * hd;
#pragma unroll
    for (int i = 0; i < MAX_HD; ++i)
      if (i < hd) dqp[i] = scale * acc[i];
  }

#pragma unroll
  for (int t = 0; t < 27; ++t) tile[t * kPitch + threadIdx.x] = lg[t];  // 0 when inactive
  __syncthreads();

  // the block's dl rows are one contiguous span of n*27 floats
  const int n = total - blk0 < kThreads ? static_cast<int>(total - blk0) : kThreads;
  float* dlb = dl + blk0 * 27;
  for (int j = threadIdx.x; j < n * 27; j += kThreads) dlb[j] = tile[(j % 27) * kPitch + j / 27];

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

template <int MAX_HD>
__global__ void __launch_bounds__(kThreads)
modet_attn_bwd_dk_kernel(const float* __restrict__ q, const float* __restrict__ dl,
                         float* __restrict__ dk, int D, int H, int W, int heads, int hd,
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
      const float dlt = __ldg(dl + src * 27 + t);
      const float* qp = q + src * hd;
#pragma unroll
      for (int i = 0; i < MAX_HD; ++i)
        if (i < hd) acc[i] += dlt * __ldg(qp + i);
    }
  }
  float* dkp = dk + idx * hd;
#pragma unroll
  for (int i = 0; i < MAX_HD; ++i)
    if (i < hd) dkp[i] = scale * acc[i];
}

unsigned blocks_for(long long total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 = launched).
extern "C" int smilecode_modet_attn_bwd_dq(const float* q, const float* k, const float* rpb,
                                           const float* g, float* dq, float* dl,
                                           float* drpb_part, long long B, int D, int H, int W,
                                           int heads, int hd, float scale, void* stream) {
  const long long total = B * D * H * W * heads;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(total);
  if (hd <= 8) {
    modet_attn_bwd_dq_kernel<8><<<blocks, kThreads, 0, st>>>(
        q, k, rpb, g, dq, dl, drpb_part, D, H, W, heads, hd, scale, total);
  } else if (hd <= 16) {
    modet_attn_bwd_dq_kernel<16><<<blocks, kThreads, 0, st>>>(
        q, k, rpb, g, dq, dl, drpb_part, D, H, W, heads, hd, scale, total);
  } else if (hd <= 32) {
    modet_attn_bwd_dq_kernel<32><<<blocks, kThreads, 0, st>>>(
        q, k, rpb, g, dq, dl, drpb_part, D, H, W, heads, hd, scale, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smilecode_modet_attn_bwd_dk(const float* q, const float* dl, float* dk,
                                           long long B, int D, int H, int W, int heads,
                                           int hd, float scale, void* stream) {
  const long long total = B * D * H * W * heads;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(total);
  if (hd <= 8) {
    modet_attn_bwd_dk_kernel<8><<<blocks, kThreads, 0, st>>>(q, dl, dk, D, H, W, heads, hd,
                                                              scale, total);
  } else if (hd <= 16) {
    modet_attn_bwd_dk_kernel<16><<<blocks, kThreads, 0, st>>>(q, dl, dk, D, H, W, heads, hd,
                                                               scale, total);
  } else if (hd <= 32) {
    modet_attn_bwd_dk_kernel<32><<<blocks, kThreads, 0, st>>>(q, dl, dk, D, H, W, heads, hd,
                                                               scale, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
