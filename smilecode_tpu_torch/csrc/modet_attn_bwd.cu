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
// goes into drpb, but its zero k gives dq nothing and it has no k slot to
// receive dk.
//
// Layout: q, k, dq, dk (B, D, H, W, heads, hd) contiguous; rpb (heads, 27)
// float32 or null; g (B, D, H, W, heads, 3); dl (B, D, H, W, heads, 27)
// (written by K3, read by K4); drpb_part (K3's blocks, heads, 27) float32.
// In halo-k mode (koff = 1, the D-sharded step; _backward_planes with
// k_prepadded_d=True, modet_attn.py:367-372, :464-465) k and dk have D+2
// slices: K3 reads k's border slices as data, and K4 writes dk for all D+2,
// its slices 0 and D+1 (query coordinates -1 and D, where no q lies) the
// cotangents of the window's outer taps, which the halo exchange's transpose
// carries back to the neighbour shards.
// q, k, g, dq, dl and dk share one storage type T, float32 or bf16
// (io_types.cuh). With bf16 the softmax is recomputed in float32 from the
// bf16 q and k (q scaled in bf16 as the forward scales it); dl, dq and the
// drpb partials come from the float32 dl, and only the stored dl, dq and dk
// are rounded to bf16: the JAX backward stores dl in its io dtype
// (modet_attn.py:245, :450) and casts dq and dk back to the input dtype
// (:360), while drpb stays float32. K4 reads the rounded dl, as C does.
//
// What bounds them on the H100: memory. K3 reads q, g and k and writes dq
// plus the 27-value dl row of each (voxel, head): dl dominates (531 MB at
// level 1 of a 160x192x160 pair, f32). K3 stands on K1's stage
// (attn_tile.cuh): its block stages the k neighbourhood of a brick in a
// zero-filled shared-memory ring, one d-slice ahead of the compute, and one
// thread per (voxel, head) reads q and g once, computes the 27 logits with
// K1's function (bit for bit K1's) into registers, then the probabilities,
// writes dl into a shared dl tile, and reads the 27 neighbour k rows from
// the ring a second time for dq; no bounds checks, no second pass of global
// loads. A w-row of the brick's dl is one contiguous span of bw*heads*27
// values in memory: the tile lays each row out at the span's alignment, so
// it leaves as 16-byte vector stores. Each thread sums its dl_t over the
// block's d range in registers; at the end the block adds them in a fixed
// order (groups of voxels, then the groups) into its drpb partial, so drpb
// is deterministic. Measured on the H100 (PERF.md), K3 runs at about half
// of its bound at level 1 (f32): the two passes over the 27 staged rows and
// the dl stores take instruction issue and shared-memory time that device
// memory does not.
//
// K4 reads dl (27 values per voxel and head) and q and writes dk: the dl
// read dominates its bytes too. Its block takes a brick of voxels and walks
// a chunk of D like K3's, one thread per (voxel, head), but stages both
// inputs: each d-slice's (bh+2) x (bw+2) halo of dl rows and of q rows, zero
// outside the volume, copied one slice ahead into a two-slot ring. A halo
// row of dl is 108 bytes a voxel in float32 (54 in bf16), no whole number of
// 16-byte units, so each halo row goes as a span laid out at its alignment
// (attn_tile.cuh: load_spans): its interior by one bulk copy of the tensor
// memory accelerator, its ends unit by unit with cp.async. A staged slice s
// is the source of dk at s-1, s and s+1, so a thread keeps three dk rows in
// registers and reads each of its 9 source q rows once per slice for all
// three (27 dl values and 9 q rows a slice, against 27 of each for the
// window at once). Measured on the H100 (PERF.md): at level 1, 0.76 of its
// bound in float32 (device memory sets the pace; the per-thread cp.async
// copies it replaced left it copy-bound at 0.58) and 0.56 in bf16, where
// the bf16 unpacking and the shared-memory reads are as many as in float32.

#include <cuda_runtime.h>
#include <math.h>

#include "attn_tile.cuh"
#include "io_types.cuh"

namespace {

using namespace smilecode::attn;
using smilecode::from_f32;
using smilecode::kVec16;
using smilecode::round_to;
using smilecode::st_vec16;
using smilecode::to_f32;

// floats of a K3 dl-tile row: one brick w-row of dl (bw*heads*27), shifted
// by up to V-1 to the global span's 16-byte alignment, rounded to V
template <typename T>
__host__ __device__ inline int dl_stride(const Brick& g) {
  constexpr int V = kVec16<T>;
  return (g.bw * g.heads * 27 + 2 * V - 1) / V * V;
}

constexpr int kGroups = 8;  // voxel groups of K3's drpb reduction

template <typename T>
size_t dq_smem_bytes(const Brick& g) {
  return kRing * g.slot_elems * sizeof(T) +
         (static_cast<size_t>(g.bh) * dl_stride<T>(g) + g.heads * 27 * (1 + kGroups)) *
             sizeof(float);
}

// at most 128 registers (two blocks per SM): left alone, ptxas takes 185-255
// for the unrolled passes, one block per SM
template <typename T, int MAX_HD, bool PAIRS>
__global__ void __launch_bounds__(kMaxThreads, 2)
modet_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const float* __restrict__ rpb, const T* __restrict__ g_out,
                         T* __restrict__ dq, T* __restrict__ dl,
                         float* __restrict__ drpb_part, Brick g, float scale) {
  constexpr int V = kVec16<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* tile = reinterpret_cast<float*>(smem + kRing * g.slot_elems * sizeof(T));
  const int stride = dl_stride<T>(g);
  const int cols = g.heads * 27;
  float* bias = tile + g.bh * stride;  // cols
  float* gsum = bias + cols;            // cols * kGroups: the drpb group sums
  float part[27];  // this thread's sum of dl_t over the block's d range
#pragma unroll
  for (int t = 0; t < 27; ++t) part[t] = 0.f;
  const Origin o = origin(g, g.D);
  const long long bd = static_cast<long long>(o.b) * g.D;
  const long long bk = static_cast<long long>(o.b) * g.kD;
  stage_prologue(ring, bias, k, rpb, bk, o, g);
  const Seat me = seat(o.h0, o.w0, g);
  const float qscale = round_to<T>(scale);
  const float* bs = bias + me.head * 27;
  const int nw = min(g.bw, g.W - o.w0);  // voxels of a brick w-row inside the volume
  const int rows = min(g.bh, g.H - o.h0);
  const int span = nw * cols;            // dl values of a brick w-row
  const long long hstep = static_cast<long long>(g.W) * cols;
  const long long step = static_cast<long long>(g.H) * g.W * g.heads;  // rows per d-slice
  long long idx = (((bd + o.d0) * g.H + me.h) * g.W + me.w) * g.heads + me.head;
  float qn[MAX_HD], gn[3];  // the q and g rows of the slice to come
  if (me.active) {
    fetch_row<T, MAX_HD>(qn, q + idx * g.hd, g.hd);
    fetch_row<T, 3>(gn, g_out + idx * 3, 3);
  }

  for (int d = o.d0; d < o.d1; ++d, idx += step) {
    const int j = d - o.d0;  // slots j, j+1, j+2 hold slices d-1, d, d+1
    if (d + 2 <= o.d1) load_slice(ring + ((j + 3) % kRing) * g.slot_elems, k, bk, d + 2, o.h0, o.w0, g);
    cp_async_commit();
    // index of the first dl value of the slice's brick w-row 0; row hl
    // starts hl*hstep later, and its tile row holds it from position
    // (its start mod V) on
    const long long row0 = (((bd + d) * g.H + o.h0) * g.W + o.w0) * cols;
    if (me.active) {
      float qr[MAX_HD];
      scale_q<T, MAX_HD>(qr, qn, qscale);
      const float g0 = gn[0], g1 = gn[1], g2 = gn[2];
      if (d + 1 < o.d1) {
        fetch_row<T, MAX_HD>(qn, q + (idx + step) * g.hd, g.hd);
        fetch_row<T, 3>(gn, g_out + (idx + step) * 3, 3);
      }
      const T* slots[3];
#pragma unroll
      for (int od = 0; od < 3; ++od) slots[od] = ring + ((j + od) % kRing) * g.slot_elems + me.own;
      float e[27];  // logits, then exp(logit - max)
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < 27; ++t) {
        e[t] = logit<T, MAX_HD, PAIRS>(qr, slots[t / 9] + token_offset(t % 9, g), g.hd, bs[t]);
        m = fmaxf(m, e[t]);
      }
      float s = 0.f, sda = 0.f;
      const float m_log2e = m * kLog2e;
#pragma unroll
      for (int t = 0; t < 27; ++t) {
        e[t] = exp_minus(e[t], m_log2e);
        s += e[t];
        sda += e[t] * ((t / 9 - 1) * g0 + ((t / 3) % 3 - 1) * g1 + (t % 3 - 1) * g2);
      }
      const float inv = 1.f / s;
      const float ssum = sda * inv;  // sum_u p_u da_u
      float* tl = tile + me.hl * stride + static_cast<int>((row0 + me.hl * hstep) & (V - 1)) +
                  (me.wl * g.heads + me.head) * 27;  // this thread's 27 dl values
      float acc[MAX_HD];
#pragma unroll
      for (int i = 0; i < MAX_HD; ++i) acc[i] = 0.f;
#pragma unroll
      for (int t = 0; t < 27; ++t) {
        const float da = (t / 9 - 1) * g0 + ((t / 3) % 3 - 1) * g1 + (t % 3 - 1) * g2;
        const float dlt = e[t] * inv * (da - ssum);
        tl[t] = dlt;
        part[t] += dlt;
        axpy<T, MAX_HD, PAIRS>(acc, dlt, slots[t / 9] + token_offset(t % 9, g), g.hd);
      }
      T* dqp = dq + idx * g.hd;
#pragma unroll
      for (int i = 0; i < MAX_HD; ++i)
        if (i < g.hd) dqp[i] = from_f32<T>(scale * acc[i]);
    }
    __syncthreads();

    // the slice's dl leaves row by row: tile position p of row hl and dl
    // index r0 - r0 % V + p agree modulo V, so whole V-vectors are 16-byte
    // stores, the partial first and last ones scalar stores
    const int nvec = (span + 2 * V - 2) / V;  // vectors of a row, at most
    for (int u = threadIdx.x; u < rows * nvec; u += blockDim.x) {
      const int hl = u / nvec, vi = u - hl * nvec;
      const long long r0 = row0 + hl * hstep;
      const int shift = static_cast<int>(r0 & (V - 1));
      const int lo = vi * V, hi = lo + V;  // tile positions of this vector
      if (lo >= shift + span) continue;
      const float* src = tile + hl * stride + lo;
      T* dst = dl + (r0 - shift + lo);
      if (lo >= shift && hi <= shift + span) {
        float v[V];
#pragma unroll
        for (int x = 0; x < V; ++x) v[x] = src[x];
        st_vec16(dst, v);
      } else {
        for (int x = max(0, shift - lo); x < V && lo + x < shift + span; ++x)
          dst[x] = from_f32<T>(src[x]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  if (drpb_part) {
    // partial[head, t] = the threads' sums part[t] over the brick's voxels
    // v, added in a fixed order: ascending v within kGroups groups, then the
    // groups in order
#pragma unroll
    for (int t = 0; t < 27; ++t) tile[threadIdx.x * 27 + t] = part[t];
    __syncthreads();
    const int nv = g.bh * g.bw, per = (nv + kGroups - 1) / kGroups;
    for (int w = threadIdx.x; w < cols * kGroups; w += blockDim.x) {
      const int grp = w % kGroups, c = w / kGroups, head = c / 27, t = c % 27;
      float sum = 0.f;
      for (int v = grp * per; v < min(nv, (grp + 1) * per); ++v)
        sum += tile[(v * g.heads + head) * 27 + t];
      gsum[w] = sum;
    }
    __syncthreads();
    const long long blk =
        (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      float sum = 0.f;
      for (int grp = 0; grp < kGroups; ++grp) sum += gsum[c * kGroups + grp];
      drpb_part[blk * cols + c] = sum;
    }
  }
}

// K4's stage: a ring slot holds the (bh+2) x (bw+2) halo of a brick in one
// d-slice, the dl rows (heads*27 values a voxel) and then the q rows
// (heads*hd), each halo row a span (attn_tile.cuh: load_spans); dl is
// 16-byte aligned, q's copy unit (Brick::unit) the widest its address
// allows: 16 bytes (bulk copies) or 8, 4, 2 (units only). After the ring,
// one mbarrier per slot counts its bulk bytes.
struct DkStage {
  Brick g;
  int lrow, qrow;            // bytes of a voxel's dl and q rows
  int lpitch, qpitch;        // bytes of a slot row of dl and of q
  int slot;                  // bytes of a ring slot: (bh+2) * (lpitch + qpitch)
  long long lbytes, qbytes;  // bytes of dl and q
  bool mixed;                // a slot byte can be a bulk copy's in one slice, a unit's in another
};

constexpr int kDkRing = 2;  // K4's ring slots: the slice read and the one in flight

template <typename T>
__device__ __forceinline__ void load_dk_slice(unsigned char* slot, const T* q, const T* dl,
                                              long long bd, int d, const Origin& o,
                                              const DkStage& st, unsigned long long* bar) {
  char* sb = reinterpret_cast<char*>(slot);
  const char* ls = reinterpret_cast<const char*>(dl);
  char* qb = sb + (st.g.bh + 2) * st.lpitch;
  const char* qs = reinterpret_cast<const char*>(q);
  unsigned sent = load_spans<16>(sb, st.lpitch, ls, st.lrow, st.lbytes, bd, d, o.h0, o.w0, st.g,
                                 bar, 0);
  const int qfirst = st.g.bh + 2;  // q's rows start with the groups after dl's
  switch (st.g.unit) {
    case 16:
      sent += load_spans<16>(qb, st.qpitch, qs, st.qrow, st.qbytes, bd, d, o.h0, o.w0, st.g, bar,
                             qfirst);
      break;
    case 8:
      load_spans<8>(qb, st.qpitch, qs, st.qrow, st.qbytes, bd, d, o.h0, o.w0, st.g, bar, qfirst);
      break;
    case 4:
      load_spans<4>(qb, st.qpitch, qs, st.qrow, st.qbytes, bd, d, o.h0, o.w0, st.g, bar, qfirst);
      break;
    default:
      load_spans<2>(qb, st.qpitch, qs, st.qrow, st.qbytes, bd, d, o.h0, o.w0, st.g, bar, qfirst);
      break;
  }
  // one arrival per copy group, with the bytes its bulk copies bring
  if (threadIdx.x % copy_lanes() == 0 && threadIdx.x / copy_lanes() < copy_groups())
    mbar_expect(bar, sent);
}

__device__ __forceinline__ void st_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// dk row p = scale * acc, rounded to T
template <typename T, int MAX_HD, bool PAIRS>
__device__ __forceinline__ void store_dk(T* p, const float (&acc)[MAX_HD], int hd, float scale) {
  if constexpr (PAIRS) {
#pragma unroll
    for (int i = 0; i < MAX_HD; i += 2)
      if (i < hd) st_pair(p + i, scale * acc[i], scale * acc[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < MAX_HD; ++i)
      if (i < hd) p[i] = from_f32<T>(scale * acc[i]);
  }
}

// K4. Staged slice s is the source slice of dk at s-1, s and s+1 (od = 0, 1,
// 2: x_d = s + od - 1), so a thread keeps three accumulators, a0 for s-1, a1
// for s, a2 for s+1, reads each of its 9 source q rows once per slice for all
// three, and retires a0 after the slice; the ring needs two slots. A block
// walks the source slices d0-1 .. d1 of its chunk that lie in the volume
// (outside ones give nothing, as in the plain version). dk[x] sums its 27
// terms slice by slice (x_d-1, x_d, x_d+1), (oh, ow) ascending in each: not
// the plain version's t order, the same float32 terms. The grid chunks dk's
// kD slices; in halo-k mode a chunk's query coordinates [x0, x1) are its dk
// slices less one, so the first and last chunks reach x = -1 and x = D,
// whose only sources are slices 0 and D-1.
template <typename T, int MAX_HD, bool PAIRS>
__global__ void __launch_bounds__(kMaxThreads, MAX_HD > 8 ? 1 : sizeof(T) == 2 ? 4 : 2)
modet_attn_bwd_dk_kernel(const T* __restrict__ q, const T* __restrict__ dl, T* __restrict__ dk,
                         DkStage st, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Brick& g = st.g;
  const Origin o = origin(g, g.kD);
  const int x0 = o.d0 - g.koff, x1 = o.d1 - g.koff;  // the chunk's dk slices, query coordinates
  const long long bd = static_cast<long long>(o.b) * g.D;
  const Seat me = seat(o.h0, o.w0, g);
  const int s0 = max(x0 - 1, 0), s1 = min(x1, g.D - 1);  // source slices, inclusive
  const int hd = MAX_HD % 8 ? MAX_HD : g.hd;  // MAX_HD 6: exactly ModeT's head_dim
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + kDkRing * st.slot);
  if (threadIdx.x == 0) {
    mbar_init(bars, copy_groups());
    mbar_init(bars + 1, copy_groups());
  }
  __syncthreads();
  load_dk_slice(smem, q, dl, bd, s0, o, st, bars);
  cp_async_commit();
  cp_async_wait_all();
  mbar_wait(bars, 0);
  if (st.mixed) fence_proxy_async();
  __syncthreads();

  const long long step = static_cast<long long>(g.H) * g.W * g.heads;  // rows per d-slice
  // dk row at query coordinate 0 (dk slice koff)
  const long long row0 =
      (((static_cast<long long>(o.b) * g.kD + g.koff) * g.H + me.h) * g.W + me.w) * g.heads +
      me.head;
  // this thread's dl and q rows of halo voxel (hl, wl) in a slot, before the
  // slot row's shift
  const int lown = me.hl * st.lpitch + (me.wl * g.heads + me.head) * 27 * static_cast<int>(sizeof(T));
  const int qown = (g.bh + 2) * st.lpitch + me.hl * st.qpitch + (me.wl * g.heads + me.head) * g.hd *
                   static_cast<int>(sizeof(T));
  float a0[MAX_HD], a1[MAX_HD], a2[MAX_HD];
#pragma unroll
  for (int i = 0; i < MAX_HD; ++i) a0[i] = a1[i] = a2[i] = 0.f;

  for (int s = s0; s <= s1; ++s) {
    const unsigned char* slot = smem + ((s - s0) & 1) * st.slot;
    const int f = s - s0 + 1;  // fill number of slice s+1: slot f & 1, its (f >> 1)-th use
    if (s < s1) load_dk_slice(smem + (f & 1) * st.slot, q, dl, bd, s + 1, o, st, bars + (f & 1));
    cp_async_commit();
    const bool u0 = s > x0, u1 = s >= x0 && s < x1, u2 = s + 1 < x1;
    if (me.active) {
#pragma unroll
      for (int oh = 0; oh < 3; ++oh) {
        // halo row hl + 2 - oh holds the sources of row h - (oh - 1)
        const int hh = me.hl + 2 - oh;
        const long long g0 = span_start(bd, s, o.h0 - 1 + hh, o.w0, 1, g);  // voxel index
        const unsigned char* lr =
            slot + lown + (2 - oh) * st.lpitch + static_cast<int>((g0 * st.lrow) & 15);
        const unsigned char* qr = slot + qown + (2 - oh) * st.qpitch +
                                  static_cast<int>((g0 * st.qrow) & (g.unit - 1));
#pragma unroll
        for (int ow = 0; ow < 3; ++ow) {
          const T* lp = reinterpret_cast<const T*>(lr + (2 - ow) * st.lrow) + oh * 3 + ow;
          const T* qp = reinterpret_cast<const T*>(qr + (2 - ow) * st.qrow);
          float qv[MAX_HD];
          if constexpr (PAIRS) {
#pragma unroll
            for (int i = 0; i < MAX_HD; i += 2)
              if (i < hd) lds_pair(qp + i, qv[i], qv[i + 1]);
          } else {
#pragma unroll
            for (int i = 0; i < MAX_HD; ++i)
              if (i < hd) qv[i] = lds_f32(qp + i);
          }
          if (u0) {
            const float x = lds_f32(lp);
#pragma unroll
            for (int i = 0; i < MAX_HD; ++i)
              if (i < hd) a0[i] += x * qv[i];
          }
          if (u1) {
            const float x = lds_f32(lp + 9);
#pragma unroll
            for (int i = 0; i < MAX_HD; ++i)
              if (i < hd) a1[i] += x * qv[i];
          }
          if (u2) {
            const float x = lds_f32(lp + 18);
#pragma unroll
            for (int i = 0; i < MAX_HD; ++i)
              if (i < hd) a2[i] += x * qv[i];
          }
        }
      }
      if (u0) store_dk<T, MAX_HD, PAIRS>(dk + (row0 + (s - 1) * step) * hd, a0, hd, scale);
    }
#pragma unroll
    for (int i = 0; i < MAX_HD; ++i) {
      a0[i] = a1[i];
      a1[i] = a2[i];
      a2[i] = 0.f;
    }
    cp_async_wait_all();
    if (s < s1) mbar_wait(bars + (f & 1), (f >> 1) & 1);
    if (st.mixed) fence_proxy_async();  // unit writes before a later bulk copy's
    __syncthreads();
  }
  // dk at s1 waits in a0 (with x1 = D: the last slice, D-1), and in halo-k
  // mode dk at s1 + 1 = D in a1
  if (me.active) {
    if (s1 >= x0 && s1 < x1) store_dk<T, MAX_HD, PAIRS>(dk + (row0 + s1 * step) * hd, a0, hd, scale);
    if (s1 + 1 < x1) store_dk<T, MAX_HD, PAIRS>(dk + (row0 + (s1 + 1) * step) * hd, a1, hd, scale);
  }
}

template <typename T, int MAX_HD, bool PAIRS>
int launch_dq(const T* q, const T* k, const float* rpb, const T* g, T* dq, T* dl, float* part,
              long long B, const Brick& geo, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<T>(geo);
  if (smem > static_cast<size_t>(kSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = modet_attn_bwd_dq_kernel<T, MAX_HD, PAIRS>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid_of(B, geo, geo.D), geo.bh * geo.bw * geo.heads, smem, stream>>>(q, k, rpb, g, dq, dl,
                                                                         part, geo, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dq(const T* q, const T* k, const float* rpb, const T* g, T* dq, T* dl, float* drpb_part,
           long long B, int D, int H, int W, int heads, int hd, float scale, int bh, int bw,
           int cd, int unit, int koff, void* stream) {
  if (B * D * H * W * heads == 0) return static_cast<int>(cudaSuccess);
  Brick geo;
  if (B < 0 || !make_brick<T>(geo, D, H, W, heads, hd, bh, bw, cd, unit, k, koff) ||
      reinterpret_cast<unsigned long long>(dl) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pairs = hd % 2 == 0;
  if (hd <= 8) {
    return pairs ? launch_dq<T, 8, true>(q, k, rpb, g, dq, dl, drpb_part, B, geo, scale, st)
                 : launch_dq<T, 8, false>(q, k, rpb, g, dq, dl, drpb_part, B, geo, scale, st);
  } else if (hd <= 16) {
    return pairs ? launch_dq<T, 16, true>(q, k, rpb, g, dq, dl, drpb_part, B, geo, scale, st)
                 : launch_dq<T, 16, false>(q, k, rpb, g, dq, dl, drpb_part, B, geo, scale, st);
  } else if (hd <= 32) {
    return pairs ? launch_dq<T, 32, true>(q, k, rpb, g, dq, dl, drpb_part, B, geo, scale, st)
                 : launch_dq<T, 32, false>(q, k, rpb, g, dq, dl, drpb_part, B, geo, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int MAX_HD, bool PAIRS>
int launch_dk(const T* q, const T* dl, T* dk, long long B, const DkStage& st, float scale,
              cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kDkRing) * st.slot + 2 * sizeof(unsigned long long);
  if (smem > static_cast<size_t>(kSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = modet_attn_bwd_dk_kernel<T, MAX_HD, PAIRS>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Brick& g = st.g;
  kernel<<<grid_of(B, g, g.kD), g.bh * g.bw * g.heads, smem, stream>>>(q, dl, dk, st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dk(const T* q, const T* dl, T* dk, long long B, int D, int H, int W, int heads, int hd,
           float scale, int bh, int bw, int cd, int koff, void* stream) {
  if (B * D * H * W * heads == 0) return static_cast<int>(cudaSuccess);
  const auto addr = [](const void* p) { return reinterpret_cast<unsigned long long>(p); };
  const int isz = static_cast<int>(sizeof(T));
  int qunit = 16;  // q's copy unit: the widest that its address allows
  while (addr(q) % qunit) qunit /= 2;
  if (B < 0 || D <= 0 || H <= 0 || W <= 0 || heads <= 0 || hd <= 0 || bh <= 0 || bw <= 0 ||
      cd <= 0 || static_cast<long long>(bh) * bw * heads > kMaxThreads || addr(dl) % 16 ||
      qunit < isz || addr(dk) % isz || (koff != 0 && koff != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  DkStage st;
  st.g = Brick{D, H, W, heads, hd, bh, bw, cd, qunit, heads * hd, bw + 2, 0, D + 2 * koff, koff};
  st.lrow = heads * 27 * isz;
  st.qrow = heads * hd * isz;
  st.lpitch = span_pitch(bw, st.lrow);
  st.qpitch = span_pitch(bw, st.qrow);
  st.slot = (bh + 2) * (st.lpitch + st.qpitch);
  st.lbytes = B * D * H * W * static_cast<long long>(st.lrow);
  st.qbytes = B * D * H * W * static_cast<long long>(st.qrow);
  // a row's shift, and with it the split between bulk and unit copies, is the
  // same in every slice when W rows are whole 16-byte units
  st.mixed = (static_cast<long long>(W) * st.lrow) % 16 || (static_cast<long long>(W) * st.qrow) % 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // pairs: q rows and dk rows start at even values
  const bool pairs = hd % 2 == 0 && qunit >= 2 * isz && addr(dk) % (2 * isz) == 0;
  if (hd == 6) {
    return pairs ? launch_dk<T, 6, true>(q, dl, dk, B, st, scale, s)
                 : launch_dk<T, 6, false>(q, dl, dk, B, st, scale, s);
  } else if (hd <= 8) {
    return pairs ? launch_dk<T, 8, true>(q, dl, dk, B, st, scale, s)
                 : launch_dk<T, 8, false>(q, dl, dk, B, st, scale, s);
  } else if (hd <= 16) {
    return pairs ? launch_dk<T, 16, true>(q, dl, dk, B, st, scale, s)
                 : launch_dk<T, 16, false>(q, dl, dk, B, st, scale, s);
  } else if (hd <= 32) {
    return pairs ? launch_dk<T, 32, true>(q, dl, dk, B, st, scale, s)
                 : launch_dk<T, 32, false>(q, dl, dk, B, st, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Every entry point returns cudaGetLastError() after the launch (0 = launched).
// K3 returns cudaErrorInvalidValue for a brick (bh, bw, cd) or copy width
// (unit bytes) the shapes or k's address do not allow, or a dl that is not
// 16-byte aligned (kernels/modet_attn.py:attn_geometry); its drpb_part is
// (blocks of that brick's grid, heads, 27). koff: 0, or 1 for halo-k mode (k
// and K4's dk of D+2 slices).
extern "C" int smilecode_modet_attn_bwd_dq(const float* q, const float* k, const float* rpb,
                                           const float* g, float* dq, float* dl,
                                           float* drpb_part, long long B, int D, int H, int W,
                                           int heads, int hd, float scale, int bh, int bw, int cd,
                                           int unit, int koff, void* stream) {
  return bwd_dq<float>(q, k, rpb, g, dq, dl, drpb_part, B, D, H, W, heads, hd, scale, bh, bw, cd,
                       unit, koff, stream);
}

extern "C" int smilecode_modet_attn_bwd_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                                const float* rpb, const __nv_bfloat16* g,
                                                __nv_bfloat16* dq, __nv_bfloat16* dl,
                                                float* drpb_part, long long B, int D, int H,
                                                int W, int heads, int hd, float scale, int bh,
                                                int bw, int cd, int unit, int koff, void* stream) {
  return bwd_dq<__nv_bfloat16>(q, k, rpb, g, dq, dl, drpb_part, B, D, H, W, heads, hd, scale, bh,
                               bw, cd, unit, koff, stream);
}

extern "C" int smilecode_modet_attn_bwd_dk(const float* q, const float* dl, float* dk,
                                           long long B, int D, int H, int W, int heads,
                                           int hd, float scale, int bh, int bw, int cd, int koff,
                                           void* stream) {
  return bwd_dk<float>(q, dl, dk, B, D, H, W, heads, hd, scale, bh, bw, cd, koff, stream);
}

extern "C" int smilecode_modet_attn_bwd_dk_bf16(const __nv_bfloat16* q, const __nv_bfloat16* dl,
                                                __nv_bfloat16* dk, long long B, int D, int H,
                                                int W, int heads, int hd, float scale, int bh,
                                                int bw, int cd, int koff, void* stream) {
  return bwd_dk<__nv_bfloat16>(q, dl, dk, B, D, H, W, heads, hd, scale, bh, bw, cd, koff, stream);
}
