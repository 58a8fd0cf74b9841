// Shared halo stage of the neighborhood-attention kernels K1, K3 and K4
// (Hopper, sm_90a). K1 and K3 stage k as below; K4 (modet_attn_bwd.cu)
// stages dl and q rows with the brick, origin and seat of this file and the
// span copies further down.
//
// Both kernels compute, for each (voxel x, head), the 27 logits
//   logit_t = (q*scale) . k[x + o_t] + rpb[head, t],  o_t = (od-1, oh-1, ow-1),
//   t = (od*3 + oh)*3 + ow,
// with k zero outside the volume (the plain version's F.pad, and the TPU
// kernels' padded k). The TPU kernels copy their k window into VMEM before
// they compute (smilecode_tpu/kernels/modet_attn.py:196-200); here a block
// stages it in shared memory:
//
// * A block owns a brick: bh x bw voxels of (h, w), one thread per (voxel,
//   head) of a slice, walking cd consecutive slices of d. Its k neighbourhood
//   is a ring of kRing slots, each one d-slice of (bh+2) x (bw+2) voxels x
//   heads*hd values, kept in the storage type T (float32, or bf16 at half the
//   bytes). Output slice d reads the slots of d-1, d and d+1 while slice d+2
//   is copied into the fourth slot with cp.async, so the copy overlaps the
//   compute.
// * Out-of-volume voxels are filled with zeros (cp.async with a source size
//   of 0), so the inner loops have no bounds checks: an outside neighbour
//   gives logit 0*q + rpb and adds dl*0 to dq, exactly as the zero-padded
//   plain version does, non-finite q included.
// * Each k value is read from device memory about (bh+2)(bw+2)/(bh*bw)
//   times per d-chunk (the h/w halo, neighbouring blocks hit in L2) plus
//   2/cd for the d halo, and 27 times from shared memory.
//
// The brick (bh, bw, cd) and the copy width come from the Python wrapper
// (kernels/modet_attn.py:attn_geometry), which also sizes the drpb partials
// of K3 from the same grid.
//
// Halo-k mode (koff = 1; the D-sharded training step,
// smilecode_tpu/kernels/modet_attn.py:109-134 with k_prepadded_d=True): k
// has kD = D+2 slices, its first and last the neighbour shards' slices (zeros
// at the global ends, from the halo exchange). Query slice d reads k slices
// d-1..d+1 at k's own indices d..d+2, so only the D test of the copy changes:
// those border slices are data, not zero fill; H and W keep their zero
// border. K4 then writes dk for all kD slices (modet_attn_bwd.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "io_types.cuh"

namespace smilecode {
namespace attn {

constexpr int kRing = 4;         // ring slots: three read, one in flight
constexpr int kMaxThreads = 256;  // (voxel, head) rows per brick slice
constexpr int kSmemMax = 232448;  // dynamic shared memory a block can use

// One launch's geometry, the same for every block. Grid: (ceil(W/bw),
// ceil(H/bh), B*chunks), chunks = ceil(D/cd); blockDim.x = bh*bw*heads.
struct Brick {
  int D, H, W, heads, hd;
  int bh, bw, cd;
  int unit;         // bytes per copy: 16, 8 or 4 (cp.async), or 2 (plain loads)
  int row;          // heads*hd values per voxel
  int pitch;        // bw + 2 voxels per halo row of a slot
  int slot_elems;   // values of T per ring slot (a multiple of 16 bytes)
  int kD, koff;     // k's (and K4's dk's) slices and the offset of query slice 0 in them:
                    // D and 0, or D+2 and 1 in halo-k mode
};

template <typename T>
__host__ __device__ inline int slot_elems(int bh, int bw, int row) {
  const int bytes = (bh + 2) * (bw + 2) * row * static_cast<int>(sizeof(T));
  return ((bytes + 15) / 16) * 16 / static_cast<int>(sizeof(T));
}

// The brick of a launch, or false when the arguments cannot be launched:
// non-positive sizes, a block over kMaxThreads, a koff other than 0 or 1,
// or a copy width that the row or k's address does not allow.
template <typename T>
inline bool make_brick(Brick& g, int D, int H, int W, int heads, int hd, int bh, int bw, int cd,
                       int unit, const void* k, int koff) {
  g = Brick{D, H, W, heads, hd, bh, bw, cd, unit, heads * hd, bw + 2, 0, D + 2 * koff, koff};
  if (D <= 0 || H <= 0 || W <= 0 || heads <= 0 || hd <= 0 || bh <= 0 || bw <= 0 || cd <= 0 ||
      (koff != 0 && koff != 1))
    return false;
  if (static_cast<long long>(bh) * bw * heads > kMaxThreads) return false;
  const int row_bytes = g.row * static_cast<int>(sizeof(T));
  if (unit != 16 && unit != 8 && unit != 4 && unit != 2) return false;
  if (row_bytes % unit || reinterpret_cast<unsigned long long>(k) % unit) return false;
  g.slot_elems = slot_elems<T>(bh, bw, g.row);
  return true;
}

// ---- copies into the ring ----------------------------------------------

// the first n (0 <= n <= U) of U bytes at src into dst, zeros after them;
// src is not read where n = 0
template <int U>
__device__ __forceinline__ void copy_bytes(void* dst, const void* src, int n) {
  if constexpr (U == 2) {
    // a bf16 row of an odd number of values: plain 2-byte loads
    *static_cast<unsigned short*>(dst) =
        n ? __ldg(static_cast<const unsigned short*>(src)) : static_cast<unsigned short>(0);
  } else {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (U == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(U),
                   "r"(n));
    }
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int U>
__device__ __forceinline__ void load_slice_units(T* slot, const T* k, long long bk, int d, int h0,
                                                 int w0, const Brick& g) {
  // a halo row of the slot, (bw+2) voxel rows, is contiguous in k and in the
  // slot, and only its ends can lie outside the volume in w: groups of up to
  // 32 threads copy whole rows, U bytes a thread, with no divisions
  const int row_bytes = g.row * static_cast<int>(sizeof(T));
  const int span = g.pitch * row_bytes;                             // bytes of a halo row
  const int lo = w0 == 0 ? row_bytes : 0;                           // voxel w0-1 < 0 outside
  const int hi = (min(g.W, w0 + g.bw + 1) - (w0 - 1)) * row_bytes;  // voxels >= W outside
  const int lanes = min(32, static_cast<int>(blockDim.x));
  const int groups = blockDim.x / lanes, grp = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  if (grp >= groups) return;
  const int dk = d + g.koff;  // k's own index of query-coordinate slice d
  const bool d_in = dk >= 0 && dk < g.kD;
  const char* kb = reinterpret_cast<const char*>(k);
  char* sb = reinterpret_cast<char*>(slot);
  for (int hh = grp; hh < g.bh + 2; hh += groups) {
    const int h = h0 - 1 + hh;
    const bool row_in = d_in && h >= 0 && h < g.H;
    const long long base = (((bk + dk) * g.H + h) * g.W + w0 - 1) * static_cast<long long>(row_bytes);
    for (int b = lane * U; b < span; b += lanes * U) {
      const bool inside = row_in && b >= lo && b < hi;
      // 0 bytes read: the slot gets zeros
      copy_bytes<U>(sb + hh * span + b, inside ? kb + base + b : kb, inside ? U : 0);
    }
  }
}

// Issue the copy of the k slice that query slice d reads as its od = 1
// neighbour (zeros outside the volume, and outside k's kD slices) of the
// brick at (h0, w0) of batch element b (bk = b*kD) into ring slot ``slot``.
// The copy is asynchronous for units of 4-16 bytes: cp_async_commit,
// cp_async_wait_all and __syncthreads make it visible.
template <typename T>
__device__ __forceinline__ void load_slice(T* slot, const T* k, long long bk, int d, int h0, int w0,
                                           const Brick& g) {
  switch (g.unit) {
    case 16: load_slice_units<T, 16>(slot, k, bk, d, h0, w0, g); break;
    case 8: load_slice_units<T, 8>(slot, k, bk, d, h0, w0, g); break;
    case 4: load_slice_units<T, 4>(slot, k, bk, d, h0, w0, g); break;
    default: load_slice_units<T, 2>(slot, k, bk, d, h0, w0, g); break;
  }
}

// ---- span copies (K4) --------------------------------------------------
//
// K4 stages rows too wide or too oddly sized for whole-voxel units (dl's 27
// values: 108 bytes in float32, 54 in bf16) as spans: a halo row of (bw+2)
// voxel rows is one contiguous span in memory. Its slot row keeps the span's
// alignment modulo the copy unit U (16 bytes, or 8, 4, 2 for a q whose
// address allows no more): slot-row byte r holds tensor byte floor_U(g0) +
// r, where g0 is the byte offset of voxel w0-1, so voxel ww of the halo
// starts at (g0 mod U) + ww * row_bytes, and whole units line up in both.
// With U = 16 the units of a row that lie inside the volume (and inside the
// tensor) go as one bulk copy of the tensor memory accelerator (TMA,
// cp.async.bulk), whose completion an mbarrier counts in bytes; the rest,
// at most a unit at each end of the row and zeros for voxels outside the
// volume, go unit by unit with cp.async (source size 0: zeros).

__host__ __device__ inline int span_pitch(int bw, int row_bytes) {
  return ((bw + 2) * row_bytes + 15 + 15) / 16 * 16;  // any shift below 16
}

// byte offset in the tensor of voxel w0-1 of row h of d-slice d (negative
// for the halo row h = -1 of the first slice)
__device__ __forceinline__ long long span_start(long long bd, int d, int h, int w0, int row_bytes,
                                                const Brick& g) {
  return (((bd + d) * g.H + h) * g.W + w0 - 1) * static_cast<long long>(row_bytes);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects ``bytes`` more of bulk copies
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tWAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
// orders this thread's shared-memory writes before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The unit at the left end of a halo row whose voxel w0-1 lies outside the
// volume: its first f bytes are that voxel's (zeros), bytes [f, n) data.
// Voxel rows are whole values, so in 4-byte pieces only a bf16 value
// boundary (f = 2 mod 4) splits a piece: that piece takes a plain load.
template <int U>
__device__ __forceinline__ void copy_straddle(char* dst, const char* src, int f, int n,
                                              const char* safe) {
#pragma unroll
  for (int p = 0; p < U; p += 4) {
    const int a = max(f - p, 0), b = min(n - p, 4);  // data bytes [a, b) of the piece
    if (a == 0 && b > 0) {
      copy_bytes<4>(dst + p, src + p, b);
    } else if (a < b) {  // a == 2, b == 4
      *reinterpret_cast<unsigned short*>(dst + p) = 0;
      *reinterpret_cast<unsigned short*>(dst + p + 2) =
          __ldg(reinterpret_cast<const unsigned short*>(src + p + 2));
    } else {
      copy_bytes<4>(dst + p, safe, 0);
    }
  }
}

// A halo row of a span copy: its U-byte units [0, kend) cover the span; the
// in-volume bytes are [lo, hi) of it (relative to g0); units [b0, b1) go by
// one bulk copy (U = 16 only), the others unit by unit.
struct SpanRow {
  long long g0;  // byte offset of voxel w0-1
  int shift, lo, hi, kend, b0, b1;
  bool in;       // the row lies inside the volume in h
};

template <int U>
__device__ __forceinline__ SpanRow span_row(long long bd, int d, int hh, int h0, int w0,
                                            int row_bytes, long long bytes, const Brick& g) {
  SpanRow r;
  const int h = h0 - 1 + hh, span = (g.bw + 2) * row_bytes;
  r.g0 = span_start(bd, d, h, w0, row_bytes, g);
  r.shift = static_cast<int>(r.g0 & (U - 1));
  r.lo = w0 == 0 ? row_bytes : 0;                           // voxel w0-1 < 0 outside
  r.hi = (min(g.W, w0 + g.bw + 1) - (w0 - 1)) * row_bytes;  // voxels >= W outside
  r.in = h >= 0 && h < g.H;
  r.kend = (r.shift + span + U - 1) / U;
  r.b0 = r.b1 = 0;
  if (U == 16 && r.in) {
    // whole units inside the volume; with lo = 0 the first unit's head (voxel
    // w0-2) and with hi = span the last unit's tail are never read, so they
    // may come along where they lie inside the tensor
    const int khi = (r.shift + r.hi + 15) / 16;
    r.b0 = r.lo == 0 ? 0 : (r.shift + r.lo + 15) / 16;
    r.b1 = r.hi == span && r.g0 - r.shift + 16LL * khi <= bytes ? khi : (r.shift + r.hi) / 16;
    if (r.b1 < r.b0) r.b0 = r.b1 = 0;
  }
  return r;
}

// Copy groups of a block: up to 32 threads each (a warp, or the whole block
// when it is smaller); threads past the last whole group copy nothing.
__device__ __forceinline__ int copy_lanes() { return min(32, static_cast<int>(blockDim.x)); }
__device__ __forceinline__ int copy_groups() { return blockDim.x / copy_lanes(); }

// Issue the copy of the (bh+2) halo rows of d-slice d of x, a (B, D, H, W)
// grid of row_bytes-byte voxel rows, ``bytes`` long, whose address is
// U-aligned, into region (slot rows pitch bytes apart), zeros for voxels
// outside the volume in h or w: row hh by copy group (hh + first) mod
// groups, its bulk part (U = 16) by the group's first thread, which arrives
// on bar later. Returns the bytes of this thread's bulk copies.
template <int U>
__device__ __forceinline__ unsigned load_spans(char* region, int pitch, const char* x,
                                               int row_bytes, long long bytes, long long bd,
                                               int d, int h0, int w0, const Brick& g,
                                               unsigned long long* bar, int first) {
  const int lanes = copy_lanes(), groups = copy_groups();
  const int grp = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  unsigned sent = 0;
  if (grp >= groups) return 0;
  for (int hh = (grp + groups - first % groups) % groups; hh < g.bh + 2; hh += groups) {
    const SpanRow r = span_row<U>(bd, d, hh, h0, w0, row_bytes, bytes, g);
    char* row = region + hh * pitch;
    if (lane == 0 && r.b1 > r.b0) {
      bulk_copy(row + U * r.b0, x + (r.g0 - r.shift + U * static_cast<long long>(r.b0)),
                U * (r.b1 - r.b0), bar);
      sent += U * (r.b1 - r.b0);
    }
    const int n_units = r.kend - (r.b1 - r.b0);
    for (int u = lane; u < n_units; u += lanes) {
      const int k = u < r.b0 ? u : u - r.b0 + r.b1;
      const int at = U * k - r.shift;  // this unit's first byte, relative to g0
      char* dst = row + U * k;
      if (r.in && at + U > r.lo && at < r.hi) {
        const char* src = x + (r.g0 + at);
        const int n = min(U, r.hi - at);
        if (U > 2 && r.lo > 0 && at < r.lo) {
          copy_straddle<U>(dst, src, r.lo - at, n, x);
        } else {
          copy_bytes<U>(dst, src, n);
        }
      } else {
        copy_bytes<U>(dst, x, 0);
      }
    }
  }
  return sent;
}

// ---- reading the ring --------------------------------------------------

__device__ __forceinline__ float lds_f32(const float* p) { return *p; }
__device__ __forceinline__ float lds_f32(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p)) << 16);
}
// two adjacent values at p (8-byte aligned for float, 4-byte for bf16)
__device__ __forceinline__ void lds_pair(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void lds_pair(const __nv_bfloat16* p, float& a, float& b) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}

// The slot-relative offset (in values) of token t's neighbour row for the
// thread whose own voxel row starts at offset 0: the slot is the d-neighbour
// od, the row (oh, ow) of the halo.
__device__ __forceinline__ int token_offset(int t, const Brick& g) {
  return ((t / 3) % 3 * g.pitch + t % 3) * g.row;
}

// logit_t from q (scaled, in registers) and the neighbour's k row kr in
// shared memory: the dot product in ascending i, then the bias. K1 and K3
// both call this, so K3's recomputed softmax sees K1's logits bit for bit.
// PAIRS (hd even): the row is read two values at a time.
template <typename T, int MAX_HD, bool PAIRS>
__device__ __forceinline__ float logit(const float (&qr)[MAX_HD], const T* kr, int hd, float bias) {
  float acc = 0.f;
  if constexpr (PAIRS) {
#pragma unroll
    for (int i = 0; i < MAX_HD; i += 2) {
      if (i < hd) {
        float a, b;
        lds_pair(kr + i, a, b);
        acc += qr[i] * a;
        acc += qr[i + 1] * b;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < MAX_HD; ++i)
      if (i < hd) acc += qr[i] * lds_f32(kr + i);
  }
  return acc + bias;
}

// acc += s * kr (the dq contraction of K3), same reads as `logit`
template <typename T, int MAX_HD, bool PAIRS>
__device__ __forceinline__ void axpy(float (&acc)[MAX_HD], float s, const T* kr, int hd) {
  if constexpr (PAIRS) {
#pragma unroll
    for (int i = 0; i < MAX_HD; i += 2) {
      if (i < hd) {
        float a, b;
        lds_pair(kr + i, a, b);
        acc[i] += s * a;
        acc[i + 1] += s * b;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < MAX_HD; ++i)
      if (i < hd) acc[i] += s * lds_f32(kr + i);
  }
}

// exp(x - m) for the softmax over a voxel's 27 logits, given m*log2(e): one
// FFMA and the SFU's exp2, as flash attention computes it (accurate expf
// takes ~8 more instructions; `attn_ab.py` measured K1 6-9% and K3 f32 4%
// faster with this on the H100). The extra rounding of x*log2(e) is a
// relative error of |x - m| * 2^-24 in a term, far inside the 1e-5
// tolerances; NaN and infinite logits give NaN as expf(x - m) does.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp_minus(float x, float m_log2e) {
  return exp2f(fmaf(x, kLog2e, -m_log2e));
}

// n values of T at p (a q or g row of one (voxel, head)) as float32; each
// kernel fetches the next slice's rows while it computes the current one
template <typename T, int N>
__device__ __forceinline__ void fetch_row(float (&r)[N], const T* p, int n) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = (i < n) ? to_f32(p[i]) : 0.f;
}

// q scaled in T, as the forward scales it
template <typename T, int MAX_HD>
__device__ __forceinline__ void scale_q(float (&qr)[MAX_HD], const float (&raw)[MAX_HD],
                                        float qscale) {
#pragma unroll
  for (int i = 0; i < MAX_HD; ++i) qr[i] = round_to<T>(raw[i] * qscale);
}

// Where a thread of the brick sits: its (voxel, head) in the slice, whether
// that voxel is inside the volume, and its row offset in a ring slot.
struct Seat {
  int head, hl, wl, h, w, own;
  bool active;
};

__device__ __forceinline__ Seat seat(int h0, int w0, const Brick& g) {
  Seat s;
  s.head = threadIdx.x % g.heads;
  const int v = threadIdx.x / g.heads;
  s.wl = v % g.bw;
  s.hl = v / g.bw;
  s.h = h0 + s.hl;
  s.w = w0 + s.wl;
  s.active = s.h < g.H && s.w < g.W;
  s.own = (s.hl * g.pitch + s.wl) * g.row + s.head * g.hd;
  return s;
}

// Block coordinates: the brick origin (h0, w0), the batch element b and the
// d range [d0, d1) of this block, of the ``depth`` slices its grid chunks
// (D for K1 and K3, whose blocks walk query slices; kD for K4, whose blocks
// walk dk slices).
struct Origin {
  int h0, w0, b, d0, d1;
};

__device__ __forceinline__ Origin origin(const Brick& g, int depth) {
  Origin o;
  const int chunks = (depth + g.cd - 1) / g.cd;
  o.w0 = blockIdx.x * g.bw;
  o.h0 = blockIdx.y * g.bh;
  o.b = blockIdx.z / chunks;
  o.d0 = (blockIdx.z % chunks) * g.cd;
  o.d1 = min(o.d0 + g.cd, depth);
  return o;
}

inline dim3 grid_of(long long B, const Brick& g, int depth) {
  const long long chunks = (depth + g.cd - 1) / g.cd;
  return dim3(static_cast<unsigned>((g.W + g.bw - 1) / g.bw),
              static_cast<unsigned>((g.H + g.bh - 1) / g.bh), static_cast<unsigned>(B * chunks));
}

// Prologue of a block: copy the slices d0-1, d0, d0+1 into slots 0..2 and
// the bias rows (rpb or zeros) into bias[heads*27], and wait for them.
template <typename T>
__device__ __forceinline__ void stage_prologue(T* ring, float* bias, const T* k, const float* rpb,
                                               long long bk, const Origin& o, const Brick& g) {
  for (int i = threadIdx.x; i < g.heads * 27; i += blockDim.x) bias[i] = rpb ? rpb[i] : 0.f;
  for (int i = 0; i < 3; ++i)
    load_slice(ring + i * g.slot_elems, k, bk, o.d0 - 1 + i, o.h0, o.w0, g);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
}

}  // namespace attn
}  // namespace smilecode
