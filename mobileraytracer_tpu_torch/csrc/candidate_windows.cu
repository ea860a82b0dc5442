// Candidate windows: the interval slab tests over the supers and over the
// chosen supers' blocks, and both stable smallest-k selections, fused in
// one kernel.
//
// Replaces no Pallas kernel.  What it replaces is the `jnp` chain of
// `_candidates` in mobileraytracer_tpu/ops/pallas_bvh.py (:333), which XLA
// fused on the TPU: the bundle hull, the slab test of every super, a
// `lax.top_k`, a gather of the chosen supers' packed block rows, the slab
// test of their blocks and a second `lax.top_k`.  The port ran it as about
// 230 eager PyTorch ops a call, each to and from HBM:
// `block_traversal._candidates_plain`, which stays as the reference.  This
// kernel equals it bit for bit on CUDA tensors, in all four outputs:
//   - inv_d is 1.0f / d with |d| < 1e-30 clamped to +-1e-30 (the sign of
//     d < 0), the IEEE division; every product and difference is rounded
//     on its own (--fmad=false);
//   - tmin / tmax are torch.minimum / torch.maximum on CUDA: NaN if an
//     operand is, else the min / max instruction that ATen's `::min` /
//     `::max` compile to, so the sign of a zero comes out the same;
//   - the selections are torch.sort(stable=True) cut to k: ascending,
//     -0.0 equal to +0.0, ties to the lower index, +inf entries in index
//     order, NaN last.  Each entry is one 64-bit key: the float's bits made
//     orderable (-0.0 folded onto +0.0, any NaN onto the top) above the
//     index, and a last bit that remembers a -0.0, so the value written is
//     the original one.  Keys are unique, so any sorting network gives the
//     stable order.
// The bundle hull is a warp min / max.  ATen's amin / amax reduce in an
// order of their own, which matters only for a bundle whose origins mix
// -0.0 and +0.0 on one axis and then only against a box bound of -0.0:
// there the hull here takes the min instruction's zero.
//
// What bounds it on the H100.  A bundle reads its rays' origins and
// directions (24 B a ray), the super table (K1 x 6 floats) and the packed
// rows of the s supers it picks (8 x BPS floats each, from L2: the whole
// table is K1 x 512 B, 123 KB for the conference proxy), and writes m x 12
// B and its cut.  The arithmetic is 12 f32 operations an axis a box (two
// differences and four products per face) over K1 + s BPS boxes, plus the
// minima, maxima and the selections' compares, which the bound does not
// count.  The refill's call (65,536 bundles of 16 rays, K1 = 241, s = 32,
// BPS = 16, m = 48) reads 25 MB and writes 38 MB, and needs 1.8 G
// operations: ~0.03 ms against ~23 ms for the eager chain.  The design:
//   - one warp a bundle, so nothing leaves the warp: the hull by shuffles,
//     then each lane tests every 32nd box;
//   - the CUDA block's warps stage the super table in shared memory, 512
//     supers at a time, so any K1 runs;
//   - the slab tests' minima and maxima are single min.NaN / max.NaN
//     instructions;
//   - each selection is a sorted list of the k smallest keys held across
//     the warp (1, 2 or 4 keys a lane, by k), fed 32 boxes at a time: a
//     ballot drops the keys that do not beat the list's k-th; up to four
//     go in one by one (a shift by shuffles), more are sorted by a warp
//     bitonic network, reversed against the list's last row (the min of an
//     ascending and a descending run is a bitonic run holding the smallest
//     of both) and merged by a bitonic half-cleaner cascade;
//   - a block's entry is at least its super's (the max with e_sel), and
//     the supers come in ascending order, so phase B stops at the first
//     chunk whose first super and index already rank behind the list's
//     m-th key;
//   - only the outputs go to HBM: no (bundle, super) or (bundle, block)
//     array, no sort in memory, one launch.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mt.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSuperChunk = 512;       // supers staged in shared memory
constexpr int kMaxDepth = 128;         // top_s and top_m, 4 keys a lane
constexpr int kInsertMax = 4;          // keys a chunk inserted one by one
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;

// torch.minimum / torch.maximum as ATen computes them on CUDA: the min /
// max instruction (so a zero's sign comes out the same), NaN when either
// operand is.  ATen returns the NaN operand, min.NaN a canonical NaN; no
// output can tell them apart (a NaN entry sorts last and is written as
// the padding value).
__device__ __forceinline__ float tmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float tmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The sort key of value v at index idx (see the note at the top).
__device__ __forceinline__ unsigned long long make_key(float v,
                                                       unsigned idx) {
  uint32_t u = __float_as_uint(v);
  const uint32_t neg_zero = u == 0x80000000u;
  uint32_t ord;
  if (v != v) {
    ord = 0xffffffffu;
  } else {
    if (neg_zero) u = 0u;
    ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return ((unsigned long long)ord << 32) | (idx << 1) | neg_zero;
}

__device__ __forceinline__ unsigned key_index(unsigned long long k) {
  return (uint32_t)k >> 1;
}

__device__ __forceinline__ uint32_t key_order(unsigned long long k) {
  return (uint32_t)(k >> 32);
}

// The value a key was made from (any NaN comes back as one NaN).
__device__ __forceinline__ float key_value(unsigned long long k) {
  if ((uint32_t)k & 1u) return -0.0f;
  const uint32_t ord = key_order(k);
  if (ord == 0xffffffffu) return __uint_as_float(0x7fffffffu);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

__device__ __forceinline__ unsigned long long kmin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ unsigned long long kmax(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? b : a;
}

// One key a lane, sorted ascending across the warp.
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long k,
                                                        int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, k, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & size) == 0);
      k = keep_min ? kmin(k, o) : kmax(k, o);
    }
  }
  return k;
}

// A sorted list of 32 KPL keys: element r * 32 + lane is list[r] of lane.
template <int KPL>
struct List {
  unsigned long long key[KPL];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int r = 0; r < KPL; ++r) key[r] = kNoKey;
  }

  // Element i, the same i on every lane.
  __device__ __forceinline__ unsigned long long at(int i) const {
    unsigned long long v = key[0];
#pragma unroll
    for (int r = 1; r < KPL; ++r)
      if ((i >> 5) == r) v = key[r];
    return __shfl_sync(kFull, v, i & 31);
  }

  // Merges a warp-sorted chunk of 32 keys: the list keeps the 32 KPL
  // smallest of both, sorted.
  __device__ __forceinline__ void merge(unsigned long long chunk, int lane) {
    const unsigned long long rev = __shfl_sync(kFull, chunk, 31 - lane);
    key[KPL - 1] = kmin(key[KPL - 1], rev);
#pragma unroll
    for (int jr = KPL / 2; jr > 0; jr >>= 1) {
#pragma unroll
      for (int r = 0; r < KPL; ++r) {
        if ((r & jr) == 0) {
          const unsigned long long a = key[r], b = key[r | jr];
          key[r] = kmin(a, b);
          key[r | jr] = kmax(a, b);
        }
      }
    }
#pragma unroll
    for (int j = 16; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < KPL; ++r) {
        const unsigned long long o = __shfl_xor_sync(kFull, key[r], j);
        key[r] = (lane & j) == 0 ? kmin(key[r], o) : kmax(key[r], o);
      }
    }
  }

  // Inserts key x (the same on every lane, in no list row yet): the keys
  // above it move up one place and the last drops out.
  __device__ __forceinline__ void insert(unsigned long long x, int lane) {
    unsigned long long prev[KPL];
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const unsigned long long up = __shfl_up_sync(kFull, key[r], 1);
      const unsigned long long wrap =
          __shfl_sync(kFull, key[r > 0 ? r - 1 : 0], 31);
      prev[r] = lane == 0 ? wrap : up;
    }
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const bool head = r == 0 && lane == 0;
      if (key[r] > x) key[r] = head || prev[r] < x ? x : prev[r];
    }
  }

  // Offers one key a lane (kNoKey for none) to the list's `depth` smallest;
  // `kth` is the list's element depth - 1 and is kept current.  A few
  // keys go in one by one, more as a sorted chunk.
  __device__ __forceinline__ void offer(unsigned long long k, int depth,
                                        unsigned long long& kth, int lane) {
    if (k >= kth) k = kNoKey;
    unsigned want = __ballot_sync(kFull, k != kNoKey);
    if (want == 0u) return;
    if (__popc(want) <= kInsertMax) {
      while (want) {
        const int src = __ffs(want) - 1;
        want &= want - 1u;
        insert(__shfl_sync(kFull, k, src), lane);
      }
    } else {
      merge(warp_sort(k, lane), lane);
    }
    kth = at(depth - 1);
  }
};

// The bundle's interval hull on one axis: origin and 1 / direction ranges.
struct Axis {
  float o0, o1, i0, i1;
};

// Min and max of (bound - o) * inv over the hull's four corners, in the
// plain version's order.
__device__ __forceinline__ void corners(float bound, const Axis& h,
                                        float& mn, float& mx) {
  const float a0 = bound - h.o1;
  const float a1 = bound - h.o0;
  const float p00 = a0 * h.i0, p01 = a0 * h.i1;
  const float p10 = a1 * h.i0, p11 = a1 * h.i1;
  mn = tmin(tmin(p00, p01), tmin(p10, p11));
  mx = tmax(tmax(p00, p01), tmax(p10, p11));
}

// The conservative entry lower bound of the bundle into box [lo, hi], +inf
// where every ray certainly misses it; `ub` gets the exit upper bound.
__device__ __forceinline__ float entry_lb(const Axis (&h)[3],
                                          const float (&lo)[3],
                                          const float (&hi)[3], float& ub) {
  float lb = 0.0f, far_ub = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float lo_min, lo_max, hi_min, hi_max;
    corners(lo[a], h[a], lo_min, lo_max);
    corners(hi[a], h[a], hi_min, hi_max);
    const float near = tmin(lo_min, hi_min);
    const float far = tmax(lo_max, hi_max);
    lb = a == 0 ? near : tmax(lb, near);
    far_ub = a == 0 ? far : tmin(far_ub, far);
  }
  // torch.clamp(lb, min=0.0): a NaN stays NaN.
  const float lb0 = tmax(lb, 0.0f);
  ub = far_ub;
  return (far_ub < lb0 || far_ub < 0.0f) ? INFINITY : lb;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = tmin(v, __shfl_xor_sync(kFull, v, off));
  return __shfl_sync(kFull, v, 0);      // one zero sign for every lane
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = tmax(v, __shfl_xor_sync(kFull, v, off));
  return __shfl_sync(kFull, v, 0);
}

struct Args {
  const float* o;             // (B, o_stride) rows, xyz first
  const float* d;
  const float* super_lo;      // (3, K1)
  const float* super_hi;
  const float* packed;        // (K1, 8 BPS)
  const float* caps;          // (nt,) or null
  const float* floors;        // (nt,) or null
  int* cand_gid;              // (nt, m)
  int* cand_first;
  float* cand_entry;
  float* cut;                 // (nt,)
  int nt, st, o_stride, d_stride, k1, bps, s, m, nb;
  float big;
};

template <int KPL>
__global__ void __launch_bounds__(kThreads)
window_kernel(const Args p) {
  __shared__ float s_lo[3][kSuperChunk];
  __shared__ float s_hi[3][kSuperChunk];
  __shared__ int s_sup[kWarps][kMaxDepth];
  __shared__ float s_esel[kWarps][kMaxDepth];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bundle = blockIdx.x * kWarps + warp;
  const bool active = bundle < p.nt;     // the same on the whole warp

  // The bundle's hull, per axis (ATen's amin / amax over its st rays).
  Axis h[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    h[a].o0 = h[a].i0 = INFINITY;
    h[a].o1 = h[a].i1 = -INFINITY;
  }
  if (active) {
    for (int r = lane; r < p.st; r += 32) {
      const size_t ray = (size_t)bundle * p.st + r;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float o = p.o[ray * p.o_stride + a];
        const float d = p.d[ray * p.d_stride + a];
        const float den =
            fabsf(d) < 1e-30f ? (d < 0.0f ? -1e-30f : 1e-30f) : d;
        const float inv = 1.0f / den;
        h[a].o0 = tmin(h[a].o0, o);
        h[a].o1 = tmax(h[a].o1, o);
        h[a].i0 = tmin(h[a].i0, inv);
        h[a].i1 = tmax(h[a].i1, inv);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      h[a].o0 = warp_min(h[a].o0);
      h[a].o1 = warp_max(h[a].o1);
      h[a].i0 = warp_min(h[a].i0);
      h[a].i1 = warp_max(h[a].i1);
    }
  }
  const bool has_cap = p.caps != nullptr, has_floor = p.floors != nullptr;
  const float cap = active && has_cap ? p.caps[bundle] : 0.0f;
  const float flr = active && has_floor ? p.floors[bundle] : 0.0f;

  // Phase A: the s nearest supers.
  List<KPL> list;
  list.clear();
  unsigned long long kth = kNoKey;
  for (int base = 0; base < p.k1; base += kSuperChunk) {
    const int n = min(kSuperChunk, p.k1 - base);
    __syncthreads();                     // the last chunk is done with
    for (int i = threadIdx.x; i < 3 * n; i += kThreads) {
      const int a = i / n, j = i - a * n;
      s_lo[a][j] = p.super_lo[(size_t)a * p.k1 + base + j];
      s_hi[a][j] = p.super_hi[(size_t)a * p.k1 + base + j];
    }
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      unsigned long long k = kNoKey;
      if (j < n) {
        const float lo[3] = {s_lo[0][j], s_lo[1][j], s_lo[2][j]};
        const float hi[3] = {s_hi[0][j], s_hi[1][j], s_hi[2][j]};
        float ub;
        float e = entry_lb(h, lo, hi, ub);
        if (has_cap && e >= cap) e = INFINITY;
        if (has_floor && ub < flr) e = INFINITY;
        k = make_key(e, (unsigned)(base + j));
      }
      list.offer(k, p.s, kth, lane);
    }
  }
  if (!active) return;

  // The chosen supers, ascending, and the super cutoff.
  bool ok = true;
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int i = r * 32 + lane;
    if (i < p.s) {
      const float e = key_value(list.key[r]);
      s_sup[warp][i] = (int)key_index(list.key[r]);
      s_esel[warp][i] = e;
      ok = ok && isfinite(e);
    }
  }
  const bool all_ok = __all_sync(kFull, ok);
  const float sup_cut = all_ok ? key_value(list.at(p.s - 1)) : INFINITY;
  __syncwarp();

  // Phase B: the m nearest blocks of the chosen supers.
  const int bps = p.bps, nc = p.s * bps;
  list.clear();
  kth = kNoKey;
  for (int c0 = 0; c0 < nc; c0 += 32) {
    // Every key of this chunk and the later ones is at least its first
    // super's entry at the chunk's first index.
    const float e0 = s_esel[warp][c0 / bps];
    if ((make_key(e0, (unsigned)c0) & ~1ull) >= kth) break;
    const int c = c0 + lane;
    unsigned long long k = kNoKey;
    if (c < nc) {
      const int sp = c / bps, q = c - sp * bps;
      const float* row = p.packed + (size_t)s_sup[warp][sp] * 8 * bps;
      const float lo[3] = {row[q], row[bps + q], row[2 * bps + q]};
      const float hi[3] = {row[3 * bps + q], row[4 * bps + q],
                           row[5 * bps + q]};
      const float count = row[7 * bps + q];
      const float es = s_esel[warp][sp];
      float ub;
      float lb = tmax(entry_lb(h, lo, hi, ub), es);
      if (!(count > 0.0f && isfinite(es))) lb = INFINITY;
      if (has_cap && lb >= cap) lb = INFINITY;
      if (has_floor && lb < flr) lb = INFINITY;
      k = make_key(lb, (unsigned)c);
    }
    list.offer(k, p.m, kth, lane);
  }

  // The window, ascending, and its cut.
  const size_t out0 = (size_t)bundle * p.m;
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int i = r * 32 + lane;
    if (i < p.m) {
      const unsigned c = key_index(list.key[r]);
      const int sp = (int)c / bps, q = (int)c - sp * bps;
      const int sup = s_sup[warp][sp];
      const float e = key_value(list.key[r]);
      p.cand_gid[out0 + i] = min(max(sup * bps + q, 0), p.nb - 1);
      p.cand_first[out0 + i] =
          (int)p.packed[(size_t)sup * 8 * bps + 6 * bps + q];
      p.cand_entry[out0 + i] = isfinite(e) ? e : p.big;
    }
  }
  const float last = key_value(list.at(p.m - 1));
  if (lane == 0) {
    const float cut = tmin(isfinite(last) ? last : INFINITY, sup_cut);
    p.cut[bundle] = isfinite(cut) ? cut : p.big;
  }
}

// Keys a lane of the sorted lists for windows `depth` deep (max(s, m)).
int keys_per_lane(int depth) {
  return depth <= 32 ? 1 : depth <= 64 ? 2 : depth <= kMaxDepth ? 4 : 0;
}

}  // namespace

// One warp a bundle, 8 bundles a CUDA block, on `stream`.  o and d are
// (nt st, *) rows of stride o_stride / d_stride floats, xyz first;
// super_lo / super_hi (3, k1); packed (k1, 8 bps); caps and floors (nt,) or
// null.  Writes cand_gid, cand_first (int32) and cand_entry (nt, m) and
// cut (nt,).  Returns cudaErrorInvalidValue for a shape the kernel does not
// take (s or m outside [1, 128], m above s bps, s above k1), else
// cudaGetLastError() after the launch.
extern "C" int mrt_candidate_windows(
    const float* o, const float* d, const float* super_lo,
    const float* super_hi, const float* packed, const float* caps,
    const float* floors, int* cand_gid, int* cand_first, float* cand_entry,
    float* cut, int nt, int st, int o_stride, int d_stride, int k1, int bps,
    int s, int m, int nb, float big, cudaStream_t stream) {
  if (nt <= 0) return 0;
  const int kpl = keys_per_lane(s > m ? s : m);
  if (kpl == 0 || st < 1 || s < 1 || m < 1 || s > k1 || bps < 1 ||
      m > s * bps || nb != k1 * bps)
    return (int)cudaErrorInvalidValue;
  const Args a{o, d, super_lo, super_hi, packed, caps, floors, cand_gid,
               cand_first, cand_entry, cut, nt, st, o_stride, d_stride, k1,
               bps, s, m, nb, big};
  const unsigned blocks = (unsigned)((nt + kWarps - 1) / kWarps);
  if (kpl == 1)
    window_kernel<1><<<blocks, kThreads, 0, stream>>>(a);
  else if (kpl == 2)
    window_kernel<2><<<blocks, kThreads, 0, stream>>>(a);
  else
    window_kernel<4><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Registers, shared memory and resident blocks per SM of the kernel built
// for windows `depth` deep (see mrt::kernel_info).
extern "C" int mrt_window_info(int* info, int depth) {
  const int kpl = keys_per_lane(depth);
  if (kpl == 1) return mrt::kernel_info(window_kernel<1>, kThreads, 0, info);
  if (kpl == 2) return mrt::kernel_info(window_kernel<2>, kThreads, 0, info);
  if (kpl == 4) return mrt::kernel_info(window_kernel<4>, kThreads, 0, info);
  return (int)cudaErrorInvalidValue;
}
