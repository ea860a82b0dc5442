// Baldwin-Weber tile traversal kernel.
//
// Replaces the TPU kernel `_make_tile_kernel` / `_traverse_tile_padded` of
// mobileraytracer_tpu/ops/pallas_bvh.py (pallas_call at :1291).  Its plain
// PyTorch version is `tile_plain` in ops/kernels.py; the two agree bit for
// bit.
//
// One CUDA block walks one 128-ray tile through the tile's shared list of
// m candidate blocks.  Round r evaluates, for every ray and each triangle
// of tw[gid[r]], the six affine forms of the Baldwin-Weber rows (plane
// distance and barycentrics at the origin, and their rates along the
// direction), t = -no / nd, u and v, and the loose and strict acceptance
// of pallas_bvh.py:1155-1198.  Each ray keeps the round's three smallest
// tracked t with the slots of the first two (:1203-1218), merges them into
// its running sorted triple (:1222-1238), and keeps its best strict hit
// and the ambiguity flag.  After the round the tile stops when r + 1 == m
// or entry[r + 1] >= the tile-wide max of each ray's bound (:1240-1249).
// At least one round always runs.
//
// The TPU kernel gets the six forms from one (256, 8) x (8, 384) float32
// matrix product.  Here they are scalar float32: each form sums the x, y
// and z terms and then the offset, every operation rounded (the library is
// built with --fmad=false), as the plain version does.  The margins of the
// acceptance tests assume a full-float32 contraction, which this is, so
// the tensor cores (3xTF32) are not used.  Every constant that the JAX code
// forms from Python floats arrives from the host already rounded once to
// float32 (BwConsts).
//
// What bounds it on the H100: the f32 operations of the pairs (up to 41
// each, unfused), and around them the latency of a chain of dependent
// operations per pair.  The design:
//   - four threads per ray, 8 rays x 4 parts per warp, 512 threads per
//     tile (tile-MT's layout).  Part q takes the float4 groups q, q + 4, ...
//     of the block, four triangles per load of each row;
//   - the tiles start most listed candidates first (tile_order.cuh), so
//     the longest walks (64 rounds against a mean of 5.9 on the 512x512
//     primaries) overlap the others instead of ending the launch alone;
//   - each scan stops at the block's last valid lane (valid_groups, a
//     ballot over row 4's valid columns once the block has landed): the
//     block build puts a leaf's triangles first and leaves the rest zero;
//   - bw_test leaves a pair as soon as a value the plain version computes
//     rejects it, in the order of kernels.BW_STAGE_OPS: the lane, then
//     det_s and |n.d| (the ambiguity flag is taken before leaving), then t
//     outside both t ranges, then u, then v.  An exited pair contributes
//     what the plain version's 2e30 contributes: nothing but ties at the
//     sentinel, which the single-pass top-3 below never needs;
//   - the round's top-3 is one pass in registers: each part keeps its three
//     smallest tracked (t, slot) pairs in (t, slot) order, and the four
//     triples merge by shuffles.  The plain version's three passes exclude
//     lanes by slot; wherever the round's three smallest tracked t are below
//     1e30 and carry distinct slots (a block's valid lanes carry the slots
//     f0 .. f0 + cnt - 1, block_traversal.build_blocks), those passes give
//     the (t, slot)-sorted top-3.  A ray whose round tracked a t >= 1e30
//     (reachable with t_init = 1e30: the slot resets of :1207-1218 then
//     apply), or whose top-3 repeats a slot, reruns the round in the
//     three-pass form (full_round), recomputing the tracked t;
//   - the blocks of rounds r and r + 1 sit in two shared-memory buffers
//     (rows 0-4 of tw, 7.5 KB each, 16-byte cp.async); round r + 2's block
//     is copied while round r + 1 runs, from the index clamped to the list;
//   - one barrier per round: each warp leaves its max of the rays' bound in
//     a double-buffered slot, and the barrier publishes the verdict, makes
//     the next block visible and frees the buffer the next copy overwrites.
#include <cuda_runtime.h>

#include "mt.cuh"
#include "tile_order.cuh"

namespace {

using namespace mrt;

constexpr int kTile = 128;
constexpr int kSplit = 4;                    // threads per ray
constexpr int kThreads = kTile * kSplit;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRays = 32 / kSplit;       // rays per warp
constexpr int kCols = 3 * kLanes;            // column groups n_hat | w_u | w_v
constexpr int kTwRows = 8;                   // rows per block in tw
constexpr int kTwUsed = 5;                   // rows 0-3 affine rows, 4 metadata
// Rows 0-4 of a block: the first 7,680 bytes of its 12,288-byte row of tw,
// copied as 480 16-byte pieces.
constexpr int kTwChunks = kTwUsed * kCols / 4;
constexpr float kBig2 = 2.0e30f;             // 2 * RAY_LENGTH_MAX

// Float32 constants, in the order of kernels.bw_consts.
struct BwConsts {
  float half_eps, eps15, neg_mu, mu, one_p_mu, one_m_mu, eps_m_tmg,
      eps_p_tmg, one_p_trel, one_m_trel, tmg;
};

// A ray's limits and constants for the pair test.
struct BwRay {
  Ray r;
  float hi_loose, hi_strict;
  int any_hit;
};

// One ray against one triangle, given its Baldwin-Weber columns (n_hat, its
// offset; w_u, c_u; w_v, c_v) and metadata (valid, slot, |ab x ac|).
// Merges a strict hit into (mo, so), sets amb for an ill-conditioned pair,
// and returns whether the pair is tracked (loose, and for any-hit not
// strict), with its t in `t_hit`.  Returns as soon as a value that the plain
// version computes rejects the pair.
__device__ __forceinline__ bool bw_test(const BwRay& q, const BwConsts& c,
                                        float nx, float ny, float nz,
                                        float nw, float ux, float uy,
                                        float uz, float uw, float vx,
                                        float vy, float vz, float vw,
                                        float valid, float slot, float nlen,
                                        float& t_hit, float& mo, float& so,
                                        bool& amb) {
  const Ray& ray = q.r;
  if (!(valid > 0.5f) || slot == ray.prev) return false;
  const float nd = ray.dx * nx + ray.dy * ny + ray.dz * nz;
  const float abs_nd = fabsf(nd);
  const float det_s = abs_nd * nlen;
  if (!(det_s >= c.half_eps)) return false;
  if (!(abs_nd >= c.half_eps)) {
    amb = true;
    return false;
  }
  const float no = ray.ox * nx + ray.oy * ny + ray.oz * nz + nw;
  // |nd| >= half_eps here, so the plain version divides by nd itself.
  const float inv_nd = 1.0f / nd;
  const float t = -no * inv_nd;
  const bool in_loose = (t >= c.eps_m_tmg) && (t <= q.hi_loose);
  const bool in_strict = (t >= c.eps_p_tmg) && (t <= q.hi_strict);
  if (!(in_loose || in_strict)) return false;
  const float uo = ray.ox * ux + ray.oy * uy + ray.oz * uz + uw;
  const float ud = ray.dx * ux + ray.dy * uy + ray.dz * uz;
  const float u = uo + t * ud;
  if (!(u >= c.neg_mu)) return false;
  const float vo = ray.ox * vx + ray.oy * vy + ray.oz * vz + vw;
  const float vd = ray.dx * vx + ray.dy * vy + ray.dz * vz;
  const float v = vo + t * vd;
  if (!(v >= c.neg_mu)) return false;
  const float uv = u + v;
  const bool loose = in_loose && (uv <= c.one_p_mu);
  const bool strict = in_strict && (det_s >= c.eps15) && (u >= c.mu) &&
                      (v >= c.mu) && (uv <= c.one_m_mu);
  if (strict) merge_min(mo, so, t, slot);
  t_hit = t;
  return q.any_hit ? (loose && !strict) : loose;
}

// Triangle j of block w against the ray (bw_test on its columns).
__device__ __forceinline__ bool bw_lane(const float (*w)[kCols], int j,
                                        const BwRay& q, const BwConsts& c,
                                        float& t, float& mo, float& so,
                                        bool& amb) {
  const int ju = kLanes + j, jv = 2 * kLanes + j;
  return bw_test(q, c, w[0][j], w[1][j], w[2][j], w[3][j], w[0][ju],
                 w[1][ju], w[2][ju], w[3][ju], w[0][jv], w[1][jv], w[2][jv],
                 w[3][jv], w[4][j], w[4][ju], w[4][jv], t, mo, so, amb);
}

// Whether (t, s) comes before (t2, s2) in (t, slot) order.
__device__ __forceinline__ bool before(float t, float s, float t2,
                                       float s2) {
  return t < t2 || (t == t2 && s < s2);
}

// The three smallest (t, slot) pairs seen, in (t, slot) order; unused
// entries are (kBig2, kBig2).
struct Top3 {
  float t0 = kBig2, s0 = kBig2, t1 = kBig2, s1 = kBig2, t2 = kBig2,
        s2 = kBig2;

  __device__ __forceinline__ void add(float t, float s) {
    if (!before(t, s, t2, s2)) return;
    if (before(t, s, t1, s1)) {
      t2 = t1;
      s2 = s1;
      if (before(t, s, t0, s0)) {
        t1 = t0;
        s1 = s0;
        t0 = t;
        s0 = s;
      } else {
        t1 = t;
        s1 = s;
      }
    } else {
      t2 = t;
      s2 = s;
    }
  }

  // Merges in the triple of the thread `off` lanes away.
  __device__ __forceinline__ void merge(int off) {
    const float a0 = __shfl_xor_sync(0xffffffffu, t0, off);
    const float b0 = __shfl_xor_sync(0xffffffffu, s0, off);
    const float a1 = __shfl_xor_sync(0xffffffffu, t1, off);
    const float b1 = __shfl_xor_sync(0xffffffffu, s1, off);
    const float a2 = __shfl_xor_sync(0xffffffffu, t2, off);
    const float b2 = __shfl_xor_sync(0xffffffffu, s2, off);
    add(a0, b0);
    add(a1, b1);
    add(a2, b2);
  }
};

// The round's (m1, sl1, m2, sl2, m3) of the plain version.
struct Round {
  float m1, sl1, m2, sl2, m3;
};

// The round for one ray in the plain version's three passes over the
// block's 128 lanes (pallas_bvh.py:1203-1218), each lane's tracked t
// recomputed by bw_lane (kBig2 where it is not tracked).  The second
// smallest excludes the lanes of slot sl1 (after its reset), the third the
// lanes of slot sl2 at m2 (before its reset).
__device__ Round full_round(const float (*w)[kCols], const BwRay& q,
                            const BwConsts& c) {
  float mo = kBig2, so = kBig2;
  bool amb = false;
  auto tracked = [&](int j) {
    float t;
    return bw_lane(w, j, q, c, t, mo, so, amb) ? t : kBig2;
  };
  Round o;
  o.m1 = kBig2;
  o.sl1 = kBig2;
  for (int j = 0; j < kLanes; ++j) {
    merge_min(o.m1, o.sl1, tracked(j), w[4][kLanes + j]);
  }
  o.sl1 = o.m1 < kBig ? o.sl1 : -1.0f;
  o.m2 = kBig2;
  o.sl2 = kBig2;
  for (int j = 0; j < kLanes; ++j) {
    const float slot = w[4][kLanes + j];
    merge_min(o.m2, o.sl2, slot == o.sl1 ? kBig2 : tracked(j), slot);
  }
  o.m3 = kBig2;
  for (int j = 0; j < kLanes; ++j) {
    const float slot = w[4][kLanes + j];
    const float tl2 = slot == o.sl1 ? kBig2 : tracked(j);
    o.m3 = fminf(o.m3, (slot == o.sl2 && tl2 <= o.m2) ? kBig2 : tl2);
  }
  o.sl2 = o.m2 < kBig ? o.sl2 : -1.0f;
  return o;
}

// One round of one ray: its part's groups of block w, then the merge over
// the ray's four threads.  Every thread of the warp must call it.  Returns
// the round's triple and sets (mo, so) to its strict minimum and amb_r to
// its ambiguity flag, the same in the ray's four threads.
__device__ __forceinline__ Round bw_round(const float (*w)[kCols], int part,
                                          const BwRay& q, const BwConsts& c,
                                          float& mo, float& so, bool& amb_r) {
  const int n_groups = valid_groups(&w[4][0]);
  Top3 top;
  mo = kBig2;
  so = kBig2;
  bool amb = false, high = false;
  for (int g = part; g < n_groups; g += kSplit) {
    const int j = 4 * g;
    float4 f[3 * kTwUsed];   // rows 0-4 of the three column groups
#pragma unroll
    for (int k = 0; k < kTwUsed; ++k) {
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        f[3 * k + s] =
            *reinterpret_cast<const float4*>(&w[k][s * kLanes + j]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float t;
      if (bw_test(q, c, comp(f[0], e), comp(f[3], e), comp(f[6], e),
                  comp(f[9], e), comp(f[1], e), comp(f[4], e), comp(f[7], e),
                  comp(f[10], e), comp(f[2], e), comp(f[5], e),
                  comp(f[8], e), comp(f[11], e), comp(f[12], e),
                  comp(f[13], e), comp(f[14], e), t, mo, so, amb)) {
        top.add(t, comp(f[13], e));
        high = high || !(t < kBig);
      }
    }
  }
  int flags = (amb ? 1 : 0) | (high ? 2 : 0);
  for (int off = kWarpRays; off < 32; off <<= 1) {
    top.merge(off);
    merge_min(mo, so, __shfl_xor_sync(0xffffffffu, mo, off),
              __shfl_xor_sync(0xffffffffu, so, off));
    flags |= __shfl_xor_sync(0xffffffffu, flags, off);
  }
  amb_r = (flags & 1) != 0;
  // The entries below kBig are tracked pairs; a repeated slot among them
  // would let the plain version's slot exclusion drop more than one lane.
  const bool repeat = (top.t1 < kBig && top.s1 == top.s0) ||
                      (top.t2 < kBig && (top.s2 == top.s0 ||
                                         top.s2 == top.s1));
  if ((flags & 2) || repeat) return full_round(w, q, c);
  return Round{top.t0, top.t0 < kBig ? top.s0 : -1.0f, top.t1,
               top.t1 < kBig ? top.s1 : -1.0f, top.t2};
}

__global__ void __launch_bounds__(kThreads, 1)
tilebw_kernel(const float* __restrict__ tw, const int* __restrict__ gid,
              const float* __restrict__ entry, const float* __restrict__ rays,
              const int* __restrict__ order, float* __restrict__ out, int m,
              int any_hit, BwConsts c) {
  __shared__ __align__(16) float blk[2][kTwUsed][kCols];
  __shared__ float red[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int part = lane / kWarpRays;           // which groups of triangles
  const int tile = order[blockIdx.x];
  const size_t ray_i =
      (size_t)tile * kTile + (tid >> 5) * kWarpRays + lane % kWarpRays;
  const int* g = gid + (size_t)tile * m;
  const float* e = entry + (size_t)tile * m;
  const size_t stride = (size_t)kTwRows * kCols;

  copy_async<kTwChunks>(&blk[0][0][0], tw + (size_t)g[0] * stride, tid,
                        kThreads);
  copy_async<kTwChunks>(&blk[1][0][0], tw + (size_t)g[min(1, m - 1)] * stride,
                        tid, kThreads);
  BwRay q;
  q.r = load_ray(rays, ray_i);
  const float cap = q.r.t_init;
  q.hi_loose = cap * c.one_p_trel + c.tmg;
  q.hi_strict = cap * c.one_m_trel - c.tmg;
  q.any_hit = any_hit;
  float t1 = kBig2, s1 = -1.0f, t2 = kBig2, s2 = -1.0f, t3 = kBig2;
  float ts_m = kBig2, ts_s = -1.0f, amb = 0.0f;
  cp_async_wait<1>();
  __syncthreads();

  int r = 0;
  while (true) {
    const float e_next = e[min(r + 1, m - 1)];
    const int g_pre = g[min(r + 2, m - 1)];
    float mo, so;
    bool amb_r;
    const Round x = bw_round(blk[r & 1], part, q, c, mo, so, amb_r);
    if (amb_r) amb = 1.0f;
    if (mo < ts_m) {
      ts_m = mo;
      if (mo < kBig) ts_s = so;
    }

    // Merge the round's sorted triple into the running one.
    const bool take1 = x.m1 < t1;
    const float o_t = take1 ? t1 : x.m1, o_s = take1 ? s1 : x.sl1;
    const float a_t = take1 ? x.m2 : t2, a_s = take1 ? x.sl2 : s2;
    const bool take2 = a_t < o_t;
    const float n_t3 =
        fminf(fminf(fmaxf(t1, x.m2), fmaxf(t2, x.m1)), fminf(t3, x.m3));
    if (take1) {
      t1 = x.m1;
      s1 = x.sl1;
    }
    t2 = take2 ? a_t : o_t;
    s2 = take2 ? a_s : o_s;
    t3 = n_t3;

    float bound = any_hit ? (ts_m < kBig ? -kBig2 : cap)
                          : fminf(ts_m * c.one_p_trel + c.tmg, cap);
    for (int off = 16; off > 0; off >>= 1) {
      bound = fmaxf(bound, __shfl_xor_sync(0xffffffffu, bound, off));
    }
    if (lane == 0) red[r & 1][tid >> 5] = bound;
    cp_async_wait<0>();
    __syncthreads();
    float t_worst = red[r & 1][0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) t_worst = fmaxf(t_worst, red[r & 1][k]);
    const bool done = (r + 1 >= m) || (e_next >= t_worst);
    ++r;
    if (done) break;
    // Round r's block is in blk[r & 1]; the other buffer was read in the
    // round just finished, and every thread has passed the barrier.
    copy_async<kTwChunks>(&blk[(r + 1) & 1][0][0],
                          tw + (size_t)g_pre * stride, tid, kThreads);
  }
  // Part p writes columns 4p to 4p + 3 of the ray's row.
  const float4 row =
      part == 0   ? make_float4(t1, s1, t2, s2)
      : part == 1 ? make_float4(t3, ts_m, ts_s, (float)r)
      : part == 2 ? make_float4(amb, 0.0f, 0.0f, 0.0f)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  reinterpret_cast<float4*>(out + ray_i * 16)[part] = row;
}

}  // namespace

// Launches the two order passes and then one block per 128-ray tile on
// `stream`.  tw is (NB, 8, 384), gid/entry (n_tiles, m), rays
// (n_tiles * 128, 8), out (n_tiles * 128, 16); `scratch` is 2 * n_tiles
// int32 (counts, order); `consts` points to the 11 host floats of
// kernels.bw_consts.  Returns cudaGetLastError() after the launches.
extern "C" int mrt_traverse_tilebw(const float* tw, const int* gid,
                                   const float* entry, const float* rays,
                                   int* scratch, float* out, int n_tiles,
                                   int m, int any_hit, const float* consts,
                                   cudaStream_t stream) {
  BwConsts c;
  c.half_eps = consts[0];
  c.eps15 = consts[1];
  c.neg_mu = consts[2];
  c.mu = consts[3];
  c.one_p_mu = consts[4];
  c.one_m_mu = consts[5];
  c.eps_m_tmg = consts[6];
  c.eps_p_tmg = consts[7];
  c.one_p_trel = consts[8];
  c.one_m_trel = consts[9];
  c.tmg = consts[10];
  const cudaError_t err = order_tiles(entry, scratch, n_tiles, m, stream);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    tilebw_kernel<<<n_tiles, kThreads, 0, stream>>>(
        tw, gid, entry, rays, scratch + n_tiles, out, m, any_hit, c);
  }
  return (int)cudaGetLastError();
}

// Registers, shared memory and resident blocks per SM of the kernel (see
// mrt::kernel_info).
extern "C" int mrt_tilebw_info(int* info) {
  return kernel_info(tilebw_kernel, kThreads, 0, info);
}
