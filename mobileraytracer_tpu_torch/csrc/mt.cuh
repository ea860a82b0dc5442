// Shared pieces of the traversal kernels: the block layout, the
// asynchronous block copy, the trim of a block's scan at its last valid lane
// (traverse_tilebw.cu, traverse_resident.cu), and the Moller-Trumbore round
// of one ray against one 128-triangle block (traverse_banded.cu,
// traverse_tilemt.cu, traverse_resident.cu).
//
// The arithmetic is the JAX package's, operation for operation
// (mobileraytracer_tpu/ops/pallas_bvh.py:524-548 and :1368-1391, which
// follow the reference acceptance tests of Triangle.cpp:63-109).  The
// library is built with --fmad=false: contracting a product and a sum into
// one FMA changes the low bits of det, u, v and t, and then a ray on a
// triangle edge, or a tie, can flip, so the kernel would no longer equal
// its plain PyTorch version (ops/kernels.py) bit for bit.  1.0f / det stays
// the IEEE division (-prec-div=true, nvcc's default).
//
// What bounds a test on the H100: 46 unfused f32 operations (one of them
// the IEEE division, a reciprocal and its correction) plus the comparisons,
// against 11 values of the triangle read from shared memory.  Unfused, a
// lane does one operation per clock, so the kernels cannot pass half the
// published FP32 rate, which counts an FMA as two.  Two things here cut
// what each test issues:
//   - mt_scan reads the rows as float4, four neighbouring triangles per
//     load, so 11 shared-memory loads serve four tests instead of one;
//   - mt_test stops a lane as soon as the values the plain version computes
//     reject it: an invalid lane or the ray's previous slot, |det| < eps,
//     u outside [0, 1], then v < 0 or u + v > 1.  Nothing is reformulated:
//     every value that is computed is computed as the plain version does.
//     The rays of a warp are coherent (4x4 patches; one light point per
//     16-ray band), so most of these exits are taken by the whole warp.
// The round's minimum t and lowest slot at it do not depend on the order
// of the tests, so a round may be split between threads (merge_min) and
// taken four triangles at a time and stay exact.  The early exits leave
// each test a chain of dependent operations with branches between them, so
// a ray's round is latency-bound: the kernels split a ray's 128 triangles
// between threads to shorten it.  For the same reason a scan may stop at a
// block's last valid lane (valid_groups): the lanes past it are rejected
// before anything is computed, and the one case where they still count, a
// round with no hit below kBig, is mt_finish's full rerun.
#pragma once

#include <cuda_runtime.h>

namespace mrt {

constexpr int kLanes = 128;       // triangles per block
constexpr int kRows = 16;         // rows per block in tb
constexpr int kRowsUsed = 11;     // rows 0-8 a/ab/ac, 9 valid, 10 slot
constexpr float kBig = 1.0e30f;   // RAY_LENGTH_MAX
constexpr float kEps = 1.0e-6f;   // EPSILON
// Rows 0-10 of a block: the first 5,632 bytes of its 8,192-byte row of tb,
// contiguous and 16-byte aligned, copied as 352 16-byte pieces.
constexpr int kChunks = kRowsUsed * kLanes / 4;

struct Ray {
  float ox, oy, oz, dx, dy, dz, t_init, prev;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        size_t i) {
  const float4* p = reinterpret_cast<const float4*>(rays + i * 8);
  const float4 a = p[0], b = p[1];
  return Ray{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// Starts the copy of the first kN 16-byte pieces of `src` into `dst` with
// cp.async (through L2 only), thread `k` of `n` taking every n-th piece,
// and commits them as one group.  The caller waits with cp_async_wait and
// then makes the copy visible with a barrier.
template <int kN>
__device__ __forceinline__ void copy_async(float* dst,
                                           const float* __restrict__ src,
                                           int k, int n) {
  float4* d = reinterpret_cast<float4*>(dst);
  const float4* s = reinterpret_cast<const float4*>(src);
  for (int i = k; i < kN; i += n) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(d + i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
                 "l"(s + i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Starts the copy of rows 0-10 of block `src` into `dst` (copy_async).
__device__ __forceinline__ void copy_block_async(float (*dst)[kLanes],
                                                 const float* __restrict__ src,
                                                 int k, int n) {
  copy_async<kChunks>(&dst[0][0], src, k, n);
}

// Waits until at most `n` of this thread's copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// The round's running minimum: t below tmin wins, t equal to it keeps the
// lower slot.
__device__ __forceinline__ void merge_min(float& tmin, float& smin, float t,
                                          float slot) {
  if (t < tmin) {
    tmin = t;
    smin = slot;
  } else if (t == tmin) {
    smin = fminf(smin, slot);
  }
}

// One ray against one triangle: merges t into (tmin, smin) if the plain
// version accepts the pair with t < t_best, and returns as soon as a value
// it computes rejects the pair.
__device__ __forceinline__ void mt_test(const Ray& r, float pax, float pay,
                                        float paz, float abx, float aby,
                                        float abz, float acx, float acy,
                                        float acz, float valid, float slot,
                                        float t_best, float& tmin,
                                        float& smin) {
  if (!(valid > 0.5f) || slot == r.prev) return;
  const float px = r.dy * acz - r.dz * acy;
  const float py = r.dz * acx - r.dx * acz;
  const float pz = r.dx * acy - r.dy * acx;
  const float det = abx * px + aby * py + abz * pz;
  if (!(fabsf(det) >= kEps)) return;
  const float inv = 1.0f / det;
  const float tvx = r.ox - pax, tvy = r.oy - pay, tvz = r.oz - paz;
  const float u = inv * (tvx * px + tvy * py + tvz * pz);
  if (!(u >= 0.0f && u <= 1.0f)) return;
  const float qx = tvy * abz - tvz * aby;
  const float qy = tvz * abx - tvx * abz;
  const float qz = tvx * aby - tvy * abx;
  const float v = inv * (r.dx * qx + r.dy * qy + r.dz * qz);
  if (!(v >= 0.0f && u + v <= 1.0f)) return;
  const float t = inv * (acx * qx + acy * qy + acz * qz);
  if (t >= kEps && t < t_best) merge_min(tmin, smin, t, slot);
}

// Component c (0-3) of v.
__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The float4 groups of a block's lanes (four lanes each) up to the last
// one holding a lane that `valid` (the block's row of valid flags, in
// shared memory) marks valid: 0-32.  Lanes past it fail every test at the
// lane check.  Every lane of the warp must call it.
__device__ __forceinline__ int valid_groups(const float* valid) {
  const float4 v = reinterpret_cast<const float4*>(valid)[threadIdx.x & 31];
  const unsigned any = __ballot_sync(
      0xffffffffu, v.x > 0.5f || v.y > 0.5f || v.z > 0.5f || v.w > 0.5f);
  return 32 - __clz(any);
}

// Triangles [j, j + 4) of `blk` against ray r, one float4 read of each
// row.
__device__ __forceinline__ void mt_test4(const float (*blk)[kLanes], int j,
                                         const Ray& r, float t_best,
                                         float& tmin, float& smin) {
  float4 w[kRowsUsed];
#pragma unroll
  for (int k = 0; k < kRowsUsed; ++k) {
    w[k] = *reinterpret_cast<const float4*>(&blk[k][j]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mt_test(r, comp(w[0], c), comp(w[1], c), comp(w[2], c), comp(w[3], c),
            comp(w[4], c), comp(w[5], c), comp(w[6], c), comp(w[7], c),
            comp(w[8], c), comp(w[9], c), comp(w[10], c), t_best, tmin, smin);
  }
}

// Triangles [j0, j0 + n) of `blk` (n a multiple of 4) against ray r,
// four triangles per float4 read of each row; (tmin, smin) start at
// (kBig, kBig).
__device__ __forceinline__ void mt_scan(const float (*blk)[kLanes], int j0,
                                        int n, const Ray& r, float t_best,
                                        float& tmin, float& smin) {
  for (int j = j0; j < j0 + n; j += 4) mt_test4(blk, j, r, t_best, tmin, smin);
}

// Triangles 4g to 4g + 3 of `blk` for g = g0, g0 + step, ... below g_end,
// as mt_scan.
__device__ __forceinline__ void mt_scan_groups(const float (*blk)[kLanes],
                                               int g0, int g_end, int step,
                                               const Ray& r, float t_best,
                                               float& tmin, float& smin) {
  for (int g = g0; g < g_end; g += step) {
    mt_test4(blk, 4 * g, r, t_best, tmin, smin);
  }
}

// One round for one ray, every test run to its end: tests the block's 128
// triangles and updates (t_best, slot_best).  The round's candidate t is
// kept only where it beats t_best; tmin is the round's minimum and smin the
// lowest slot at tmin; the round wins only if strictly closer than t_best.
// Only mt_finish runs it, for the one round the early exits cannot decide.
__device__ __forceinline__ void mt_round(const float (*blk)[kLanes],
                                         const Ray& r, float& t_best,
                                         float& slot_best) {
  float tmin = kBig;
  float smin = kBig;
  for (int j = 0; j < kLanes; ++j) {
    const float pax = blk[0][j], pay = blk[1][j], paz = blk[2][j];
    const float abx = blk[3][j], aby = blk[4][j], abz = blk[5][j];
    const float acx = blk[6][j], acy = blk[7][j], acz = blk[8][j];
    const float valid = blk[9][j], slot = blk[10][j];
    const float px = r.dy * acz - r.dz * acy;
    const float py = r.dz * acx - r.dx * acz;
    const float pz = r.dx * acy - r.dy * acx;
    const float det = abx * px + aby * py + abz * pz;
    const float inv = 1.0f / (fabsf(det) < kEps ? 1.0f : det);
    const float tvx = r.ox - pax, tvy = r.oy - pay, tvz = r.oz - paz;
    const float u = inv * (tvx * px + tvy * py + tvz * pz);
    const float qx = tvy * abz - tvz * aby;
    const float qy = tvz * abx - tvx * abz;
    const float qz = tvx * aby - tvy * abx;
    const float v = inv * (r.dx * qx + r.dy * qy + r.dz * qz);
    float t = inv * (acx * qx + acy * qy + acz * qz);
    const bool ok = (fabsf(det) >= kEps) && (u >= 0.0f) && (u <= 1.0f) &&
                    (v >= 0.0f) && (u + v <= 1.0f) && (t >= kEps) &&
                    (valid > 0.5f) && (slot != r.prev);
    t = (ok && t < t_best) ? t : kBig;
    merge_min(tmin, smin, t, slot);
  }
  if (tmin < t_best) {
    t_best = tmin;
    slot_best = smin;
  }
}

// Ends a round that mt_scan took (merged over every triangle of the
// block): the accepted minimum below kBig wins, as in mt_round, since it
// beats t_best.  With none below kBig, mt_round's minimum is kBig with the
// lowest slot of every lane at kBig, which matters only when kBig beats
// t_best; that round is then taken again in full.
__device__ __forceinline__ void mt_finish(const float (*blk)[kLanes],
                                          const Ray& r, float tmin,
                                          float smin, float& t_best,
                                          float& slot_best) {
  if (tmin < kBig) {
    t_best = tmin;
    slot_best = smin;
  } else if (kBig < t_best) {
    mt_round(blk, r, t_best, slot_best);
  }
}

// Fills info with the launch facts of `fn` at `threads` threads and `smem`
// bytes of dynamic shared memory: registers per thread, static shared
// bytes, dynamic shared bytes, local (spilled) bytes per thread, threads
// per block and resident blocks per SM.  Returns a cudaError_t.
template <typename F>
int kernel_info(F fn, int threads, size_t smem, int* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)smem;
  info[3] = (int)a.localSizeBytes;
  info[4] = threads;
  info[5] = blocks;
  return 0;
}

}  // namespace mrt
