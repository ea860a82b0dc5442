// Shared pieces of the Moller-Trumbore traversal kernels
// (traverse_banded.cu, traverse_tilemt.cu, traverse_resident.cu): the block
// layout and one ray's Moller-Trumbore scan over one 128-triangle block,
// held in shared memory (or, for the resident kernel, read in place).
//
// The arithmetic is the JAX package's, operation for operation
// (mobileraytracer_tpu/ops/pallas_bvh.py:524-548 and :1368-1391, which
// follow the reference acceptance tests of Triangle.cpp:63-109).  The
// library is built with --fmad=false: contracting a product and a sum into
// one FMA changes the low bits of det, u, v and t, and then a ray on a
// triangle edge, or a tie, can flip, so the kernel would no longer equal
// its plain PyTorch version (ops/kernels.py) bit for bit.  1.0f / det stays
// the IEEE division (-prec-div=true, nvcc's default).
#pragma once

#include <cuda_runtime.h>

namespace mrt {

constexpr int kLanes = 128;       // triangles per block
constexpr int kRows = 16;         // rows per block in tb
constexpr int kRowsUsed = 11;     // rows 0-8 a/ab/ac, 9 valid, 10 slot
constexpr float kBig = 1.0e30f;   // RAY_LENGTH_MAX
constexpr float kEps = 1.0e-6f;   // EPSILON

struct Ray {
  float ox, oy, oz, dx, dy, dz, t_init, prev;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        size_t i) {
  const float* p = rays + i * 8;
  return Ray{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
}

// Copies rows 0-10 of block `src` into `dst` using `n` threads with
// index `k` (0 <= k < n).
__device__ __forceinline__ void copy_block(float (*dst)[kLanes],
                                          const float* __restrict__ src,
                                          int k, int n) {
  for (int i = k; i < kRowsUsed * kLanes; i += n) {
    dst[i / kLanes][i % kLanes] = src[i];
  }
}

// One round for one ray: tests the block's 128 triangles and updates
// (t_best, slot_best).  The round's candidate t is kept only where it
// beats t_best; tmin is the round's minimum and smin the lowest slot at
// tmin; the round wins only if strictly closer than t_best.
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
    if (t < tmin) {
      tmin = t;
      smin = slot;
    } else if (t == tmin) {
      smin = fminf(smin, slot);
    }
  }
  if (tmin < t_best) {
    t_best = tmin;
    slot_best = smin;
  }
}

}  // namespace mrt
