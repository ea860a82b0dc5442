// Banded lockstep traversal kernel.
//
// Replaces the TPU kernel `_make_kernel` / `_traverse_padded` of
// mobileraytracer_tpu/ops/pallas_bvh.py (pallas_call at :584).  Its plain
// PyTorch version is `banded_plain` in ops/kernels.py; the two agree bit
// for bit.
//
// One CUDA block runs one program: 8 bands of 16 rays, one thread per ray,
// so a band is half a warp.  Every band has its own list of m candidate
// blocks.  Round r: band g copies rows 0-10 of its block tb[gid[g*m + r]]
// into its own shared-memory slot (8 x 5.6 KB = 45 KB, under the 48 KB
// static limit), then each thread scans the 128 triangles (mt.cuh).
//
// The program-level lockstep of the TPU kernel is kept exactly
// (pallas_bvh.py:479-499, 550-555): a band is dead when its next entry is
// >= its worst t_best (16-lane shuffle max), or for any-hit when all its
// rays are occluded; the loop ends only when every band is dead, and dead
// bands keep visiting their blocks until then.  In closest-hit mode those
// visits cannot change t or slot; in any-hit mode they can (an occluded ray
// keeps taking closer blockers while a sibling band is alive), so t and
// slot equal the JAX package's only with the same lockstep.  `steps` is the
// program's round count, written for all 128 rays.
//
// What bounds it on the H100: about 30 f32 operations per ray-triangle
// test plus the shared-memory reads, with one block of 128 threads per
// program, so occupancy and latency hiding are low and each round waits for
// its own block copies.  Speed is later work: double-buffered cp.async or
// TMA loads of the next round's blocks, more rays per block, persistent
// blocks.
#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

using namespace mrt;

constexpr int kBand = 16;                  // rays per band (SUBTILE)
constexpr int kGroup = 8;                  // bands per program
constexpr int kProg = kBand * kGroup;      // threads per block

// Whether every band is done before round r + 1 (r == -1: before round 0).
__device__ __forceinline__ bool all_done(int r, int m,
                                         const float* __restrict__ e,
                                         float t_best, float t_init,
                                         int any_hit) {
  float tw = t_best;
  int not_occ = !(t_best < t_init);
  for (int off = kBand / 2; off > 0; off >>= 1) {
    tw = fmaxf(tw, __shfl_xor_sync(0xffffffffu, tw, off));
    not_occ |= __shfl_xor_sync(0xffffffffu, not_occ, off);
  }
  const int nxt = min(r + 1, m - 1);
  bool dead = (r + 1 >= m) || (e[nxt] >= tw);
  if (any_hit) dead = dead || !not_occ;
  return __syncthreads_and(dead) != 0;
}

__global__ void __launch_bounds__(kProg)
banded_kernel(const float* __restrict__ tb, const int* __restrict__ gid,
              const float* __restrict__ entry,
              const float* __restrict__ rays, float* __restrict__ out,
              int n_rays, int m, int any_hit) {
  __shared__ float blk[kGroup][kRowsUsed][kLanes];
  const int prog = blockIdx.x;
  const int lane = threadIdx.x;
  const int band = lane / kBand;
  const size_t ray_i = (size_t)prog * kProg + lane;
  const Ray ray = load_ray(rays, ray_i);
  const int* g = gid + ((size_t)prog * kGroup + band) * m;
  const float* e = entry + ((size_t)prog * kGroup + band) * m;

  float t_best = ray.t_init;
  float slot_best = -1.0f;
  bool alive = !all_done(-1, m, e, t_best, ray.t_init, any_hit);
  int r = 0;
  while (alive) {
    __syncthreads();  // the previous round's blocks are no longer read
    copy_block(blk[band], tb + (size_t)g[r] * kRows * kLanes,
               lane % kBand, kBand);
    __syncthreads();
    mt_round(blk[band], ray, t_best, slot_best);
    alive = !all_done(r, m, e, t_best, ray.t_init, any_hit);
    ++r;
  }
  out[ray_i] = t_best;
  out[(size_t)n_rays + ray_i] = slot_best;
  out[2 * (size_t)n_rays + ray_i] = (float)r;
}

}  // namespace

// Launches one block per 128-ray program on `stream`.  gid/entry are
// (n_groups * 8, m), rays (n_groups * 128, 8), out (3, n_groups * 128)
// holding t, slot and steps.  Returns cudaGetLastError() after the launch.
extern "C" int mrt_traverse_banded(const float* tb, const int* gid,
                                   const float* entry, const float* rays,
                                   float* out, int n_groups, int m,
                                   int any_hit, cudaStream_t stream) {
  if (n_groups > 0) {
    banded_kernel<<<n_groups, kProg, 0, stream>>>(
        tb, gid, entry, rays, out, n_groups * kProg, m, any_hit);
  }
  return (int)cudaGetLastError();
}

// cudaGetErrorString for the codes the launchers return.
extern "C" const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
