// Banded lockstep traversal kernel.
//
// Replaces the TPU kernel `_make_kernel` / `_traverse_padded` of
// mobileraytracer_tpu/ops/pallas_bvh.py (pallas_call at :584).  Its plain
// PyTorch version is `banded_plain` in ops/kernels.py; the two agree bit
// for bit.
//
// One CUDA block runs one program: 8 bands of 16 rays, every band with its
// own list of m candidate blocks.  Round r tests each band's rays against
// the 128 triangles of its block tb[gid[g*m + r]] (mt.cuh).
//
// The program-level lockstep of the TPU kernel is kept exactly
// (pallas_bvh.py:479-499, 550-555): a band is dead when its next entry is
// >= its worst t_best (16-lane shuffle max), or for any-hit when all its
// rays are occluded; the loop ends only when every band is dead, and dead
// bands keep visiting their blocks until then.  In closest-hit mode those
// visits cannot change t or slot; in any-hit mode they can (an occluded ray
// keeps taking closer blockers while a sibling band is alive), so t and
// slot equal the JAX package's only with the same lockstep: one
// __syncthreads_and over all eight bands per round.  `steps` is the
// program's round count, written for all 128 rays.
//
// What bounds it on the H100: the tests' f32 operations (mt.cuh), and
// before this design the latency around them: eight blocks of 5.6 KB, one
// per band, fill 45 KB of shared memory per program, so at most five
// programs fit on an SM, and each round waited for its own copies.  The
// design:
//   - two threads per ray, each scanning 64 of the block's triangles; the
//     two partial minima merge by the tie rule.  A band is then one warp,
//     and three programs of 8 warps fit on an SM (80 registers a thread);
//   - the warp's block needs only that warp's copies and a __syncwarp, no
//     block barrier.  As soon as the warp has read its block it starts the
//     cp.async copy of the next round's block (the index clamped to the
//     list), which runs while the program waits at the lockstep barrier; a
//     copy for a round that never runs changes nothing.  A second buffer
//     per band would take 90 KB a program, two programs an SM;
//   - the kernel takes the programs from the last: its caller
//     (block_traversal._banded_balanced) sorts subtiles by candidate
//     count, fewest first, so the longest walks start first instead of
//     ending the launch alone.  The order changes when a program runs,
//     never what it computes.
#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

using namespace mrt;

constexpr int kBand = 16;                       // rays per band (SUBTILE)
constexpr int kGroup = 8;                       // bands per program
constexpr int kProg = kBand * kGroup;           // rays per program
constexpr int kSplit = 2;                       // threads per ray
constexpr int kBandThreads = kBand * kSplit;    // a band is one warp
constexpr int kThreads = kProg * kSplit;

// Whether every band is dead after a round: `last` when no entry is left,
// `e_next` the band's next entry.  Every thread of the block must call it.
__device__ __forceinline__ bool all_done(bool last, float e_next,
                                         float t_best, float t_init,
                                         int any_hit) {
  float tw = t_best;
  int not_occ = !(t_best < t_init);
  for (int off = kBand / 2; off > 0; off >>= 1) {
    tw = fmaxf(tw, __shfl_xor_sync(0xffffffffu, tw, off));
    not_occ |= __shfl_xor_sync(0xffffffffu, not_occ, off);
  }
  bool dead = last || (e_next >= tw);
  if (any_hit) dead = dead || !not_occ;
  return __syncthreads_and(dead) != 0;
}

__global__ void __launch_bounds__(kThreads, 3)
banded_kernel(const float* __restrict__ tb, const int* __restrict__ gid,
              const float* __restrict__ entry,
              const float* __restrict__ rays, float* __restrict__ out,
              int n_rays, int m, int any_hit) {
  __shared__ __align__(16) float blk[kGroup][kRowsUsed][kLanes];
  const int tid = threadIdx.x;
  const int band = tid / kBandThreads;
  const int k = tid % kBandThreads;              // index in the band
  const int half = k / kBand;                    // which triangles
  const size_t prog = gridDim.x - 1 - blockIdx.x;
  const size_t ray_i = prog * kProg + band * kBand + k % kBand;
  const int* g = gid + (prog * kGroup + band) * m;
  const float* e = entry + (prog * kGroup + band) * m;
  const size_t stride = (size_t)kRows * kLanes;

  copy_block_async(blk[band], tb + (size_t)g[0] * stride, k, kBandThreads);
  const Ray ray = load_ray(rays, ray_i);
  float t_best = ray.t_init;
  float slot_best = -1.0f;
  bool alive = !all_done(false, e[0], t_best, ray.t_init, any_hit);
  int r = 0;
  while (alive) {
    const int nxt = min(r + 1, m - 1);
    const float e_next = e[nxt];
    const int g_next = g[nxt];
    cp_async_wait<0>();
    __syncwarp();
    float tmin = kBig, smin = kBig;
    mt_scan(blk[band], half * (kLanes / kSplit), kLanes / kSplit, ray,
            t_best, tmin, smin);
    merge_min(tmin, smin, __shfl_xor_sync(0xffffffffu, tmin, kBand),
              __shfl_xor_sync(0xffffffffu, smin, kBand));
    mt_finish(blk[band], ray, tmin, smin, t_best, slot_best);
    __syncwarp();
    copy_block_async(blk[band], tb + (size_t)g_next * stride, k,
                     kBandThreads);
    alive = !all_done(r + 1 >= m, e_next, t_best, ray.t_init, any_hit);
    ++r;
  }
  cp_async_wait<0>();
  if (half == 0) {
    out[ray_i] = t_best;
    out[(size_t)n_rays + ray_i] = slot_best;
    out[2 * (size_t)n_rays + ray_i] = (float)r;
  }
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
    banded_kernel<<<n_groups, kThreads, 0, stream>>>(
        tb, gid, entry, rays, out, n_groups * kProg, m, any_hit);
  }
  return (int)cudaGetLastError();
}

// Registers, shared memory and resident blocks per SM of the kernel (see
// mrt::kernel_info).
extern "C" int mrt_banded_info(int* info) {
  return kernel_info(banded_kernel, kThreads, 0, info);
}

// cudaGetErrorString for the codes the launchers return.
extern "C" const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
