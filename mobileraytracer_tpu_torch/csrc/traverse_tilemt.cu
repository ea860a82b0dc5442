// Tile-MT traversal kernel.
//
// Replaces the TPU kernel `_make_tilemt_kernel` / `_traverse_tilemt_padded`
// of mobileraytracer_tpu/ops/pallas_bvh.py (pallas_call at :1434).  Its
// plain PyTorch version is `tilemt_plain` in ops/kernels.py; the two agree
// bit for bit.
//
// One CUDA block walks one 128-ray tile through the tile's shared list of
// m candidate blocks, one thread per ray.  Round r: the block copies rows
// 0-10 of tb[gid[r]] (11 x 128 f32 = 5.6 KB) into shared memory, then each
// thread scans the 128 triangles as broadcast reads (mt.cuh).  After the
// round the tile stops when r + 1 == m or entry[r + 1] >= the tile's worst
// t: the block-wide max of t_best (closest hit), or for any-hit the max
// t_init over rays not yet occluded, stopping at once when every ray is
// occluded (pallas_bvh.py:1393-1403).  At least one round always runs.
// Output rows are [t, slot, rounds, 0].
//
// What bounds it on the H100: about 30 f32 operations per ray-triangle
// test plus the shared-memory reads, with one block of 128 threads per
// tile, so occupancy and latency hiding are low and each round waits for
// its own block copy.  Speed is later work: double-buffered cp.async or
// TMA loads of the next block, more rays per block, persistent blocks.
#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

using namespace mrt;

constexpr int kTile = 128;

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  __syncthreads();  // earlier readers of `red` are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
}

__global__ void __launch_bounds__(kTile)
tilemt_kernel(const float* __restrict__ tb, const int* __restrict__ gid,
              const float* __restrict__ entry,
              const float* __restrict__ rays, float* __restrict__ out,
              int m, int any_hit) {
  __shared__ float blk[kRowsUsed][kLanes];
  __shared__ float red[kTile / 32];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t ray_i = (size_t)tile * kTile + lane;
  const Ray ray = load_ray(rays, ray_i);
  const int* g = gid + (size_t)tile * m;
  const float* e = entry + (size_t)tile * m;

  float t_best = ray.t_init;
  float slot_best = -1.0f;
  int r = 0;
  while (true) {
    __syncthreads();  // the previous round's block is no longer read
    copy_block(blk, tb + (size_t)g[r] * kRows * kLanes, lane, kTile);
    __syncthreads();
    mt_round(blk, ray, t_best, slot_best);

    float t_worst;
    if (any_hit) {
      const bool occ = t_best < ray.t_init;
      const bool all_occ = __syncthreads_and(occ) != 0;
      const float w = block_max(occ ? -kBig : ray.t_init, red);
      t_worst = all_occ ? -kBig : w;
    } else {
      t_worst = block_max(t_best, red);
    }
    const int nxt = min(r + 1, m - 1);
    const bool done = (r + 1 >= m) || (e[nxt] >= t_worst);
    ++r;
    if (done) break;
  }
  float* o = out + ray_i * 4;
  o[0] = t_best;
  o[1] = slot_best;
  o[2] = (float)r;
  o[3] = 0.0f;
}

}  // namespace

// Launches one block per 128-ray tile on `stream`.  gid/entry are
// (n_tiles, m), rays (n_tiles * 128, 8), out (n_tiles * 128, 4).  Returns
// cudaGetLastError() after the launch.
extern "C" int mrt_traverse_tilemt(const float* tb, const int* gid,
                                   const float* entry, const float* rays,
                                   float* out, int n_tiles, int m,
                                   int any_hit, cudaStream_t stream) {
  if (n_tiles > 0) {
    tilemt_kernel<<<n_tiles, kTile, 0, stream>>>(tb, gid, entry, rays, out,
                                                 m, any_hit);
  }
  return (int)cudaGetLastError();
}
