// Tile-MT traversal kernel.
//
// Replaces the TPU kernel `_make_tilemt_kernel` / `_traverse_tilemt_padded`
// of mobileraytracer_tpu/ops/pallas_bvh.py (pallas_call at :1434).  Its
// plain PyTorch version is `tilemt_plain` in ops/kernels.py; the two agree
// bit for bit.
//
// One CUDA block walks one 128-ray tile through the tile's shared list of
// m candidate blocks.  Each round tests every ray against the 128
// triangles of one block (mt.cuh).  After the round the tile stops when
// r + 1 == m or entry[r + 1] >= the tile's worst t: the block-wide max of
// t_best (closest hit), or for any-hit the max t_init over rays not yet
// occluded, which is -kBig once every ray is occluded
// (pallas_bvh.py:1393-1403).  At least one round always runs.  Output rows
// are [t, slot, rounds, 0].
//
// What bounds it on the H100: the tests' f32 operations (mt.cuh), and
// before this design the latency around them.  Walks are uneven: on the
// 512x512 primaries the mean tile takes 5.5 rounds and the longest 64, and
// a tile's rounds run one after another, so a long tile that starts late
// ends the launch alone.  The design:
//   - four threads per ray, each scanning 32 of a block's triangles, merged
//     by the tie rule within the warp (a warp holds 8 rays x 4 parts), so a
//     round takes a quarter of the time on one ray's critical path.  At 90
//     registers one block of 512 threads fits on an SM (two would need 64
//     registers a thread);
//   - the tiles start most listed candidates first (count_kernel and a
//     one-block counting sort, order_kernel, before the walk; tile_order.cuh),
//     so the longest walks overlap the others instead of ending the launch
//     alone; the order changes when a tile runs, never what it computes;
//   - the blocks of rounds r and r + 1 sit in two shared-memory buffers;
//     round r + 2's block is copied with cp.async while round r + 1 runs,
//     from the index clamped to the list, so a copy for a round that never
//     runs costs 5.6 KB of L2 reads and changes nothing;
//   - one barrier per round: each warp leaves its max of the exit value in
//     shared memory and waits for its own copies, and the barrier then
//     publishes the round's verdict, makes the next block visible and frees
//     the buffer that the next copy overwrites.
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

__global__ void __launch_bounds__(kThreads, 1)
tilemt_kernel(const float* __restrict__ tb, const int* __restrict__ gid,
              const float* __restrict__ entry,
              const float* __restrict__ rays, const int* __restrict__ order,
              float* __restrict__ out, int m, int any_hit) {
  __shared__ __align__(16) float blk[2][kRowsUsed][kLanes];
  __shared__ float red[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int part = lane / kWarpRays;           // which triangles
  const int tile = order[blockIdx.x];
  const size_t ray_i =
      (size_t)tile * kTile + (tid >> 5) * kWarpRays + lane % kWarpRays;
  const int* g = gid + (size_t)tile * m;
  const float* e = entry + (size_t)tile * m;
  const size_t stride = (size_t)kRows * kLanes;

  copy_block_async(blk[0], tb + (size_t)g[0] * stride, tid, kThreads);
  copy_block_async(blk[1], tb + (size_t)g[min(1, m - 1)] * stride, tid,
                   kThreads);
  const Ray ray = load_ray(rays, ray_i);
  float t_best = ray.t_init;
  float slot_best = -1.0f;
  cp_async_wait<1>();
  __syncthreads();

  int r = 0;
  while (true) {
    const float e_next = e[min(r + 1, m - 1)];
    const int g_pre = g[min(r + 2, m - 1)];
    const float (*cur)[kLanes] = blk[r & 1];
    float tmin = kBig, smin = kBig;
    mt_scan(cur, part * (kLanes / kSplit), kLanes / kSplit, ray, t_best,
            tmin, smin);
    for (int off = kWarpRays; off < 32; off <<= 1) {
      merge_min(tmin, smin, __shfl_xor_sync(0xffffffffu, tmin, off),
                __shfl_xor_sync(0xffffffffu, smin, off));
    }
    mt_finish(cur, ray, tmin, smin, t_best, slot_best);
    // Closest hit: the worst t_best; any-hit: the worst t_init of a ray not
    // yet occluded (-kBig when every ray is).
    const bool occ = t_best < ray.t_init;
    float w = any_hit ? (occ ? -kBig : ray.t_init) : t_best;
    for (int off = 16; off > 0; off >>= 1) {
      w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, off));
    }
    if (lane == 0) red[r & 1][tid >> 5] = w;
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
    copy_block_async(blk[(r + 1) & 1], tb + (size_t)g_pre * stride, tid,
                     kThreads);
  }
  if (part == 0) {
    reinterpret_cast<float4*>(out)[ray_i] =
        make_float4(t_best, slot_best, (float)r, 0.0f);
  }
}

}  // namespace

// Launches the two order passes and then one block per 128-ray tile on
// `stream`.  gid/entry are (n_tiles, m), rays (n_tiles * 128, 8), out
// (n_tiles * 128, 4); `scratch` is 2 * n_tiles int32 (counts, order).
// Returns cudaGetLastError() after the launches.
extern "C" int mrt_traverse_tilemt(const float* tb, const int* gid,
                                   const float* entry, const float* rays,
                                   int* scratch, float* out, int n_tiles,
                                   int m, int any_hit, cudaStream_t stream) {
  const cudaError_t err = order_tiles(entry, scratch, n_tiles, m, stream);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    tilemt_kernel<<<n_tiles, kThreads, 0, stream>>>(
        tb, gid, entry, rays, scratch + n_tiles, out, m, any_hit);
  }
  return (int)cudaGetLastError();
}

// Registers, shared memory and resident blocks per SM of the kernel (see
// mrt::kernel_info).
extern "C" int mrt_tilemt_info(int* info) {
  return kernel_info(tilemt_kernel, kThreads, 0, info);
}
