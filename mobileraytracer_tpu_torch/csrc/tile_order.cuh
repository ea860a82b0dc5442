// The longest-first tile order of the tile kernels (traverse_tilemt.cu,
// traverse_tilebw.cu): before the walk, count_kernel counts each tile's
// listed candidates and order_kernel sorts the tiles by that count, most
// first, so that the longest walks start first and overlap the others
// instead of ending the launch alone.  The order changes when a tile runs,
// never what it computes.
#pragma once

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

constexpr int kCountThreads = 256;    // threads of a count_kernel block
constexpr int kOrderThreads = 1024;   // threads of the order_kernel block

// counts[t] = the listed candidates of tile t: entries below kBig / 2
// (padding is kBig).  One warp per tile, reading its list coalesced.
__global__ void __launch_bounds__(kCountThreads)
count_kernel(const float* __restrict__ entry, int* __restrict__ counts,
             int n_tiles, int m) {
  const int t = blockIdx.x * (kCountThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (t >= n_tiles) return;                    // the whole warp
  const float* e = entry + (size_t)t * m;
  int c = 0;
  for (int i = lane; i - lane < m; i += 32) {
    c += __popc(__ballot_sync(0xffffffffu, i < m && e[i] < 0.5f * mrt::kBig));
  }
  if (lane == 0) counts[t] = c;
}

// Writes to `order` the tiles sorted by their counts, most first: a
// counting sort over the m + 1 possible counts in one block, with `start`
// (m + 1 ints of dynamic shared memory) the bins' next slots.
__global__ void __launch_bounds__(kOrderThreads)
order_kernel(const int* __restrict__ counts, int* __restrict__ order,
             int n_tiles, int m) {
  extern __shared__ int start[];
  for (int i = threadIdx.x; i <= m; i += kOrderThreads) start[i] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += kOrderThreads) {
    atomicAdd(&start[m - counts[t]], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int i = 0; i <= m; ++i) {
      const int h = start[i];
      start[i] = sum;
      sum += h;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += kOrderThreads) {
    order[atomicAdd(&start[m - counts[t]], 1)] = t;
  }
}

// Launches the two passes on `stream`: scratch holds 2 * n_tiles int32, the
// counts and then the order, which the walk reads at scratch + n_tiles.
// Returns cudaErrorInvalidValue when the m + 1 bins do not fit in 48 KB of
// shared memory, else cudaSuccess.
inline cudaError_t order_tiles(const float* entry, int* scratch, int n_tiles,
                               int m, cudaStream_t stream) {
  const size_t bins = (size_t)(m + 1) * sizeof(int);
  if (bins > 48 * 1024) return cudaErrorInvalidValue;
  if (n_tiles > 0) {
    int* counts = scratch;
    int* order = scratch + n_tiles;
    constexpr int kTilesPerBlock = kCountThreads / 32;
    count_kernel<<<(n_tiles + kTilesPerBlock - 1) / kTilesPerBlock,
                   kCountThreads, 0, stream>>>(entry, counts, n_tiles, m);
    order_kernel<<<1, kOrderThreads, bins, stream>>>(counts, order, n_tiles,
                                                     m);
  }
  return cudaSuccess;
}

}  // namespace
