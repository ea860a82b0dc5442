// Resident-table any-hit traversal kernel.
//
// Replaces the TPU kernel `_make_resident_kernel` /
// `_traverse_resident_padded` of mobileraytracer_tpu/ops/pallas_bvh.py
// (pallas_call at :948).  Its plain PyTorch version is `resident_plain` in
// ops/kernels.py; the two agree bit for bit.
//
// The block table is cut into partitions of kPart = 640 blocks (zero-padded
// to whole partitions by the caller).  The grid is (program, partition):
// one CUDA block per pair, g_n bands of 16 rays (g_n = 8 by default; the
// JAX kernel's `g_n`, set by traverse_resident(res_group=), 1 to 32).
// Band g's candidate list is sorted by block id, so its blocks in partition
// p are the run [s0, s1) = starts[g, p], starts[g, p + 1].  Round r tests,
// for every band, block clip(s0 + r, s0, max(s1 - 1, s0)) of its list, read
// at clip(gid - p * 640, 0, 639) inside partition p's slab
// (pallas_bvh.py:885-892); list positions past the program's g_n * m
// entries read its last entry, as the JAX kernel's bounded list read does
// in interpret mode.  A band is alive while s0 + r < s1 and one of its rays
// is unoccluded (t_best >= t_init, :867-877); there is no entry-distance
// test.  The program runs while any of its g_n bands is alive, and a dead
// band, a band whose run in partition p is empty included, keeps testing
// its clamped block: in any-hit mode those visits can still lower t and
// change the slot, so t and slot per partition equal the JAX kernel's only
// with the same lockstep, and they depend on g_n.  Each ray's t and slot
// for partition p are written to row p of `out`; the caller combines
// partitions by min.
//
// On the TPU the partition's 5 MB slab stays resident in VMEM for all
// programs.  A Hopper SM has no store of that size; the slab stays in the
// 50 MB L2 while the programs of one partition run, and each round's block
// is staged in shared memory.
//
// What bounds it on the H100: the tests' f32 operations (mt.cuh), and
// around them the latency of each round: a lockstep barrier per round and
// short walks (a few rounds per program).  The design is the banded
// kernel's (traverse_banded.cu):
//   - two threads per ray, a band is one warp, g_n warps a program; each
//     thread scans every other float4 group of the band's block (mt_scan_
//     groups), stopping at the block's last valid lane (valid_groups), and
//     the two halves merge by the tie rule before mt_finish, which reruns
//     the round in full (mt_round) in the one case the skipped lanes decide;
//   - the band's block (rows 0-10, 5.6 KB; 45 KB a program of 8 bands) is
//     staged in shared memory by cp.async.  The next round's index
//     is known in advance (s0 + r + 1, clamped), so its copy starts as soon
//     as the warp has read the current block, and overlaps the lockstep
//     barrier.  A dead band
//     whose clamped block does not change keeps its buffer and copies
//     nothing.
// The band count is a launch argument.  The kernel is built for programs of
// exactly 8 bands (the default: the count a constant, the blocks in static
// shared memory) and of at most 8, 16 and 32 bands, so that each keeps the
// register budget of its block size: up to 8 bands (256 threads), three
// programs fit an SM.  Above 8 bands the staged blocks pass 48 KB, which
// needs the kernel's dynamic shared memory limit raised first.
#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

using namespace mrt;

constexpr int kBand = 16;                       // rays per band (SUBTILE)
constexpr int kSplit = 2;                       // threads per ray
constexpr int kBandThreads = kBand * kSplit;    // a band is one warp
constexpr int kPart = 640;                      // blocks per partition (NBP)
constexpr int kMaxBands = 32;                   // 1,024 threads a block
constexpr int kBandBytes = kRowsUsed * kLanes * (int)sizeof(float);

// Whether any band of the program is alive at round r.  Every thread of the
// block must call it.
__device__ __forceinline__ bool any_alive(int r, int s0, int s1, float t_best,
                                          float t_init) {
  int not_occ = !(t_best < t_init);
  for (int off = kBand / 2; off > 0; off >>= 1) {
    not_occ |= __shfl_xor_sync(0xffffffffu, not_occ, off);
  }
  return __syncthreads_or((s0 + r < s1) && not_occ) != 0;
}

// A program of g_n <= kBands bands (g_n * 32 threads).  kExact: g_n is
// kBands, a constant, and the blocks are staged in static shared memory;
// otherwise g_n comes from the launch and g_n * kBandBytes of dynamic
// shared memory hold them.
template <int kBands, bool kExact>
__global__ void __launch_bounds__(kBands * kBandThreads, kBands <= 8 ? 3 : 1)
resident_kernel(const float* __restrict__ tb, const int* __restrict__ starts,
                const int* __restrict__ glist, const float* __restrict__ rays,
                float* __restrict__ out, int n_rays, int n_parts, int m,
                int g_n_arg) {
  const int g_n = kExact ? kBands : g_n_arg;
  const int tid = threadIdx.x;
  const int band = tid / kBandThreads;
  const int k = tid % kBandThreads;              // index in the band
  const int half = k / kBand;                    // which groups of triangles
  const int prog = blockIdx.x;
  const int p = blockIdx.y;
  float(*blk)[kLanes];
  if constexpr (kExact) {
    __shared__ __align__(16) float fixed[kBands][kRowsUsed][kLanes];
    blk = fixed[band];
  } else {
    extern __shared__ __align__(16) float smem[];
    blk = reinterpret_cast<float(*)[kLanes]>(smem) + band * kRowsUsed;
  }
  const size_t ray_i = (size_t)prog * g_n * kBand + band * kBand + k % kBand;
  const int* st = starts + ((size_t)prog * g_n + band) * (n_parts + 1);
  const int s0 = st[p];
  const int s1 = st[p + 1];
  const int* gl = glist + (size_t)prog * g_n * m;
  const size_t stride = (size_t)kRows * kLanes;
  const float* slab = tb + (size_t)p * kPart * stride;
  // The partition-p block that the band tests in round r.
  auto block_at = [&](int r) {
    const int idx = min(s0 + r, max(s1 - 1, s0));
    const int pos = min(band * m + idx, g_n * m - 1);
    return min(max(gl[pos] - p * kPart, 0), kPart - 1);
  };

  const Ray ray = load_ray(rays, ray_i);
  float t_best = ray.t_init;
  float slot_best = -1.0f;
  bool alive = any_alive(0, s0, s1, t_best, ray.t_init);
  int lid = block_at(0);
  if (alive) copy_block_async(blk, slab + lid * stride, k, kBandThreads);
  int r = 0;
  while (alive) {
    const int lid_next = block_at(r + 1);
    cp_async_wait<0>();
    __syncwarp();
    const int n_groups = valid_groups(&blk[9][0]);
    float tmin = kBig, smin = kBig;
    mt_scan_groups(blk, half, n_groups, kSplit, ray, t_best, tmin, smin);
    merge_min(tmin, smin, __shfl_xor_sync(0xffffffffu, tmin, kBand),
              __shfl_xor_sync(0xffffffffu, smin, kBand));
    mt_finish(blk, ray, tmin, smin, t_best, slot_best);
    __syncwarp();
    if (lid_next != lid) {
      copy_block_async(blk, slab + lid_next * stride, k, kBandThreads);
      lid = lid_next;
    }
    alive = any_alive(r + 1, s0, s1, t_best, ray.t_init);
    ++r;
  }
  cp_async_wait<0>();
  if (half == 0) {
    out[(size_t)p * n_rays + ray_i] = t_best;
    out[((size_t)n_parts + p) * n_rays + ray_i] = slot_best;
  }
}

// The build of the kernel for g_n bands and its dynamic shared memory,
// with that memory's limit raised where it passes the default 48 KB.  The
// default 8 bands take the exact build.
using Kernel = void (*)(const float*, const int*, const int*, const float*,
                        float*, int, int, int, int);

struct Launch {
  Kernel fn;
  size_t smem;
};

template <int kBands, bool kExact>
cudaError_t prepared(int g_n, Launch* launch) {
  *launch = {resident_kernel<kBands, kExact>,
             kExact ? 0 : (size_t)g_n * kBandBytes};
  if (kExact || kBands * kBandBytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(resident_kernel<kBands, kExact>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kBands * kBandBytes);
}

cudaError_t kernel_for(int g_n, Launch* launch) {
  if (g_n < 1 || g_n > kMaxBands) return cudaErrorInvalidValue;
  if (g_n == 8) return prepared<8, true>(g_n, launch);
  if (g_n < 8) return prepared<8, false>(g_n, launch);
  if (g_n <= 16) return prepared<16, false>(g_n, launch);
  return prepared<32, false>(g_n, launch);
}

}  // namespace

// Launches one block of g_n * 32 threads per (program, partition) on
// `stream`.  tb is (n_parts * 640, 16, 128); starts (n_groups * g_n,
// n_parts + 1) and glist (n_groups * g_n, m) int32; rays (n_groups * g_n *
// 16, 8); out (2, n_parts, n_groups * g_n * 16) holding t, then slot.
// Returns cudaErrorInvalidValue for g_n outside [1, 32], else
// cudaGetLastError() after the launch.
extern "C" int mrt_traverse_resident(const float* tb, const int* starts,
                                     const int* glist, const float* rays,
                                     float* out, int n_groups, int n_parts,
                                     int m, int g_n, cudaStream_t stream) {
  Launch launch;
  const cudaError_t err = kernel_for(g_n, &launch);
  if (err != cudaSuccess) return (int)err;
  if (n_groups > 0 && n_parts > 0) {
    launch.fn<<<dim3(n_groups, n_parts), g_n * kBandThreads, launch.smem,
                stream>>>(tb, starts, glist, rays, out,
                          n_groups * g_n * kBand, n_parts, m, g_n);
  }
  return (int)cudaGetLastError();
}

// Registers, shared memory and resident blocks per SM of the kernel at g_n
// bands a program (see mrt::kernel_info).
extern "C" int mrt_resident_info(int* info, int g_n) {
  Launch launch;
  const cudaError_t err = kernel_for(g_n, &launch);
  if (err != cudaSuccess) return (int)err;
  return kernel_info(launch.fn, g_n * kBandThreads, launch.smem, info);
}
