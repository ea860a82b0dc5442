// Resident-table any-hit traversal kernel.
//
// Replaces the TPU kernel `_make_resident_kernel` /
// `_traverse_resident_padded` of mobileraytracer_tpu/ops/pallas_bvh.py
// (pallas_call at :948).  Its plain PyTorch version is `resident_plain` in
// ops/kernels.py; the two agree bit for bit.
//
// The block table is cut into partitions of kPart = 640 blocks (zero-padded
// to whole partitions by the caller).  The grid is (program, partition):
// one CUDA block of 128 threads per pair, 8 bands of 16 rays, one thread
// per ray.  Band g's candidate list is sorted by block id, so its blocks in
// partition p are the run [s0, s1) = starts[g, p], starts[g, p + 1].  Round
// r tests, for every band, block clip(s0 + r, s0, max(s1 - 1, s0)) of its
// list, read at clip(gid - p * 640, 0, 639) inside partition p's slab
// (pallas_bvh.py:885-892); list positions past the program's 8 * m entries
// read its last entry, as the JAX kernel's bounded list read does in
// interpret mode.  A band is alive while s0 + r < s1 and one of its rays is
// unoccluded (t_best >= t_init, :867-877); there is no entry-distance test.
// The program runs while any band is alive, and a dead band keeps testing
// its clamped block: in any-hit mode those visits can still lower t and
// change the slot, so t and slot per partition equal the JAX kernel's only
// with the same lockstep.  Each thread writes its ray's t and slot for
// partition p; the caller combines partitions by min.
//
// On the TPU the partition's 5 MB slab stays resident in VMEM for all
// programs.  A Hopper SM has no store of that size; here every thread reads
// its band's 11 used rows straight from device memory, where the slab stays
// in the 50 MB L2 while the programs of one partition run, and the 16
// threads of a band read the same addresses (broadcast loads).
//
// What bounds it on the H100: about 30 f32 operations per ray-triangle
// test plus 11 loads per triangle from L1/L2, one 128-thread block per
// (program, partition) pair, and short walks (a few rounds), so launch and
// latency, not arithmetic, dominate.  Speed is later work: staging each
// round's 8 blocks in shared memory with cp.async, skipping pairs whose
// bands are all empty before launch.
#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

using namespace mrt;

constexpr int kBand = 16;                  // rays per band (SUBTILE)
constexpr int kGroup = 8;                  // bands per program
constexpr int kProg = kBand * kGroup;      // threads per block
constexpr int kPart = 640;                 // blocks per partition (NBP)

// Whether any band of the program is alive at round r.
__device__ __forceinline__ bool any_alive(int r, int s0, int s1, float t_best,
                                          float t_init) {
  int not_occ = !(t_best < t_init);
  for (int off = kBand / 2; off > 0; off >>= 1) {
    not_occ |= __shfl_xor_sync(0xffffffffu, not_occ, off);
  }
  return __syncthreads_or((s0 + r < s1) && not_occ) != 0;
}

__global__ void __launch_bounds__(kProg)
resident_kernel(const float* __restrict__ tb, const int* __restrict__ starts,
                const int* __restrict__ glist, const float* __restrict__ rays,
                float* __restrict__ out, int n_rays, int n_parts, int m) {
  const int prog = blockIdx.x;
  const int p = blockIdx.y;
  const int lane = threadIdx.x;
  const int band = lane / kBand;
  const size_t ray_i = (size_t)prog * kProg + lane;
  const Ray ray = load_ray(rays, ray_i);
  const int* st = starts + ((size_t)prog * kGroup + band) * (n_parts + 1);
  const int s0 = st[p];
  const int s1 = st[p + 1];
  const int* gl = glist + (size_t)prog * kGroup * m;
  const float* slab = tb + (size_t)p * kPart * kRows * kLanes;

  float t_best = ray.t_init;
  float slot_best = -1.0f;
  bool alive = any_alive(0, s0, s1, t_best, ray.t_init);
  int r = 0;
  while (alive) {
    const int idx = min(s0 + r, max(s1 - 1, s0));
    const int pos = min(band * m + idx, kGroup * m - 1);
    const int lid = min(max(gl[pos] - p * kPart, 0), kPart - 1);
    mt_round(reinterpret_cast<const float (*)[kLanes]>(
                 slab + (size_t)lid * kRows * kLanes),
             ray, t_best, slot_best);
    alive = any_alive(r + 1, s0, s1, t_best, ray.t_init);
    ++r;
  }
  out[(size_t)p * n_rays + ray_i] = t_best;
  out[((size_t)n_parts + p) * n_rays + ray_i] = slot_best;
}

}  // namespace

// Launches one block per (program, partition) on `stream`.  tb is
// (n_parts * 640, 16, 128); starts (n_groups * 8, n_parts + 1) and glist
// (n_groups * 8, m) int32; rays (n_groups * 128, 8); out (2, n_parts,
// n_groups * 128) holding t, then slot.  Returns cudaGetLastError() after
// the launch.
extern "C" int mrt_traverse_resident(const float* tb, const int* starts,
                                     const int* glist, const float* rays,
                                     float* out, int n_groups, int n_parts,
                                     int m, cudaStream_t stream) {
  if (n_groups > 0 && n_parts > 0) {
    resident_kernel<<<dim3(n_groups, n_parts), kProg, 0, stream>>>(
        tb, starts, glist, rays, out, n_groups * kProg, n_parts, m);
  }
  return (int)cudaGetLastError();
}

// Registers, shared memory and resident blocks per SM of the kernel (see
// mrt::kernel_info).
extern "C" int mrt_resident_info(int* info) {
  return kernel_info(resident_kernel, kProg, 0, info);
}
