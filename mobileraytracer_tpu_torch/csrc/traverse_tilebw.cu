// Baldwin-Weber tile traversal kernel.
//
// Replaces the TPU kernel `_make_tile_kernel` / `_traverse_tile_padded` of
// mobileraytracer_tpu/ops/pallas_bvh.py (pallas_call at :1291).  Its plain
// PyTorch version is `tile_plain` in ops/kernels.py; the two agree bit for
// bit.
//
// One CUDA block walks one 128-ray tile through the tile's shared list of
// m candidate blocks, one thread per ray.  Round r: the block copies rows
// 0-4 of tw[gid[r]] (5 x 384 f32 = 7.5 KB) into shared memory; each thread
// then evaluates, for each of the 128 triangles, the six affine forms of
// the Baldwin-Weber rows (plane distance and barycentrics at the origin,
// and their rates along the direction), t = -no / nd, u and v, and the
// loose and strict acceptance of pallas_bvh.py:1155-1198.  It keeps the
// round's three smallest tracked t with the slots of the first two
// (:1203-1218), merges them into its running sorted triple (:1222-1238),
// and keeps its best strict hit and the ambiguity flag.  After the round
// the tile stops when r + 1 == m or entry[r + 1] >= the block-wide max of
// each ray's bound (:1240-1249).  At least one round always runs.
//
// The TPU kernel gets the six forms from one (256, 8) x (8, 384) float32
// matrix product.  Here they are scalar float32: each form sums the x, y
// and z terms and then the offset, every operation rounded (the library is
// built with --fmad=false), as the plain version does; the zero columns
// 4-7 of the TPU's ray matrix contribute nothing and are skipped.  The
// margins of the acceptance tests assume a full-float32 contraction, which
// this is.  Every constant that the JAX code forms from Python floats
// arrives from the host already rounded once to float32 (BwConsts).
//
// The round's second and third smallest t exclude lanes by the slot of
// the first and second, so each thread keeps its 128 tracked t of the
// round in shared memory (64 KB per block) for two more passes.
//
// What bounds it on the H100: about 45 f32 operations per ray-triangle
// pair plus the three passes over the round's lanes, one 128-thread block
// per tile with 72 KB of shared memory, so at most three blocks per SM and
// each round waits for its own block copy.  Speed is later work: the
// product on the tensor cores (3xTF32 or a re-derived margin), double-
// buffered block loads, a single-pass top-3.
#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

using namespace mrt;

constexpr int kTile = 128;
constexpr int kCols = 3 * kLanes;       // column groups n_hat | w_u | w_v
constexpr int kTwRows = 8;              // rows per block in tw
constexpr int kTwUsed = 5;              // rows 0-3 affine rows, 4 metadata
constexpr float kBig2 = 2.0e30f;        // 2 * RAY_LENGTH_MAX
constexpr size_t kSmem =
    (size_t)(kLanes * kTile + kTwUsed * kCols) * sizeof(float);

// Float32 constants, in the order of kernels.bw_consts.
struct BwConsts {
  float half_eps, eps15, neg_mu, mu, one_p_mu, one_m_mu, eps_m_tmg,
      eps_p_tmg, one_p_trel, one_m_trel, tmg;
};

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  __syncthreads();  // earlier readers of `red` are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
}

// Running minimum of x with the lowest slot among the lanes at it: the
// JAX kernel's min(x) and min(where(x <= min(x), slot, big2)).  Every x is
// <= kBig2, so (kBig2, kBig2) is the neutral start.
__device__ __forceinline__ void min_slot(float x, float slot, float& m,
                                         float& s) {
  if (x < m) {
    m = x;
    s = slot;
  } else if (x == m) {
    s = fminf(s, slot);
  }
}

__global__ void __launch_bounds__(kTile)
tilebw_kernel(const float* __restrict__ tw, const int* __restrict__ gid,
              const float* __restrict__ entry, const float* __restrict__ rays,
              float* __restrict__ out, int m, int any_hit, BwConsts c) {
  extern __shared__ float smem[];
  float* tl_s = smem;                          // [kLanes][kTile] tracked t
  float (*w)[kCols] = reinterpret_cast<float (*)[kCols]>(smem +
                                                          kLanes * kTile);
  __shared__ float red[kTile / 32];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t ray_i = (size_t)tile * kTile + lane;
  const Ray ray = load_ray(rays, ray_i);
  const float cap = ray.t_init;
  const float hi_loose = cap * c.one_p_trel + c.tmg;
  const float hi_strict = cap * c.one_m_trel - c.tmg;
  const int* g = gid + (size_t)tile * m;
  const float* e = entry + (size_t)tile * m;

  float t1 = kBig2, s1 = -1.0f, t2 = kBig2, s2 = -1.0f, t3 = kBig2;
  float ts_m = kBig2, ts_s = -1.0f, amb = 0.0f;
  int r = 0;
  while (true) {
    __syncthreads();  // the previous round's block is no longer read
    const float* src = tw + (size_t)g[r] * kTwRows * kCols;
    for (int i = lane; i < kTwUsed * kCols; i += kTile) {
      w[i / kCols][i % kCols] = src[i];
    }
    __syncthreads();

    float mo = kBig2, so = kBig2, m1 = kBig2, sl1 = kBig2;
    bool amb_r = false;
    for (int j = 0; j < kLanes; ++j) {
      const int ju = kLanes + j, jv = 2 * kLanes + j;
      const float no = ray.ox * w[0][j] + ray.oy * w[1][j] +
                       ray.oz * w[2][j] + w[3][j];
      const float nd = ray.dx * w[0][j] + ray.dy * w[1][j] + ray.dz * w[2][j];
      const float uo = ray.ox * w[0][ju] + ray.oy * w[1][ju] +
                       ray.oz * w[2][ju] + w[3][ju];
      const float ud =
          ray.dx * w[0][ju] + ray.dy * w[1][ju] + ray.dz * w[2][ju];
      const float vo = ray.ox * w[0][jv] + ray.oy * w[1][jv] +
                       ray.oz * w[2][jv] + w[3][jv];
      const float vd =
          ray.dx * w[0][jv] + ray.dy * w[1][jv] + ray.dz * w[2][jv];
      const float abs_nd = fabsf(nd);
      const float inv_nd = 1.0f / (abs_nd < c.half_eps ? 1.0f : nd);
      const float t = -no * inv_nd;
      const float u = uo + t * ud;
      const float v = vo + t * vd;
      const float slot = w[4][ju];
      const bool base = (w[4][j] > 0.5f) && (slot != ray.prev);
      const float det_s = abs_nd * w[4][jv];
      const bool well = abs_nd >= c.half_eps;
      const float uv = u + v;
      const bool loose = base && (det_s >= c.half_eps) && well &&
                         (u >= c.neg_mu) && (v >= c.neg_mu) &&
                         (uv <= c.one_p_mu) && (t >= c.eps_m_tmg) &&
                         (t <= hi_loose);
      amb_r = amb_r || (base && (det_s >= c.half_eps) && !well);
      const bool strict = base && (det_s >= c.eps15) && well &&
                          (u >= c.mu) && (v >= c.mu) && (uv <= c.one_m_mu) &&
                          (t >= c.eps_p_tmg) && (t <= hi_strict);
      min_slot(strict ? t : kBig2, slot, mo, so);
      const bool track = any_hit ? (loose && !strict) : loose;
      const float tl = track ? t : kBig2;
      tl_s[j * kTile + lane] = tl;
      min_slot(tl, slot, m1, sl1);
    }
    if (amb_r) amb = 1.0f;
    if (mo < ts_m) {
      ts_m = mo;
      if (mo < kBig) ts_s = so;
    }

    // Second smallest, excluding the lanes of slot sl1 (after its reset);
    // third smallest, excluding the lanes of slot sl2 at m2 (before its
    // reset), as pallas_bvh.py:1211-1218 orders them.
    sl1 = m1 < kBig ? sl1 : -1.0f;
    float m2 = kBig2, sl2 = kBig2;
    for (int j = 0; j < kLanes; ++j) {
      const float slot = w[4][kLanes + j];
      const float tl2 = slot == sl1 ? kBig2 : tl_s[j * kTile + lane];
      min_slot(tl2, slot, m2, sl2);
    }
    float m3 = kBig2;
    for (int j = 0; j < kLanes; ++j) {
      const float slot = w[4][kLanes + j];
      const float tl2 = slot == sl1 ? kBig2 : tl_s[j * kTile + lane];
      m3 = fminf(m3, (slot == sl2 && tl2 <= m2) ? kBig2 : tl2);
    }
    sl2 = m2 < kBig ? sl2 : -1.0f;

    // Merge the round's sorted triple into the running one.
    const bool take1 = m1 < t1;
    const float o_t = take1 ? t1 : m1, o_s = take1 ? s1 : sl1;
    const float a_t = take1 ? m2 : t2, a_s = take1 ? sl2 : s2;
    const bool take2 = a_t < o_t;
    const float n_t3 =
        fminf(fminf(fmaxf(t1, m2), fmaxf(t2, m1)), fminf(t3, m3));
    if (take1) {
      t1 = m1;
      s1 = sl1;
    }
    t2 = take2 ? a_t : o_t;
    s2 = take2 ? a_s : o_s;
    t3 = n_t3;

    const float bound = any_hit
                            ? (ts_m < kBig ? -kBig2 : cap)
                            : fminf(ts_m * c.one_p_trel + c.tmg, cap);
    const float t_worst = block_max(bound, red);
    const int nxt = min(r + 1, m - 1);
    const bool done = (r + 1 >= m) || (e[nxt] >= t_worst);
    ++r;
    if (done) break;
  }
  float* o = out + ray_i * 16;
  o[0] = t1;
  o[1] = s1;
  o[2] = t2;
  o[3] = s2;
  o[4] = t3;
  o[5] = ts_m;
  o[6] = ts_s;
  o[7] = (float)r;
  o[8] = amb;
  for (int k = 9; k < 16; ++k) o[k] = 0.0f;
}

cudaError_t prepare() {
  return cudaFuncSetAttribute(tilebw_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kSmem);
}

}  // namespace

// Launches one block per 128-ray tile on `stream`.  tw is (NB, 8, 384),
// gid/entry (n_tiles, m), rays (n_tiles * 128, 8), out (n_tiles * 128, 16);
// `consts` points to the 11 host floats of kernels.bw_consts.  Returns
// cudaGetLastError() after the launch.
extern "C" int mrt_traverse_tilebw(const float* tw, const int* gid,
                                   const float* entry, const float* rays,
                                   float* out, int n_tiles, int m,
                                   int any_hit, const float* consts,
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
  cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    tilebw_kernel<<<n_tiles, kTile, kSmem, stream>>>(tw, gid, entry, rays,
                                                     out, m, any_hit, c);
  }
  return (int)cudaGetLastError();
}

// Registers, shared memory and resident blocks per SM of the kernel (see
// mrt::kernel_info).
extern "C" int mrt_tilebw_info(int* info) {
  const cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  return kernel_info(tilebw_kernel, kTile, kSmem, info);
}
