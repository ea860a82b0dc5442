// Gumbel-max categorical draw: threefry2x32, the Gumbel table and the row
// argmax fused in one kernel.
//
// Replaces no Pallas kernel.  What it replaces is XLA's lowering of
// `jax.random.categorical(key, logits, shape=(k,))` (the JAX package's
// edge draws, mobileraytracer_tpu/diff/geom.py), which the port first ran
// as `threefry.categorical`: about 130 eager int32 elementwise ops over
// 2^26-draw blocks, some 8,000 launches for the two draws of one 512x512
// `vertex_grad` call, each op writing and reading its block to HBM.  That
// plain version stays as the reference, and this kernel equals it bit for
// bit:
//   - row i < k, column c < E hashes the flat index i E + c, a 64-bit
//     count split into its (hi, lo) words, with threefry2x32 under the key
//     (jax/_src/prng.py `_threefry2x32_lowering`: 5 blocks of 4 rounds,
//     a key injection after each block), and XORs the two output words;
//   - the top 23 bits index `_gumbel_table`, -log(-log(u)) of the uniform
//     float they make, as XLA's CPU log computes it; the table is the bit
//     source that the plain version and the benchmark's reference share,
//     so nothing here recomputes a log;
//   - v = table value + logits[c], one float32 add (--fmad=false);
//   - each row keeps its first argmax: the larger value wins, on equal
//     values the smaller column (-0.0 and +0.0 are equal, as torch.argmax
//     sees them), and a NaN logit is larger than any value (torch.argmax's
//     rule; with a finite table a NaN can only come from a logit).
//
// What bounds it on the H100: integer ALU work.  A count costs about 75
// int32 operations (20 rounds of add, funnel-shift rotate and xor, the key
// injections, the xor and shift of the output, the 64-bit index) and one
// 4-byte gather from the 32 MiB table, which stays in the 50 MB L2.  At
// 132 SMs x 64 int32 lanes x 1.98 GHz = 16.7 T int ops/s, the cell's two
// draws (4,096 and 1,024 rows over 993,552 edge slots, 5.09e9 counts) need
// about 23 ms.  The gathers come near that too: one 32-byte L2 sector and
// one L1 wavefront each, no reuse.  The design:
//   - each CUDA block owns a tile of kRows rows x kCols * kThreads columns;
//     a thread loads its kCols logits once and reuses them for every row;
//     its kCols counts a row are independent hash chains, unrolled, so the
//     integer pipes and the gathers' latency overlap;
//   - the key is read from the device inside the kernel (no host read), and
//     its schedule is folded once per thread into the ten words that the
//     five injections add, the round number (i + 1) included;
//   - rotations are __funnelshift_l with immediate counts;
//   - a row's best (value, column) is reduced in registers, then across the
//     warp by xor shuffles, then across the block's warps in shared memory;
//   - blocks combine with one 64-bit atomicMax per block and row on a
//     packed key, chosen over a second pass because it needs no per-block
//     scratch and no second launch: the high word holds the value's
//     order-preserving bits (taken after v + 0.0f, so -0.0 and +0.0 tie;
//     a NaN takes the top), the low word 0xFFFFFFFF - c, so the smaller
//     column wins a tie.  A max is order-independent, so the result does
//     not depend on the order the blocks run in.  The caller zeroes the
//     (k,) words and unpacks the columns;
//   - the grid is a flat list of tiles worked out from k and E alone, so
//     any shape runs (E = 1, ragged row and column tiles), and the cell's
//     two shapes give 124,416 and 31,104 blocks: every SM stays full.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "mt.cuh"

namespace {

constexpr int kThreads = 256;                  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                       // columns a thread, per row
constexpr int kTileCols = kCols * kThreads;    // 2,048 columns a tile
constexpr int kRows = 16;                      // rows a tile
constexpr uint32_t kNone = 0xFFFFFFFFu;        // no column

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four rounds of Threefry-2x32 with rotations A, B, C, D.
template <int A, int B, int C, int D>
__device__ __forceinline__ void rounds4(uint32_t& x, uint32_t& y) {
  x += y; y = rotl(y, A) ^ x;
  x += y; y = rotl(y, B) ^ x;
  x += y; y = rotl(y, C) ^ x;
  x += y; y = rotl(y, D) ^ x;
}

// The key schedule, folded: the first injection (k0, k1), then after
// block i, x += inj_x[i] and y += inj_y[i] (= ks[(i + 2) % 3] + i + 1).
struct Schedule {
  uint32_t k0, k1;
  uint32_t inj_x[5], inj_y[5];
};

__device__ __forceinline__ Schedule schedule(const long long* key) {
  Schedule s;
  const uint32_t ks[3] = {(uint32_t)key[0], (uint32_t)key[1],
                          (uint32_t)key[0] ^ (uint32_t)key[1] ^ 0x1BD11BDAu};
  s.k0 = ks[0];
  s.k1 = ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    s.inj_x[i] = ks[(i + 1) % 3];
    s.inj_y[i] = ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return s;
}

// The random word of count (hi, lo): both threefry2x32 outputs, XORed.
__device__ __forceinline__ uint32_t random_word(const Schedule& s,
                                                uint32_t hi, uint32_t lo) {
  uint32_t x = hi + s.k0, y = lo + s.k1;
  rounds4<13, 15, 26, 6>(x, y);  x += s.inj_x[0]; y += s.inj_y[0];
  rounds4<17, 29, 16, 24>(x, y); x += s.inj_x[1]; y += s.inj_y[1];
  rounds4<13, 15, 26, 6>(x, y);  x += s.inj_x[2]; y += s.inj_y[2];
  rounds4<17, 29, 16, 24>(x, y); x += s.inj_x[3]; y += s.inj_y[3];
  rounds4<13, 15, 26, 6>(x, y);  x += s.inj_x[4]; y += s.inj_y[4];
  return x ^ y;
}

// Whether (v, c) beats (best, best_c): larger, or equal and to the left.
// Neither value is NaN here.
__device__ __forceinline__ bool beats(float v, uint32_t c, float best,
                                      uint32_t best_c) {
  return v > best || (v == best && c < best_c);
}

__global__ void __launch_bounds__(kThreads)
gumbel_kernel(const long long* __restrict__ key,
              const float* __restrict__ logits,
              const float* __restrict__ table,
              unsigned long long* __restrict__ out, int k, int e,
              int col_tiles) {
  __shared__ float s_v[kRows][kWarps];
  __shared__ uint32_t s_c[kRows][kWarps];
  __shared__ uint32_t s_nan;                   // the tile's first NaN column
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = (int)(blockIdx.x / col_tiles) * kRows;
  const uint32_t c0 = (blockIdx.x % col_tiles) * (uint32_t)kTileCols;
  const int rows = min(kRows, k - row0);
  if (tid == 0) s_nan = kNone;
  __syncthreads();

  // The thread's columns c0 + tid + j kThreads; past E a logit of -inf
  // never beats the starting best, and a NaN logit goes to s_nan.
  float lg[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const uint32_t c = c0 + tid + j * kThreads;
    lg[j] = c < (uint32_t)e ? logits[c] : -INFINITY;
    if (lg[j] != lg[j]) atomicMin(&s_nan, c);
  }
  const uint32_t first_c = c0 + tid < (uint32_t)e ? c0 + tid : kNone;
  const Schedule s = schedule(key);

  for (int r = 0; r < rows; ++r) {
    const unsigned long long base =
        (unsigned long long)(row0 + r) * (unsigned)e + c0 + tid;
    float best = -INFINITY;
    uint32_t best_c = first_c;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const unsigned long long idx = base + j * kThreads;
      const uint32_t w = random_word(s, (uint32_t)(idx >> 32),
                                     (uint32_t)idx);
      const float v = __ldg(table + (w >> 9)) + lg[j];
      if (v > best) {                          // columns ascend: first wins
        best = v;
        best_c = c0 + tid + j * kThreads;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const uint32_t oc = __shfl_xor_sync(0xffffffffu, best_c, off);
      if (beats(ov, oc, best, best_c)) {
        best = ov;
        best_c = oc;
      }
    }
    if (lane == 0) {
      s_v[r][warp] = best;
      s_c[r][warp] = best_c;
    }
  }
  __syncthreads();

  if (tid < rows) {
    float best = s_v[tid][0];
    uint32_t best_c = s_c[tid][0];
    for (int w = 1; w < kWarps; ++w) {
      if (beats(s_v[tid][w], s_c[tid][w], best, best_c)) {
        best = s_v[tid][w];
        best_c = s_c[tid][w];
      }
    }
    // v + 0.0f, written as a compare: -0.0 takes +0.0's bits.
    const uint32_t u = best == 0.0f ? 0u : __float_as_uint(best);
    uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    if (s_nan != kNone) {
      ord = 0xFFFFFFFFu;
      best_c = s_nan;
    }
    atomicMax(out + row0 + tid,
              ((unsigned long long)ord << 32) | (kNone - best_c));
  }
}

}  // namespace

// Draws k samples of the categorical over `e` logits under `key` (two
// 32-bit words held in int64) into out, (k,) packed words that the caller
// zeroed: column c of row i is 0xFFFFFFFF - (out[i] & 0xFFFFFFFF).  table is
// the (2^23,) Gumbel table.  Returns cudaErrorInvalidValue for a shape the
// flat grid cannot hold, else cudaGetLastError() after the launch.
extern "C" int mrt_gumbel_argmax(const long long* key, const float* logits,
                                 const float* table, unsigned long long* out,
                                 int k, int e, cudaStream_t stream) {
  if (k <= 0) return 0;
  if (e <= 0) return (int)cudaErrorInvalidValue;
  const long long col_tiles = (e + (long long)kTileCols - 1) / kTileCols;
  const long long row_tiles = (k + (long long)kRows - 1) / kRows;
  if (col_tiles * row_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  gumbel_kernel<<<(unsigned)(col_tiles * row_tiles), kThreads, 0, stream>>>(
      key, logits, table, out, k, e, (int)col_tiles);
  return (int)cudaGetLastError();
}

// Registers, shared memory and resident blocks per SM of the kernel (see
// mrt::kernel_info).
extern "C" int mrt_gumbel_info(int* info) {
  return mrt::kernel_info(gumbel_kernel, kThreads, 0, info);
}
