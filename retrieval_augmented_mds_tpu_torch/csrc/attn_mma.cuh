// bf16 tensor-core tiles for the attention kernels (sm_80+ `mma.sync`).
//
// A CTA of 4 warps owns 64 rows (16 per warp) and walks tiles of another
// matrix. Operands stay bf16 in shared memory, each row padded by 8 bf16
// (16 bytes), so the 8 row addresses of an `ldmatrix` fall on 8 distinct
// groups of 4 banks. Products run as m16n8k16 MMAs with f32 accumulators:
//
//   mma_xyt: acc += X Y^T  (X the warp's 16 rows, Y the walked tile's rows,
//            both row-major [*, DH]): the scores Q K^T and dO V^T;
//   mma_py:  acc += P Y    (P a 16 x N operand held in registers, Y read
//            transposed by `ldmatrix.trans`): P V, P dO, dS Q, dS K.
//
// The C fragment of a 16 x N product is, pair of n-tiles by pair, the A
// fragment of the same 16 x N matrix as an operand (`to_a`): probabilities
// and score gradients never leave registers and are rounded to bf16 only
// there. Walked tiles arrive by `cp.async` into two buffers, so the next
// tile loads while this one computes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace attn {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // rows a CTA owns: 16 per warp
constexpr int kTile = 64;  // keys per tile; a key tile is skipped or not as a whole
constexpr int kPad = 8;    // bf16 of padding per shared-memory row
constexpr int kSub = 32;   // columns of a tile scored at a time (registers)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zeros when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + ROWS) of a row-major [*, DH] bf16 matrix into a
// padded shared tile, asynchronously; rows at or past `end` are zero.
template <int DH, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int row0,
                                          int end) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks, pos = row0 + r;
    const bool ok = pos < end;
    cp_async16(dst + r * (DH + kPad) + c * 8, src + (long)(ok ? pos : 0) * DH + c * 8, ok);
  }
}

// dst[j] = src[pos0 + j] for j < N, asynchronously; zero at or past `end`.
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int pos0,
                                         int end) {
  for (int j = threadIdx.x; j < N; j += kThreads) {
    const bool ok = pos0 + j < end;
    cp_async4(dst + j, src + (ok ? pos0 + j : 0), ok);
  }
}

// acc[N/8] += X Y^T: x the warp's 16 rows, y N rows, both padded [*, DH].
template <int DH, int N>
__device__ __forceinline__ void mma_xyt(float (&acc)[N / 8][4], const bf16* x, const bf16* y) {
  constexpr int LD = DH + kPad;
  const int lane = threadIdx.x & 31;
  // x4 row addresses: A takes (rows 0-7, 8-15) x (k 0-7, 8-15) as a0..a3;
  // B takes (k 0-7, 8-15) of n-tile 0, then of n-tile 1
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ac = (lane >> 4) * 8;
  const int br = (lane & 7) + (lane >> 4) * 8, bc = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, x + ar * LD + kk * 16 + ac);
#pragma unroll
    for (int jn = 0; jn < N / 16; ++jn) {
      uint32_t b[4];
      ldsm_x4(b, y + (jn * 16 + br) * LD + kk * 16 + bc);
      mma16816(acc[2 * jn], a, b[0], b[1]);
      mma16816(acc[2 * jn + 1], a, b[2], b[3]);
    }
  }
}

// acc[DH/8] += P Y: p the warp's 16 x N operand as A fragments, y N rows
// of a padded [*, DH] tile (the reduction runs over those N rows).
template <int DH, int N>
__device__ __forceinline__ void mma_py(float (&acc)[DH / 8][4], const uint32_t (&p)[N / 16][4],
                                       const bf16* y) {
  constexpr int LD = DH + kPad;
  const int lane = threadIdx.x & 31;
  // x4.trans: (rows 0-7, 8-15) of head dims 0-7 give b0, b1 of d-tile 0;
  // those of head dims 8-15 give d-tile 1
  const int tr = (lane & 7) + ((lane >> 3) & 1) * 8, tc = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int jd = 0; jd < DH / 16; ++jd) {
      uint32_t b[4];
      ldsm_x4_t(b, y + (kk * 16 + tr) * LD + jd * 16 + tc);
      mma16816(acc[2 * jd], p[kk], b[0], b[1]);
      mma16816(acc[2 * jd + 1], p[kk], b[2], b[3]);
    }
  }
}

// The C fragments of a 16 x N f32 product as the A fragments of the same
// matrix, rounded to bf16.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Store the warp's 16 x DH accumulator to rows row0.. of a row-major
// [*, DH] matrix (bf16 or f32), the rows below `end`, row g times mul[0]
// and row g + 8 times mul[1]. Lane (g, t) holds rows g and g + 8, head
// dims 8 jd + 2 t and + 1.
template <int DH, typename Out>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 8][4], Out* __restrict__ dst,
                                           int row0, int end, const float (&mul)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= end) continue;
#pragma unroll
    for (int jd = 0; jd < DH / 8; ++jd)
      store_pair(dst + (long)r * DH + 8 * jd + 2 * t, acc[jd][2 * h] * mul[h],
                 acc[jd][2 * h + 1] * mul[h]);
  }
}

// The same with one multiplier for every row.
template <int DH, typename Out>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 8][4], Out* __restrict__ dst,
                                           int row0, int end, float mul) {
  const float both[2] = {mul, mul};
  store_rows<DH>(acc, dst, row0, end, both);
}

// Max and sum over the 4 lanes of a quad, which together hold a row of a
// 16 x N C fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The first tile at or after `kt` (of n tiles of TILE positions) that
// holds a position p with marked(p), or n. One barrier per probe of
// kThreads x PER positions: thread i tests positions PER i to PER i +
// PER - 1, so the first lane whose ballot is set, in warp order, names the
// first such tile. `parity` alternates the two probe buffers, so a probe
// never overwrites one that a slower warp is still reading.
template <int TILE, int PER, typename Marked>
__device__ __forceinline__ int next_marked_tile(int kt, int n, const Marked& marked,
                                                unsigned (&probe)[2][kWarps], int& parity) {
  static_assert(TILE % PER == 0, "a thread's positions lie in one tile");
  constexpr int kTiles = kThreads * PER / TILE;  // tiles per probe
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (; kt < n; kt += kTiles) {
    const int p0 = kt * TILE + PER * threadIdx.x;
    bool hit = false;
#pragma unroll
    for (int i = 0; i < PER; ++i) hit |= marked(p0 + i);
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    unsigned(&buf)[kWarps] = probe[parity];
    parity ^= 1;
    if (lane == 0) buf[warp] = bal;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (buf[w]) return min(n, kt + (32 * w + __ffs(buf[w]) - 1) * PER / TILE);
  }
  return n;
}

// Shared tiles of the forward: the CTA's 64 query rows, two buffers of the
// walked key tile (keys, values, key bias), and the sum of the values of
// the keys a causal block skips (a fully masked row's closed form).
template <int DH>
struct FwdTiles {
  bf16 q[kRows][DH + kPad];
  bf16 k[2][kTile][DH + kPad], v[2][kTile][DH + kPad];
  float bias[2][kTile];
  float vsum[DH];
  unsigned probe[2][kWarps];
};

// Shared tiles of the dq pass: the CTA's 64 query rows and dO rows, and
// two buffers of the walked key tile (keys, values, key bias).
template <int DH>
struct DqTiles {
  bf16 q[kRows][DH + kPad], dout[kRows][DH + kPad];
  bf16 k[2][kTile][DH + kPad], v[2][kTile][DH + kPad];
  float bias[2][kTile];
  unsigned probe[2][kWarps];
};

// Shared tiles of the dk/dv pass: the CTA's 64 keys and values, and two
// buffers of the walked query tile (queries, dO, the rows' raw statistics
// and delta). At dh 128 the walked tile is 32 rows, to keep the two
// accumulators, the scores and dP within the register file.
template <int DH>
struct DkvTiles {
  static constexpr int BN = DH >= 128 ? 32 : 64;
  bf16 k[kRows][DH + kPad], v[kRows][DH + kPad];
  bf16 q[2][BN][DH + kPad], dout[2][BN][DH + kPad];
  float stat[2][3][BN];  // [buffer][raw statistic 0, 1, delta][row]
  unsigned probe[2][kWarps];
};

}  // namespace mma
}  // namespace attn
