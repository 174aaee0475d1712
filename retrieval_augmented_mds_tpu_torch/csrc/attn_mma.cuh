// The attention kernels' tiles and what they share (forward and backward,
// sliding and dense, both dtypes): the mask value and the tests for fully
// masked rows, the CTA shape, how a backward reads the forward's row
// statistics (MLStats, LseStats), the launch of a kernel with large shared
// memory, and the tensor-core tiles themselves (sm_80+ `mma.sync`).
//
// A CTA of 4 warps owns 64 rows (16 per warp) and walks tiles of another
// matrix. The element type of the shared tiles picks the operand policy:
//
// - bf16: m16n8k16 MMAs on bf16 operands. Each row is padded by 8 bf16
//   (16 bytes), so the 8 row addresses of an `ldmatrix` fall on 8 distinct
//   groups of 4 banks.
// - float: split TF32 ("3xTF32"), m16n8k8 MMAs. Each f32 operand x is
//   split in registers into hi = rna(x) and lo = rna(x - hi), rna being
//   TF32's round to nearest, ties away (x - hi is exact in f32), and a
//   product runs as lo.hi' + hi.lo' + hi.hi', the dropped lo.lo' and lo's
//   own rounding leaving ~2^-21 of each |x y|: f32 accuracy, where one
//   TF32 pass keeps ~2^-11. `ldmatrix` moves b16 only,
//   so fragments come from 32-bit shared loads; each row is padded by 4
//   floats (16 bytes), a stride of 4 mod 32 words, so the 32 lanes of a
//   fragment hit 32 banks whether they read along rows or down columns.
//
// Both accumulate in f32 with the same C fragment (lane (g, t): rows g and
// g + 8, columns 2t and 2t + 1 of each 8-column tile):
//
//   mma_xyt: acc += X Y^T  (X the warp's 16 rows, Y the walked tile's rows,
//            both row-major [*, DH]): the scores Q K^T and dO V^T;
//   mma_py:  acc += P Y    (P a 16 x N operand held in registers, Y read
//            down its columns): P V, P dO, dS Q, dS K.
//
// The C fragment of a 16 x N product is the A operand of the same matrix
// (`to_a`): probabilities and score gradients never leave registers. bf16
// rounds them there, pair of n-tiles by pair; split TF32 splits them per
// k-step and feeds a lane's columns 2t and 2t + 1 as k-slots t and t + 4,
// with rows 2t and 2t + 1 of Y as B's rows t and t + 4 (the order of a
// sum's terms changes, not its value), so no shuffle is needed. Walked
// tiles arrive by `cp.async` into two buffers, so the next tile loads
// while this one computes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr float kMaskVal = -1e9f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = 4;
// a row whose max is within this of -1e9 saw no unmasked column
constexpr float kDegenerate = kMaskVal + 1000.f;
// the same for a row's log-sum-exp: -1e9 + log S rounds to -1e9 in f32
constexpr float kLseDegenerate = -1e8f;

// How a backward reads the forward's statistics of a query row, as the pair
// (m, l) of p = exp(s - m) / l. MLStats: the row max and the denominator
// (K2, K4 keep them apart). `kRaw` arrays hold them per row; `decode`
// turns a row's raw values into (m, l), so a kernel may stage the raw
// arrays in shared memory.
struct MLStats {
  static constexpr int kRaw = 2;
  const float* m;
  const float* l;
  __device__ MLStats shifted(long o) const { return {m + o, l + o}; }
  __device__ const float* raw(int a) const { return a == 0 ? m : l; }
  __device__ float2 decode(float a, float b) const { return make_float2(a, b); }
  __device__ float2 operator[](int i) const { return make_float2(m[i], l[i]); }
};

// LseStats: one log-sum-exp per row (K6). A row with an open key reads
// (lse, 1). A fully masked row has every logit at exactly -1e9, so its
// lse = -1e9 + log S rounds to -1e9 and exp(s - lse) would give each key
// 1, not 1/S; it reads the closed form (-1e9, S): uniform over the S keys.
struct LseStats {
  static constexpr int kRaw = 1;
  const float* lse;
  float s_len;
  __device__ LseStats shifted(long o) const { return {lse + o, s_len}; }
  __device__ const float* raw(int) const { return lse; }
  __device__ float2 decode(float x, float) const {
    return x <= kLseDegenerate ? make_float2(kMaskVal, s_len) : make_float2(x, 1.f);
  }
  __device__ float2 operator[](int i) const { return decode(lse[i], 0.f); }
};

// Launch a kernel whose shared memory may pass the 48 KB static limit.
template <typename Kernel, typename... Args>
int launch_dyn(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // rows a CTA owns: 16 per warp
constexpr int kTile = 64;  // keys per tile; a key tile is skipped or not as a whole
constexpr int kSub = 32;   // columns of a tile scored at a time (registers)

// Row stride of a shared [*, DH] tile of T: 16 bytes of padding per row.
template <typename T, int DH>
constexpr int kLd = DH + 16 / static_cast<int>(sizeof(T));

// CTAs per SM the kernels of a policy are compiled for (registers): f32
// tiles take twice the shared memory, and split TF32 more registers.
template <typename T, int DH>
constexpr int kMinBlocks = sizeof(T) == 2 ? (DH >= 128 ? 2 : 3) : (DH >= 128 ? 1 : 2);

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

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// Copy rows [row0, row0 + ROWS) of a row-major [*, DH] matrix (bf16 or f32)
// into a padded shared tile, asynchronously; rows at or past `end` are zero.
template <int DH, int ROWS, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int row0,
                                          int end) {
  constexpr int kPer = 16 / sizeof(T), kChunks = DH / kPer;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks, pos = row0 + r;
    const bool ok = pos < end;
    cp_async16(dst + r * kLd<T, DH> + c * kPer, src + (long)(ok ? pos : 0) * DH + c * kPer,
               ok);
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
  constexpr int LD = kLd<bf16, DH>;
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
  constexpr int LD = kLd<bf16, DH>;
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

// ---------------------------------------------------------------------------
// split TF32 (f32 tiles)
// ---------------------------------------------------------------------------

// x = hi + lo, both TF32. hi is x rounded to nearest, ties away from zero,
// as `cvt.rna.tf32.f32` rounds it, but by integer ops on the bits (half of
// the dropped range added to the magnitude, then the low 13 bits cleared):
// the cvt also tests for NaN and infinity, which doubles its instructions.
// Finite values and infinities round alike; a NaN whose payload fills the
// top mantissa bits may carry into the sign. x - hi is exact in f32, and lo
// is that remainder rounded the same way, its low 13 bits left to the
// tensor core, which reads only the top 19 bits of a TF32 operand.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c += a b: a 16 x 8 (row), b 8 x 8 (col), TF32 in, f32 accumulate. Not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// n-tiles of a product taken together by `mma1688x3`
constexpr int kGroup = 4;

// c[j0 + i] += a b[i] for the NG n-tiles of a group, in split TF32: the
// small terms first, each term over the whole group before the next, so
// no MMA waits on the one before it.
template <int NG, int NT>
__device__ __forceinline__ void mma1688x3(float (&c)[NT][4], int j0, const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&bh)[NG][2],
                                          const uint32_t (&bl)[NG][2]) {
#pragma unroll
  for (int i = 0; i < NG; ++i) mma1688(c[j0 + i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < NG; ++i) mma1688(c[j0 + i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < NG; ++i) mma1688(c[j0 + i], ah, bh[i][0], bh[i][1]);
}

// acc[N/8] += X Y^T: x the warp's 16 rows, y N rows, both padded f32
// [*, DH]. A lane reads rows g and g + 8 of x (and row g of each 8-row
// tile of y) at head dims t and t + 4 of each k-step: banks 4g + t.
template <int DH, int N>
__device__ __forceinline__ void mma_xyt(float (&acc)[N / 8][4], const float* x, const float* y) {
  constexpr int LD = kLd<float, DH>, NG = N / 8 < kGroup ? N / 8 : kGroup;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    const float* xa = x + g * LD + kk * 8 + t;
    uint32_t ah[4], al[4];
    split_tf32(xa[0], ah[0], al[0]);           // (g, t)
    split_tf32(xa[8 * LD], ah[1], al[1]);      // (g + 8, t)
    split_tf32(xa[4], ah[2], al[2]);           // (g, t + 4)
    split_tf32(xa[8 * LD + 4], ah[3], al[3]);  // (g + 8, t + 4)
#pragma unroll
    for (int j0 = 0; j0 < N / 8; j0 += NG) {
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const float* yb = y + (8 * (j0 + i) + g) * LD + kk * 8 + t;
        split_tf32(yb[0], bh[i][0], bl[i][0]);  // (k t, n g)
        split_tf32(yb[4], bh[i][1], bl[i][1]);  // (k t + 4, n g)
      }
      mma1688x3(acc, j0, ah, al, bh, bl);
    }
  }
}

// acc[DH/8] += P Y: p the warp's 16 x N operand as f32 C fragments, y N
// rows of a padded f32 [*, DH] tile (the reduction runs over those N
// rows). k-step j takes the lane's columns 8j + 2t and + 1 of p as k-slots
// t and t + 4, and rows 8j + 2t and + 1 of y as B's rows t and t + 4; y is
// read down its columns, lane (g, t) at banks 8t + g.
template <int DH, int N>
__device__ __forceinline__ void mma_py(float (&acc)[DH / 8][4], const float (&p)[N / 8][4],
                                       const float* y) {
  constexpr int LD = kLd<float, DH>, NG = DH / 8 < kGroup ? DH / 8 : kGroup;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(p[j][0], ah[0], al[0]);  // (g, 8j + 2t)
    split_tf32(p[j][2], ah[1], al[1]);  // (g + 8, 8j + 2t)
    split_tf32(p[j][1], ah[2], al[2]);  // (g, 8j + 2t + 1)
    split_tf32(p[j][3], ah[3], al[3]);  // (g + 8, 8j + 2t + 1)
    const float* yb = y + (8 * j + 2 * t) * LD + g;
#pragma unroll
    for (int j0 = 0; j0 < DH / 8; j0 += NG) {
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        split_tf32(yb[8 * (j0 + i)], bh[i][0], bl[i][0]);       // row 8j + 2t, dim 8 jd + g
        split_tf32(yb[LD + 8 * (j0 + i)], bh[i][1], bl[i][1]);  // row 8j + 2t + 1
      }
      mma1688x3(acc, j0, ah, al, bh, bl);
    }
  }
}

// The C fragments of a 16 x N f32 product as the split-TF32 operand of the
// same matrix: kept in f32 and split per k-step by `mma_py`.
template <int N>
__device__ __forceinline__ void to_a(float (&a)[N / 8][4], const float (&c)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = c[j][e];
  }
}

// The operand type `to_a` fills for a policy: bf16 A fragments, or f32 C
// fragments.
template <typename T, int N>
struct POperandOf;
template <int N>
struct POperandOf<bf16, N> {
  using type = uint32_t[N / 16][4];
};
template <int N>
struct POperandOf<float, N> {
  using type = float[N / 8][4];
};
template <typename T, int N>
using POperand = typename POperandOf<T, N>::type;

// Whether a policy keeps a long sum out of the MMA accumulator: the tensor
// cores add into their f32 accumulator rounding toward zero, and over the
// thousands of MMAs of a sum over 8192+ keys that drift passes the f32
// tolerance (f32 K6 at S = 16384: 1.07e-4 x max|ref|). So in f32 a tile's
// product goes into a zeroed accumulator, added to the running sum by
// FADD or FFMA; bf16, held to 2e-2, keeps the sum in the MMA.
template <typename T>
constexpr bool kTileSums = sizeof(T) == 4;

// ---------------------------------------------------------------------------
// both policies
// ---------------------------------------------------------------------------

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
// walked key tile (keys, values, key bias), and the sums of the values of
// the keys a fully masked row has as columns but the walk skipped (its
// closed form): the keys past a causal block, or, for a sliding block,
// the window keys out of its walk, one sum per w-block the rows lie in.
template <int DH, typename T = bf16>
struct FwdTiles {
  static constexpr int LD = kLd<T, DH>;
  T q[kRows][LD];
  T k[2][kTile][LD], v[2][kTile][LD];
  float bias[2][kTile];
  float vsum[2][DH];
  unsigned probe[2][kWarps];
};

// Shared tiles of the dq pass: the CTA's 64 query rows and dO rows, and
// two buffers of the walked key tile (keys, values, key bias).
template <int DH, typename T = bf16>
struct DqTiles {
  static constexpr int LD = kLd<T, DH>;
  T q[kRows][LD], dout[kRows][LD];
  T k[2][kTile][LD], v[2][kTile][LD];
  float bias[2][kTile];
  unsigned probe[2][kWarps];
};

// Shared tiles of the dk/dv pass: the CTA's 64 keys and values, and two
// buffers of the walked query tile (queries, dO, the rows' raw statistics
// and delta). At dh 128 the walked tile is 32 rows, to keep the two
// accumulators, the scores and dP within the register file.
template <int DH, typename T = bf16>
struct DkvTiles {
  static constexpr int BN = DH >= 128 ? 32 : 64, LD = kLd<T, DH>;
  T k[kRows][LD], v[kRows][LD];
  T q[2][BN][LD], dout[2][BN][LD];
  float stat[2][3][BN];  // [buffer][raw statistic 0, 1, delta][row]
  unsigned probe[2][kWarps];
};

}  // namespace mma
}  // namespace attn
