// The tensor-core score tile shared by the MIPS kernels (K1:
// mips_topk.cu, K10: mips_chunkmax.cu; K8's ivf_probe_topk.cu reads its
// bf16/int8 slabs).
//
// A CTA of 8 warps owns NQ queries (8, 16, 32 or 64) and walks tiles of
// ROWS corpus rows, computing for each tile
//
//   acc[rows, queries] = E_tile . Q^T,  f32 accumulators,
//
// with `mma.sync` (the operand helpers of attn_mma.cuh): the corpus rows
// are the M side and the queries the N side, so a batch of 4 queries
// wastes half of one n8 tile. Warp w owns MT m16 tiles, rows
// 16 MT w .. 16 MT (w + 1) - 1: MT = 1 (ROWS = 128) for NQ <= 16, where
// the corpus bytes bound the kernel and small tiles keep more CTAs, and
// bytes, in flight; MT = 2 (ROWS = 256) for NQ >= 32, where each B
// fragment then feeds two MMAs and each query slab serves 256 rows, which
// halves the shared-memory reads per product and the query bytes per tile.
// Lane (g, t) ends a tile holding, for m-tile i and n-tile j,
//   acc[i][j][2h + e] = score of row 16 (MT w + i) + g + 8h, query 8j + 2t + e
// (the C fragment of m16n8k16 and of m16n8k8 alike).
//
// D is walked in slabs of 128 bytes of a corpus row (32 f32, 64 bf16 or
// 128 int8 dims), and the (tile, slab) steps of a CTA form one flat
// sequence that runs through kStages `cp.async` buffers: the loads of
// step i + 2 are in flight while step i multiplies. Every shared row is
// padded by 16 bytes (row pitches of 144 and 272 bytes are 4 words past a
// multiple of 32), so the 8 rows an `ldmatrix` phase reads fall on
// distinct banks.
//
// Three operand policies, by the corpus type ET:
//
// - bf16: m16n8k16 on bf16 rows and bf16 queries (the wrapper rounds
//   them), both through `ldmatrix`.
// - int8 (SQ8): rows arrive as bytes and are widened to bf16 straight into
//   the A fragments (2-byte shared loads, -127..127 exact in bf16) without
//   a conversion instruction (`widen4`: an I2F issues at 16 a clock on an
//   SM, a byte permute or an FADD at 64 or more); the per-row scale is
//   applied to the score, as the TPU kernel does. Queries are bf16.
// - f32: split TF32 ("3xTF32", attn_mma.cuh `split_tf32`), m16n8k8 on f32
//   rows and f32 queries. Each operand x is split in registers into
//   hi = rna(x) and lo = rna(x - hi), and a product runs as three MMAs,
//   lo.hi' + hi.lo' + hi.hi': the dropped lo.lo' and lo's own rounding
//   leave ~2^-21 of each |x y|, f32 accuracy, where one TF32 pass keeps
//   ~2^-11. `ldmatrix` moves b16 only, so both fragments come from 32-bit
//   shared loads; at the 144-byte pitch (36 words) lane (g, t) reads word
//   36 (r0 + g) + 8 kk + t (+ 4, + 8 rows) of the corpus slab and word
//   36 (8 j + g) + 8 kk + t (+ 4) of the query slab, bank 4 g + t (+ a
//   constant) in both: the 32 lanes of every A and B load fall on 32
//   distinct banks. A warp splits each corpus fragment once per k-step
//   (it feeds NQ / 8 n-tiles) and each query fragment once per k-step and
//   slab (it feeds MT m-tiles): once per slab and warp, not per MMA. The
//   tensor cores' f32 accumulation truncates (attn_mma.cuh `kTileSums`):
//   an MMA cuts its sum toward zero at the magnitude of its accumulator.
//   So f32 multiplies each slab (4 k-steps, 12 MMAs) into a zeroed
//   accumulator and adds it to the tile's running score with an FADD
//   (round to nearest); the truncations then cost a few ulps of one slab's
//   sum, not of the whole score. bf16 and int8 keep the whole sum in the
//   MMA accumulator, as before.
//
// VEC = true takes 16-byte `cp.async` copies; it needs both row strides in
// bytes (D * sizeof(ET) and D * sizeof(QT)) to be multiples of 16 and the
// base pointers 16-byte aligned, which the wrappers check. VEC = false
// copies element by element, synchronously, for the odd widths of small
// corpora (the retriever's l2 route, D = 769); the wrappers never pad or
// copy the corpus.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_mma.cuh"
#include "topk_select.cuh"

namespace mips {

using bf16 = __nv_bfloat16;
using attn::mma::cp_async16;
using attn::mma::cp_async_commit;
using attn::mma::cp_async_wait;
using attn::mma::ldsm_x4;
using attn::mma::mma1688x3;
using attn::mma::mma16816;
using attn::mma::pack_bf16;
using attn::mma::split_tf32;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
// The kernels report the layout these give (`mips_topk_layout`,
// `mips_chunkmax_layout`), from which ops/mips_topk.py plans its splits.
constexpr int kPartRows = 128;   // rows per tile of one m16 tile per warp
constexpr int kSlabBytes = 128;  // bytes of a corpus row per slab
constexpr int kPadBytes = 16;
constexpr int kStages = 3;
using topk::kNegInf;

template <typename ET>
constexpr bool kF32 = std::is_same<ET, float>::value;

template <typename ET, int NQ>
struct Slab {
  using QT = std::conditional_t<kF32<ET>, float, bf16>;   // the queries' type
  static constexpr int MT = NQ >= 32 ? 2 : 1;              // m16 tiles per warp
  static constexpr int ROWS = kPartRows * MT;              // corpus rows per tile
  static constexpr int KS = kSlabBytes / (int)sizeof(ET);  // dims per slab
  static constexpr int E_LD = kSlabBytes + kPadBytes;      // bytes per corpus row
  static constexpr int Q_LD = KS * (int)sizeof(QT) + kPadBytes;  // bytes per query row
  static constexpr int kBytes = ROWS * E_LD + NQ * Q_LD;   // one stage
};

// Load slab d0 .. d0 + KS of tile rows row0 .. row0 + ROWS (rows at or past
// row_end are zero) and of queries qb0 .. qb0 + NQ - 1 (those at or past B
// are zero) into one stage; dims at or past D are zero.
template <typename ET, int NQ, bool VEC>
__device__ __forceinline__ void load_slab(char* stage, const ET* __restrict__ E,
                                          const typename Slab<ET, NQ>::QT* __restrict__ Q,
                                          int row0, int row_end, int qb0, int B, int D,
                                          int d0) {
  using S = Slab<ET, NQ>;
  using QT = typename S::QT;
  char* es = stage;
  char* qs = stage + S::ROWS * S::E_LD;
  if constexpr (VEC) {
    constexpr int kEC = kSlabBytes / 16;                 // chunks per corpus row
    constexpr int kEE = 16 / (int)sizeof(ET);            // dims per corpus chunk
    for (int i = threadIdx.x; i < S::ROWS * kEC; i += kThreads) {
      const int r = i / kEC, c = i % kEC, row = row0 + r, d = d0 + c * kEE;
      const bool ok = row < row_end && d < D;
      cp_async16(es + r * S::E_LD + c * 16, E + (ok ? (long)row * D + d : 0), ok);
    }
    constexpr int kQC = S::KS * (int)sizeof(QT) / 16;  // chunks per query row
    constexpr int kQE = 16 / (int)sizeof(QT);          // dims per query chunk
    for (int i = threadIdx.x; i < NQ * kQC; i += kThreads) {
      const int r = i / kQC, c = i % kQC, b = qb0 + r, d = d0 + c * kQE;
      const bool ok = b < B && d < D;
      cp_async16(qs + r * S::Q_LD + c * 16, Q + (ok ? (long)b * D + d : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < S::ROWS * S::KS; i += kThreads) {
      const int r = i / S::KS, c = i % S::KS, row = row0 + r, d = d0 + c;
      ET v{};
      if (row < row_end && d < D) v = E[(long)row * D + d];
      reinterpret_cast<ET*>(es + r * S::E_LD)[c] = v;
    }
    for (int i = threadIdx.x; i < NQ * S::KS; i += kThreads) {
      const int r = i / S::KS, c = i % S::KS, b = qb0 + r, d = d0 + c;
      QT v{};
      if (b < B && d < D) v = Q[(long)b * D + d];
      reinterpret_cast<QT*>(qs + r * S::Q_LD)[c] = v;
    }
  }
}

// The A fragment of k-step kk for the 16 rows from r0 of a staged slab.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const char* es, int r0, int kk,
                                       const bf16*) {
  constexpr int LD = Slab<bf16, 8>::E_LD;
  const int lane = threadIdx.x & 31;
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ac = (lane >> 4) * 8;
  ldsm_x4(a, reinterpret_cast<const bf16*>(es + (r0 + ar) * LD + (kk * 16 + ac) * 2));
}

// int8: the four bytes of a little-endian word -> two bf16 pairs (bytes 0,
// 1 to lo, bytes 2, 3 to hi), exactly: a byte b becomes the f32 2^23 +
// (b ^ 128) by a byte permute into 0x4B000000, one FADD takes 2^23 + 128
// off, and the bf16 is the f32's upper half (exact for |b| <= 128).
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // b + 128 in each byte
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Lane (g, t) widens dims 2t, 2t + 1 and 2t + 8, 2t + 9 of rows g and g + 8
// (two 2-byte loads a row) into k-slots 2t, 2t + 1 (a[0], a[1]) and 2t + 8,
// 2t + 9 (a[2], a[3]): the bf16 fragment layout, so the queries keep theirs.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const char* es, int r0, int kk,
                                       const int8_t*) {
  constexpr int LD = Slab<int8_t, 8>::E_LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const char* p = es + (r0 + g) * LD + kk * 16 + 2 * t;
  auto pair = [](const char* x) {
    return (uint32_t)*reinterpret_cast<const uint16_t*>(x) |
           (uint32_t)*reinterpret_cast<const uint16_t*>(x + 8) << 16;
  };
  widen4(pair(p), a[0], a[2]);
  widen4(pair(p + 8 * LD), a[1], a[3]);
}

template <typename ET, int NQ>
using Acc = float[Slab<ET, NQ>::MT][NQ / 8][4];

// f32: acc += the warp's MT x 16 rows of one staged slab times its NQ
// queries in split TF32, k-step by k-step (8 dims): the MT corpus
// fragments split once, then each group of n-tiles' query fragments split
// once and fed to the MT m-tiles, three MMAs each (`mma1688x3`: the small
// terms first), all into acc.
template <int NQ>
__device__ __forceinline__ void mma_slab_tf32(Acc<float, NQ>& acc, const char* stage) {
  using S = Slab<float, NQ>;
  static_assert(S::E_LD == S::Q_LD, "one pitch for corpus and query rows");
  constexpr int MT = S::MT, NT = NQ / 8, LD = S::E_LD / 4;  // LD in words
  constexpr int NG = NT < attn::mma::kGroup ? NT : attn::mma::kGroup;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * MT * (threadIdx.x >> 5);
  const float* es = reinterpret_cast<const float*>(stage) + (r0 + g) * LD + t;
  const float* qs = reinterpret_cast<const float*>(stage + S::ROWS * S::E_LD) + g * LD + t;
#pragma unroll
  for (int kk = 0; kk < S::KS / 8; ++kk) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* x = es + 16 * i * LD + 8 * kk;
      split_tf32(x[0], ah[i][0], al[i][0]);           // (g, t)
      split_tf32(x[8 * LD], ah[i][1], al[i][1]);      // (g + 8, t)
      split_tf32(x[4], ah[i][2], al[i][2]);           // (g, t + 4)
      split_tf32(x[8 * LD + 4], ah[i][3], al[i][3]);  // (g + 8, t + 4)
    }
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += NG) {
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const float* y = qs + 8 * (j0 + j) * LD + 8 * kk;
        split_tf32(y[0], bh[j][0], bl[j][0]);  // (k t, n g)
        split_tf32(y[4], bh[j][1], bl[j][1]);  // (k t + 4, n g)
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) mma1688x3<NG, NT>(acc[i], j0, ah[i], al[i], bh, bl);
    }
  }
}

// bf16, int8: acc += the warp's MT x 16 rows of one staged slab times its
// NQ queries.
template <typename ET, int NQ>
__device__ __forceinline__ void mma_slab(Acc<ET, NQ>& acc, const char* stage) {
  using S = Slab<ET, NQ>;
  constexpr int MT = S::MT;
  const char* es = stage;
  const char* qs = stage + S::ROWS * S::E_LD;
  const int lane = threadIdx.x & 31, r0 = 16 * MT * (threadIdx.x >> 5);
  const ET* tag = nullptr;
  if constexpr (NQ == 8) {
    // one x4 load of the 8 query rows gives the B fragments of two k-steps
    const bf16* qp = reinterpret_cast<const bf16*>(qs + (lane & 7) * S::Q_LD) + (lane >> 3) * 8;
#pragma unroll
    for (int kk = 0; kk < S::KS / 16; kk += 2) {
      uint32_t b[4];
      ldsm_x4(b, qp + kk * 16);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a0[4], a1[4];
        a_frag(a0, es, r0 + 16 * i, kk, tag);
        a_frag(a1, es, r0 + 16 * i, kk + 1, tag);
        mma16816(acc[i][0], a0, b[0], b[1]);
        mma16816(acc[i][0], a1, b[2], b[3]);
      }
    }
  } else {
    // as attn_mma.cuh's mma_xyt: one x4 load gives two n-tiles of a k-step
    const int br = (lane & 7) + (lane >> 4) * 8, bc = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < S::KS / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) a_frag(a[i], es, r0 + 16 * i, kk, tag);
#pragma unroll
      for (int jn = 0; jn < NQ / 16; ++jn) {
        uint32_t b[4];
        ldsm_x4(b, reinterpret_cast<const bf16*>(qs + (jn * 16 + br) * S::Q_LD) + kk * 16 + bc);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma16816(acc[i][2 * jn], a[i], b[0], b[1]);
          mma16816(acc[i][2 * jn + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
}

// Walk tiles row_begin, row_begin + ROWS, ... < row_end of the corpus over
// D, one flat pipeline of (tile, slab) steps. After the last slab of each
// tile, epilogue(acc, row0, scratch) runs with every thread of the CTA (it
// may synchronise); acc is zeroed for the next tile after it returns.
// scratch is the stage just multiplied (kBytes): free for the epilogue
// once every thread has passed a barrier in it, until it returns. f32
// (`kTileSums`) multiplies each slab into a zeroed accumulator and adds it
// to acc; bf16 and int8 multiply into acc.
template <typename ET, int NQ, bool VEC, typename Epilogue>
__device__ __forceinline__ void walk_tiles(char* stages, const ET* __restrict__ E,
                                           const typename Slab<ET, NQ>::QT* __restrict__ Q,
                                           int row_begin, int row_end, int qb0, int B, int D,
                                           Epilogue&& epilogue) {
  using S = Slab<ET, NQ>;
  const int n_slab = (D + S::KS - 1) / S::KS;
  const int n_tile = row_end > row_begin ? (row_end - row_begin + S::ROWS - 1) / S::ROWS : 0;
  const int total = n_tile * n_slab;
  auto issue = [&](int step) {
    if (step < total) {
      const int tile = step / n_slab, slab = step % n_slab;
      load_slab<ET, NQ, VEC>(stages + (step % kStages) * S::kBytes, E, Q,
                             row_begin + tile * S::ROWS, row_end, qb0, B, D, slab * S::KS);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  Acc<ET, NQ> acc;
  auto zero = [](Acc<ET, NQ>& x) {
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) x[i][j][c] = 0.f;
  };
  zero(acc);
  for (int step = 0; step < total; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's stage has landed; the stage refilled below is free
    issue(step + kStages - 1);
    char* stage = stages + (step % kStages) * S::kBytes;
    if constexpr (kF32<ET>) {
      static_assert(attn::mma::kTileSums<ET>, "f32 sums each slab apart");
      Acc<ET, NQ> part;  // this slab's product alone
      zero(part);
      mma_slab_tf32<NQ>(part, stage);
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] = __fadd_rn(acc[i][j][c], part[i][j][c]);
    } else {
      mma_slab<ET, NQ>(acc, stage);
    }
    if (step % n_slab == n_slab - 1) {
      epilogue(acc, row_begin + (step / n_slab) * S::ROWS, stage);
      zero(acc);
    }
  }
  cp_async_wait<0>();
}

// layout = {queries per CTA, corpus rows per tile, dynamic shared memory in
// bytes, CTAs per SM on the current device (0: the shared memory does not
// fit)} of kernel instance `kern`, launched with kThreads threads.
template <typename K>
cudaError_t describe(K kern, int nq, int rows, size_t smem, int* layout) {
  layout[0] = nq;
  layout[1] = rows;
  layout[2] = (int)smem;
  layout[3] = 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess) {
    cudaGetLastError();  // too large for this device: no CTA fits
    return cudaSuccess;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(layout + 3, kern, kThreads, smem);
}

// s = (acc * scale) + bias, rounded step by step in the JAX order.
__device__ __forceinline__ float score(float acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(acc, scale), bias);
}

}  // namespace mips
