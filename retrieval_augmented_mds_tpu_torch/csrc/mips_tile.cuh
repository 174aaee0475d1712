// The bf16 tensor-core score tile shared by the MIPS kernels (K1:
// mips_topk.cu, K10: mips_chunkmax.cu).
//
// A CTA of 8 warps owns NQ queries (8, 16, 32 or 64) and walks tiles of
// ROWS corpus rows, computing for each tile
//
//   acc[rows, queries] = E_tile . Q^T,  bf16 operands, f32 accumulators,
//
// with `mma.sync` m16n8k16 (the operand helpers of attn_mma.cuh): the
// corpus rows are the M side and the queries the N side, so a batch of 4
// queries wastes half of one n8 tile. Warp w owns MT m16 tiles, rows
// 16 MT w .. 16 MT (w + 1) - 1: MT = 1 (ROWS = 128) for NQ <= 16, where
// the corpus bytes bound the kernel and small tiles keep more CTAs, and
// bytes, in flight; MT = 2 (ROWS = 256) for NQ >= 32, where each B
// fragment then feeds two MMAs and each query slab serves 256 rows, which
// halves the shared-memory reads per product and the query bytes per tile.
// Lane (g, t) ends a tile holding, for m-tile i and n-tile j,
//   acc[i][j][2h + e] = score of row 16 (MT w + i) + g + 8h, query 8j + 2t + e.
//
// D is walked in slabs of 128 bytes of a corpus row (64 bf16 or 128 int8
// dims), and the (tile, slab) steps of a CTA form one flat sequence that
// runs through kStages `cp.async` buffers: the loads of step i + 2 are in
// flight while step i multiplies. Every shared row is padded by 16 bytes
// (row pitches of 144 and 272 bytes are 4 words past a multiple of 32), so
// the 8 rows an `ldmatrix` phase reads fall on distinct banks.
//
// int8 (SQ8) rows arrive as bytes and are widened to bf16 straight into
// the A fragments (2-byte shared loads, -127..127 exact in bf16) without a
// conversion instruction (`widen4`: an I2F issues at 16 a clock on an SM,
// a byte permute or an FADD at 64 or more); the per-row scale is applied
// to the score, as the TPU kernel does. Queries arrive as bf16 (the
// wrapper rounds them), always through `ldmatrix`.
//
// VEC = true takes 16-byte `cp.async` copies; it needs both row strides in
// bytes (D * sizeof(ET) and D * 2) to be multiples of 16 and the base
// pointers 16-byte aligned, which the wrappers check. VEC = false copies
// element by element, synchronously, for the odd widths of small corpora;
// the wrappers never pad or copy the corpus.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "topk_select.cuh"

namespace mips {

using bf16 = __nv_bfloat16;
using attn::mma::cp_async16;
using attn::mma::cp_async_commit;
using attn::mma::cp_async_wait;
using attn::mma::ldsm_x4;
using attn::mma::mma16816;
using attn::mma::pack_bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
// The kernels report the layout these give (`mips_topk_layout`,
// `mips_chunkmax_layout`), from which ops/mips_topk.py plans its splits.
constexpr int kPartRows = 128;   // rows per tile of one m16 tile per warp
constexpr int kSlabBytes = 128;  // bytes of a corpus row per slab
constexpr int kPadBytes = 16;
constexpr int kStages = 3;
using topk::kNegInf;

template <typename ET, int NQ>
struct Slab {
  static constexpr int MT = NQ >= 32 ? 2 : 1;              // m16 tiles per warp
  static constexpr int ROWS = kPartRows * MT;              // corpus rows per tile
  static constexpr int KS = kSlabBytes / (int)sizeof(ET);  // dims per slab
  static constexpr int E_LD = kSlabBytes + kPadBytes;      // bytes per corpus row
  static constexpr int Q_LD = KS * 2 + kPadBytes;          // bytes per query row
  static constexpr int kBytes = ROWS * E_LD + NQ * Q_LD;   // one stage
};

// Load slab d0 .. d0 + KS of tile rows row0 .. row0 + ROWS (rows at or past
// row_end are zero) and of queries qb0 .. qb0 + NQ - 1 (those at or past B
// are zero) into one stage; dims at or past D are zero.
template <typename ET, int NQ, bool VEC>
__device__ __forceinline__ void load_slab(char* stage, const ET* __restrict__ E,
                                          const bf16* __restrict__ Q, int row0,
                                          int row_end, int qb0, int B, int D, int d0) {
  using S = Slab<ET, NQ>;
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
    constexpr int kQC = S::KS * 2 / 16;  // chunks per query row
    for (int i = threadIdx.x; i < NQ * kQC; i += kThreads) {
      const int r = i / kQC, c = i % kQC, b = qb0 + r, d = d0 + c * 8;
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
      bf16 v{};
      if (b < B && d < D) v = Q[(long)b * D + d];
      reinterpret_cast<bf16*>(qs + r * S::Q_LD)[c] = v;
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

// acc += the warp's MT x 16 rows of one staged slab times its NQ queries.
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
// once every thread has passed a barrier in it, until it returns.
template <typename ET, int NQ, bool VEC, typename Epilogue>
__device__ __forceinline__ void walk_tiles(char* stages, const ET* __restrict__ E,
                                           const bf16* __restrict__ Q, int row_begin,
                                           int row_end, int qb0, int B, int D,
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
  auto zero = [&] {
#pragma unroll
    for (int i = 0; i < S::MT; ++i)
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  };
  zero();
  for (int step = 0; step < total; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's stage has landed; the stage refilled below is free
    issue(step + kStages - 1);
    char* stage = stages + (step % kStages) * S::kBytes;
    mma_slab<ET, NQ>(acc, stage);
    if (step % n_slab == n_slab - 1) {
      epilogue(acc, row_begin + (step / n_slab) * S::ROWS, stage);
      zero();
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
