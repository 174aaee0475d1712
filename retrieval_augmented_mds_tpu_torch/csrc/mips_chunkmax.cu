// Phase 1 of the two-phase exact MIPS top-k: the scores and their
// per-128-column chunk maxima, for sm_90a.
//
// Replaces the TPU kernel `_chunkmax_kernel` of retrieval_augmented_mds_tpu/
// ops/mips_topk.py (called from `mips_topk_blocked`). Same contract:
//   scores[b, n] = q_b . e_n + row_bias[n], accumulated in f32, for a bf16
//   or f32 corpus (queries rounded to its type by the caller);
//   columns n >= N and the per-query ignored ids are -3e38;
//   cmax[b, c] = max of scores[b, 128c : 128c + 128].
// Phase 2 (the top chunks, their columns, the top-k of those) is plain
// PyTorch in ops/mips_topk.py, as it is XLA in the JAX package.
//
// What bounds it on an H100: bytes in bf16, operations in f32. At K1's
// serving shape (B = 256, N = 131072, D = 768) a bf16 corpus is 201 MB and
// the scores it writes 134 MB, ~0.1 ms at 3.35 TB/s, against 25.8 G
// multiply-adds, ~52 us at the bf16 tensor-core peak; an f32 corpus is 403
// MB (0.161 ms of bytes with the scores) against 51.5 GFLOP, 0.313 ms as
// split TF32 (0.769 ms on the CUDA cores).
//
// Design: K1's score tile (mips_tile.cuh: `mma.sync` tiles of 128 or 256
// corpus rows, one or two chunks, against NQ queries, D walked in
// `cp.async` slabs; bf16 products for a bf16 corpus, split TF32 with each
// slab summed apart for an f32 one). grid.x = groups of NQ queries,
// grid.y = splits of the corpus, so the query groups that read one corpus
// slab run together and share it through L2. After a tile, the scores
// (s = acc * 1 + bias, the expression K1 rounds) go to a shared [NQ][rows]
// f32 tile, columns >= N as -3e38; the query's few ignored ids that fall
// in the tile are then scattered to -3e38 there, with no loop per score.
// Each warp writes whole query rows of the tile, a chunk at a time (512
// contiguous bytes, four 128-byte segments), and takes the chunk's maximum
// from the same values with one warp reduction, after the scatter, so an
// ignored id never reaches a maximum (a maximum taken from the C fragments
// would include them). K10 and K1 walk D in the same order through the
// same code in both types, so their unmasked scores are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mips_tile.cuh"

namespace {

using mips::bf16;
using mips::kNegInf;
using mips::kThreads;
using mips::kWarps;
using topk::warp_max;

constexpr int kChunk = mips::kPartRows;  // columns per chunk maximum

// floats per row of the shared score tile: the tile's rows and 4 of padding
template <typename ET, int NQ>
constexpr int kLD = mips::Slab<ET, NQ>::ROWS + 4;

template <typename ET, int NQ, bool VEC>
__global__ void __launch_bounds__(kThreads)
chunkmax_mma_kernel(const typename mips::Slab<ET, NQ>::QT* __restrict__ q,
                    const ET* __restrict__ E,
                    const float* __restrict__ bias, const int* __restrict__ ignore,
                    int n_ignore, int B, int N, int D, int n_pad, int rows_per_split,
                    float* __restrict__ scores, float* __restrict__ cmax) {
  extern __shared__ __align__(16) char smem[];
  using S = mips::Slab<ET, NQ>;
  constexpr int MT = S::MT, LD = kLD<ET, NQ>;
  float* st = reinterpret_cast<float*>(smem + mips::kStages * S::kBytes);  // [NQ][LD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int qb0 = blockIdx.x * NQ;
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const int n_chunks = n_pad / kChunk;

  mips::walk_tiles<ET, NQ, VEC>(
      smem, E, q, row_begin, row_end, qb0, B, D,
      [&](mips::Acc<ET, NQ>& acc, int row0, char*) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * (MT * warp + i) + g + 8 * h, row = row0 + r;
            const float bi = bias && row < N ? bias[row] : 0.f;
#pragma unroll
            for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                st[(8 * j + 2 * t + e) * LD + r] =
                    row < N ? mips::score(acc[i][j][2 * h + e], 1.f, bi) : kNegInf;
          }
        __syncthreads();
        if (ignore) {
          for (int x = threadIdx.x; x < NQ * n_ignore; x += kThreads) {
            const int qi = x / n_ignore, b = qb0 + qi;
            if (b >= B) continue;
            const int id = ignore[(long)b * n_ignore + x % n_ignore];
            if (id >= row0 && id < row0 + S::ROWS && id < N) st[qi * LD + id - row0] = kNegInf;
          }
          __syncthreads();
        }
        // each warp writes whole query rows, one 128-column chunk at a time
        for (int qi = warp; qi < NQ && qb0 + qi < B; qi += kWarps) {
          const long b = qb0 + qi;
#pragma unroll
          for (int c = 0; c < MT; ++c) {
            const int col = row0 + c * kChunk;
            if (col >= n_pad) break;
            const float4 v = *reinterpret_cast<const float4*>(st + qi * LD + c * kChunk + 4 * lane);
            *reinterpret_cast<float4*>(scores + b * n_pad + col + 4 * lane) = v;
            const float m = warp_max(fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
            if (lane == 0) cmax[b * n_chunks + col / kChunk] = m;
          }
        }
        // the next write to st follows the walk's barrier of the next step
      });
}

struct Args {
  const void *q, *corpus, *bias, *ignore;
  int n_ignore, B, N, D, n_pad, rows_per_split, splits;
  void *scores, *cmax;
};

// The instance for ET and NQ queries: launches (layout null) or describes
// itself (mips::describe).
template <typename ET, int NQ, bool VEC>
cudaError_t run_mma(const Args& a, cudaStream_t s, int* layout) {
  using S = mips::Slab<ET, NQ>;
  auto kern = chunkmax_mma_kernel<ET, NQ, VEC>;
  const size_t smem = mips::kStages * S::kBytes + NQ * kLD<ET, NQ> * sizeof(float);
  if (layout) return mips::describe(kern, NQ, S::ROWS, smem, layout);
  if (a.rows_per_split % S::ROWS != 0) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + NQ - 1) / NQ, a.splits);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const typename S::QT*>(a.q), static_cast<const ET*>(a.corpus),
      static_cast<const float*>(a.bias), static_cast<const int*>(a.ignore), a.n_ignore, a.B,
      a.N, a.D, a.n_pad, a.rows_per_split, static_cast<float*>(a.scores),
      static_cast<float*>(a.cmax));
  return cudaGetLastError();
}

template <typename ET, bool VEC>
cudaError_t run_mma_nq(int nq, const Args& a, cudaStream_t s, int* layout) {
  switch (nq) {
    case 8: return run_mma<ET, 8, VEC>(a, s, layout);
    case 16: return run_mma<ET, 16, VEC>(a, s, layout);
    case 32: return run_mma<ET, 32, VEC>(a, s, layout);
    case 64: return run_mma<ET, 64, VEC>(a, s, layout);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(int dtype, int nq, int vec, const Args& a, cudaStream_t s, int* layout) {
  switch (dtype) {
    case 0:
      return vec ? run_mma_nq<float, true>(nq, a, s, layout)
                 : run_mma_nq<float, false>(nq, a, s, layout);
    case 1:
      return vec ? run_mma_nq<bf16, true>(nq, a, s, layout)
                 : run_mma_nq<bf16, false>(nq, a, s, layout);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The layout of the instance for dtype (0 = f32, 1 = bf16) and groups of
// nq = 8, 16, 32 or 64 queries, with 16-byte copies (vec = 1) or without:
// {queries per CTA, corpus rows per tile, dynamic shared memory in bytes,
// CTAs per SM on the current device (0: it does not fit)}, which the
// caller plans its splits from.
extern "C" int mips_chunkmax_layout(int dtype, int nq, int vec, int* layout) {
  return (int)run(dtype, nq, vec, Args{}, nullptr, layout);
}

// dtype: 0 = f32 (q f32 [B, D], split TF32), 1 = bf16 (q bf16 [B, D],
// rounded by the caller); groups of nq queries over splits of
// rows_per_split rows, a multiple of the tile's rows; vec = 1 when the row
// strides of q and the corpus in bytes are multiples of 16 and both
// pointers 16-byte aligned. bias [N] f32 or null; ignore [B, n_ignore]
// int32 or null. n_pad = N rounded up to a multiple of 128; scores
// [B, n_pad] and cmax [B, n_pad / 128] f32.
extern "C" int mips_chunkmax_launch(const void* q, const void* corpus, int dtype,
                                    const void* bias, const void* ignore, int n_ignore,
                                    int B, int N, int D, int n_pad, int nq, int vec,
                                    int rows_per_split, int splits, void* scores,
                                    void* cmax, void* stream) {
  if (n_pad % kChunk != 0 || n_pad < N) return (int)cudaErrorInvalidValue;
  const Args a{q, corpus, bias, ignore, n_ignore, B, N, D, n_pad, rows_per_split, splits,
               scores, cmax};
  return (int)run(dtype, nq, vec, a, static_cast<cudaStream_t>(stream), nullptr);
}
