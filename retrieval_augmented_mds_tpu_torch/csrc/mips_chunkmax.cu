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
// What bounds it on an H100: bytes. At K1's serving shape (B = 256,
// N = 131072, D = 768, bf16) the corpus is 201 MB and the scores it writes
// 134 MB, ~0.1 ms at 3.35 TB/s, against 25.8 G multiply-adds, ~52 us at
// the bf16 tensor-core peak.
//
// Design (bf16): K1's score tile (mips_tile.cuh: `mma.sync` bf16 tiles of
// 128 or 256 corpus rows, one or two chunks, against NQ queries, D walked
// in `cp.async` slabs). grid.x = groups of NQ queries, grid.y = splits of
// the corpus, so the query groups that read one corpus slab run together
// and share it through L2. After a tile, the scores (s = acc * 1 + bias,
// the expression K1 rounds) go to a shared [NQ][rows] f32 tile, columns
// >= N as -3e38; the query's few ignored ids that fall in the tile are
// then scattered to -3e38 there, with no loop per score. Each warp writes
// whole query rows of the tile, a chunk at a time (512 contiguous bytes,
// four 128-byte segments), and takes the chunk's maximum from the same
// values with one warp reduction, after the scatter, so an ignored id
// never reaches a maximum (a maximum taken from the C fragments would
// include them). With a bf16 corpus
// K10 and K1 walk D in the same order through the same code, so their
// unmasked scores are bit-equal. The f32 corpus keeps the CUDA-core
// register tiles (TF32 would change its numerics).

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
template <int NQ>
constexpr int kLD = mips::Slab<bf16, NQ>::ROWS + 4;

template <int NQ, bool VEC>
__global__ void __launch_bounds__(kThreads)
chunkmax_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ E,
                    const float* __restrict__ bias, const int* __restrict__ ignore,
                    int n_ignore, int B, int N, int D, int n_pad, int rows_per_split,
                    float* __restrict__ scores, float* __restrict__ cmax) {
  extern __shared__ __align__(16) char smem[];
  using S = mips::Slab<bf16, NQ>;
  constexpr int MT = S::MT, LD = kLD<NQ>;
  float* st = reinterpret_cast<float*>(smem + mips::kStages * S::kBytes);  // [NQ][LD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int qb0 = blockIdx.x * NQ;
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const int n_chunks = n_pad / kChunk;

  mips::walk_tiles<bf16, NQ, VEC>(
      smem, E, q, row_begin, row_end, qb0, B, D,
      [&](mips::Acc<bf16, NQ>& acc, int row0, char*) {
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

// ---------------------------------------------------------------------------
// f32 corpus: CUDA-core register tiles
// ---------------------------------------------------------------------------

constexpr int kQB = 16;   // queries per CTA
constexpr int kRT = 256;  // corpus rows per CTA (two chunks)
constexpr int kKC = 16;   // depth staged per step

// A CTA owns 16 queries x one tile of 256 corpus rows; each thread owns 4
// queries x 4 rows, the corpus tile is staged transposed in shared memory
// in steps of 16 dims. The scores are written row-contiguous from
// registers; the tile then goes through shared memory, where one warp per
// query reduces each chunk with shuffles.
__global__ void __launch_bounds__(kThreads)
chunkmax_f32_kernel(const float* __restrict__ q, const float* __restrict__ E,
                    const float* __restrict__ bias, const int* __restrict__ ignore,
                    int n_ignore, int B, int N, int D, int n_pad, float* __restrict__ scores,
                    float* __restrict__ cmax) {
  __shared__ float Qs[kQB][kKC];
  __shared__ float Es[kKC * (kRT + 1)];  // reused as the [kQB][kRT] score tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qb0 = blockIdx.x * kQB;
  const int row0 = blockIdx.y * kRT;
  const int tq = tid >> 6, tr = tid & 63;  // 4 query groups x 64 row lanes

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kKC) {
    __syncthreads();
    {
      const int qi = tid / kKC, c = tid % kKC, b = qb0 + qi, d = d0 + c;
      Qs[qi][c] = (b < B && d < D) ? q[(long)b * D + d] : 0.f;
    }
    for (int e = tid; e < kRT * kKC; e += kThreads) {
      const int r = e / kKC, c = e % kKC, row = row0 + r, d = d0 + c;
      Es[c * (kRT + 1) + r] = (row < N && d < D) ? E[(long)row * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kKC; ++c) {
      float qv[4], ev[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[tq * 4 + i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) ev[j] = Es[c * (kRT + 1) + tr + 64 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], ev[j], acc[i][j]);
    }
  }
  __syncthreads();  // Es now becomes the score tile

  float* S = Es;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = tq * 4 + i, b = qb0 + qi;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tr + 64 * j, row = row0 + r;
      float s = kNegInf;
      if (row < N) {
        s = acc[i][j] + (bias ? bias[row] : 0.f);
        if (b < B) {
          for (int t = 0; t < n_ignore; ++t)
            if (ignore[(long)b * n_ignore + t] == row) s = kNegInf;
        }
      }
      S[qi * kRT + r] = s;
      if (b < B && row < n_pad) scores[(long)b * n_pad + row] = s;
    }
  }
  __syncthreads();

  // warp w reduces the chunks of queries 2w and 2w + 1
  const int n_chunks = n_pad / kChunk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = warp * 2 + h, b = qb0 + qi;
#pragma unroll
    for (int c = 0; c < kRT / kChunk; ++c) {
      float m = kNegInf;
#pragma unroll
      for (int x = lane; x < kChunk; x += 32) m = fmaxf(m, S[qi * kRT + c * kChunk + x]);
      m = warp_max(m);
      const int chunk = row0 / kChunk + c;
      if (lane == 0 && b < B && chunk < n_chunks) cmax[(long)b * n_chunks + chunk] = m;
    }
  }
}

// The bf16 instance for NQ queries: launches (layout null) or describes
// itself (mips::describe).
template <int NQ, bool VEC>
cudaError_t run_mma(const void* q, const void* corpus, const void* bias, const void* ignore,
                    int n_ignore, int B, int N, int D, int n_pad, int rows_per_split,
                    int splits, void* scores, void* cmax, cudaStream_t s, int* layout) {
  auto kern = chunkmax_mma_kernel<NQ, VEC>;
  constexpr int kRows = mips::Slab<bf16, NQ>::ROWS;
  const size_t smem =
      mips::kStages * mips::Slab<bf16, NQ>::kBytes + NQ * kLD<NQ> * sizeof(float);
  if (layout) return mips::describe(kern, NQ, kRows, smem, layout);
  if (rows_per_split % kRows != 0) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + NQ - 1) / NQ, splits);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(corpus),
      static_cast<const float*>(bias), static_cast<const int*>(ignore), n_ignore, B, N, D,
      n_pad, rows_per_split, static_cast<float*>(scores), static_cast<float*>(cmax));
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t run_mma_nq(int nq, const void* q, const void* corpus, const void* bias,
                       const void* ignore, int n_ignore, int B, int N, int D, int n_pad,
                       int rows_per_split, int splits, void* scores, void* cmax,
                       cudaStream_t s, int* layout) {
#define MIPS_CHUNKMAX_NQ(NQ)                                                               \
  case NQ:                                                                                 \
    return run_mma<NQ, VEC>(q, corpus, bias, ignore, n_ignore, B, N, D, n_pad,             \
                            rows_per_split, splits, scores, cmax, s, layout);
  switch (nq) {
    MIPS_CHUNKMAX_NQ(8)
    MIPS_CHUNKMAX_NQ(16)
    MIPS_CHUNKMAX_NQ(32)
    MIPS_CHUNKMAX_NQ(64)
    default: return cudaErrorInvalidValue;
  }
#undef MIPS_CHUNKMAX_NQ
}

cudaError_t run_mma_vec(int nq, int vec, const void* q, const void* corpus, const void* bias,
                        const void* ignore, int n_ignore, int B, int N, int D, int n_pad,
                        int rows_per_split, int splits, void* scores, void* cmax,
                        cudaStream_t s, int* layout) {
  return vec ? run_mma_nq<true>(nq, q, corpus, bias, ignore, n_ignore, B, N, D, n_pad,
                                rows_per_split, splits, scores, cmax, s, layout)
             : run_mma_nq<false>(nq, q, corpus, bias, ignore, n_ignore, B, N, D, n_pad,
                                 rows_per_split, splits, scores, cmax, s, layout);
}

}  // namespace

// The layout of the bf16 instance for groups of nq = 8, 16, 32 or 64
// queries, with 16-byte copies (vec = 1) or without: {queries per CTA,
// corpus rows per tile, dynamic shared memory in bytes, CTAs per SM on the
// current device (0: it does not fit)}, which the caller plans its splits
// from.
extern "C" int mips_chunkmax_layout(int nq, int vec, int* layout) {
  return (int)run_mma_vec(nq, vec, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, 0, 0, 0,
                          nullptr, nullptr, nullptr, layout);
}

// dtype: 0 = f32 (q f32 [B, D]; 256-row CTAs), 1 = bf16 (q bf16 [B, D],
// rounded by the caller; groups of nq queries over splits of
// rows_per_split rows, a multiple of the tile's rows; vec = 1 when D is a
// multiple of 8 and both pointers are 16-byte aligned). bias [N] f32 or
// null; ignore [B, n_ignore] int32 or null. n_pad = N rounded up to a
// multiple of 128; scores [B, n_pad] and cmax [B, n_pad / 128] f32.
extern "C" int mips_chunkmax_launch(const void* q, const void* corpus, int dtype,
                                    const void* bias, const void* ignore, int n_ignore,
                                    int B, int N, int D, int n_pad, int nq, int vec,
                                    int rows_per_split, int splits, void* scores,
                                    void* cmax, void* stream) {
  if (n_pad % kChunk != 0 || n_pad < N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((B + kQB - 1) / kQB, (n_pad + kRT - 1) / kRT);
    chunkmax_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(corpus),
        static_cast<const float*>(bias), static_cast<const int*>(ignore), n_ignore, B, N, D,
        n_pad, static_cast<float*>(scores), static_cast<float*>(cmax));
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)run_mma_vec(nq, vec, q, corpus, bias, ignore, n_ignore, B, N, D, n_pad,
                          rows_per_split, splits, scores, cmax, s, nullptr);
}
