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
// What bounds it on an H100: at K1's serving shape (B = 256, N = 131072,
// D = 768, bf16) the corpus is 201 MB and the scores it writes 134 MB, one
// pass over both ~0.1 ms of HBM time, while the B*N*D = 25.8 G
// multiply-adds take ~0.8 ms even at the full f32 CUDA-core rate. This
// first kernel keeps the products on the CUDA cores (no wgmma yet), so it
// is bound by FMA issue and shared-memory reads, not by HBM.
//
// Design: K1's register-tiled f32 GEMM (mips_topk.cu) without its running
// selection. A CTA owns 16 queries x one tile of 256 corpus rows (two
// chunks); each thread owns 4 queries x 4 rows, the corpus tile is staged
// transposed in shared memory in steps of 16 dims and converted to f32 on
// load. grid.x walks the query groups, so the CTAs that read one corpus
// tile run together and share it through L2, and the corpus comes from HBM
// about once. The scores are written row-contiguous from registers; the
// tile then goes through shared memory, where one warp per query reduces
// each chunk with shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQB = 16;        // queries per CTA
constexpr int kRT = 256;       // corpus rows per CTA
constexpr int kKC = 16;        // depth staged per step
constexpr int kChunk = 128;    // columns per chunk maximum
constexpr int kThreads = 256;  // 8 warps
constexpr float kNegInf = -3.0e38f;

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename ET>
__global__ void __launch_bounds__(kThreads)
chunkmax_kernel(const float* __restrict__ q, const ET* __restrict__ E,
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
      Es[c * (kRT + 1) + r] = (row < N && d < D) ? load_f(E, (long)row * D + d) : 0.f;
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

}  // namespace

// dtype: 0 = f32, 1 = bf16. q is f32 [B, D] (already rounded to the
// corpus's type by the caller); bias [N] f32 or null; ignore [B, n_ignore]
// int32 or null. n_pad = N rounded up to a multiple of 128; scores
// [B, n_pad] and cmax [B, n_pad / 128] f32.
extern "C" int mips_chunkmax_launch(const void* q, const void* corpus, int dtype,
                                    const void* bias, const void* ignore, int n_ignore,
                                    int B, int N, int D, int n_pad, void* scores,
                                    void* cmax, void* stream) {
  if (n_pad % kChunk != 0 || n_pad < N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kQB - 1) / kQB, (n_pad + kRT - 1) / kRT);
  const float* qf = static_cast<const float*>(q);
  const float* bf = static_cast<const float*>(bias);
  const int* ig = static_cast<const int*>(ignore);
  float* sc = static_cast<float*>(scores);
  float* cm = static_cast<float*>(cmax);
  switch (dtype) {
    case 0:
      chunkmax_kernel<float><<<grid, kThreads, 0, s>>>(
          qf, static_cast<const float*>(corpus), bf, ig, n_ignore, B, N, D, n_pad, sc, cm);
      break;
    case 1:
      chunkmax_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          qf, static_cast<const __nv_bfloat16*>(corpus), bf, ig, n_ignore, B, N, D, n_pad,
          sc, cm);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
