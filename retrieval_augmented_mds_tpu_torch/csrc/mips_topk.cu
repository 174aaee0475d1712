// Exact maximum-inner-product top-k over a flat corpus, for sm_90a.
//
// Replaces the TPU kernel `_kernel` of retrieval_augmented_mds_tpu/ops/
// mips_topk.py (called from `mips_topk`). Same contract:
//   scores = (q . e) * row_scale + row_bias, accumulated in f32;
//   columns >= N and per-query ignored ids are masked to -3e38;
//   the result is the top-k of the DISTINCT score values, each reported with
//   the lowest corpus index that holds it; leftover slots are (-3e38, -1).
//
// What bounds it on an H100: at the serving shape (B=256 queries, N=131072
// rows, D=768, bf16) the corpus is 201 MB, one pass over it ~60 us of HBM
// time, while the B*N*D = 25.8 G multiply-adds take ~0.8 ms even at the
// full f32 CUDA-core rate. This first kernel keeps the products on the
// CUDA cores (no wgmma yet), so it is bound by FMA issue and shared-memory
// reads, not by HBM.
//
// Design: pass 1 splits the corpus across CTAs (grid.x = splits) and the
// queries into groups of 16 (grid.y). A CTA runs a register-tiled f32 GEMM
// over its rows in 256-row tiles: each thread owns 4 queries x 4 rows, the
// corpus tile is staged transposed in shared memory and dequantised on load
// (bf16 -> f32, int8 -> f32 then * row_scale on the score), so each corpus
// element is read from HBM once per 16 queries. After every tile the 256
// new scores of a query are merged with its running top-k in shared memory
// by one warp: k rounds of (warp max, lowest index among equal values,
// remove every equal value; `topk::warp_select`, shared with K8). Pass 2
// merges the per-split lists [B, splits, k] with the same rule. The merge is exact: a value among the
// global top-k distinct values is among the top-k distinct values of every
// split holding it, reported there with that split's lowest index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

using topk::kNegInf;
using topk::warp_max;
using topk::warp_min;

constexpr int kQB = 16;       // queries per CTA
constexpr int kRT = 256;      // corpus rows per tile
constexpr int kKC = 16;       // depth staged per step
constexpr int kThreads = 256;
constexpr int kMaxK = 128;
constexpr int kNewSlots = kRT / 32;           // tile candidates per lane
constexpr int kRunSlots = kMaxK / 32;         // running candidates per lane

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f(const int8_t* p, long i) {
  return static_cast<float>(p[i]);
}

template <typename ET>
__global__ void __launch_bounds__(kThreads)
mips_partial_kernel(const float* __restrict__ q, const ET* __restrict__ E,
                    const float* __restrict__ bias, const float* __restrict__ scale,
                    const int* __restrict__ ignore, int n_ignore, int B, int N,
                    int D, int k, int rows_per_split, float* __restrict__ part_v,
                    int* __restrict__ part_i) {
  __shared__ float Qs[kQB][kKC];
  __shared__ float Es[kKC * (kRT + 1)];  // reused as the [kQB][kRT] score tile
  __shared__ float Rv[kQB][kMaxK];
  __shared__ int Ri[kQB][kMaxK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, splits = gridDim.x;
  const int qb0 = blockIdx.y * kQB;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const int tq = tid >> 6, tr = tid & 63;  // 4 query groups x 64 row lanes

  for (int i = tid; i < kQB * kMaxK; i += kThreads) {
    Rv[i / kMaxK][i % kMaxK] = kNegInf;
    Ri[i / kMaxK][i % kMaxK] = -1;
  }

  for (int row0 = row_begin; row0 < row_end; row0 += kRT) {
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
        Es[c * (kRT + 1) + r] =
            (row < row_end && d < D) ? load_f(E, (long)row * D + d) : 0.f;
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tq * 4 + i, r = tr + 64 * j, row = row0 + r, b = qb0 + qi;
        float s = kNegInf;
        if (row < row_end) {
          const float sc = scale ? scale[row] : 1.f;
          const float bi = bias ? bias[row] : 0.f;
          s = __fadd_rn(__fmul_rn(acc[i][j], sc), bi);
          if (b < B) {
            for (int t = 0; t < n_ignore; ++t)
              if (ignore[(long)b * n_ignore + t] == row) s = kNegInf;
          }
        }
        S[qi * kRT + r] = s;
      }
    }
    __syncthreads();

    // warp w merges queries 2w and 2w+1 into their running lists
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = warp * 2 + h;
      float v[kNewSlots + kRunSlots];
      int id[kNewSlots + kRunSlots];
#pragma unroll
      for (int s = 0; s < kNewSlots; ++s) {
        v[s] = S[qi * kRT + lane + 32 * s];
        id[s] = row0 + lane + 32 * s;
      }
#pragma unroll
      for (int s = 0; s < kRunSlots; ++s) {
        const int kk = lane + 32 * s;
        v[kNewSlots + s] = kk < k ? Rv[qi][kk] : kNegInf;
        id[kNewSlots + s] = kk < k ? Ri[qi][kk] : INT_MAX;
      }
      __syncwarp();
      topk::warp_select(v, id, k, Rv[qi], Ri[qi], -1);
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < kQB * k; i += kThreads) {
    const int qi = i / k, kk = i % k, b = qb0 + qi;
    if (b < B) {
      const long o = ((long)b * splits + split) * k + kk;
      part_v[o] = Rv[qi][kk];
      part_i[o] = Ri[qi][kk];
    }
  }
}

// One warp per query: k selection rounds over its splits*k candidates.
// Removed candidates are overwritten in the scratch buffer.
__global__ void __launch_bounds__(kThreads)
mips_merge_kernel(float* __restrict__ part_v, const int* __restrict__ part_i,
                  int B, int n_cand, int k, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warp
  float* pv = part_v + (long)b * n_cand;
  const int* pi = part_i + (long)b * n_cand;
  for (int r = 0; r < k; ++r) {
    float m = kNegInf;
    for (int j = lane; j < n_cand; j += 32) m = fmaxf(m, pv[j]);
    m = warp_max(m);
    int best = -1;
    if (m > kNegInf) {
      best = INT_MAX;
      for (int j = lane; j < n_cand; j += 32) {
        if (pv[j] == m) {
          best = min(best, pi[j]);
          pv[j] = kNegInf;
        }
      }
      best = warp_min(best);
    }
    if (lane == 0) {
      out_v[(long)b * k + r] = m;
      out_i[(long)b * k + r] = best;
    }
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = int8. q is f32 [B, D] (already rounded to the
// corpus's compute type by the caller); bias/scale may be null; ignore is
// [B, n_ignore] int32 or null. part_* are [B, splits, k] scratch.
extern "C" int mips_topk_launch(const void* q, const void* corpus, int dtype,
                                const void* bias, const void* scale,
                                const void* ignore, int n_ignore, int B, int N,
                                int D, int k, int rows_per_split, int splits,
                                void* part_v, void* part_i, void* out_v,
                                void* out_i, void* stream) {
  if (k < 1 || k > kMaxK || rows_per_split % kRT != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(splits, (B + kQB - 1) / kQB);
  const float* qf = static_cast<const float*>(q);
  const float* bf = static_cast<const float*>(bias);
  const float* sf = static_cast<const float*>(scale);
  const int* ig = static_cast<const int*>(ignore);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  switch (dtype) {
    case 0:
      mips_partial_kernel<float><<<grid, kThreads, 0, s>>>(
          qf, static_cast<const float*>(corpus), bf, sf, ig, n_ignore, B, N, D,
          k, rows_per_split, pv, pi);
      break;
    case 1:
      mips_partial_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          qf, static_cast<const __nv_bfloat16*>(corpus), bf, sf, ig, n_ignore,
          B, N, D, k, rows_per_split, pv, pi);
      break;
    case 2:
      mips_partial_kernel<int8_t><<<grid, kThreads, 0, s>>>(
          qf, static_cast<const int8_t*>(corpus), bf, sf, ig, n_ignore, B, N,
          D, k, rows_per_split, pv, pi);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mips_merge_kernel<<<(B + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(
      pv, pi, B, splits * k, k, static_cast<float*>(out_v),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
