// Per-query IVF probe top-k, for sm_90a.
//
// Replaces the TPU kernel `_kernel` of retrieval_augmented_mds_tpu/index/
// ivf_serving.py (called from `ivf_search_serving`). Same contract: for each
// query i and each probe p < nprobe, cluster cid = probes[i, p] is scored,
//   s = (q_i . e) * scale[cid, slot] + bias[cid, slot], accumulated in f32
// (the caller rounds q to bf16 for an int8 or bf16 payload, as K1's does),
// and the result is the top-k of the DISTINCT score values over the query's
// probed rows, each with the lowest position p * L + slot holding it (the
// earlier probe rank, then the lower slot). Empty slots are (-3e38, INT_MAX);
// padding rows (bias -3e38) are never selected.
//
// What bounds it on an H100: bytes. At the serving shape (B = 4 queries,
// nprobe = 32, L = 1536 rows of D = 768 int8) the probed rows are 151 MB,
// ~45 us at 3.35 TB/s, against 0.3 GFLOP of multiply-adds (~5 us on the f32
// CUDA cores). The design keeps HBM busy: many blocks, 16-byte loads.
//
// Design: the TPU runs one grid step per query and streams its nprobe
// clusters through a double-buffered DMA chain; on the H100 that would be
// B blocks on 132 SMs. Here pass 1 launches one block per (query, probe,
// 256-row slice of the cluster); each block reads its probe id itself.
// Every warp scores 32 rows, 4 at a time: each lane loads 16-byte chunks of
// the rows (lane l takes chunks l, l + 32, ...), multiplies them with the
// query held in shared memory as f32, and the warp sums its lanes. The
// block's 256 scores go to shared memory and one warp selects their top-k
// distinct values (`topk::warp_select`, shared with K1), written as a
// partial list. Pass 2, one block per query, merges the nprobe * slices
// partial lists under the same rule. The merge is exact: a value among the
// top-k distinct values of the query is among those of every slice holding
// it, reported there with that slice's lowest position. No cp.async or TMA
// pipelining and no int8 dp4a/wgmma score yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

using topk::kNegInf;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 256;                    // cluster rows per block
constexpr int kRowsPerWarp = kRows / kWarps;  // 32
constexpr int kRU = 4;                        // rows a warp loads together
constexpr int kSlots = kRows / 32;            // candidates per lane in the select
constexpr int kMaxD = 8192;
constexpr int kMaxK = 128;

// One 16-byte chunk of a payload row times the matching query values.
template <typename ET>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ float dot(const uint4& r, const float* qs, float acc) {
    const float4 a = *reinterpret_cast<const float4*>(qs);
    acc = fmaf(a.x, __uint_as_float(r.x), acc);
    acc = fmaf(a.y, __uint_as_float(r.y), acc);
    acc = fmaf(a.z, __uint_as_float(r.z), acc);
    acc = fmaf(a.w, __uint_as_float(r.w), acc);
    return acc;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  static __device__ __forceinline__ float two(unsigned w, float q0, float q1, float acc) {
    acc = fmaf(q0, __uint_as_float(w << 16), acc);  // element 2j: the low half
    return fmaf(q1, __uint_as_float(w & 0xffff0000u), acc);
  }
  static __device__ __forceinline__ float dot(const uint4& r, const float* qs, float acc) {
    const float4 a = *reinterpret_cast<const float4*>(qs);
    const float4 b = *reinterpret_cast<const float4*>(qs + 4);
    acc = two(r.x, a.x, a.y, acc);
    acc = two(r.y, a.z, a.w, acc);
    acc = two(r.z, b.x, b.y, acc);
    return two(r.w, b.z, b.w, acc);
  }
};

template <>
struct Chunk<int8_t> {
  static constexpr int kElems = 16;
  static __device__ __forceinline__ float four(unsigned w, const float4& a, float acc) {
    // little-endian: byte j is element j; sign-extended by the shifts
    acc = fmaf(a.x, __int2float_rn(static_cast<int>(w << 24) >> 24), acc);
    acc = fmaf(a.y, __int2float_rn(static_cast<int>(w << 16) >> 24), acc);
    acc = fmaf(a.z, __int2float_rn(static_cast<int>(w << 8) >> 24), acc);
    return fmaf(a.w, __int2float_rn(static_cast<int>(w) >> 24), acc);
  }
  static __device__ __forceinline__ float dot(const uint4& r, const float* qs, float acc) {
    const float4* a = reinterpret_cast<const float4*>(qs);
    acc = four(r.x, a[0], acc);
    acc = four(r.y, a[1], acc);
    acc = four(r.z, a[2], acc);
    return four(r.w, a[3], acc);
  }
};

template <typename ET>
__global__ void __launch_bounds__(kThreads)
ivf_probe_partial_kernel(const float* __restrict__ q, const ET* __restrict__ clustered,
                         const float* __restrict__ bias, const float* __restrict__ scale,
                         const int* __restrict__ probes, int P, int L, int D, int k,
                         int splits, float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ __align__(16) float qs[];  // [D] this query, f32
  __shared__ float S[kRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int p = blockIdx.x / splits, split = blockIdx.x - p * splits;
  const int cid = probes[b * P + p];
  const int row0 = split * kRows;
  const int nrows = min(kRows, L - row0);
  for (int d = tid; d < D; d += kThreads) qs[d] = q[(long)b * D + d];
  __syncthreads();

  constexpr int E = Chunk<ET>::kElems;
  const int cpr = D / E;  // 16-byte chunks per row
  const long first = (long)cid * L + row0;
  const uint4* rows = reinterpret_cast<const uint4*>(clustered) + first * cpr;
  for (int r0 = warp * kRowsPerWarp; r0 < (warp + 1) * kRowsPerWarp; r0 += kRU) {
    if (r0 >= nrows) {  // warp-uniform
      if (lane < kRU) S[r0 + lane] = kNegInf;
      continue;
    }
    float acc[kRU];
#pragma unroll
    for (int u = 0; u < kRU; ++u) acc[u] = 0.f;
    for (int c = lane; c < cpr; c += 32) {
      uint4 raw[kRU];
#pragma unroll
      for (int u = 0; u < kRU; ++u)
        raw[u] = r0 + u < nrows ? __ldg(rows + (long)(r0 + u) * cpr + c)
                                : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < kRU; ++u) acc[u] = Chunk<ET>::dot(raw[u], qs + c * E, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < kRU; ++u) {
      const float a = topk::warp_sum(acc[u]);
      const int r = r0 + u;
      if (lane == 0) {
        float s = kNegInf;
        if (r < nrows) {
          const long o = first + r;
          s = __fadd_rn(__fmul_rn(a, scale ? scale[o] : 1.f), bias[o]);
        }
        S[r] = s;
      }
    }
  }
  __syncthreads();

  if (warp == 0) {
    float v[kSlots];
    int id[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int r = lane + 32 * s;
      v[s] = S[r];
      id[s] = p * L + row0 + r;
    }
    const long o = ((long)b * gridDim.x + blockIdx.x) * k;
    topk::warp_select(v, id, k, part_v + o, part_i + o, INT_MAX);
  }
}

// One block per query: k selection rounds over its n_cand partial
// candidates, removed ones overwritten in the scratch buffer.
__global__ void __launch_bounds__(kThreads)
ivf_merge_kernel(float* __restrict__ part_v, const int* __restrict__ part_i, int n_cand,
                 int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  float* pv = part_v + (long)b * n_cand;
  const int* pi = part_i + (long)b * n_cand;
  for (int r = 0; r < k; ++r) {
    float m = kNegInf;
    for (int j = tid; j < n_cand; j += kThreads) m = fmaxf(m, pv[j]);
    m = topk::warp_max(m);
    if (lane == 0) red_v[warp] = m;
    __syncthreads();
    m = red_v[0];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_v[w]);
    int best = INT_MAX;
    if (m > kNegInf) {  // block-uniform
      for (int j = tid; j < n_cand; j += kThreads) {
        if (pv[j] == m) {
          best = min(best, pi[j]);
          pv[j] = kNegInf;
        }
      }
    }
    best = topk::warp_min(best);
    if (lane == 0) red_i[warp] = best;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) best = min(best, red_i[w]);
      out_v[(long)b * k + r] = m;
      out_i[(long)b * k + r] = best;
    }
    __syncthreads();  // red_v and red_i are reused by the next round
  }
}

template <typename ET>
cudaError_t launch_partial(const float* q, const void* clustered, const float* bias,
                           const float* scale, const int* probes, int B, int P, int L,
                           int D, int k, int splits, float* pv, int* pi, cudaStream_t s) {
  ivf_probe_partial_kernel<ET><<<dim3(P * splits, B), kThreads, D * sizeof(float), s>>>(
      q, static_cast<const ET*>(clustered), bias, scale, probes, P, L, D, k, splits, pv, pi);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = int8. q is f32 [B, D] (already rounded to
// the payload's compute type by the caller); clustered is [C, L, D] with a
// 16-byte aligned base; bias [C, L] f32; scale [C, L] f32 or null; probes
// [B, P] int32. part_* are [B, P * splits, k] scratch, splits = ceil(L / 256).
extern "C" int ivf_probe_topk_launch(const void* q, const void* clustered, int dtype,
                                     const void* bias, const void* scale,
                                     const void* probes, int B, int P, int L, int D,
                                     int k, int splits, void* part_v, void* part_i,
                                     void* out_v, void* out_i, void* stream) {
  if (k < 1 || k > kMaxK || D % 16 != 0 || D > kMaxD || B < 1 || P < 1 || L < 1 ||
      splits != (L + kRows - 1) / kRows ||
      reinterpret_cast<uintptr_t>(clustered) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* bf = static_cast<const float*>(bias);
  const float* sf = static_cast<const float*>(scale);
  const int* pr = static_cast<const int*>(probes);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_partial<float>(qf, clustered, bf, sf, pr, B, P, L, D, k, splits, pv, pi, s);
      break;
    case 1:
      err = launch_partial<__nv_bfloat16>(qf, clustered, bf, sf, pr, B, P, L, D, k, splits,
                                          pv, pi, s);
      break;
    case 2:
      err = launch_partial<int8_t>(qf, clustered, bf, sf, pr, B, P, L, D, k, splits, pv, pi, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  ivf_merge_kernel<<<B, kThreads, 0, s>>>(pv, pi, P * splits * k, k,
                                          static_cast<float*>(out_v),
                                          static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
