// Distinct-value top-k selection shared by the search kernels
// (mips_topk.cu: K1; ivf_probe_topk.cu: K8).
//
// The rule of both TPU kernels: the result is the top-k of the DISTINCT
// score values, each reported with the lowest index (K1: corpus row; K8:
// probed-set position) that holds it. Scores of -3e38 (padding, masked or
// ignored rows) are never selected; an exhausted round reports
// (-3e38, empty).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>

namespace topk {

constexpr float kNegInf = -3.0e38f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// k rounds over the candidates a warp holds (NS per lane). Each round takes
// the largest remaining value, reports the lowest index holding it, and
// removes every candidate equal to it. Lane 0 writes out_v[r], out_i[r].
template <int NS>
__device__ void warp_select(float (&v)[NS], int (&id)[NS], int k, float* out_v,
                            int* out_i, int empty) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < k; ++r) {
    float m = kNegInf;
#pragma unroll
    for (int s = 0; s < NS; ++s) m = fmaxf(m, v[s]);
    m = warp_max(m);
    int best = empty;
    if (m > kNegInf) {  // warp-uniform
      best = INT_MAX;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (v[s] == m) {
          best = min(best, id[s]);
          v[s] = kNegInf;
        }
      }
      best = warp_min(best);
    }
    if (lane == 0) {
      out_v[r] = m;
      out_i[r] = best;
    }
  }
}

}  // namespace topk
