// Dense attention rows, backward, for sm_90a. Two entry points share two
// kernels:
//
// K5, `dense_bwd_launch`, replaces the TPU kernel `_bwd_kernel` of
// retrieval_augmented_mds_tpu/ops/flash_dense.py (`flash_dense_backward`,
// S <= 4096), from the forward's row max m and denominator l (K4).
//
// K7, `dense_blocked_bwd_launch`, replaces the blocked backward kernels
// `_blocked_merged_bwd_kernel`, `_blocked_dq_kernel` and
// `_blocked_dkv_kernel` (`flash_dense_blocked_backward`, S > 4096), from
// one log-sum-exp per row (K6): p = exp(s - lse). There the JAX kernels
// give a fully masked row (an all-padding source) p = 1 per key, since its
// lse rounds to -1e9; K7 reads such a row (lse <= -1e8) as uniform over
// the S keys, p = 1/S, what the composite's VJP gives (attn_tile.cuh
// `LseStats`).
//
// Given delta = rowsum(dO * out), both recompute p tile by tile and return
//   dq = scale * sum_k ds . k,  dk = sum_q ds . (scale q),  dv = sum_q p . dO,
// with ds = p (dp - delta), dp = dO . v. As in the plain composite, a
// causal-masked column passes no gradient to q or k, while an additive key
// bias of -1e9 is part of the logit and does; a fully masked row is
// uniform over all S keys, so it reaches dv of every key.
//
// What bounds it on an H100: the TPU kernels recompute [wq, S] rows (or
// [wq, wk] blocks) in VMEM and accumulate dk/dv, and in the merged blocked
// kernel dq, over a sequential sweep of the grid. CTAs run in no order, so
// one design covers the merged and the split TPU variants: two passes that
// each own their output and need no atomics, a dq pass (a CTA per query
// tile walks the keys) and a dk/dv pass (a CTA per key tile walks the
// queries). A merged pass would need atomics into dq from every key tile:
// 512 tiles of 32 keys per (batch, head) at S = 16384, all adding into one
// 512 x 64 block. Both passes recompute the scores and dO . v: 4 + 4 of the
// 10 multiply-adds per (q, k) pair are done twice, on the f32 CUDA cores
// (no wgmma yet). They are bound by FMA and shared-memory issue; HBM
// traffic is a few passes over q, k, v and dO.

#include "attn_tile.cuh"

namespace {

using namespace attn;

template <int DH, typename T, typename Stats>
__global__ void __launch_bounds__(kThreads)
dense_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ key_bias, const T* __restrict__ dout, Stats stats,
                const float* __restrict__ delta, T* __restrict__ dq, int nh, int T_len,
                int S_len, int causal, float scale) {
  constexpr int BQ = Tile<DH>::BQ, R = Tile<DH>::R, DV = Tile<DH>::DV;
  extern __shared__ __align__(16) unsigned char smem[];
  DqSmem<DH>& sm = *reinterpret_cast<DqSmem<DH>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / nh;
  const int q0 = blockIdx.x * BQ, r0 = warp * R;
  const long qbase = (long)bh * T_len * DH, kbase = (long)bh * S_len * DH;
  const float* kb = key_bias + (long)b * S_len;

  stage_block<DH>(sm.q, q + qbase, q0, T_len, scale);
  stage_block<DH>(sm.dout, dout + qbase, q0, T_len, 1.f);
  RowStats<DH> rs;
  load_stats<DH>(rs, stats.shifted((long)bh * T_len), delta + (long)bh * T_len, q0 + r0,
                 T_len);
  float acc[R][DV] = {};

  // causal-masked keys pass no gradient to q: stop at the tile's last row
  const int hi = causal ? min(S_len, q0 + BQ) : S_len;
  for (int k0 = 0; k0 < hi; k0 += kBK) {
    __syncthreads();
    stage_t<DH>(sm.k, k + kbase, k0, hi, 1.f);
    stage_t<DH>(sm.v, v + kbase, k0, hi, 1.f);
    __syncthreads();
    const int pos = k0 + lane;
    const bool in = pos < hi;
    const float bias = in ? kb[pos] : 0.f;
    const auto mask = [&](int r, float s) {
      return (causal && pos > q0 + r0 + r) ? Logit{kMaskVal, false} : Logit{s + bias, true};
    };
    dq_tile<DH>(sm, rs, r0, in, mask, acc);
  }
  write_acc<DH>(acc, dq + qbase, q0 + r0, T_len, scale);
}

template <int DH, typename T, typename Stats>
__global__ void __launch_bounds__(kThreads)
dense_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ key_bias, const T* __restrict__ dout, Stats stats,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 int nh, int T_len, int S_len, int causal, float scale) {
  constexpr int BK = Tile<DH>::BQ, R = Tile<DH>::R, DV = Tile<DH>::DV;
  extern __shared__ __align__(16) unsigned char smem[];
  DkvSmem<DH>& sm = *reinterpret_cast<DkvSmem<DH>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / nh;
  const int k0 = blockIdx.x * BK, r0 = warp * R;
  const long qbase = (long)bh * T_len * DH, kbase = (long)bh * S_len * DH;
  const Stats st = stats.shifted((long)bh * T_len);

  stage_block<DH>(sm.k, k + kbase, k0, S_len, 1.f);
  stage_block<DH>(sm.v, v + kbase, k0, S_len, 1.f);
  float kbias[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kp = k0 + r0 + r;
    kbias[r] = kp < S_len ? key_bias[(long)b * S_len + kp] : 0.f;
  }
  float gk[R][DV] = {}, gv[R][DV] = {};

  for (int qt = 0; qt < T_len; qt += kBK) {
    if (causal && qt + kBK <= k0) {
      // every row of this tile is before every key of the CTA: only a
      // fully masked row (uniform, so its p reaches dv) contributes
      const int row = qt + threadIdx.x;
      const bool deg = threadIdx.x < kBK && row < T_len && st[row].x < kDegenerate;
      if (!__syncthreads_or(deg)) continue;
    }
    __syncthreads();
    stage_queries<DH>(sm, q + qbase, dout + qbase, st, delta + (long)bh * T_len, qt, T_len,
                      scale);
    __syncthreads();
    const int row = qt + lane;
    const auto mask = [&](int r, float s) {
      const int kp = k0 + r0 + r;
      return (kp >= S_len || (causal && kp > row)) ? Logit{kMaskVal, false}
                                                   : Logit{s + kbias[r], true};
    };
    dkv_tile<DH>(sm, r0, row < T_len, mask, gk, gv);
  }
  write_acc<DH>(gk, dk + kbase, k0 + r0, S_len, 1.f);
  write_acc<DH>(gv, dv + kbase, k0 + r0, S_len, 1.f);
}

template <int DH, typename T, typename Stats>
int launch(const void* q, const void* k, const void* v, const void* kb, const void* dout,
           Stats stats, const void* delta, void* dq, void* dk, void* dv, int BH, int nh,
           int T_len, int S_len, int causal, float scale, cudaStream_t s) {
  constexpr int BQ = Tile<DH>::BQ;
  int err = launch_dyn(dense_dq_kernel<DH, T, Stats>, dim3((T_len + BQ - 1) / BQ, BH),
                       sizeof(DqSmem<DH>), s, static_cast<const T*>(q),
                       static_cast<const T*>(k), static_cast<const T*>(v),
                       static_cast<const float*>(kb), static_cast<const T*>(dout), stats,
                       static_cast<const float*>(delta), static_cast<T*>(dq), nh, T_len,
                       S_len, causal, scale);
  if (err) return err;
  return launch_dyn(dense_dkv_kernel<DH, T, Stats>, dim3((S_len + BQ - 1) / BQ, BH),
                    sizeof(DkvSmem<DH>), s, static_cast<const T*>(q),
                    static_cast<const T*>(k), static_cast<const T*>(v),
                    static_cast<const float*>(kb), static_cast<const T*>(dout), stats,
                    static_cast<const float*>(delta), static_cast<T*>(dk),
                    static_cast<T*>(dv), nh, T_len, S_len, causal, scale);
}

template <typename T, typename Stats>
int launch_dh(int dh, const void* q, const void* k, const void* v, const void* kb,
              const void* dout, Stats stats, const void* delta, void* dq, void* dk,
              void* dv, int BH, int nh, int T_len, int S_len, int causal, float scale,
              cudaStream_t s) {
  switch (dh) {
    case 32:
      return launch<32, T>(q, k, v, kb, dout, stats, delta, dq, dk, dv, BH, nh, T_len,
                           S_len, causal, scale, s);
    case 64:
      return launch<64, T>(q, k, v, kb, dout, stats, delta, dq, dk, dv, BH, nh, T_len,
                           S_len, causal, scale, s);
    case 128:
      return launch<128, T>(q, k, v, kb, dout, stats, delta, dq, dk, dv, BH, nh, T_len,
                            S_len, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename Stats>
int launch_dtype(int dtype, int dh, const void* q, const void* k, const void* v,
                 const void* kb, const void* dout, Stats stats, const void* delta, void* dq,
                 void* dk, void* dv, int BH, int nh, int T_len, int S_len, int causal,
                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(dh, q, k, v, kb, dout, stats, delta, dq, dk, dv, BH, nh, T_len,
                            S_len, causal, scale, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, kb, dout, stats, delta, dq, dk, dv, BH, nh,
                                    T_len, S_len, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K5. dtype: 0 = f32, 1 = bf16. q/dout/dq [B*nh, T, dh]; k/v/dk/dv
// [B*nh, S, dh]; key_bias [B, S] f32; m/l/delta [B*nh, T] f32. Any T, S >= 1.
extern "C" int dense_bwd_launch(const void* q, const void* k, const void* v,
                                const void* key_bias, const void* dout, const void* m,
                                const void* l, const void* delta, void* dq, void* dk,
                                void* dv, int dtype, int B, int nh, int T_len, int S_len,
                                int dh, int causal, float scale, void* stream) {
  const MLStats stats{static_cast<const float*>(m), static_cast<const float*>(l)};
  return launch_dtype(dtype, dh, q, k, v, key_bias, dout, stats, delta, dq, dk, dv, B * nh,
                      nh, T_len, S_len, causal, scale, stream);
}

// K7. As K5, with lse [B*nh, T] f32 (K6) in place of m and l.
extern "C" int dense_blocked_bwd_launch(const void* q, const void* k, const void* v,
                                        const void* key_bias, const void* dout,
                                        const void* lse, const void* delta, void* dq,
                                        void* dk, void* dv, int dtype, int B, int nh,
                                        int T_len, int S_len, int dh, int causal,
                                        float scale, void* stream) {
  const LseStats stats{static_cast<const float*>(lse), static_cast<float>(S_len)};
  return launch_dtype(dtype, dh, q, k, v, key_bias, dout, stats, delta, dq, dk, dv, B * nh,
                      nh, T_len, S_len, causal, scale, stream);
}
