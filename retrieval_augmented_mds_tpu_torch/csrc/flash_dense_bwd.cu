// Dense attention rows, backward, for sm_90a. Two entry points share one
// design:
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
// Two passes that each own their output, so no atomics and the same bits
// on every run: a dq pass (a CTA per 64-row query tile walks the key
// tiles) and a dk/dv pass (a CTA per 64-key tile walks the query tiles).
// The TPU kernels sweep their grid in order and may carry dq across it
// (the merged kernel); CTAs run in no order, so one pair of passes covers
// the merged and the split TPU variants. Both passes recompute the scores
// and dO . v: 4 + 4 of the 10 multiply-adds per (q, k) pair run twice.
//
// What bounds it on an H100, and what the design does about it:
//
// - bf16 (every led_base slice): tensor-core issue, then bytes. The five
//   products per tile pair (S = Q K^T, dP = dO V^T, dV += P^T dO,
//   dK += dS^T Q, dQ += dS K) are `mma.sync` m16n8k16 MMAs on bf16
//   shared-memory tiles (attn_mma.cuh), f32 accumulators; P and dS are
//   rounded to bf16 only as operands, the statistics, delta and the
//   exponentials stay f32. 64 x 64 tiles, 4 warps of 16 rows; the walked
//   tile is double-buffered by `cp.async` with its key bias or row
//   statistics, so it loads while the previous one computes.
// - Padding: sources are mostly padding (97% of a 16384-token one on the
//   fixture). A key tile whose every bias is <= -1e9 gives each row with
//   an open key p = exp(<= -9e8 + s) = 0 in f32, so ds = 0 and the tile
//   adds exactly nothing: the dq pass skips such tiles when every row of
//   its block has an open key (m > kDegenerate, or lse > kLseDegenerate),
//   and a dk/dv CTA whose key tile is masked whole walks only the query
//   tiles that hold a fully masked row (as it already does for query
//   tiles wholly before its keys under the causal mask). Fully masked rows
//   are computed over every key, as the uniform row needs.
// - f32 (the tiny smoke config, held to the CPU at 1e-4): the CUDA-core
//   tiles of attn_tile.cuh, FMA-bound, shared with K3; no TF32.

#include "attn_mma.cuh"
#include "attn_tile.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// bf16: tensor-core passes
// ---------------------------------------------------------------------------

template <int DH, typename Stats>
__global__ void __launch_bounds__(kThreads, DH >= 128 ? 2 : 3)
mma_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
              const __nv_bfloat16* __restrict__ dout, Stats stats,
              const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int nh,
              int T_len, int S_len, int causal, float scale) {
  using namespace attn::mma;
  extern __shared__ __align__(16) unsigned char smem[];
  DqTiles<DH>& sm = *reinterpret_cast<DqTiles<DH>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / nh, q0 = blockIdx.x * kRows;
  const long qbase = (long)bh * T_len * DH, kbase = (long)bh * S_len * DH;
  const float* kb = key_bias + (long)b * S_len;
  const Stats st = stats.shifted((long)bh * T_len);

  load_rows<DH, kRows>(&sm.q[0][0], q + qbase, q0, T_len);
  load_rows<DH, kRows>(&sm.dout[0][0], dout + qbase, q0, T_len);
  cp_async_commit();

  // this lane's two rows: g and g + 8 of the warp's 16
  int row[2];
  float m[2], rl[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    const bool ok = row[h] < T_len;
    const float2 ml = ok ? st[row[h]] : make_float2(0.f, 1.f);
    m[h] = ml.x;
    rl[h] = 1.f / ml.y;
    dl[h] = ok ? delta[(long)bh * T_len + row[h]] : 0.f;
  }
  // a key tile masked whole adds nothing to rows that each have an open key
  const int r = q0 + threadIdx.x;
  const bool skip =
      __syncthreads_and(threadIdx.x >= kRows || r >= T_len || st[r].x > kDegenerate);
  // causal-masked keys pass no gradient to q: stop at the block's last row
  const int hi = causal ? min(S_len, q0 + kRows) : S_len;
  const int n = (hi + kTile - 1) / kTile;
  int parity = 0;
  const auto open_key = [&](int p) { return p < hi && kb[p] > kMaskVal; };
  const auto next = [&](int kt) {
    return skip ? next_marked_tile<kTile, 8>(kt, n, open_key, sm.probe, parity) : kt;
  };
  const auto fetch = [&](int kt, int buf) {
    if (kt < n) {
      load_rows<DH, kTile>(&sm.k[buf][0][0], k + kbase, kt * kTile, hi);
      load_rows<DH, kTile>(&sm.v[buf][0][0], v + kbase, kt * kTile, hi);
      load_vec<kTile>(sm.bias[buf], kb, kt * kTile, hi);
    }
    cp_async_commit();
  };

  float acc[DH / 8][4] = {};
  int cur = next(0), buf = 0;
  fetch(cur, 0);
  while (cur < n) {
    const int nxt = next(cur + 1);
    fetch(nxt, buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int j0 = 0; j0 < kTile; j0 += kSub) {  // kSub keys at a time
      float s[kSub / 8][4] = {}, dp[kSub / 8][4] = {};
      mma_xyt<DH, kSub>(s, &sm.q[warp * 16][0], &sm.k[buf][j0][0]);
      mma_xyt<DH, kSub>(dp, &sm.dout[warp * 16][0], &sm.v[buf][j0][0]);
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, c = j0 + 8 * j + 2 * t + (e & 1), key = cur * kTile + c;
          const bool grad = key < hi && !(causal && key > row[h]);
          const float p = __expf(s[j][e] * scale + sm.bias[buf][c] - m[h]) * rl[h];
          s[j][e] = grad ? p * (dp[j][e] - dl[h]) : 0.f;  // ds
        }
      }
      uint32_t ds[kSub / 16][4];
      to_a<kSub>(ds, s);
      mma_py<DH, kSub>(acc, ds, &sm.k[buf][j0][0]);
    }
    __syncthreads();
    cur = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();
  store_rows<DH>(acc, dq + qbase, q0 + warp * 16, T_len, scale);
}

template <int DH, typename Stats>
__global__ void __launch_bounds__(kThreads, DH >= 128 ? 2 : 3)
mma_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
               const __nv_bfloat16* __restrict__ dout, Stats stats,
               const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int nh, int T_len, int S_len, int causal,
               float scale) {
  using namespace attn::mma;
  constexpr int BN = DkvTiles<DH>::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  DkvTiles<DH>& sm = *reinterpret_cast<DkvTiles<DH>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / nh, k0 = blockIdx.x * kRows;
  const long qbase = (long)bh * T_len * DH, kbase = (long)bh * S_len * DH;
  const float* kb = key_bias + (long)b * S_len;
  const Stats st = stats.shifted((long)bh * T_len);
  const float* dl = delta + (long)bh * T_len;

  // this lane's two keys: g and g + 8 of the warp's 16
  int key[2];
  float kbias[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = k0 + warp * 16 + g + 8 * h;
    kbias[h] = key[h] < S_len ? kb[key[h]] : 0.f;
  }
  // every key of the block masked by its bias: rows with an open key give
  // them p = 0, so only fully masked rows reach them
  const int kp = k0 + threadIdx.x;
  const bool masked =
      __syncthreads_and(threadIdx.x >= kRows || kp >= S_len || kb[kp] <= kMaskVal);
  const int n = (T_len + BN - 1) / BN;
  // under the causal mask, query tiles wholly before the block's keys see
  // none of them; the same holds for every row with an open key when the
  // block is masked. Such tiles count only if they hold a fully masked row.
  const int before = causal ? min(n, k0 / BN) : 0;
  const auto degenerate = [&](int r) { return r < T_len && !(st[r].x > kDegenerate); };
  int parity = 0;
  const auto next = [&](int it) {
    if (!masked && it >= before) return it;
    return next_marked_tile<BN, 4>(it, masked ? n : before, degenerate, sm.probe, parity);
  };
  const auto fetch = [&](int it, int buf) {
    if (it < n) {
      const int qt = it * BN;
      load_rows<DH, BN>(&sm.q[buf][0][0], q + qbase, qt, T_len);
      load_rows<DH, BN>(&sm.dout[buf][0][0], dout + qbase, qt, T_len);
#pragma unroll
      for (int a = 0; a < Stats::kRaw; ++a) load_vec<BN>(sm.stat[buf][a], st.raw(a), qt, T_len);
      load_vec<BN>(sm.stat[buf][2], dl, qt, T_len);
    }
    cp_async_commit();
  };

  float gk[DH / 8][4] = {}, gv[DH / 8][4] = {};
  int cur = next(0), buf = 0;
  if (cur < n) {  // the block's keys and values join the first tile's group
    load_rows<DH, kRows>(&sm.k[0][0], k + kbase, k0, S_len);
    load_rows<DH, kRows>(&sm.v[0][0], v + kbase, k0, S_len);
  }
  fetch(cur, 0);
  while (cur < n) {
    const int nxt = next(cur + 1);
    fetch(nxt, buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int j0 = 0; j0 < BN; j0 += kSub) {  // kSub query rows at a time
      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys
      float s[kSub / 8][4] = {}, dp[kSub / 8][4] = {};
      mma_xyt<DH, kSub>(s, &sm.k[warp * 16][0], &sm.q[buf][j0][0]);
      mma_xyt<DH, kSub>(dp, &sm.v[warp * 16][0], &sm.dout[buf][j0][0]);
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {  // this lane's columns 8 j + 2 t and + 1
          const int c = j0 + 8 * j + 2 * t + c2, qr = cur * BN + c;
          const float2 ml =
              st.decode(sm.stat[buf][0][c], Stats::kRaw > 1 ? sm.stat[buf][1][c] : 0.f);
          const float rl = 1.f / ml.y, dlc = sm.stat[buf][2][c];
          const bool in = qr < T_len;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + c2;
            const bool off = key[h] >= S_len || (causal && key[h] > qr);
            const float logit = off ? kMaskVal : s[j][e] * scale + kbias[h];
            const float p = in ? __expf(logit - ml.x) * rl : 0.f;
            s[j][e] = p;
            dp[j][e] = (in && !off) ? p * (dp[j][e] - dlc) : 0.f;  // ds
          }
        }
      }
      uint32_t a[kSub / 16][4];
      to_a<kSub>(a, s);
      mma_py<DH, kSub>(gv, a, &sm.dout[buf][j0][0]);
      to_a<kSub>(a, dp);
      mma_py<DH, kSub>(gk, a, &sm.q[buf][j0][0]);
    }
    __syncthreads();
    cur = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();
  store_rows<DH>(gk, dk + kbase, k0 + warp * 16, S_len, scale);
  store_rows<DH>(gv, dv + kbase, k0 + warp * 16, S_len, 1.f);
}

template <int DH, typename Stats>
int launch_mma(const void* q, const void* k, const void* v, const void* kb, const void* dout,
               Stats stats, const void* delta, void* dq, void* dk, void* dv, int BH, int nh,
               int T_len, int S_len, int causal, float scale, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  constexpr int R = mma::kRows;
  int err = launch_dyn(mma_dq_kernel<DH, Stats>, dim3((T_len + R - 1) / R, BH),
                       sizeof(mma::DqTiles<DH>), s, static_cast<const bf16*>(q),
                       static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                       static_cast<const float*>(kb), static_cast<const bf16*>(dout), stats,
                       static_cast<const float*>(delta), static_cast<bf16*>(dq), nh, T_len,
                       S_len, causal, scale);
  if (err) return err;
  return launch_dyn(mma_dkv_kernel<DH, Stats>, dim3((S_len + R - 1) / R, BH),
                    sizeof(mma::DkvTiles<DH>), s, static_cast<const bf16*>(q),
                    static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                    static_cast<const float*>(kb), static_cast<const bf16*>(dout), stats,
                    static_cast<const float*>(delta), static_cast<bf16*>(dk),
                    static_cast<bf16*>(dv), nh, T_len, S_len, causal, scale);
}

// ---------------------------------------------------------------------------
// f32: CUDA-core passes (attn_tile.cuh)
// ---------------------------------------------------------------------------

template <int DH, typename Stats>
__global__ void __launch_bounds__(kThreads)
dense_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ key_bias,
                const float* __restrict__ dout, Stats stats, const float* __restrict__ delta,
                float* __restrict__ dq, int nh, int T_len, int S_len, int causal, float scale) {
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

template <int DH, typename Stats>
__global__ void __launch_bounds__(kThreads)
dense_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ key_bias,
                 const float* __restrict__ dout, Stats stats, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int nh, int T_len, int S_len,
                 int causal, float scale) {
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

template <int DH, typename Stats>
int launch_f32(const void* q, const void* k, const void* v, const void* kb, const void* dout,
               Stats stats, const void* delta, void* dq, void* dk, void* dv, int BH, int nh,
               int T_len, int S_len, int causal, float scale, cudaStream_t s) {
  constexpr int BQ = Tile<DH>::BQ;
  int err = launch_dyn(dense_dq_kernel<DH, Stats>, dim3((T_len + BQ - 1) / BQ, BH),
                       sizeof(DqSmem<DH>), s, static_cast<const float*>(q),
                       static_cast<const float*>(k), static_cast<const float*>(v),
                       static_cast<const float*>(kb), static_cast<const float*>(dout), stats,
                       static_cast<const float*>(delta), static_cast<float*>(dq), nh, T_len,
                       S_len, causal, scale);
  if (err) return err;
  return launch_dyn(dense_dkv_kernel<DH, Stats>, dim3((S_len + BQ - 1) / BQ, BH),
                    sizeof(DkvSmem<DH>), s, static_cast<const float*>(q),
                    static_cast<const float*>(k), static_cast<const float*>(v),
                    static_cast<const float*>(kb), static_cast<const float*>(dout), stats,
                    static_cast<const float*>(delta), static_cast<float*>(dk),
                    static_cast<float*>(dv), nh, T_len, S_len, causal, scale);
}

// dtype 0 (f32) on the CUDA-core kernels, 1 (bf16) on the tensor-core ones
template <typename Stats>
int launch_dtype(int dtype, int dh, const void* q, const void* k, const void* v,
                 const void* kb, const void* dout, Stats stats, const void* delta, void* dq,
                 void* dk, void* dv, int BH, int nh, int T_len, int S_len, int causal,
                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
#define ARGS q, k, v, kb, dout, stats, delta, dq, dk, dv, BH, nh, T_len, S_len, causal, scale, s
  switch (dh) {
    case 32:
      return bf16 ? launch_mma<32>(ARGS) : launch_f32<32>(ARGS);
    case 64:
      return bf16 ? launch_mma<64>(ARGS) : launch_f32<64>(ARGS);
    case 128:
      return bf16 ? launch_mma<128>(ARGS) : launch_f32<128>(ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ARGS
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
