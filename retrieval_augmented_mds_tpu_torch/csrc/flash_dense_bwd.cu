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
// the S keys, p = 1/S, what the composite's VJP gives (attn_mma.cuh
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
// - The passes run on the tensor cores in both dtypes, one template over
//   the operand policy of attn_mma.cuh: bf16 (every led_base slice) as
//   m16n8k16 MMAs, f32 (the decoder of a config that keeps the default
//   f32 precision, held to the plain version at 1e-4) as split-TF32
//   m16n8k8 MMAs, three per product, which keep f32 accuracy. The least
//   time is the operations over the bf16 peak, or in f32 3 x the
//   operations over the 495 TFLOP/s dense TF32 peak, or the bytes; in f32
//   the instruction count holds it back (the splits and 32-bit shared
//   loads beside each MMA). The five products per tile pair (S = Q K^T,
//   dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ += dS K) run on
//   shared-memory tiles with f32 accumulators; P and dS become operands
//   only in registers (rounded to bf16, or split), the statistics, delta
//   and the exponentials stay f32. In f32 the dq pass sums each key
//   tile's dS K apart and adds it to dq by FADD (`kTileSums`: the tensor
//   cores' f32 accumulation truncates, which over 16384 keys drifts past
//   1e-4); the dk/dv pass sums over the T query rows (512 in the decoder)
//   in the MMA accumulator. 64 x 64 tiles (the dk/dv pass walks
//   32-row query tiles at dh 128), 4 warps of 16 rows; the walked tile is
//   double-buffered by `cp.async` with its key bias or row statistics, so
//   it loads while the previous one computes. f32 tiles take twice the
//   shared memory: at dh 64 105 KB (dq) and 106 KB (dk/dv) a CTA, 2 CTAs
//   per SM; at dh 128 203 and 136 KB, 1 CTA per SM.
// - Padding: sources are mostly padding (97% of a 16384-token one on the
//   fixture). A key tile whose every bias is <= -1e9 gives each row with
//   an open key p = exp(<= -9e8 + s) = 0 in f32, so ds = 0 and the tile
//   adds exactly nothing: the dq pass skips such tiles when every row of
//   its block has an open key (m > kDegenerate, or lse > kLseDegenerate),
//   and a dk/dv CTA whose key tile is masked whole walks only the query
//   tiles that hold a fully masked row (as it already does for query
//   tiles wholly before its keys under the causal mask). Fully masked rows
//   are computed over every key, as the uniform row needs.

#include "attn_mma.cuh"

namespace {

using namespace attn;

// T = bf16 or float (the operand policy) in both passes.
template <typename T, int DH, typename Stats>
__global__ void __launch_bounds__(kThreads, mma::kMinBlocks<T, DH>)
mma_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ key_bias, const T* __restrict__ dout, Stats stats,
              const float* __restrict__ delta, T* __restrict__ dq, int nh, int T_len,
              int S_len, int causal, float scale) {
  using namespace attn::mma;
  extern __shared__ __align__(16) unsigned char smem[];
  DqTiles<DH, T>& sm = *reinterpret_cast<DqTiles<DH, T>*>(smem);
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
    float part[DH / 8][4] = {};  // this tile's dS K, in f32 (kTileSums)
    float(&sum)[DH / 8][4] = kTileSums<T> ? part : acc;
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
      POperand<T, kSub> ds;
      to_a<kSub>(ds, s);
      mma_py<DH, kSub>(sum, ds, &sm.k[buf][j0][0]);
    }
    if constexpr (kTileSums<T>) {
#pragma unroll
      for (int jd = 0; jd < DH / 8; ++jd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jd][e] += part[jd][e];
      }
    }
    __syncthreads();
    cur = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();
  store_rows<DH>(acc, dq + qbase, q0 + warp * 16, T_len, scale);
}

template <typename T, int DH, typename Stats>
__global__ void __launch_bounds__(kThreads, mma::kMinBlocks<T, DH>)
mma_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ key_bias, const T* __restrict__ dout, Stats stats,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
               int nh, int T_len, int S_len, int causal, float scale) {
  using namespace attn::mma;
  constexpr int BN = DkvTiles<DH, T>::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  DkvTiles<DH, T>& sm = *reinterpret_cast<DkvTiles<DH, T>*>(smem);
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
      POperand<T, kSub> a;
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

template <typename T, int DH, typename Stats>
int launch(const void* q, const void* k, const void* v, const void* kb, const void* dout,
           Stats stats, const void* delta, void* dq, void* dk, void* dv, int BH, int nh,
           int T_len, int S_len, int causal, float scale, cudaStream_t s) {
  constexpr int R = mma::kRows;
  const auto ct = [](const void* p) { return static_cast<const T*>(p); };
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  int err = launch_dyn(mma_dq_kernel<T, DH, Stats>, dim3((T_len + R - 1) / R, BH),
                       sizeof(mma::DqTiles<DH, T>), s, ct(q), ct(k), ct(v), cf(kb), ct(dout),
                       stats, cf(delta), static_cast<T*>(dq), nh, T_len, S_len, causal, scale);
  if (err) return err;
  return launch_dyn(mma_dkv_kernel<T, DH, Stats>, dim3((S_len + R - 1) / R, BH),
                    sizeof(mma::DkvTiles<DH, T>), s, ct(q), ct(k), ct(v), cf(kb), ct(dout),
                    stats, cf(delta), static_cast<T*>(dk), static_cast<T*>(dv), nh, T_len,
                    S_len, causal, scale);
}

#define ARGS q, k, v, kb, dout, stats, delta, dq, dk, dv, BH, nh, T_len, S_len, causal, scale, s

template <typename T, typename Stats>
int launch_dh(int dh, const void* q, const void* k, const void* v, const void* kb,
              const void* dout, Stats stats, const void* delta, void* dq, void* dk, void* dv,
              int BH, int nh, int T_len, int S_len, int causal, float scale, cudaStream_t s) {
  switch (dh) {
    case 32:
      return launch<T, 32>(ARGS);
    case 64:
      return launch<T, 64>(ARGS);
    case 128:
      return launch<T, 128>(ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dtype 0 (f32: split TF32) or 1 (bf16), both on the tensor cores
template <typename Stats>
int launch_dtype(int dtype, int dh, const void* q, const void* k, const void* v,
                 const void* kb, const void* dout, Stats stats, const void* delta, void* dq,
                 void* dk, void* dv, int BH, int nh, int T_len, int S_len, int causal,
                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(dh, ARGS);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(dh, ARGS);
  return (int)cudaErrorInvalidValue;
}

#undef ARGS

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
