// Dense attention rows, forward, for sm_90a (the decoder's self- and
// cross-attention at training time). Two entry points:
//
// K4, `dense_fwd_launch`, replaces the TPU kernel `_fwd_kernel` of
// retrieval_augmented_mds_tpu/ops/flash_dense.py (`flash_dense_attention`,
// S <= 4096): for every query row i of every (batch, head), one softmax over
// the S keys, scored q.k/sqrt(dh) + key_bias[k] (0 or -1e9: source padding),
// with keys k > i set to exactly -1e9 when causal; out = softmax . v, plus
// the row max m and the denominator l = sum exp(s - m), kept separate for
// the backward.
//
// K6, `dense_blocked_fwd_launch`, replaces `_blocked_fwd_kernel`
// (`flash_dense_blocked`, S > 4096: the decoder's cross-attention over a
// source of up to 16384 tokens): the same rows, with one log-sum-exp
// lse = m + log l per row in place of (m, l), the JAX package's residual.
// On a fully masked row lse rounds to -1e9 (log S vanishes under the
// 64-unit ULP of 1e9); the backward (flash_dense_bwd.cu) detects that row
// and takes it as uniform over the S keys.
//
// What bounds it on an H100, and what the design does about it: the TPU's
// blocked kernel streams 512-key blocks through a sequential grid axis;
// here one CTA walks all key tiles of its rows itself, an online softmax,
// so S has no cap and the LSE comes out of the CTA's own loop.
//
// - bf16 K6 (the long-source slice): tensor-core issue, then the bytes of
//   K and V (read once per 64-row block). One CTA of 4 warps owns 64 query
//   rows (16 per warp) and walks 64-key tiles that `cp.async` brings into
//   two buffers, so the next tile loads while this one computes
//   (attn_mma.cuh). S = Q K^T and O += P V are `mma.sync` m16n8k16 MMAs on
//   bf16 shared-memory tiles with f32 accumulators; the bias, the causal
//   mask and the online softmax (row max and sum over the 4 lanes of a
//   quad) run on the C fragments, P is rounded to bf16 only as an operand.
//   Padding: the fixture's 16384-token sources are 97% padding. A key tile
//   whose every bias is -1e9 gives a row with an open key p = exp(<= -9e8 +
//   s - m) = 0, and the rescale exp(m_old - m_new) of an earlier such tile
//   is 0 as well, so skipping it gives the same sums: a block whose every
//   row has an open key (its first row sees one) visits only the tiles
//   that hold one, found by a ballot probe of 16 tiles per barrier. A block
//   with a fully masked row walks every tile, as the uniform row needs.
//   The stats output (lse, or m and l) is a template parameter.
// - K4 and f32 K6: the f32 CUDA-core tiles of attn_tile.cuh (one CTA per
//   (batch*head, 32 or 16 query rows), 32-key tiles, no skip), FMA and
//   shared-memory issue bound.
//
// Ragged T and S are masked inside the kernels. With `causal` a CTA walks
// only the keys up to its last row; when one of its rows is fully masked
// (every key it sees carries -1e9, as for an all-padding source), it adds
// the skipped keys, all exactly -1e9, in closed form, so such a row comes
// out uniform over all S keys, as the plain composite makes it.

#include <type_traits>

#include "attn_mma.cuh"
#include "attn_tile.cuh"

namespace {

using namespace attn;

// kLse: write lse = m + log l into m_out (K6) instead of m and l (K4)
template <int DH, typename T, bool kLse>
__global__ void __launch_bounds__(kThreads)
dense_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ key_bias,
                 T* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int nh, int T_len, int S_len,
                 int causal, float scale) {
  constexpr int BQ = Tile<DH>::BQ, R = Tile<DH>::R;
  __shared__ Smem<DH> sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / nh;
  const int q0 = blockIdx.x * BQ, r0 = warp * R;
  const long qbase = (long)bh * T_len * DH, kbase = (long)bh * S_len * DH;
  const float* kb = key_bias + (long)b * S_len;

  stage_block<DH>(sm.q, q + qbase, q0, T_len, scale);
  Rows<DH> st;
  init_rows<DH>(st);

  const int hi = causal ? min(S_len, q0 + BQ) : S_len;
  for (int k0 = 0; k0 < hi; k0 += kBK) {
    __syncthreads();
    stage<DH>(sm, k + kbase, v + kbase, k0, hi);
    __syncthreads();
    float s[R];
    scores<DH>(sm, r0, s);
    const int pos = k0 + lane;
    const bool in = pos < hi;
    const float bias = in ? kb[pos] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r)
      s[r] = (causal && pos > q0 + r0 + r) ? kMaskVal : s[r] + bias;
    update<DH>(sm, st, s, in);
  }

  if (hi < S_len) {  // causal: keys past the tile's last row, all -1e9
    bool degenerate = false;
#pragma unroll
    for (int r = 0; r < R; ++r) degenerate |= st.m[r] < kDegenerate;
    if (__syncthreads_or(degenerate)) {
      for (int d = threadIdx.x; d < DH; d += kThreads) {
        float sum = 0.f;
        for (int pos = hi; pos < S_len; ++pos) sum += to_f(v[kbase + (long)pos * DH + d]);
        sm.v[0][d] = sum;
      }
      __syncthreads();
      add_masked_columns<DH>(st, static_cast<float>(S_len - hi), sm.v[0]);
    }
  }
  write_rows<DH>(st, out + qbase, m_out + (long)bh * T_len,
                 kLse ? nullptr : l_out + (long)bh * T_len, q0 + r0, T_len);
}

// bf16 on the tensor cores. kLse: write lse = m + log l into m_out (K6)
// instead of m and l.
template <int DH, bool kLse>
__global__ void __launch_bounds__(kThreads, DH >= 128 ? 2 : 3)
mma_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
               __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
               float* __restrict__ l_out, int nh, int T_len, int S_len, int causal,
               float scale) {
  using namespace attn::mma;
  extern __shared__ __align__(16) unsigned char smem[];
  FwdTiles<DH>& sm = *reinterpret_cast<FwdTiles<DH>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / nh, q0 = blockIdx.x * kRows;
  const long qbase = (long)bh * T_len * DH, kbase = (long)bh * S_len * DH;
  const float* kb = key_bias + (long)b * S_len;

  load_rows<DH, kRows>(&sm.q[0][0], q + qbase, q0, T_len);
  cp_async_commit();
  int row[2];  // this lane's two rows: g and g + 8 of the warp's 16
#pragma unroll
  for (int h = 0; h < 2; ++h) row[h] = q0 + warp * 16 + g + 8 * h;

  // causal: keys past the block's last row carry -1e9 for all its rows
  const int hi = causal ? min(S_len, q0 + kRows) : S_len;
  const int n = (hi + kTile - 1) / kTile;
  int parity = 0;
  const auto open_key = [&](int p) { return p < hi && kb[p] > kMaskVal; };
  const int first = next_marked_tile<kTile, 8>(0, n, open_key, sm.probe, parity);
  // every row of the block has an open key iff its first row sees one:
  // then a tile with no open key adds exactly nothing
  const int fk = first * kTile + threadIdx.x;
  const bool skip =
      __syncthreads_or(threadIdx.x < kTile && open_key(fk) && (!causal || fk <= q0));
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

  // running max, this lane's share of the denominator, the accumulator
  float acc[DH / 8][4] = {}, mr[2] = {-INFINITY, -INFINITY}, lr[2] = {0.f, 0.f};
  int cur = skip ? first : 0, buf = 0;
  fetch(cur, 0);
  while (cur < n) {
    const int nxt = next(cur + 1);
    fetch(nxt, buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();
    float s[kTile / 8][4] = {};
    mma_xyt<DH, kTile>(s, &sm.q[warp * 16][0], &sm.k[buf][0][0]);
    float mx[2] = {mr[0], mr[1]};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = 8 * j + 2 * t + (e & 1), key = cur * kTile + c;
        const float x = key >= hi                     ? -INFINITY
                        : (causal && key > row[h]) ? kMaskVal
                                                   : s[j][e] * scale + sm.bias[buf][c];
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);  // finite: key cur * kTile < hi is a column
      alpha[h] = __expf(mr[h] - mx[h]);
      mr[h] = mx[h];
      lr[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[j][e] = __expf(s[j][e] - mr[h]);
        lr[h] += s[j][e];
      }
    }
#pragma unroll
    for (int jd = 0; jd < DH / 8; ++jd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jd][e] *= alpha[e >> 1];
    }
    uint32_t pa[kTile / 16][4];
    to_a<kTile>(pa, s);
    mma_py<DH, kTile>(acc, pa, &sm.v[buf][0][0]);
    __syncthreads();
    cur = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) lr[h] = quad_sum(lr[h]);

  if (hi < S_len) {  // causal: keys past the block's last row, all -1e9
    bool degenerate = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) degenerate |= row[h] < T_len && mr[h] < kDegenerate;
    if (__syncthreads_or(degenerate)) {
      for (int d = threadIdx.x; d < DH; d += kThreads) {
        float sum = 0.f;
        for (int pos = hi; pos < S_len; ++pos)
          sum += __bfloat162float(v[kbase + (long)pos * DH + d]);
        sm.vsum[d] = sum;
      }
      __syncthreads();
      const float count = static_cast<float>(S_len - hi);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // only rows whose max is about -1e9 change
        const float mn = fmaxf(mr[h], kMaskVal);
        const float a = expf(mr[h] - mn), pd = expf(kMaskVal - mn);
        lr[h] = lr[h] * a + count * pd;
        mr[h] = mn;
#pragma unroll
        for (int jd = 0; jd < DH / 8; ++jd) {
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2)
            acc[jd][2 * h + c2] = acc[jd][2 * h + c2] * a + pd * sm.vsum[8 * jd + 2 * t + c2];
        }
      }
    }
  }
  const float inv[2] = {1.f / lr[0], 1.f / lr[1]};
  store_rows<DH>(acc, out + qbase, q0 + warp * 16, T_len, inv);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= T_len) continue;
      const long i = (long)bh * T_len + row[h];
      if (kLse) {
        m_out[i] = mr[h] + logf(lr[h]);
      } else {
        m_out[i] = mr[h];
        l_out[i] = lr[h];
      }
    }
  }
}

template <int DH, bool kLse>
int launch_mma(const void* q, const void* k, const void* v, const void* kb, void* out,
               void* m, void* l, int BH, int nh, int T_len, int S_len, int causal,
               float scale, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  return launch_dyn(mma_fwd_kernel<DH, kLse>, dim3((T_len + mma::kRows - 1) / mma::kRows, BH),
                    sizeof(mma::FwdTiles<DH>), s, static_cast<const bf16*>(q),
                    static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                    static_cast<const float*>(kb), static_cast<bf16*>(out),
                    static_cast<float*>(m), static_cast<float*>(l), nh, T_len, S_len, causal,
                    scale);
}

template <int DH, typename T, bool kLse>
int launch(const void* q, const void* k, const void* v, const void* kb, void* out,
           void* m, void* l, int BH, int nh, int T_len, int S_len, int causal,
           float scale, cudaStream_t s) {
  const dim3 grid((T_len + Tile<DH>::BQ - 1) / Tile<DH>::BQ, BH);
  dense_fwd_kernel<DH, T, kLse><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(kb), static_cast<T*>(out), static_cast<float*>(m),
      static_cast<float*>(l), nh, T_len, S_len, causal, scale);
  return (int)cudaGetLastError();
}

// bf16 K6 on the tensor cores; K4 and f32 on the CUDA cores
template <typename T, bool kLse>
int launch_dh(int dh, const void* q, const void* k, const void* v, const void* kb,
              void* out, void* m, void* l, int BH, int nh, int T_len, int S_len,
              int causal, float scale, cudaStream_t s) {
  if constexpr (kLse && std::is_same<T, __nv_bfloat16>::value) {
#define ARGS q, k, v, kb, out, m, l, BH, nh, T_len, S_len, causal, scale, s
    switch (dh) {
      case 32:
        return launch_mma<32, kLse>(ARGS);
      case 64:
        return launch_mma<64, kLse>(ARGS);
      case 128:
        return launch_mma<128, kLse>(ARGS);
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef ARGS
  } else {
    switch (dh) {
      case 32:
        return launch<32, T, kLse>(q, k, v, kb, out, m, l, BH, nh, T_len, S_len, causal,
                                   scale, s);
      case 64:
        return launch<64, T, kLse>(q, k, v, kb, out, m, l, BH, nh, T_len, S_len, causal,
                                   scale, s);
      case 128:
        return launch<128, T, kLse>(q, k, v, kb, out, m, l, BH, nh, T_len, S_len, causal,
                                    scale, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
}

template <bool kLse>
int launch_dtype(int dtype, int dh, const void* q, const void* k, const void* v,
                 const void* kb, void* out, void* m, void* l, int BH, int nh, int T_len,
                 int S_len, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float, kLse>(dh, q, k, v, kb, out, m, l, BH, nh, T_len, S_len, causal,
                                  scale, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16, kLse>(dh, q, k, v, kb, out, m, l, BH, nh, T_len, S_len,
                                          causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K4. dtype: 0 = f32, 1 = bf16. q/out [B*nh, T, dh]; k/v [B*nh, S, dh];
// key_bias [B, S] f32; m/l [B*nh, T] f32. Any T, S >= 1.
extern "C" int dense_fwd_launch(const void* q, const void* k, const void* v,
                                const void* key_bias, void* out, void* m, void* l,
                                int dtype, int B, int nh, int T_len, int S_len, int dh,
                                int causal, float scale, void* stream) {
  return launch_dtype<false>(dtype, dh, q, k, v, key_bias, out, m, l, B * nh, nh, T_len,
                             S_len, causal, scale, stream);
}

// K6. As K4, with lse [B*nh, T] f32 in place of m and l.
extern "C" int dense_blocked_fwd_launch(const void* q, const void* k, const void* v,
                                        const void* key_bias, void* out, void* lse, int dtype,
                                        int B, int nh, int T_len, int S_len, int dh,
                                        int causal, float scale, void* stream) {
  return launch_dtype<true>(dtype, dh, q, k, v, key_bias, out, lse, nullptr, B * nh, nh,
                            T_len, S_len, causal, scale, stream);
}
