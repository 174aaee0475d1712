// Dense attention rows, forward, for sm_90a (the decoder's self- and
// cross-attention at training time). Two entry points share one kernel:
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
// What bounds it on an H100: the TPU's single-pass kernel holds a whole
// [wq, S] score row in VMEM and its blocked kernel streams 512-key blocks
// through a sequential grid axis; here one CTA walks all key tiles itself,
// an online softmax over 32-key tiles, so S has no cap and the LSE comes
// out of the CTA's own loop. Per row it does 4*S*dh flops on the f32 CUDA
// cores (no wgmma yet) and reads K/V once per CTA, so it is bound by FMA
// and shared-memory issue, not HBM.
//
// Design: one CTA (4 warps) per (batch*head, tile of BQ query rows); the
// tile routines are those of the sliding-window kernel (attn_tile.cuh).
// Ragged T and S are masked inside the kernel. With `causal` a CTA walks
// only the keys up to its last row; when one of its rows is fully masked
// (every key it sees carries -1e9, as for an all-padding source), it adds
// the skipped keys, all exactly -1e9, in closed form, so such a row comes
// out uniform over all S keys, as the plain composite makes it.

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

template <typename T, bool kLse>
int launch_dh(int dh, const void* q, const void* k, const void* v, const void* kb,
              void* out, void* m, void* l, int BH, int nh, int T_len, int S_len,
              int causal, float scale, cudaStream_t s) {
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
