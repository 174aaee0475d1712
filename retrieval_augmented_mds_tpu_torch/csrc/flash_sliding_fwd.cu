// Local-query rows of sliding-window + global attention, forward, for sm_90a.
//
// Replaces the TPU kernel `_kernel` of retrieval_augmented_mds_tpu/ops/
// flash_sliding.py (called from `flash_sliding_attention`). For every query
// row q of every (batch, head) it computes one softmax over
//   * the keys of its band, |k - q| <= w, scored q.k/sqrt(dh) + key_bias[k]
//     (key_bias is 0 or -1e9: padding and global tokens are masked);
//   * up to 128 gathered global-token keys, scored q.kg/sqrt(dh) + g_bias;
// and emits out = softmax . [v; vg], plus the row max m and the denominator
// l = sum exp(s - m), kept separate for the backward.
//
// Mask convention (the one the plain version and the JAX composite share):
// a row's columns are the 3w positions of its w-block window
// [(n-1)w, (n+2)w) plus the G globals. Window columns out of the band get
// exactly -1e9, and so do positions outside [0, T) (with a zero value
// row). A fully masked row therefore comes out uniform over those 3w + G
// columns, which is what the backward's m/l contract needs.
//
// What bounds it on an H100: per row it reads ~2w+32 keys and values that
// neighbouring rows share through shared memory, so HBM traffic is about
// the q/k/v/out streams; the 4*dh*(2w+32) flops per row run on the f32
// CUDA cores (no wgmma yet), so the kernel is bound by FMA and
// shared-memory issue.
//
// Design: one CTA (4 warps) per (batch*head, tile of BQ query rows); BQ
// divides w, so all rows of a CTA share one window. The CTA walks only the
// keys any of its rows can see, [q0-w, q0+BQ+w) clipped to [0, T), in
// 32-key tiles staged in shared memory (K transposed, padded against bank
// conflicts), then the globals in 32-key tiles, with an online softmax in
// f32 (lane = key for the scores, lane = head dim for the accumulator).
// Window columns it skipped all hold exactly -1e9; they only matter for a
// row whose max is still about -1e9 (fully masked), so such CTAs add them
// afterwards in closed form: their count and the sum of their value rows.

#include "attn_tile.cuh"

namespace {

using namespace attn;

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
sliding_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ key_bias,
                   const T* __restrict__ kg, const T* __restrict__ vg,
                   const float* __restrict__ g_bias, T* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out, int nh,
                   int T_len, int w, int G, float scale) {
  constexpr int BQ = Tile<DH>::BQ, R = Tile<DH>::R;
  __shared__ Smem<DH> sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / nh;
  const int q0 = blockIdx.x * BQ, r0 = warp * R;
  const long base = (long)bh * T_len * DH;
  const float* kb = key_bias + (long)b * T_len;

  stage_block<DH>(sm.q, q + base, q0, T_len, scale);
  Rows<DH> st;
  init_rows<DH>(st);

  // band: the keys any row of this tile can see
  const int lo = max(q0 - w, 0), hi = min(q0 + BQ + w, T_len);
  for (int k0 = lo; k0 < hi; k0 += kBK) {
    __syncthreads();
    stage<DH>(sm, k + base, v + base, k0, hi);
    __syncthreads();
    float s[R];
    scores<DH>(sm, r0, s);
    const int pos = k0 + lane;
    const bool in = pos < hi;
    const float bias = in ? kb[pos] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int dq = pos - (q0 + r0 + r);
      s[r] = (dq <= w && dq >= -w) ? s[r] + bias : kMaskVal;
    }
    update<DH>(sm, st, s, in);
  }

  // global-token columns, in the same softmax
  const long gbase = (long)bh * G * DH;
  for (int g0 = 0; g0 < G; g0 += kBK) {
    __syncthreads();
    stage<DH>(sm, kg + gbase, vg + gbase, g0, G);
    __syncthreads();
    float s[R];
    scores<DH>(sm, r0, s);
    const int g = g0 + lane;
    const bool in = g < G;
    const float bias = in ? g_bias[(long)b * G + g] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] += bias;
    update<DH>(sm, st, s, in);
  }

  // fully masked rows: add the skipped window columns (all exactly -1e9)
  bool degenerate = false;
#pragma unroll
  for (int r = 0; r < R; ++r) degenerate |= st.m[r] < kDegenerate;
  if (__syncthreads_or(degenerate)) {
    const int n = q0 / w, wlo = (n - 1) * w, whi = (n + 2) * w;
    for (int d = threadIdx.x; d < DH; d += kThreads) {
      float sum = 0.f;
      for (int pos = max(wlo, 0); pos < min(whi, T_len); ++pos)
        if (pos < lo || pos >= hi) sum += to_f(v[base + (long)pos * DH + d]);
      sm.v[0][d] = sum;
    }
    __syncthreads();
    add_masked_columns<DH>(st, static_cast<float>(3 * w - (hi - lo)), sm.v[0]);
  }
  write_rows<DH>(st, out + base, m_out + (long)bh * T_len, l_out + (long)bh * T_len,
                 q0 + r0, T_len);
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, const void* kb,
           const void* kg, const void* vg, const void* gb, void* out, void* m,
           void* l, int B, int nh, int T_len, int w, int G, float scale,
           cudaStream_t s) {
  const dim3 grid(T_len / Tile<DH>::BQ, B * nh);
  sliding_fwd_kernel<DH, T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(kb), static_cast<const T*>(kg),
      static_cast<const T*>(vg), static_cast<const float*>(gb),
      static_cast<T*>(out), static_cast<float*>(m), static_cast<float*>(l), nh,
      T_len, w, G, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, const void* kb,
              const void* kg, const void* vg, const void* gb, void* out, void* m,
              void* l, int B, int nh, int T_len, int w, int G, float scale,
              cudaStream_t s) {
  switch (dh) {
    case 32:
      return launch<32, T>(q, k, v, kb, kg, vg, gb, out, m, l, B, nh, T_len, w, G, scale, s);
    case 64:
      return launch<64, T>(q, k, v, kb, kg, vg, gb, out, m, l, B, nh, T_len, w, G, scale, s);
    case 128:
      return launch<128, T>(q, k, v, kb, kg, vg, gb, out, m, l, B, nh, T_len, w, G, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Query-row tile of the dh variant: T and w must be multiples of it.
extern "C" int sliding_fwd_block_rows(int dh) {
  return dh >= 128 ? attn::Tile<128>::BQ : attn::Tile<64>::BQ;
}

// dtype: 0 = f32, 1 = bf16. q/k/v/out [B*nh, T, dh]; key_bias [B, T] f32;
// kg/vg [B*nh, G, dh]; g_bias [B, G] f32; m/l [B*nh, T] f32.
extern "C" int sliding_fwd_launch(const void* q, const void* k, const void* v,
                                  const void* key_bias, const void* kg,
                                  const void* vg, const void* g_bias, void* out,
                                  void* m, void* l, int dtype, int B, int nh,
                                  int T_len, int dh, int w, int G, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(dh, q, k, v, key_bias, kg, vg, g_bias, out, m, l, B,
                            nh, T_len, w, G, scale, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, key_bias, kg, vg, g_bias, out,
                                    m, l, B, nh, T_len, w, G, scale, s);
  return (int)cudaErrorInvalidValue;
}
