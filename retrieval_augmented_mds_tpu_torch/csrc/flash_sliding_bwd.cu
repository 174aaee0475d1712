// Local-query rows of sliding-window + global attention, backward, for sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` of retrieval_augmented_mds_tpu/ops/
// flash_sliding_bwd.py (called from `flash_sliding_backward`). Given the
// forward's row max m and denominator l (flash_sliding_fwd.cu) and
// delta = rowsum(dO * out), it recomputes p = exp(s - m) / l for every
// column of every local row and returns dq, dk, dv [B*nh, T, dh] and the
// gradients of the gathered global keys and values dkg, dvg [B*nh, G, dh].
// The columns follow the composite the forward follows: band keys carry
// q.k/sqrt(dh) + key_bias and pass gradients to q and k; window columns
// out of the band carry exactly -1e9 and pass none to q or k, but a fully
// masked row is uniform over its 3w + G columns, so its p reaches dv of
// every key of its window; global columns pass gradients to everything.
//
// What bounds it on an H100: the TPU kernel merges the three interactions
// of each block pair into one sequential sweep, carrying partial dq/dk/dv
// in VMEM from one grid step to the next. CTAs run in no order and nothing
// carries between them, so the work is split into passes that each own
// their outputs and need no atomics:
//   1. dq: a CTA per tile of query rows walks the band keys it can see,
//      then the globals;
//   2. dk, dv: a CTA per tile of keys walks the query rows whose band holds
//      them; the other rows of their window are visited only when one of
//      them is fully masked (its m is about -1e9), which a real batch
//      never has with a nonzero dO;
//   3. dkg, dvg: a CTA per tile of globals walks all T query rows. This is
//      a second reduction pass rather than f32 atomics from pass 1: every
//      global key is summed over all T rows, so atomics would put
//      T / BQ concurrent adds on each element and make the sum's order,
//      and so the result, change from run to run; the pass costs G/T of
//      the band work.
// The scores and dO . v are recomputed in each pass, on the f32 CUDA cores
// (no wgmma yet): FMA and shared-memory issue bound it, not HBM.

#include "attn_tile.cuh"

namespace {

using namespace attn;

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
sliding_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ key_bias, const T* __restrict__ kg,
                  const T* __restrict__ vg, const float* __restrict__ g_bias,
                  const T* __restrict__ dout, const float* __restrict__ m,
                  const float* __restrict__ l, const float* __restrict__ delta,
                  T* __restrict__ dq, int nh, int T_len, int w, int G, float scale) {
  constexpr int BQ = Tile<DH>::BQ, R = Tile<DH>::R, DV = Tile<DH>::DV;
  extern __shared__ __align__(16) unsigned char smem[];
  DqSmem<DH>& sm = *reinterpret_cast<DqSmem<DH>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / nh;
  const int q0 = blockIdx.x * BQ, r0 = warp * R;
  const long base = (long)bh * T_len * DH, gbase = (long)bh * G * DH;
  const float* kb = key_bias + (long)b * T_len;

  stage_block<DH>(sm.q, q + base, q0, T_len, scale);
  stage_block<DH>(sm.dout, dout + base, q0, T_len, 1.f);
  RowStats<DH> rs;
  load_stats<DH>(rs, m + (long)bh * T_len, l + (long)bh * T_len,
                 delta + (long)bh * T_len, q0 + r0, T_len);
  float acc[R][DV] = {};

  // band: out-of-band columns pass no gradient to q, so only the keys any
  // row of this tile can see
  const int lo = max(q0 - w, 0), hi = min(q0 + BQ + w, T_len);
  for (int k0 = lo; k0 < hi; k0 += kBK) {
    __syncthreads();
    stage_t<DH>(sm.k, k + base, k0, hi, 1.f);
    stage_t<DH>(sm.v, v + base, k0, hi, 1.f);
    __syncthreads();
    const int pos = k0 + lane;
    const bool in = pos < hi;
    const float bias = in ? kb[pos] : 0.f;
    const auto mask = [&](int r, float s) {
      const int d = pos - (q0 + r0 + r);
      return (d <= w && d >= -w) ? Logit{s + bias, true} : Logit{kMaskVal, false};
    };
    dq_tile<DH>(sm, rs, r0, in, mask, acc);
  }

  for (int g0 = 0; g0 < G; g0 += kBK) {
    __syncthreads();
    stage_t<DH>(sm.k, kg + gbase, g0, G, 1.f);
    stage_t<DH>(sm.v, vg + gbase, g0, G, 1.f);
    __syncthreads();
    const int g = g0 + lane;
    const bool in = g < G;
    const float bias = in ? g_bias[(long)b * G + g] : 0.f;
    const auto mask = [&](int, float s) { return Logit{s + bias, true}; };
    dq_tile<DH>(sm, rs, r0, in, mask, acc);
  }
  write_acc<DH>(acc, dq + base, q0 + r0, T_len, scale);
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
sliding_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ key_bias, const T* __restrict__ dout,
                   const float* __restrict__ m, const float* __restrict__ l,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   int nh, int T_len, int w, float scale) {
  constexpr int BK = Tile<DH>::BQ, R = Tile<DH>::R, DV = Tile<DH>::DV;
  extern __shared__ __align__(16) unsigned char smem[];
  DkvSmem<DH>& sm = *reinterpret_cast<DkvSmem<DH>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / nh;
  const int k0 = blockIdx.x * BK, r0 = warp * R;
  const long base = (long)bh * T_len * DH;
  const float* mr = m + (long)bh * T_len;

  stage_block<DH>(sm.k, k + base, k0, T_len, 1.f);
  stage_block<DH>(sm.v, v + base, k0, T_len, 1.f);
  float kbias[R];
#pragma unroll
  for (int r = 0; r < R; ++r) kbias[r] = key_bias[(long)b * T_len + k0 + r0 + r];
  float gk[R][DV] = {}, gv[R][DV] = {};

  // rows whose window holds these keys (w-blocks n-1..n+1 of the keys'
  // block n), and the rows whose band holds one of them
  const int n = k0 / w;
  const int wlo = max((n - 1) * w, 0), whi = min((n + 2) * w, T_len);
  const int blo = max(k0 - w, 0), bhi = min(k0 + BK + w, T_len);
  for (int qt = wlo; qt < whi; qt += kBK) {
    if (qt + kBK <= blo || qt >= bhi) {
      // out of every key's band: only a fully masked row contributes
      const int row = qt + threadIdx.x;
      const bool deg = threadIdx.x < kBK && mr[row] < kDegenerate;
      if (!__syncthreads_or(deg)) continue;
    }
    __syncthreads();
    stage_queries<DH>(sm, q + base, dout + base, mr, l + (long)bh * T_len,
                      delta + (long)bh * T_len, qt, T_len, scale);
    __syncthreads();
    const int row = qt + lane;
    const auto mask = [&](int r, float s) {
      const int d = k0 + r0 + r - row;
      return (d <= w && d >= -w) ? Logit{s + kbias[r], true} : Logit{kMaskVal, false};
    };
    dkv_tile<DH>(sm, r0, true, mask, gk, gv);
  }
  write_acc<DH>(gk, dk + base, k0 + r0, T_len, 1.f);
  write_acc<DH>(gv, dv + base, k0 + r0, T_len, 1.f);
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
sliding_dkvg_kernel(const T* __restrict__ q, const T* __restrict__ kg,
                    const T* __restrict__ vg, const float* __restrict__ g_bias,
                    const T* __restrict__ dout, const float* __restrict__ m,
                    const float* __restrict__ l, const float* __restrict__ delta,
                    float* __restrict__ dkg, float* __restrict__ dvg, int nh, int T_len,
                    int G, float scale) {
  constexpr int BK = Tile<DH>::BQ, R = Tile<DH>::R, DV = Tile<DH>::DV;
  extern __shared__ __align__(16) unsigned char smem[];
  DkvSmem<DH>& sm = *reinterpret_cast<DkvSmem<DH>*>(smem);
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / nh;
  const int g0 = blockIdx.x * BK, r0 = warp * R;
  const long base = (long)bh * T_len * DH, gbase = (long)bh * G * DH;

  stage_block<DH>(sm.k, kg + gbase, g0, G, 1.f);
  stage_block<DH>(sm.v, vg + gbase, g0, G, 1.f);
  float gbias[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = g0 + r0 + r;
    gbias[r] = g < G ? g_bias[(long)b * G + g] : 0.f;
  }
  float gk[R][DV] = {}, gv[R][DV] = {};
  for (int qt = 0; qt < T_len; qt += kBK) {
    __syncthreads();
    stage_queries<DH>(sm, q + base, dout + base, m + (long)bh * T_len,
                      l + (long)bh * T_len, delta + (long)bh * T_len, qt, T_len, scale);
    __syncthreads();
    const auto mask = [&](int r, float s) { return Logit{s + gbias[r], true}; };
    dkv_tile<DH>(sm, r0, true, mask, gk, gv);
  }
  write_acc<DH>(gk, dkg + gbase, g0 + r0, G, 1.f);
  write_acc<DH>(gv, dvg + gbase, g0 + r0, G, 1.f);
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, const void* kb, const void* kg,
           const void* vg, const void* gb, const void* dout, const void* m, const void* l,
           const void* delta, void* dq, void* dk, void* dv, void* dkg, void* dvg, int BH,
           int nh, int T_len, int w, int G, float scale, cudaStream_t s) {
  constexpr int BQ = Tile<DH>::BQ;
  const auto cq = [](const void* p) { return static_cast<const T*>(p); };
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  int err = launch_dyn(sliding_dq_kernel<DH, T>, dim3(T_len / BQ, BH), sizeof(DqSmem<DH>),
                       s, cq(q), cq(k), cq(v), cf(kb), cq(kg), cq(vg), cf(gb), cq(dout),
                       cf(m), cf(l), cf(delta), static_cast<T*>(dq), nh, T_len, w, G,
                       scale);
  if (err) return err;
  err = launch_dyn(sliding_dkv_kernel<DH, T>, dim3(T_len / BQ, BH), sizeof(DkvSmem<DH>),
                   s, cq(q), cq(k), cq(v), cf(kb), cq(dout), cf(m), cf(l), cf(delta),
                   static_cast<T*>(dk), static_cast<T*>(dv), nh, T_len, w, scale);
  if (err) return err;
  return launch_dyn(sliding_dkvg_kernel<DH, T>, dim3((G + BQ - 1) / BQ, BH),
                    sizeof(DkvSmem<DH>), s, cq(q), cq(kg), cq(vg), cf(gb), cq(dout), cf(m),
                    cf(l), cf(delta), static_cast<float*>(dkg), static_cast<float*>(dvg),
                    nh, T_len, G, scale);
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, const void* kb,
              const void* kg, const void* vg, const void* gb, const void* dout,
              const void* m, const void* l, const void* delta, void* dq, void* dk,
              void* dv, void* dkg, void* dvg, int BH, int nh, int T_len, int w, int G,
              float scale, cudaStream_t s) {
  switch (dh) {
    case 32:
      return launch<32, T>(q, k, v, kb, kg, vg, gb, dout, m, l, delta, dq, dk, dv, dkg,
                           dvg, BH, nh, T_len, w, G, scale, s);
    case 64:
      return launch<64, T>(q, k, v, kb, kg, vg, gb, dout, m, l, delta, dq, dk, dv, dkg,
                           dvg, BH, nh, T_len, w, G, scale, s);
    case 128:
      return launch<128, T>(q, k, v, kb, kg, vg, gb, dout, m, l, delta, dq, dk, dv, dkg,
                            dvg, BH, nh, T_len, w, G, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. q/k/v/dout/dq/dk/dv [B*nh, T, dh]; key_bias
// [B, T] f32; kg/vg [B*nh, G, dh]; g_bias [B, G] f32; m/l/delta [B*nh, T]
// f32; dkg/dvg [B*nh, G, dh] f32. T and w multiples of 32, G in [1, 128].
extern "C" int sliding_bwd_launch(const void* q, const void* k, const void* v,
                                  const void* key_bias, const void* kg, const void* vg,
                                  const void* g_bias, const void* dout, const void* m,
                                  const void* l, const void* delta, void* dq, void* dk,
                                  void* dv, void* dkg, void* dvg, int dtype, int B, int nh,
                                  int T_len, int dh, int w, int G, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(dh, q, k, v, key_bias, kg, vg, g_bias, dout, m, l, delta, dq,
                            dk, dv, dkg, dvg, B * nh, nh, T_len, w, G, scale, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, key_bias, kg, vg, g_bias, dout, m, l,
                                    delta, dq, dk, dv, dkg, dvg, B * nh, nh, T_len, w, G,
                                    scale, s);
  return (int)cudaErrorInvalidValue;
}
