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
// every key of its window (its own w-block and the two beside it);
// global columns pass gradients to everything.
//
// What bounds it on an H100: the TPU kernel merges the three interactions
// of each block pair into one sequential sweep, carrying partial dq/dk/dv
// in VMEM from one grid step to the next. CTAs run in no order and nothing
// carries between them, so the work is split into passes that each own
// their outputs and need no atomics, and two runs give the same bits:
//   1. dq: a CTA per tile of query rows walks the band keys it can see,
//      then the globals;
//   2. dk, dv: a CTA per tile of keys walks the query rows whose band holds
//      them; the other rows of their window only when one of them is fully
//      masked (its m is about -1e9);
//   3. dkg, dvg: a CTA per tile of globals walks the query rows. A second
//      reduction pass rather than atomics from pass 1: every global key is
//      summed over all T rows, and atomics would make the sum's order, and
//      so the result, change from run to run.
// The scores and dO . v are recomputed in each pass.
//
// - bf16 (every led_base slice): tensor-core issue, then bytes. The five
//   products per tile pair are `mma.sync` m16n8k16 MMAs on bf16 shared-
//   memory tiles (attn_mma.cuh: 64-row CTAs of 4 warps, 64-row walked
//   tiles, 32 at dh 128 in passes 2 and 3, double-buffered by `cp.async`),
//   f32 accumulators; P and dS are rounded to bf16 only as operands. What
//   is exactly zero is not computed:
//   - a 64-row tile whose dO is all zero (the model's padded rows and its
//     valid global rows: the encoder zeroes or overwrites their outputs)
//     adds nothing anywhere: dp = 0, delta = 0, so ds = 0 and p dO = 0.
//     Pass 1 tests dO itself (any nonzero bit but the sign: a NaN counts),
//     writes dq = 0 for such a tile and one flag per tile, which passes 2
//     and 3 read to skip it;
//   - a band key tile that the bias masks whole adds nothing to rows that
//     each have an open column (p = exp(<= -9e8 + s - m) = 0): pass 1 skips
//     it when every row of its block has one, and pass 2 then visits only
//     the rows that are fully masked.
//   The band mask is applied per key, so a 64-key tile may span two
//   w-blocks (w = 32).
// - f32 (the tiny smoke config, held to the CPU at 1e-4): the CUDA-core
//   tiles of attn_tile.cuh, FMA and shared-memory issue bound, no skips.

#include "attn_mma.cuh"
#include "attn_tile.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// f32: CUDA-core passes (attn_tile.cuh)
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(kThreads)
sliding_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ key_bias,
                  const float* __restrict__ kg, const float* __restrict__ vg,
                  const float* __restrict__ g_bias,
                  const float* __restrict__ dout, const float* __restrict__ m,
                  const float* __restrict__ l, const float* __restrict__ delta,
                  float* __restrict__ dq, int nh, int T_len, int w, int G, float scale) {
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
  load_stats<DH>(rs, MLStats{m + (long)bh * T_len, l + (long)bh * T_len},
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

template <int DH>
__global__ void __launch_bounds__(kThreads)
sliding_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ key_bias,
                   const float* __restrict__ dout, const float* __restrict__ m,
                   const float* __restrict__ l, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int nh, int T_len, int w,
                   float scale) {
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
    stage_queries<DH>(sm, q + base, dout + base, MLStats{mr, l + (long)bh * T_len},
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

template <int DH>
__global__ void __launch_bounds__(kThreads)
sliding_dkvg_kernel(const float* __restrict__ q, const float* __restrict__ kg,
                    const float* __restrict__ vg, const float* __restrict__ g_bias,
                    const float* __restrict__ dout, const float* __restrict__ m,
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
    stage_queries<DH>(sm, q + base, dout + base,
                      MLStats{m + (long)bh * T_len, l + (long)bh * T_len},
                      delta + (long)bh * T_len, qt, T_len, scale);
    __syncthreads();
    const auto mask = [&](int r, float s) { return Logit{s + gbias[r], true}; };
    dkv_tile<DH>(sm, r0, true, mask, gk, gv);
  }
  write_acc<DH>(gk, dkg + gbase, g0 + r0, G, 1.f);
  write_acc<DH>(gv, dvg + gbase, g0 + r0, G, 1.f);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* kb, const void* kg,
           const void* vg, const void* gb, const void* dout, const void* m, const void* l,
           const void* delta, void* dq, void* dk, void* dv, void* dkg, void* dvg, int BH,
           int nh, int T_len, int w, int G, float scale, cudaStream_t s) {
  constexpr int BQ = Tile<DH>::BQ;
  const auto cq = [](const void* p) { return static_cast<const float*>(p); };
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  int err = launch_dyn(sliding_dq_kernel<DH>, dim3(T_len / BQ, BH), sizeof(DqSmem<DH>),
                       s, cq(q), cq(k), cq(v), cf(kb), cq(kg), cq(vg), cf(gb), cq(dout),
                       cf(m), cf(l), cf(delta), static_cast<float*>(dq), nh, T_len, w, G,
                       scale);
  if (err) return err;
  err = launch_dyn(sliding_dkv_kernel<DH>, dim3(T_len / BQ, BH), sizeof(DkvSmem<DH>),
                   s, cq(q), cq(k), cq(v), cf(kb), cq(dout), cf(m), cf(l), cf(delta),
                   static_cast<float*>(dk), static_cast<float*>(dv), nh, T_len, w, scale);
  if (err) return err;
  return launch_dyn(sliding_dkvg_kernel<DH>, dim3((G + BQ - 1) / BQ, BH),
                    sizeof(DkvSmem<DH>), s, cq(q), cq(kg), cq(vg), cf(gb), cq(dout), cf(m),
                    cf(l), cf(delta), static_cast<float*>(dkg), static_cast<float*>(dvg),
                    nh, T_len, G, scale);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core passes
// ---------------------------------------------------------------------------

// Whether any of rows [r0, min(r0 + 64, end)) of a bf16 [*, DH] matrix has
// a nonzero element (any bit but the sign set: a NaN counts, -0.0 does
// not), for the whole CTA.
template <int DH>
__device__ bool any_nonzero_rows(const __nv_bfloat16* __restrict__ x, int r0, int end) {
  const int chunks = (min(r0 + mma::kRows, end) - r0) * DH / 8;  // 16 bytes each
  const uint4* p = reinterpret_cast<const uint4*>(x + (long)r0 * DH);
  bool nz = false;
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const uint4 c = p[i];
    nz |= ((c.x | c.y | c.z | c.w) & 0x7fff7fffu) != 0;
  }
  return __syncthreads_or(nz);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, DH >= 128 ? 2 : 3)
sliding_mma_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
                      const __nv_bfloat16* __restrict__ kg, const __nv_bfloat16* __restrict__ vg,
                      const float* __restrict__ g_bias, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ m, const float* __restrict__ l,
                      const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                      int* __restrict__ live, int nh, int T_len, int w, int G, float scale) {
  using namespace attn::mma;
  extern __shared__ __align__(16) unsigned char smem[];
  DqTiles<DH>& sm = *reinterpret_cast<DqTiles<DH>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / nh, q0 = blockIdx.x * kRows;
  const long base = (long)bh * T_len * DH, gbase = (long)bh * G * DH;
  const float* kb = key_bias + (long)b * T_len;
  const float* gb = g_bias + (long)b * G;

  // rows whose dO is all zero add nothing anywhere: dq = 0, and the flag
  // tells passes 2 and 3 to skip them
  const bool any = any_nonzero_rows<DH>(dout + base, q0, T_len);
  if (threadIdx.x == 0) live[(long)bh * gridDim.x + blockIdx.x] = any;
  if (!any) {
    const float zero[DH / 8][4] = {};
    store_rows<DH>(zero, dq + base, q0 + warp * 16, T_len, 1.f);
    return;
  }
  load_rows<DH, kRows>(&sm.q[0][0], q + base, q0, T_len);
  load_rows<DH, kRows>(&sm.dout[0][0], dout + base, q0, T_len);
  cp_async_commit();

  // this lane's two rows: g and g + 8 of the warp's 16
  int row[2];
  float mr[2], rl[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    const bool ok = row[h] < T_len;
    const long i = (long)bh * T_len + row[h];
    mr[h] = ok ? m[i] : 0.f;
    rl[h] = ok ? 1.f / l[i] : 1.f;
    dl[h] = ok ? delta[i] : 0.f;
  }
  // a band key tile masked whole adds nothing to rows that each have an
  // open column
  const int r = q0 + threadIdx.x;
  const bool skip = __syncthreads_and(threadIdx.x >= kRows || r >= T_len ||
                                      m[(long)bh * T_len + r] > kDegenerate);
  // the band keys any row of the block can see (out-of-band columns pass
  // no gradient to q), then the globals
  const int lo = max(q0 - w, 0), hi = min(q0 + kRows + w, T_len);
  const int nb = (hi - lo + kTile - 1) / kTile, n = nb + (G + kTile - 1) / kTile;
  int parity = 0;
  const auto open_key = [&](int p) { return lo + p < hi && kb[lo + p] > kMaskVal; };
  const auto next = [&](int it) {
    return skip && it < nb ? next_marked_tile<kTile, 8>(it, nb, open_key, sm.probe, parity)
                           : it;
  };
  const auto fetch = [&](int it, int buf) {
    if (it < nb) {
      const int k0 = lo + it * kTile;
      load_rows<DH, kTile>(&sm.k[buf][0][0], k + base, k0, hi);
      load_rows<DH, kTile>(&sm.v[buf][0][0], v + base, k0, hi);
      load_vec<kTile>(sm.bias[buf], kb, k0, hi);
    } else if (it < n) {
      const int g0 = (it - nb) * kTile;
      load_rows<DH, kTile>(&sm.k[buf][0][0], kg + gbase, g0, G);
      load_rows<DH, kTile>(&sm.v[buf][0][0], vg + gbase, g0, G);
      load_vec<kTile>(sm.bias[buf], gb, g0, G);
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
    const bool band = cur < nb;
    const int c0 = band ? lo + cur * kTile : (cur - nb) * kTile;  // first key or global
#pragma unroll
    for (int j0 = 0; j0 < kTile; j0 += kSub) {  // kSub columns at a time
      float s[kSub / 8][4] = {}, dp[kSub / 8][4] = {};
      mma_xyt<DH, kSub>(s, &sm.q[warp * 16][0], &sm.k[buf][j0][0]);
      mma_xyt<DH, kSub>(dp, &sm.dout[warp * 16][0], &sm.v[buf][j0][0]);
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, c = j0 + 8 * j + 2 * t + (e & 1), col = c0 + c;
          const bool grad = band ? col < hi && abs(col - row[h]) <= w : col < G;
          const float p = __expf(s[j][e] * scale + sm.bias[buf][c] - mr[h]) * rl[h];
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
  store_rows<DH>(acc, dq + base, q0 + warp * 16, T_len, scale);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, DH >= 128 ? 2 : 3)
sliding_mma_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
                       const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m,
                       const float* __restrict__ l, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                       const int* __restrict__ live, int nh, int T_len, int w, float scale) {
  using namespace attn::mma;
  constexpr int BN = DkvTiles<DH>::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  DkvTiles<DH>& sm = *reinterpret_cast<DkvTiles<DH>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / nh, k0 = blockIdx.x * kRows;
  const long base = (long)bh * T_len * DH;
  const float* kb = key_bias + (long)b * T_len;
  const float* mrow = m + (long)bh * T_len;
  const int* lv = live + (long)bh * gridDim.x;

  // this lane's two keys (g and g + 8 of the warp's 16) and the rows whose
  // window holds each: w-blocks n - 1 .. n + 1 of the key's block n
  int key[2], wr0[2], wr1[2];
  float kbias[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = k0 + warp * 16 + g + 8 * h;
    const bool ok = key[h] < T_len;
    kbias[h] = ok ? kb[key[h]] : 0.f;
    wr0[h] = (key[h] / w - 1) * w;
    wr1[h] = ok ? (key[h] / w + 2) * w : 0;
  }
  // every key of the block masked by its bias: rows with an open column
  // give them p = 0, so only fully masked rows reach them
  const int kp = k0 + threadIdx.x;
  const bool masked =
      __syncthreads_and(threadIdx.x >= kRows || kp >= T_len || kb[kp] <= kMaskVal);
  const int kend = min(k0 + kRows, T_len);
  // rows whose window holds a key of the block, and rows whose band does
  const int wlo = max((k0 / w - 1) * w, 0), whi = min(((kend - 1) / w + 2) * w, T_len);
  const int blo = max(k0 - w, 0), bhi = min(kend + w, T_len);
  const int n = (whi + BN - 1) / BN;
  // a row adds to these keys only if its dO is not all zero, and then if
  // its band holds one of them (the block not masked whole) or if it is
  // fully masked (uniform over its window)
  const auto marked = [&](int r) {
    return r >= wlo && r < whi && lv[r / kRows] &&
           ((!masked && r >= blo && r < bhi) || !(mrow[r] > kDegenerate));
  };
  int parity = 0;
  const auto next = [&](int it) {
    if (it >= n) return n;
    const int r0 = it * BN;
    if (!masked && r0 < bhi && r0 + BN > blo && lv[r0 / kRows]) return it;
    return next_marked_tile<BN, 4>(it, n, marked, sm.probe, parity);
  };
  const auto fetch = [&](int it, int buf) {
    if (it < n) {
      const int qt = it * BN;
      load_rows<DH, BN>(&sm.q[buf][0][0], q + base, qt, T_len);
      load_rows<DH, BN>(&sm.dout[buf][0][0], dout + base, qt, T_len);
      load_vec<BN>(sm.stat[buf][0], mrow, qt, T_len);
      load_vec<BN>(sm.stat[buf][1], l + (long)bh * T_len, qt, T_len);
      load_vec<BN>(sm.stat[buf][2], delta + (long)bh * T_len, qt, T_len);
    }
    cp_async_commit();
  };

  float gk[DH / 8][4] = {}, gv[DH / 8][4] = {};
  int cur = next(wlo / BN), buf = 0;
  if (cur < n) {  // the block's keys and values join the first tile's group
    load_rows<DH, kRows>(&sm.k[0][0], k + base, k0, T_len);
    load_rows<DH, kRows>(&sm.v[0][0], v + base, k0, T_len);
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
          const float mc = sm.stat[buf][0][c], rl = 1.f / sm.stat[buf][1][c];
          const float dlc = sm.stat[buf][2][c];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + c2;
            // a column of row qr: in its window; a band key: within w
            const bool win = qr < T_len && qr >= wr0[h] && qr < wr1[h];
            const bool band = win && abs(key[h] - qr) <= w;
            const float logit = band ? s[j][e] * scale + kbias[h] : kMaskVal;
            const float p = win ? __expf(logit - mc) * rl : 0.f;
            s[j][e] = p;
            dp[j][e] = band ? p * (dp[j][e] - dlc) : 0.f;  // ds
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
  store_rows<DH>(gk, dk + base, k0 + warp * 16, T_len, scale);
  store_rows<DH>(gv, dv + base, k0 + warp * 16, T_len, 1.f);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, DH >= 128 ? 2 : 3)
sliding_mma_dkvg_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kg,
                        const __nv_bfloat16* __restrict__ vg, const float* __restrict__ g_bias,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m,
                        const float* __restrict__ l, const float* __restrict__ delta,
                        float* __restrict__ dkg, float* __restrict__ dvg,
                        const int* __restrict__ live, int nh, int T_len, int G, float scale) {
  using namespace attn::mma;
  constexpr int BN = DkvTiles<DH>::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  DkvTiles<DH>& sm = *reinterpret_cast<DkvTiles<DH>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / nh, g0 = blockIdx.x * kRows;
  const long base = (long)bh * T_len * DH, gbase = (long)bh * G * DH;
  const int* lv = live + (long)bh * ((T_len + kRows - 1) / kRows);

  int gi[2];  // this lane's two globals
  float gbias[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    gi[h] = g0 + warp * 16 + g + 8 * h;
    gbias[h] = gi[h] < G ? g_bias[(long)b * G + gi[h]] : 0.f;
  }
  // every row is a column of every global; only rows whose dO is not all
  // zero add anything
  const int n = (T_len + BN - 1) / BN;
  const auto tile_live = [&](int it) { return it < n && lv[it * BN / kRows] != 0; };
  int parity = 0;
  const auto next = [&](int it) {
    return next_marked_tile<1, 1>(it, n, tile_live, sm.probe, parity);
  };
  const auto fetch = [&](int it, int buf) {
    if (it < n) {
      const int qt = it * BN;
      load_rows<DH, BN>(&sm.q[buf][0][0], q + base, qt, T_len);
      load_rows<DH, BN>(&sm.dout[buf][0][0], dout + base, qt, T_len);
      load_vec<BN>(sm.stat[buf][0], m + (long)bh * T_len, qt, T_len);
      load_vec<BN>(sm.stat[buf][1], l + (long)bh * T_len, qt, T_len);
      load_vec<BN>(sm.stat[buf][2], delta + (long)bh * T_len, qt, T_len);
    }
    cp_async_commit();
  };

  float gk[DH / 8][4] = {}, gv[DH / 8][4] = {};
  int cur = next(0), buf = 0;
  if (cur < n) {
    load_rows<DH, kRows>(&sm.k[0][0], kg + gbase, g0, G);
    load_rows<DH, kRows>(&sm.v[0][0], vg + gbase, g0, G);
  }
  fetch(cur, 0);
  while (cur < n) {
    const int nxt = next(cur + 1);
    fetch(nxt, buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int j0 = 0; j0 < BN; j0 += kSub) {
      float s[kSub / 8][4] = {}, dp[kSub / 8][4] = {};
      mma_xyt<DH, kSub>(s, &sm.k[warp * 16][0], &sm.q[buf][j0][0]);
      mma_xyt<DH, kSub>(dp, &sm.v[warp * 16][0], &sm.dout[buf][j0][0]);
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int c = j0 + 8 * j + 2 * t + c2, qr = cur * BN + c;
          const float mc = sm.stat[buf][0][c], rl = 1.f / sm.stat[buf][1][c];
          const float dlc = sm.stat[buf][2][c];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + c2;
            const bool ok = qr < T_len && gi[h] < G;
            const float p = ok ? __expf(s[j][e] * scale + gbias[h] - mc) * rl : 0.f;
            s[j][e] = p;
            dp[j][e] = ok ? p * (dp[j][e] - dlc) : 0.f;  // ds
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
  store_rows<DH>(gk, dkg + gbase, g0 + warp * 16, G, scale);
  store_rows<DH>(gv, dvg + gbase, g0 + warp * 16, G, 1.f);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* kb, const void* kg,
               const void* vg, const void* gb, const void* dout, const void* m, const void* l,
               const void* delta, void* dq, void* dk, void* dv, void* dkg, void* dvg,
               void* live, int BH, int nh, int T_len, int w, int G, float scale,
               cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  constexpr int R = mma::kRows;
  const auto cq = [](const void* p) { return static_cast<const bf16*>(p); };
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const dim3 grid((T_len + R - 1) / R, BH);
  int err = launch_dyn(sliding_mma_dq_kernel<DH>, grid, sizeof(mma::DqTiles<DH>), s, cq(q),
                       cq(k), cq(v), cf(kb), cq(kg), cq(vg), cf(gb), cq(dout), cf(m), cf(l),
                       cf(delta), static_cast<bf16*>(dq), static_cast<int*>(live), nh, T_len,
                       w, G, scale);
  if (err) return err;
  err = launch_dyn(sliding_mma_dkv_kernel<DH>, grid, sizeof(mma::DkvTiles<DH>), s, cq(q), cq(k),
                   cq(v), cf(kb), cq(dout), cf(m), cf(l), cf(delta), static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), static_cast<const int*>(live), nh, T_len, w, scale);
  if (err) return err;
  return launch_dyn(sliding_mma_dkvg_kernel<DH>, dim3((G + R - 1) / R, BH),
                    sizeof(mma::DkvTiles<DH>), s, cq(q), cq(kg), cq(vg), cf(gb), cq(dout),
                    cf(m), cf(l), cf(delta), static_cast<float*>(dkg),
                    static_cast<float*>(dvg), static_cast<const int*>(live), nh, T_len, G,
                    scale);
}

// dtype 0 (f32) on the CUDA-core kernels, 1 (bf16) on the tensor-core ones
int launch_dtype(int dtype, int dh, const void* q, const void* k, const void* v,
                 const void* kb, const void* kg, const void* vg, const void* gb,
                 const void* dout, const void* m, const void* l, const void* delta, void* dq,
                 void* dk, void* dv, void* dkg, void* dvg, void* live, int BH, int nh,
                 int T_len, int w, int G, float scale, cudaStream_t s) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
#define ARGS q, k, v, kb, kg, vg, gb, dout, m, l, delta, dq, dk, dv, dkg, dvg
#define TAIL BH, nh, T_len, w, G, scale, s
  switch (dh) {
    case 32:
      return bf16 ? launch_mma<32>(ARGS, live, TAIL) : launch<32>(ARGS, TAIL);
    case 64:
      return bf16 ? launch_mma<64>(ARGS, live, TAIL) : launch<64>(ARGS, TAIL);
    case 128:
      return bf16 ? launch_mma<128>(ARGS, live, TAIL) : launch<128>(ARGS, TAIL);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TAIL
#undef ARGS
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. q/k/v/dout/dq/dk/dv [B*nh, T, dh]; key_bias
// [B, T] f32; kg/vg [B*nh, G, dh]; g_bias [B, G] f32; m/l/delta [B*nh, T]
// f32; dkg/dvg [B*nh, G, dh] f32; live [B*nh, ceil(T/64)] int32 scratch
// (bf16: pass 1 marks each 64-row tile whose dO is not all zero). T and w
// multiples of 32, G in [1, 128].
extern "C" int sliding_bwd_launch(const void* q, const void* k, const void* v,
                                  const void* key_bias, const void* kg, const void* vg,
                                  const void* g_bias, const void* dout, const void* m,
                                  const void* l, const void* delta, void* dq, void* dk,
                                  void* dv, void* dkg, void* dvg, void* live, int dtype, int B,
                                  int nh, int T_len, int dh, int w, int G, float scale,
                                  void* stream) {
  return launch_dtype(dtype, dh, q, k, v, key_bias, kg, vg, g_bias, dout, m, l, delta, dq, dk,
                      dv, dkg, dvg, live, B * nh, nh, T_len, w, G, scale,
                      static_cast<cudaStream_t>(stream));
}
