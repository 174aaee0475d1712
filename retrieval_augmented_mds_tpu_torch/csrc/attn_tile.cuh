// Tile routines shared by the attention kernels (forward and backward).
//
// All of them work on f32 CUDA cores in CTAs of 4 warps (bf16 K3, K5, K6
// and K7 run on tensor cores instead: attn_mma.cuh).
// A forward CTA owns BQ query rows (R per warp) and walks key tiles of 32
// (lane = key for the scores, lane = head dim for the accumulator), with an
// online softmax in f32. A backward CTA either owns query rows and walks
// key tiles (dq), or owns key rows and walks query tiles of 32 (dk, dv):
// the same loop with the roles of the two sides swapped. Shared-memory
// tiles that are read both along the head dim and along the tile are kept
// transposed, [DH][32 + 1]: lane = tile column reads consecutive words,
// lane = head dim reads words 33 apart, and neither conflicts on banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace attn {

constexpr float kMaskVal = -1e9f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = 4;
constexpr int kBK = 32;        // keys (or queries) per staged tile: one per lane
// a row whose max is within this of -1e9 saw no unmasked column
constexpr float kDegenerate = kMaskVal + 1000.f;
// the same for a row's log-sum-exp: -1e9 + log S rounds to -1e9 in f32
constexpr float kLseDegenerate = -1e8f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DH>
struct Tile {
  static constexpr int BQ = DH >= 128 ? 16 : 32;  // rows a CTA owns
  static constexpr int R = BQ / kWarps;           // rows per warp
  static constexpr int DV = DH / 32;              // head dims per lane
};

// ---------------------------------------------------------------------------
// forward: online softmax of BQ query rows over 32-key tiles
// ---------------------------------------------------------------------------

template <int DH>
struct Smem {
  float q[Tile<DH>::BQ][DH];  // pre-scaled queries
  float k[DH][kBK + 1];       // transposed key tile
  float v[kBK][DH];
  float p[kWarps][Tile<DH>::R][kBK];
};

// State of one warp's R rows: running max, denominator and accumulator.
template <int DH>
struct Rows {
  float m[Tile<DH>::R], l[Tile<DH>::R], acc[Tile<DH>::R][Tile<DH>::DV];
};

template <int DH>
__device__ void init_rows(Rows<DH>& st) {
#pragma unroll
  for (int r = 0; r < Tile<DH>::R; ++r) {
    st.m[r] = -FLT_MAX;
    st.l[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < Tile<DH>::DV; ++dd) st.acc[r][dd] = 0.f;
  }
}

// Stage BQ rows of src (row stride DH) from row0, times mul; rows at or
// past `end` are zero.
template <int DH, int N, typename T>
__device__ void stage_block(float (&dst)[N][DH], const T* __restrict__ src, int row0,
                            int end, float mul) {
  for (int i = threadIdx.x; i < N * DH; i += kThreads) {
    const int j = i / DH, pos = row0 + j;
    dst[j][i % DH] = pos < end ? to_f(src[(long)pos * DH + i % DH]) * mul : 0.f;
  }
}

// Stage keys/values src[pos0 + j] (j < kBK, valid while pos0 + j < end) into
// shared memory; invalid slots are zero.
template <int DH, typename T>
__device__ void stage(Smem<DH>& sm, const T* __restrict__ k, const T* __restrict__ v,
                      int pos0, int end) {
  for (int i = threadIdx.x; i < kBK * DH; i += kThreads) {
    const int j = i / DH, d = i % DH, pos = pos0 + j;
    float kv = 0.f, vv = 0.f;
    if (pos < end) {
      kv = to_f(k[(long)pos * DH + d]);
      vv = to_f(v[(long)pos * DH + d]);
    }
    sm.k[d][j] = kv;
    sm.v[j][d] = vv;
  }
}

// Scores of the staged tile against this warp's rows: s[r] for key = lane.
template <int DH>
__device__ void scores(const Smem<DH>& sm, int r0, float (&s)[Tile<DH>::R]) {
  constexpr int R = Tile<DH>::R;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    const float kd = sm.k[d][lane];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = fmaf(sm.q[r0 + r][d], kd, s[r]);
  }
}

// Online-softmax update of the warp's rows with the staged tile; lanes with
// !in are not columns of this tile.
template <int DH>
__device__ void update(Smem<DH>& sm, Rows<DH>& st, const float (&s)[Tile<DH>::R],
                       bool in) {
  constexpr int R = Tile<DH>::R, DV = Tile<DH>::DV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float mn = fmaxf(st.m[r], warp_max(in ? s[r] : -FLT_MAX));
    const float alpha = expf(st.m[r] - mn);
    const float p = in ? expf(s[r] - mn) : 0.f;
    st.l[r] = st.l[r] * alpha + warp_sum(p);
    st.m[r] = mn;
#pragma unroll
    for (int dd = 0; dd < DV; ++dd) st.acc[r][dd] *= alpha;
    sm.p[warp][r][lane] = p;
  }
  __syncwarp();
#pragma unroll 4
  for (int j = 0; j < kBK; ++j) {
    float vj[DV];
#pragma unroll
    for (int dd = 0; dd < DV; ++dd) vj[dd] = sm.v[j][lane + 32 * dd];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float pj = sm.p[warp][r][j];
#pragma unroll
      for (int dd = 0; dd < DV; ++dd) st.acc[r][dd] = fmaf(pj, vj[dd], st.acc[r][dd]);
    }
  }
  __syncwarp();
}

// Fold `count` columns of logit exactly -1e9, whose value rows sum to
// vsum[d], into the warp's rows. Only rows whose max is about -1e9 change.
template <int DH>
__device__ void add_masked_columns(Rows<DH>& st, float count, const float* vsum) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < Tile<DH>::R; ++r) {
    const float mn = fmaxf(st.m[r], kMaskVal);
    const float alpha = expf(st.m[r] - mn), pd = expf(kMaskVal - mn);
    st.l[r] = st.l[r] * alpha + count * pd;
    st.m[r] = mn;
#pragma unroll
    for (int dd = 0; dd < Tile<DH>::DV; ++dd)
      st.acc[r][dd] = st.acc[r][dd] * alpha + pd * vsum[lane + 32 * dd];
  }
}

// out = acc / l for the warp's rows (those below t_len), with m and l; with
// l == nullptr, m receives the log-sum-exp m + log l instead.
template <int DH, typename T>
__device__ void write_rows(const Rows<DH>& st, T* __restrict__ out, float* __restrict__ m,
                           float* __restrict__ l, int row0, int t_len) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < Tile<DH>::R; ++r) {
    const int qp = row0 + r;
    if (qp >= t_len) continue;
#pragma unroll
    for (int dd = 0; dd < Tile<DH>::DV; ++dd)
      store(&out[(long)qp * DH + lane + 32 * dd], st.acc[r][dd] / st.l[r]);
    if (lane == 0 && l == nullptr) {
      m[qp] = st.m[r] + logf(st.l[r]);
    } else if (lane == 0) {
      m[qp] = st.m[r];
      l[qp] = st.l[r];
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// A column's logit and whether the gradient flows through it. Masked
// columns (out of band, causal, outside the sequence) carry exactly -1e9
// and pass no gradient to q or k; an additive key bias of -1e9 is part of
// the logit and does pass it, as in the composites the kernels follow.
struct Logit {
  float s;
  bool grad;
};

// Transposed stage of a 32-row tile: dst[d][j] = src[pos0 + j][d] * mul,
// zero at or past `end`.
template <int DH, typename T>
__device__ void stage_t(float (&dst)[DH][kBK + 1], const T* __restrict__ src, int pos0,
                        int end, float mul) {
  for (int i = threadIdx.x; i < kBK * DH; i += kThreads) {
    const int j = i / DH, d = i % DH, pos = pos0 + j;
    dst[d][j] = pos < end ? to_f(src[(long)pos * DH + d]) * mul : 0.f;
  }
}

// dq pass: a CTA owns BQ query rows and walks key tiles.
template <int DH>
struct DqSmem {
  float q[Tile<DH>::BQ][DH];   // pre-scaled
  float dout[Tile<DH>::BQ][DH];
  float k[DH][kBK + 1];        // transposed key tile
  float v[DH][kBK + 1];        // transposed value tile
  float ds[kWarps][Tile<DH>::R][kBK];
};

// Per-row softmax statistics of a warp's R rows (every lane holds them).
template <int DH>
struct RowStats {
  float m[Tile<DH>::R], l[Tile<DH>::R], delta[Tile<DH>::R];
};

// How a backward reads the forward's statistics of a query row, as the pair
// (m, l) of p = exp(s - m) / l. MLStats: the row max and the denominator
// (K2, K4 keep them apart). `kRaw` arrays hold them per row; `decode`
// turns a row's raw values into (m, l), so a kernel may stage the raw
// arrays in shared memory.
struct MLStats {
  static constexpr int kRaw = 2;
  const float* m;
  const float* l;
  __device__ MLStats shifted(long o) const { return {m + o, l + o}; }
  __device__ const float* raw(int a) const { return a == 0 ? m : l; }
  __device__ float2 decode(float a, float b) const { return make_float2(a, b); }
  __device__ float2 operator[](int i) const { return make_float2(m[i], l[i]); }
};

// LseStats: one log-sum-exp per row (K6). A row with an open key reads
// (lse, 1). A fully masked row has every logit at exactly -1e9, so its
// lse = -1e9 + log S rounds to -1e9 and exp(s - lse) would give each key
// 1, not 1/S; it reads the closed form (-1e9, S): uniform over the S keys.
struct LseStats {
  static constexpr int kRaw = 1;
  const float* lse;
  float s_len;
  __device__ LseStats shifted(long o) const { return {lse + o, s_len}; }
  __device__ const float* raw(int) const { return lse; }
  __device__ float2 decode(float x, float) const {
    return x <= kLseDegenerate ? make_float2(kMaskVal, s_len) : make_float2(x, 1.f);
  }
  __device__ float2 operator[](int i) const { return decode(lse[i], 0.f); }
};

template <int DH, typename Stats>
__device__ void load_stats(RowStats<DH>& rs, const Stats& st, const float* __restrict__ delta,
                           int row0, int t_len) {
#pragma unroll
  for (int r = 0; r < Tile<DH>::R; ++r) {
    const int qp = row0 + r;
    const bool ok = qp < t_len;
    const float2 ml = ok ? st[qp] : make_float2(0.f, 1.f);
    rs.m[r] = ml.x;
    rs.l[r] = ml.y;
    rs.delta[r] = ok ? delta[qp] : 0.f;
  }
}

// One key tile of the dq pass. mask(r, s) gives the column's Logit for
// the warp's row r and key = lane (s: the scaled q.k score); `in` says
// whether this lane is a column at all. Accumulates ds . k into acc.
template <int DH, typename Mask>
__device__ void dq_tile(DqSmem<DH>& sm, const RowStats<DH>& rs, int r0, bool in,
                        const Mask& mask, float (&acc)[Tile<DH>::R][Tile<DH>::DV]) {
  constexpr int R = Tile<DH>::R, DV = Tile<DH>::DV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s[R], dp[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    const float kd = sm.k[d][lane], vd = sm.v[d][lane];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = fmaf(sm.q[r0 + r][d], kd, s[r]);
      dp[r] = fmaf(sm.dout[r0 + r][d], vd, dp[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const Logit lg = mask(r, s[r]);
    const float p = in ? expf(lg.s - rs.m[r]) / rs.l[r] : 0.f;
    sm.ds[warp][r][lane] = (in && lg.grad) ? p * (dp[r] - rs.delta[r]) : 0.f;
  }
  __syncwarp();
#pragma unroll 4
  for (int j = 0; j < kBK; ++j) {
    float kj[DV];
#pragma unroll
    for (int dd = 0; dd < DV; ++dd) kj[dd] = sm.k[lane + 32 * dd][j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float dsj = sm.ds[warp][r][j];
#pragma unroll
      for (int dd = 0; dd < DV; ++dd) acc[r][dd] = fmaf(dsj, kj[dd], acc[r][dd]);
    }
  }
  __syncwarp();
}

// dk/dv pass: a CTA owns BQ key rows and walks query tiles of 32.
template <int DH>
struct DkvSmem {
  float k[Tile<DH>::BQ][DH];  // this CTA's keys
  float v[Tile<DH>::BQ][DH];
  float q[DH][kBK + 1];       // transposed, pre-scaled query tile
  float dout[DH][kBK + 1];    // transposed
  float m[kBK], l[kBK], delta[kBK];
  float p[kWarps][Tile<DH>::R][kBK];
  float ds[kWarps][Tile<DH>::R][kBK];
};

// Stage the query tile pos0.. (32 rows, valid below t_len) and its stats.
template <int DH, typename T, typename Stats>
__device__ void stage_queries(DkvSmem<DH>& sm, const T* __restrict__ q,
                              const T* __restrict__ dout, const Stats& st,
                              const float* __restrict__ delta, int pos0, int t_len,
                              float scale) {
  stage_t<DH>(sm.q, q, pos0, t_len, scale);
  stage_t<DH>(sm.dout, dout, pos0, t_len, 1.f);
  for (int j = threadIdx.x; j < kBK; j += kThreads) {
    const int pos = pos0 + j;
    const bool ok = pos < t_len;
    const float2 ml = ok ? st[pos] : make_float2(0.f, 1.f);
    sm.m[j] = ml.x;
    sm.l[j] = ml.y;
    sm.delta[j] = ok ? delta[pos] : 0.f;
  }
}

// One query tile of the dk/dv pass. mask(r, s) gives the Logit of the
// warp's key r for query = lane; `in` says whether this lane is a query row
// that has the key as a column. Accumulates p . dO into dv and ds . q into
// dk (q carries the scale, so dk is final).
template <int DH, typename Mask>
__device__ void dkv_tile(DkvSmem<DH>& sm, int r0, bool in, const Mask& mask,
                         float (&dk)[Tile<DH>::R][Tile<DH>::DV],
                         float (&dv)[Tile<DH>::R][Tile<DH>::DV]) {
  constexpr int R = Tile<DH>::R, DV = Tile<DH>::DV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s[R], dp[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    const float qd = sm.q[d][lane], dod = sm.dout[d][lane];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = fmaf(sm.k[r0 + r][d], qd, s[r]);
      dp[r] = fmaf(sm.v[r0 + r][d], dod, dp[r]);
    }
  }
  const float m = sm.m[lane], l = sm.l[lane], delta = sm.delta[lane];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const Logit lg = mask(r, s[r]);
    const float p = in ? expf(lg.s - m) / l : 0.f;
    sm.p[warp][r][lane] = p;
    sm.ds[warp][r][lane] = (in && lg.grad) ? p * (dp[r] - delta) : 0.f;
  }
  __syncwarp();
#pragma unroll 4
  for (int j = 0; j < kBK; ++j) {
    float qj[DV], doj[DV];
#pragma unroll
    for (int dd = 0; dd < DV; ++dd) {
      qj[dd] = sm.q[lane + 32 * dd][j];
      doj[dd] = sm.dout[lane + 32 * dd][j];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float pj = sm.p[warp][r][j], dsj = sm.ds[warp][r][j];
#pragma unroll
      for (int dd = 0; dd < DV; ++dd) {
        dv[r][dd] = fmaf(pj, doj[dd], dv[r][dd]);
        dk[r][dd] = fmaf(dsj, qj[dd], dk[r][dd]);
      }
    }
  }
  __syncwarp();
}

// Store R rows of a [*, DH] accumulator (times mul) for rows below end.
template <int DH, typename T>
__device__ void write_acc(const float (&acc)[Tile<DH>::R][Tile<DH>::DV], T* __restrict__ dst,
                          int row0, int end, float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < Tile<DH>::R; ++r) {
    if (row0 + r >= end) continue;
#pragma unroll
    for (int dd = 0; dd < Tile<DH>::DV; ++dd)
      store(&dst[(long)(row0 + r) * DH + lane + 32 * dd], acc[r][dd] * mul);
  }
}

// Launch a kernel whose shared memory may pass the 48 KB static limit.
template <typename Kernel, typename... Args>
int launch_dyn(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace attn
