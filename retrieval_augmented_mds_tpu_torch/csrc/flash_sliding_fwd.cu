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
// What bounds it on an H100, and what the design does about it: per row
// the kernel reads ~2w keys and values that neighbouring rows share, so
// one CTA owns a block of rows and walks only the keys any of them can
// see, [q0 - w, q0 + rows + w) clipped to [0, T), then the globals, in one
// online softmax; HBM traffic is then about the q/k/v/out streams.
//
// The kernel runs on the tensor cores in both dtypes, one template over
// the operand policy of attn_mma.cuh: bf16 (every led_base slice) as
// m16n8k16 MMAs, f32 (the retriever's Longformer encoders, held to the
// plain version at 1e-4) as split-TF32 m16n8k8 MMAs, three per product,
// which keep f32 accuracy. The least time is the operations over the bf16
// tensor-core peak, or in f32 3 x the operations over the 495 TFLOP/s
// dense TF32 peak, or the bytes. What holds it back is the instruction count:
// in f32 about one instruction in fifteen is an MMA, the rest splitting
// each fragment element (4 integer and float ops), 32-bit shared loads,
// the softmax and addressing (static SASS of the dh-64 kernel;
// tools/torch_profile_dense_bwd.py --f32 times it). One CTA of 4 warps
// owns 64 query rows (16 per warp) and walks 64-key tiles that `cp.async`
// brings into two buffers (attn_mma.cuh):
// S = Q K^T and O += P V run with f32 accumulators; masks and the online
// softmax run on the C fragments, P becomes an operand only in registers
// (rounded to bf16, or split). f32 tiles take twice the shared memory:
// 88 KB a CTA at dh 64 (2 CTAs per SM), 171 KB at dh 128 (1 CTA per SM).
// Masks apply per element: a 64-row block spans two w-blocks when w is
// not a multiple of 64, so each row tests a key against its own band and
// its own window (a walked key outside the row's window is no column of
// it at all).
// Padding: a band key tile whose every key_bias is -1e9 adds exactly
// nothing to a row with an open column (p = exp(<= -9e8 + s - m) = 0, and
// the rescale of an earlier such tile is 0 too). The forward has no m
// beforehand, so the block decides from its inputs before the walk: every
// row has an open column when the batch has a valid global (every row
// sees every global; the LED and the Longformer make token 0 a global
// wherever it is not padding). Such a block visits only the tiles that
// hold an open key or an open global, marked once in a 64-bit mask before
// the walk; padded rows then cost one tile (the retriever's queries hold
// ~119 valid tokens of 512). A block of a batch with no valid global walks
// every tile, and a fully masked row adds the window keys out of its walk
// in closed form, per w-block.

#include "attn_mma.cuh"

namespace {

using namespace attn;

// T = bf16 or float (the operand policy): 64 rows a CTA, any T_len and w
// that are multiples of 32 with w dividing T_len.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, mma::kMinBlocks<T, DH>)
sliding_mma_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ key_bias,
                       const T* __restrict__ kg, const T* __restrict__ vg,
                       const float* __restrict__ g_bias, T* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out, int nh, int T_len,
                       int w, int G, float scale) {
  using namespace attn::mma;
  static_assert(kThreads >= 2 * kTile, "a thread per global tests the globals");
  extern __shared__ __align__(16) unsigned char smem[];
  FwdTiles<DH, T>& sm = *reinterpret_cast<FwdTiles<DH, T>*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / nh, q0 = blockIdx.x * kRows;
  const long base = (long)bh * T_len * DH, gbase = (long)bh * G * DH;
  const float* kb = key_bias + (long)b * T_len;
  const float* gb = g_bias + (long)b * G;

  load_rows<DH, kRows>(&sm.q[0][0], q + base, q0, T_len);
  cp_async_commit();
  // this lane's two rows (g and g + 8 of the warp's 16) and the window of
  // each: its w-block and the two beside it
  int row[2], wlo[2], whi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    wlo[h] = (row[h] / w - 1) * w;
    whi[h] = wlo[h] + 3 * w;
  }
  // the band keys any row of the block can see, then the globals
  const int qend = min(q0 + kRows, T_len);
  const int lo = max(q0 - w, 0), hi = min(qend + w, T_len);
  const int nb = (hi - lo + kTile - 1) / kTile, n = nb + (G + kTile - 1) / kTile;
  // keys in the band of every row of the block, [qend - 1 - w, q0 + w]
  const int clo = max(qend - 1 - w, 0), chi = min(q0 + w + 1, T_len);

  // every row has an open column if the batch has a valid global: then a
  // tile with no open key or global adds exactly nothing
  bool skip = __syncthreads_or(threadIdx.x < G && gb[threadIdx.x] > kMaskVal);
  // Such a block marks, once, the tiles that hold an open key or global
  // (bit i: tile i; at most 64 tiles, past that it walks every tile), so
  // the walk issues each tile's loads with no probe of the bias between.
  __shared__ unsigned long long marked;
  skip = skip && n <= 64;
  if (threadIdx.x == 0) marked = 0;
  __syncthreads();
  if (skip) {
    unsigned long long mine = 0;
    for (int p = threadIdx.x; p < hi - lo; p += kThreads)
      if (kb[lo + p] > kMaskVal) mine |= 1ull << (p / kTile);
    if (threadIdx.x < G && gb[threadIdx.x] > kMaskVal)
      mine |= 1ull << (nb + threadIdx.x / kTile);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mine |= __shfl_xor_sync(0xffffffffu, mine, o);
    if (lane == 0 && mine) atomicOr(&marked, mine);
  }
  __syncthreads();
  const unsigned long long walk = marked;
  const auto next = [&](int it) {
    if (it >= n || !skip) return it;
    const unsigned long long rest = walk >> it;
    return rest ? it + __ffsll(static_cast<long long>(rest)) - 1 : n;
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

  // running max (from -FLT_MAX: a row may have no column in a tile), this
  // lane's share of the denominator, the accumulator
  float acc[DH / 8][4] = {}, mr[2] = {-FLT_MAX, -FLT_MAX}, lr[2] = {0.f, 0.f};
  int cur = next(0), buf = 0;
  fetch(cur, 0);
  while (cur < n) {
    const int nxt = next(cur + 1);
    fetch(nxt, buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();
    const bool band = cur < nb;
    const int c0 = band ? lo + cur * kTile : (cur - nb) * kTile;  // first key or global
    // a band tile in the band of every row, inside [lo, hi): no mask
    const bool inner = band && c0 >= clo && c0 + kTile <= min(chi, hi);
    float s[kTile / 8][4] = {};
    mma_xyt<DH, kTile>(s, &sm.q[warp * 16][0], &sm.k[buf][0][0]);
    float mx[2] = {mr[0], mr[1]};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = 8 * j + 2 * t + (e & 1), col = c0 + c;
        const float logit = s[j][e] * scale + sm.bias[buf][c];
        float x = logit;
        if (!band) {
          x = col < G ? logit : -INFINITY;
        } else if (!inner) {
          // not a column of this row: past the walk or out of its window;
          // a window column out of its band: exactly -1e9
          x = col >= hi || col < wlo[h] || col >= whi[h] ? -INFINITY
              : abs(col - row[h]) <= w                  ? logit
                                                        : kMaskVal;
        }
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);  // >= -FLT_MAX: never -inf
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
    POperand<T, kTile> pa;
    to_a<kTile>(pa, s);
    mma_py<DH, kTile>(acc, pa, &sm.v[buf][0][0]);
    __syncthreads();
    cur = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) lr[h] = quad_sum(lr[h]);

  // fully masked rows (only in a block that walked every tile): add the
  // window columns out of [lo, hi), all exactly -1e9, in closed form. The
  // block's rows lie in w-blocks n0 and n0 + 1 (64 <= 2w).
  bool degenerate = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) degenerate |= row[h] < T_len && mr[h] < kDegenerate;
  if (!skip && __syncthreads_or(degenerate)) {
    const int n0 = q0 / w;
    for (int i = threadIdx.x; i < 2 * DH; i += kThreads) {
      const int wb = n0 + i / DH, d = i % DH;
      const int a = max((wb - 1) * w, 0), z = min((wb + 2) * w, T_len);
      float sum = 0.f;
      for (int pos = a; pos < min(z, lo); ++pos) sum += to_f32(v[base + (long)pos * DH + d]);
      for (int pos = max(a, hi); pos < z; ++pos) sum += to_f32(v[base + (long)pos * DH + d]);
      sm.vsum[i / DH][d] = sum;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= T_len || !(mr[h] < kDegenerate)) continue;
      // the window's 3w columns (positions outside [0, T) included) less
      // the ones walked
      const int walked = max(min(hi, whi[h]) - max(lo, wlo[h]), 0);
      const float count = static_cast<float>(3 * w - walked);
      const float* vs = sm.vsum[row[h] / w - n0];
      const float mn = fmaxf(mr[h], kMaskVal);
      const float a = expf(mr[h] - mn), pd = expf(kMaskVal - mn);
      lr[h] = lr[h] * a + count * pd;
      mr[h] = mn;
#pragma unroll
      for (int jd = 0; jd < DH / 8; ++jd) {
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2)
          acc[jd][2 * h + c2] = acc[jd][2 * h + c2] * a + pd * vs[8 * jd + 2 * t + c2];
      }
    }
  }
  const float inv[2] = {1.f / lr[0], 1.f / lr[1]};
  store_rows<DH>(acc, out + base, q0 + warp * 16, T_len, inv);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= T_len) continue;
      m_out[(long)bh * T_len + row[h]] = mr[h];
      l_out[(long)bh * T_len + row[h]] = lr[h];
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* kb, const void* kg,
           const void* vg, const void* gb, void* out, void* m, void* l, int BH, int nh,
           int T_len, int w, int G, float scale, cudaStream_t s) {
  const auto ct = [](const void* p) { return static_cast<const T*>(p); };
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  return launch_dyn(sliding_mma_fwd_kernel<T, DH>,
                    dim3((T_len + mma::kRows - 1) / mma::kRows, BH),
                    sizeof(mma::FwdTiles<DH, T>), s, ct(q), ct(k), ct(v), cf(kb), ct(kg),
                    ct(vg), cf(gb), static_cast<T*>(out), static_cast<float*>(m),
                    static_cast<float*>(l), nh, T_len, w, G, scale);
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, const void* kb,
              const void* kg, const void* vg, const void* gb, void* out, void* m, void* l,
              int BH, int nh, int T_len, int w, int G, float scale, cudaStream_t s) {
#define ARGS q, k, v, kb, kg, vg, gb, out, m, l, BH, nh, T_len, w, G, scale, s
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
#undef ARGS
}

// dtype 0 (f32: split TF32) or 1 (bf16), both on the tensor cores
int launch_dtype(int dtype, int dh, const void* q, const void* k, const void* v,
                 const void* kb, const void* kg, const void* vg, const void* gb, void* out,
                 void* m, void* l, int BH, int nh, int T_len, int w, int G, float scale,
                 cudaStream_t s) {
#define ARGS dh, q, k, v, kb, kg, vg, gb, out, m, l, BH, nh, T_len, w, G, scale, s
  if (dtype == 0) return launch_dh<float>(ARGS);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(ARGS);
  return (int)cudaErrorInvalidValue;
#undef ARGS
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. q/k/v/out [B*nh, T, dh]; key_bias [B, T] f32;
// kg/vg [B*nh, G, dh]; g_bias [B, G] f32 (1 <= G <= 128); m/l [B*nh, T] f32.
// T and w multiples of 32, w dividing T.
extern "C" int sliding_fwd_launch(const void* q, const void* k, const void* v,
                                  const void* key_bias, const void* kg,
                                  const void* vg, const void* g_bias, void* out,
                                  void* m, void* l, int dtype, int B, int nh,
                                  int T_len, int dh, int w, int G, float scale,
                                  void* stream) {
  return launch_dtype(dtype, dh, q, k, v, key_bias, kg, vg, g_bias, out, m, l, B * nh, nh,
                      T_len, w, G, scale, static_cast<cudaStream_t>(stream));
}
