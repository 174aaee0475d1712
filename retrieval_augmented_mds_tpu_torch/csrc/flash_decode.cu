// Attention rows of one cached decoder step, for sm_90a: the decoder's
// self-attention over its KV cache and its cross-attention over the
// encoder's K/V heads, computed once per generation, while `generate` runs.
// Entry point `flash_decode_launch`.
//
// It replaces no TPU kernel: the JAX package's cached decoder step is XLA
// einsums (retrieval_augmented_mds_tpu/models/core.py `attention`). It was
// added because the plain PyTorch step copies what it reads: an f32 copy of
// K, layout copies of K and V for the batched matmuls (the cross K/V are
// the strided heads of a [B, S, H] projection), and an f32 logits tensor,
// about 10 GB a layer at a batch of 256 papers, 4 beams and 2048-token
// sources, which is most of a beam step.
//
// What it computes: for every (batch item b, head h), the g x t query rows
// of its g beams (g = q batch / kv batch; 1 for the self-attention, whose
// K/V are per beam) attend, in one softmax, to the S keys of k[b, h],
// scored q.k / sqrt(dh) where mask[b, key] holds and exactly -1e9 where it
// does not (as `masked_fill` makes it); out = softmax . v. A row with no
// open key comes out uniform over the S keys, as the plain path makes it.
//
// What bounds it on an H100: the bytes of K and V that the rows need, read
// once (at dh 64 a key costs 4 x 64 = 256 operations a row against 256
// bytes: far below the ~295 operations a byte the tensor cores need).
// What the design does about it:
//
// - One CTA per (b, h) and block of 16 folded rows: a cross-attention
//   CTA's g beams share one 16-row MMA tile, so each K/V tile is read once
//   for all of them (3,072 CTAs at B = 256, 12 heads); a self-attention CTA
//   holds one beam's row (12,288 CTAs over the 1,024 beam rows).
// - K and V are read in place through their strides (batch, head, key;
//   the head dims contiguous): the cross heads as `_split_heads` leaves
//   them, the cache as [B', nh, Tmax, dh]. Nothing is copied first.
// - Only the 64-key tiles that hold an open key are read (a tile masked
//   whole adds exactly nothing to a row with an open key: exp(-1e9 - m) =
//   0). The CTA reads the mask row once, at its start, into a bitmap of
//   open tiles; no host read. For the cache, the causal mask at one query
//   closes every tile past the step's position. A row with no open key
//   walks every tile, as its uniform row needs.
// - The 4 warps share the keys: warp w takes the open tiles of rank w,
//   w + 4, ... and walks each in sub-tiles of 32 keys (16 where a key's
//   row passes 128 bytes) through its own two `cp.async` buffers, so the
//   next sub-tile loads while this one computes and no warp waits on
//   another. Each warp keeps its own running max, denominator and output
//   (the online softmax on the C fragments); the warps merge through
//   shared memory at the end. Three warps would idle if one warp owned
//   the 16 rows and walked every tile, as in K4.
// - The arithmetic of the plain path: the operand policy of attn_mma.cuh
//   (bf16 m16n8k16 MMAs; in f32 split TF32, three TF32 MMAs a product,
//   which keep f32 accuracy, each tile's P V summed apart as K4 does), f32
//   scores, softmax and accumulators, P rounded to the operand type for
//   the P V product, the output written in the input dtype. No logits
//   tensor is written.

#include "attn_mma.cuh"

namespace {

using namespace attn;

constexpr int kRowsPerCta = 16;  // one MMA tile of query rows

// Keys a warp loads and scores at a time: 32, or 16 where a key's row (dh
// elements) passes 128 bytes, so that a warp's two buffers stay near 18 KB.
template <typename T, int DH>
constexpr int kSubKeys = DH * static_cast<int>(sizeof(T)) <= 128 ? 32 : 16;

template <typename T, int DH>
struct DecodeTiles {
  static constexpr int LD = mma::kLd<T, DH>, KS = kSubKeys<T, DH>;
  // a warp's two buffers of a K/V sub-tile; after its walk, its partial rows
  union __align__(16) Warp {
    struct {
      T k[2][KS][LD], v[2][KS][LD];
    } ring;
    struct {
      float acc[kRowsPerCta][DH + 4];
      float m[kRowsPerCta], l[kRowsPerCta];
    } part;
  };
  T q[kRowsPerCta][LD];
  Warp warp[kWarps];
  // the bitmap of open 64-key tiles follows: bit kt % 8 of byte kt / 8
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, long q_b, long q_h, long q_t,
                    const T* __restrict__ k, long k_b, long k_h, long k_s,
                    const T* __restrict__ v, long v_b, long v_h, long v_s,
                    const unsigned char* __restrict__ mask, long mask_b, T* __restrict__ out,
                    int nh, int g, int t_len, int s_len, float scale) {
  using namespace attn::mma;
  using Tiles = DecodeTiles<T, DH>;
  constexpr int KS = Tiles::KS;
  constexpr int kPer = 16 / sizeof(T), kChunks = DH / kPer;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem[];
  Tiles& sm = *reinterpret_cast<Tiles*>(smem);
  unsigned char* open_tiles = smem + sizeof(Tiles);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gr = lane >> 2, tc = lane & 3;
  const int b = blockIdx.x / nh, h = blockIdx.x % nh;
  const int rows = g * t_len, r0 = blockIdx.y * kRowsPerCta;
  const int n = (s_len + kTile - 1) / kTile;
  const unsigned char* mk = mask + b * mask_b;
  const T* kp = k + b * k_b + h * k_h;
  const T* vp = v + b * v_b + h * v_h;

  // the CTA's query rows: folded row r = j t + i is beam j's query i, which
  // lies in q's batch b g + j; rows past the last are zero
  for (int i = threadIdx.x; i < kRowsPerCta * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks, row = r0 + r;
    const bool ok = row < rows;
    const int j = ok ? row / t_len : 0, ti = ok ? row % t_len : 0;
    cp_async16(&sm.q[r][c * kPer],
               q + (long)(b * g + j) * q_b + (long)h * q_h + (long)ti * q_t + c * kPer, ok);
  }
  cp_async_commit();

  // the bitmap: thread i tests keys 16 i to 16 i + 15 of each 2048, so the
  // 4 lanes of a quad cover one tile, and a warp's ballot 8 tiles (a byte)
  bool any = false;
  for (int p0 = 0; p0 < s_len; p0 += kThreads * 16) {
    const int k0 = p0 + threadIdx.x * 16;
    bool hit = false;
#pragma unroll
    for (int i = 0; i < 16; ++i) hit |= k0 + i < s_len && mk[k0 + i] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    const int byte = p0 / (8 * kTile) + warp;
    if (lane == 0 && byte * 8 < n) {
      unsigned bits = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) bits |= ((bal >> (4 * i)) & 0xfu) ? 1u << i : 0u;
      open_tiles[byte] = static_cast<unsigned char>(bits);
    }
    any |= __syncthreads_or(hit) != 0;
  }
  cp_async_wait<0>();
  __syncthreads();

  const bool walk_all = !any;  // no open key: every row is uniform over S
  const auto is_open = [&](int kt) {
    return walk_all || ((open_tiles[kt >> 3] >> (kt & 7)) & 1);
  };
  const auto next_open = [&](int kt) {
    while (kt < n && !is_open(kt)) ++kt;
    return kt;
  };
  // the open tile kWarps ranks after kt: this warp's next
  const auto advance = [&](int kt) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) kt = next_open(kt + 1);
    return kt;
  };
  // sub-tiles of tile kt that start inside the source
  const auto subs = [&](int kt) { return min(kTile / KS, (s_len - kt * kTile + KS - 1) / KS); };

  typename Tiles::Warp& wsm = sm.warp[warp];
  const auto fetch = [&](int kt, int sub, int st, unsigned char (&mreg)[KS / 8][2]) {
    if (kt < n) {
      const int key0 = kt * kTile + sub * KS;
      for (int i = lane; i < KS * kChunks; i += 32) {
        const int r = i / kChunks, c = i % kChunks, p = key0 + r;
        const bool ok = p < s_len;
        const long pp = ok ? p : 0;
        cp_async16(&wsm.ring.k[st][r][c * kPer], kp + pp * k_s + c * kPer, ok);
        cp_async16(&wsm.ring.v[st][r][c * kPer], vp + pp * v_s + c * kPer, ok);
      }
      // this lane's columns 8 j + 2 tc and + 1 of the sub-tile
#pragma unroll
      for (int j = 0; j < KS / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = key0 + 8 * j + 2 * tc + c;
          mreg[j][c] = key < s_len ? mk[key] : 0;
        }
      }
    }
    cp_async_commit();
  };

  // running max, this lane's share of the denominator, the accumulator
  float acc[DH / 8][4] = {}, mr[2] = {-INFINITY, -INFINITY}, lr[2] = {0.f, 0.f};
  int kt = next_open(0);
  for (int i = 0; i < warp; ++i) kt = next_open(kt + 1);
  int sub = 0, st = 0;
  unsigned char mcur[KS / 8][2], mnxt[KS / 8][2];
  fetch(kt, 0, 0, mcur);
  while (kt < n) {
    int nkt = kt, nsub = sub + 1;
    if (nsub == subs(kt)) {
      nkt = advance(kt);
      nsub = 0;
    }
    fetch(nkt, nsub, st ^ 1, mnxt);
    cp_async_wait<1>();
    __syncwarp();
    const int key0 = kt * kTile + sub * KS;
    float s[KS / 8][4] = {};
    mma_xyt<DH, KS>(s, &sm.q[0][0], &wsm.ring.k[st][0][0]);
    float mx[2] = {mr[0], mr[1]};
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + 2 * tc + (e & 1);
        const float x = key >= s_len ? -INFINITY : mcur[j][e & 1] ? s[j][e] * scale : kMaskVal;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = quad_max(mx[hh]);  // finite: key0 < S is a column of every row
      alpha[hh] = __expf(mr[hh] - mx[hh]);
      mr[hh] = mx[hh];
      lr[hh] *= alpha[hh];
    }
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - mr[e >> 1]);
        lr[e >> 1] += s[j][e];
      }
    }
    POperand<T, KS> pa;
    to_a<KS>(pa, s);
    if constexpr (kTileSums<T>) {  // acc = acc * alpha + this sub-tile's P V
      float pv[DH / 8][4] = {};
      mma_py<DH, KS>(pv, pa, &wsm.ring.v[st][0][0]);
#pragma unroll
      for (int jd = 0; jd < DH / 8; ++jd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jd][e] = fmaf(acc[jd][e], alpha[e >> 1], pv[jd][e]);
      }
    } else {
#pragma unroll
      for (int jd = 0; jd < DH / 8; ++jd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jd][e] *= alpha[e >> 1];
      }
      mma_py<DH, KS>(acc, pa, &wsm.ring.v[st][0][0]);
    }
    __syncwarp();  // the buffer is refilled two sub-tiles on
    kt = nkt;
    sub = nsub;
    st ^= 1;
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
      mcur[j][0] = mnxt[j][0];
      mcur[j][1] = mnxt[j][1];
    }
  }
  cp_async_wait<0>();
  __syncwarp();

  // this warp's partial rows (a warp with no tile: max -inf, sums 0)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    lr[hh] = quad_sum(lr[hh]);
    if (tc == 0) {
      wsm.part.m[gr + 8 * hh] = mr[hh];
      wsm.part.l[gr + 8 * hh] = lr[hh];
    }
  }
#pragma unroll
  for (int jd = 0; jd < DH / 8; ++jd) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wsm.part.acc[gr + 8 * (e >> 1)][8 * jd + 2 * tc + (e & 1)] = acc[jd][e];
  }
  __syncthreads();

  // merge the warps' rows; out is [B g, t, nh, dh]
  for (int i = threadIdx.x; i < kRowsPerCta * DH / 2; i += kThreads) {
    const int r = i / (DH / 2), d = 2 * (i % (DH / 2)), row = r0 + r;
    if (row >= rows) continue;
    float mmax = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mmax = fmaxf(mmax, sm.warp[w].part.m[r]);
    float l = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm.warp[w].part.m[r];
      const float a = mw == -INFINITY ? 0.f : __expf(mw - mmax);
      l += a * sm.warp[w].part.l[r];
      o0 += a * sm.warp[w].part.acc[r][d];
      o1 += a * sm.warp[w].part.acc[r][d + 1];
    }
    const int j = row / t_len, ti = row % t_len;
    store_pair(out + (((long)(b * g + j) * t_len + ti) * nh + h) * DH + d, o0 / l, o1 / l);
  }
}

template <typename T, int DH>
int launch(const void* q, const long long* qs, const void* k, const long long* ks,
           const void* v, const long long* vs, const void* mask, long long mask_b, void* out,
           int bk, int nh, int g, int t_len, int s_len, float scale, cudaStream_t stream) {
  using Tiles = DecodeTiles<T, DH>;
  const int n = (s_len + mma::kTile - 1) / mma::kTile;
  const size_t smem = sizeof(Tiles) + (n + 7) / 8;
  const dim3 grid(bk * nh, (g * t_len + kRowsPerCta - 1) / kRowsPerCta);
  const auto ct = [](const void* p) { return static_cast<const T*>(p); };
  return launch_dyn(flash_decode_kernel<T, DH>, grid, smem, stream, ct(q), (long)qs[0],
                    (long)qs[1], (long)qs[2], ct(k), (long)ks[0], (long)ks[1], (long)ks[2],
                    ct(v), (long)vs[0], (long)vs[1], (long)vs[2],
                    static_cast<const unsigned char*>(mask), (long)mask_b,
                    static_cast<T*>(out), nh, g, t_len, s_len, scale);
}

template <typename T>
int launch_dh(int dh, const void* q, const long long* qs, const void* k, const long long* ks,
              const void* v, const long long* vs, const void* mask, long long mask_b,
              void* out, int bk, int nh, int g, int t_len, int s_len, float scale,
              cudaStream_t s) {
#define ARGS q, qs, k, ks, v, vs, mask, mask_b, out, bk, nh, g, t_len, s_len, scale, s
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

}  // namespace

// dtype 0 = f32 (split TF32), 1 = bf16. q [bk g, nh, t, dh] with element
// strides qs (batch, head, time); k, v [bk, nh, S, dh] with strides ks, vs
// (batch, head, key); the head dims of each contiguous, every stride and
// pointer a multiple of 16 bytes. mask: bool [bk or 1, S] at batch stride
// mask_b (0: one row for every b), keys contiguous. out: [bk g, t, nh, dh]
// contiguous. Any S >= 1 and t >= 1.
extern "C" int flash_decode_launch(const void* q, const long long* qs, const void* k,
                                   const long long* ks, const void* v, const long long* vs,
                                   const void* mask, long long mask_b, void* out, int dtype,
                                   int dh, int bk, int nh, int g, int t_len, int s_len,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS dh, q, qs, k, ks, v, vs, mask, mask_b, out, bk, nh, g, t_len, s_len, scale, s
  if (dtype == 0) return launch_dh<float>(ARGS);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(ARGS);
  return (int)cudaErrorInvalidValue;
#undef ARGS
}
