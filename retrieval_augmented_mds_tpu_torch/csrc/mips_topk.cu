// Exact maximum-inner-product top-k over a flat corpus, for sm_90a.
//
// Replaces the TPU kernel `_kernel` of retrieval_augmented_mds_tpu/ops/
// mips_topk.py (called from `mips_topk`). Same contract:
//   scores = (q . e) * row_scale + row_bias, accumulated in f32;
//   columns >= N and per-query ignored ids are masked to -3e38;
//   the result is the top-k of the DISTINCT score values, each reported with
//   the lowest corpus index that holds it; leftover slots are (-3e38, -1).
//
// What bounds it on an H100: bytes at the bf16/int8 shapes that matter,
// operations in f32. At the serving shape (B = 256 queries, N = 131072
// rows, D = 768, bf16) the corpus is 201 MB, ~60 us at 3.35 TB/s, against
// 25.8 G multiply-adds, ~52 us at the bf16 tensor-core peak: the products
// must run on the tensor cores and the corpus must come from HBM about
// once. On the path's own shape (the IVF spill or a flat SQ8 scan, B = 4
// over 0.5-1M int8 rows) it is the corpus alone: 805 MB of int8 at 1M
// rows, ~0.24 ms. f32 at the retriever's full-KB validation (B = N = 1997,
// D = 768): 6.1 GFLOP, 0.091 ms on the CUDA cores, 0.037 ms as split TF32
// (three TF32 products each at 495 TFLOP/s), against 0.004 ms of bytes;
// at the serving shape in f32, 51.5 GFLOP, 0.313 ms in split TF32 against
// 0.120 ms of bytes.
//
// Design. Pass 1 is `mma.sync` on the shared score tile of mips_tile.cuh
// (grid.x = groups of NQ queries, grid.y = splits of the corpus, so the
// query groups that read one corpus slab run together and share it
// through L2): bf16 and int8 corpora in bf16 products, f32 in split TF32
// against f32 queries, each 32-dim slab summed apart and added by FADD.
// Split TF32 keeps the f32 kernel's values at f32 accuracy (each product
// to ~2^-21 of |q_i e_i|, the sums rounded to nearest once a slab; one
// TF32 pass would lose ~2^-11) and its ids equal to the plain f32 scores'
// but where two scores lie within that error. `mips_topk_layout` reports
// each instance's layout and occupancy, from which ops/mips_topk.py plans
// the splits.
//
// The tile's scores feed one selection, per (split, query): a running list
// of up to k distinct values in shared memory, each with its lowest row, and
// a threshold, the list's k-th value (-3e38 while it holds fewer). The rows
// are offered in parts of 128, in ascending order: a part's scores are
// staged in shared memory, and a CTA-wide vote (`__syncthreads_or`) skips
// every part in which no score beats its query's threshold, which is most of
// them once the lists are full and the splits long. Otherwise one plain loop
// over the staged scores offers each score strictly greater than the
// threshold whose row is not among the query's ignored ids (the ignore test
// runs on candidates only) to the query's candidate buffer, a slot taken
// with a shared-memory atomicAdd. When a buffer is half full after a part,
// or overflowed during one, one warp per query merges buffer and list by
// `topk::warp_select` (largest value, lowest row holding it, every equal
// value dropped; the rule K8 shares) and the threshold rises. Padding
// queries (b >= B) do no selection work.
//
// An overflowed part is offered again after the merge, this time every
// score AT OR above the new threshold. Which scores won the slots is up to
// the scheduler, so the buffer may have held a higher row of a value
// without its lowest one; the new threshold is no higher than the part's
// true k-th value, so the second pass offers every row of every value the
// list can keep, the lowest ones among them, and they fit: the buffer is
// empty and holds as many candidates as a part has rows. Candidates offered
// twice collapse in the merge, so the result does not depend on which
// scores won the slots, and reruns are bit-equal. The staging keeps the
// offer code out of the products' path: it exists once instead of at each
// of the 64 scores a thread holds (inlined there, it slowed the whole walk
// by a third; not inlined, the calls spilled the accumulators).
//
// Why the filter is exact: rows are walked in ascending order within a
// split, so a later score equal to a listed value, or to the threshold,
// never has a lower row; a score below the threshold is below k distinct
// values already seen. Pass 2 merges the per-split lists [B, splits, k]
// with the same rule. That merge is exact: a value among the global top-k
// distinct values is among the top-k distinct values of every split
// holding it, reported there with that split's lowest index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "mips_tile.cuh"
#include "topk_select.cuh"

namespace {

using mips::bf16;
using mips::kThreads;
using mips::kWarps;
using topk::kNegInf;
using topk::warp_max;
using topk::warp_min;

constexpr int kMaxK = 128;
constexpr int kStageLD = mips::kPartRows + 4;  // floats per query of a staged part

// The running selection of NQ queries in dynamic shared memory: candidate
// buffers of CAP (= the rows of a part) per query, the running lists, the
// thresholds, the buffer counts and two flags (0: a buffer overflowed, 1: a
// buffer is at least half full).
template <int NQ>
struct Selector {
  static constexpr int CAP = mips::kPartRows;
  float* cv;
  int* ci;
  float* rv;
  int* ri;
  float* thr;
  int* cnt;
  int* flags;
  int k;
  const int* ignore;
  int n_ignore;

  static constexpr size_t bytes(int k) {
    return (size_t)NQ * (8 * CAP + 8 * k + 8) + 16;
  }

  __device__ Selector(char* base, int k_, const int* ignore_, int n_ignore_)
      : k(k_), ignore(ignore_), n_ignore(n_ignore_) {
    cv = reinterpret_cast<float*>(base);
    ci = reinterpret_cast<int*>(cv + NQ * CAP);
    rv = reinterpret_cast<float*>(ci + NQ * CAP);
    ri = reinterpret_cast<int*>(rv + NQ * k);
    thr = reinterpret_cast<float*>(ri + NQ * k);
    cnt = reinterpret_cast<int*>(thr + NQ);
    flags = cnt + NQ;
  }

  __device__ void init() {
    for (int i = threadIdx.x; i < NQ * k; i += kThreads) {
      rv[i] = kNegInf;
      ri[i] = -1;
    }
    for (int i = threadIdx.x; i < NQ; i += kThreads) {
      thr[i] = kNegInf;
      cnt[i] = 0;
    }
    if (threadIdx.x < 2) flags[threadIdx.x] = 0;
  }

  // The filter: strictly above the query's threshold; on the pass after an
  // overflow (again), at or above it (see the note at the top).
  __device__ __forceinline__ bool admits(int qi, float s, bool again) const {
    const float th = thr[qi];
    return s > th || (again && s == th && s > kNegInf);
  }

  // An admitted score: into the query's buffer unless its row is ignored.
  __device__ __forceinline__ void offer(int qi, int b, int row, float s) {
    for (int t = 0; t < n_ignore; ++t)
      if (ignore[(long)b * n_ignore + t] == row) return;
    const int pos = atomicAdd(cnt + qi, 1);
    if (pos < CAP) {
      cv[qi * CAP + pos] = s;
      ci[qi * CAP + pos] = row;
      if (pos >= CAP / 2) flags[1] = 1;
    } else {
      flags[0] = 1;
    }
  }

  // Merge every non-empty buffer into its list (one warp per query), raise
  // the thresholds, empty the buffers and clear the flags. All threads.
  __device__ void flush() {
    constexpr int NC = CAP / 32, NR = kMaxK / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int qi = warp; qi < NQ; qi += kWarps) {
      const int c = min(cnt[qi], CAP);  // warp-uniform
      if (c == 0) continue;
      float v[NC + NR];
      int id[NC + NR];
#pragma unroll
      for (int s = 0; s < NC; ++s) {
        const int j = lane + 32 * s;
        v[s] = j < c ? cv[qi * CAP + j] : kNegInf;
        id[s] = j < c ? ci[qi * CAP + j] : INT_MAX;
      }
#pragma unroll
      for (int s = 0; s < NR; ++s) {
        const int j = lane + 32 * s;
        v[NC + s] = j < k ? rv[qi * k + j] : kNegInf;
        id[NC + s] = j < k ? ri[qi * k + j] : INT_MAX;
      }
      __syncwarp();
      topk::warp_select(v, id, k, rv + qi * k, ri + qi * k, -1);
      __syncwarp();
      if (lane == 0) {
        thr[qi] = rv[qi * k + k - 1];
        cnt[qi] = 0;
      }
    }
    if (threadIdx.x < 2) flags[threadIdx.x] = 0;
    __syncthreads();
  }

  // One part: the scores st[NQ][kStageLD] of its CAP rows from row `base`.
  // Skipped unless some thread's `any` (it saw a score of a query below B
  // beat that query's threshold) is set; else offered, merged when a buffer
  // is half full, and merged and offered again when one overflowed. All
  // threads; on return no thread reads st any more.
  __device__ void take_part(const float* st, int base, int qb0, int B, bool any) {
    if (!__syncthreads_or(any)) return;
    for (bool again = false;; again = true) {
      for (int x = threadIdx.x; x < NQ * CAP; x += kThreads) {
        const int qi = x / CAP, r = x % CAP, b = qb0 + qi;
        const float s = st[qi * kStageLD + r];
        if (b < B && admits(qi, s, again)) offer(qi, b, base + r, s);
      }
      __syncthreads();
      const int overflow = flags[0], half = flags[1];
      __syncthreads();  // every thread has read the flags before flush clears them
      if (!(overflow | half)) return;
      flush();
      if (!overflow) return;
    }
  }

  // The lists of the queries below B to part_[v|i][b, split, :].
  __device__ void write(int qb0, int B, int split, int splits, float* __restrict__ part_v,
                        int* __restrict__ part_i) {
    for (int i = threadIdx.x; i < NQ * k; i += kThreads) {
      const int qi = i / k, kk = i % k, b = qb0 + qi;
      if (b < B) {
        const long o = ((long)b * splits + split) * k + kk;
        part_v[o] = rv[i];
        part_i[o] = ri[i];
      }
    }
  }
};

// ---------------------------------------------------------------------------
// pass 1: tensor-core score tiles
// ---------------------------------------------------------------------------

template <typename ET, int NQ, bool VEC>
__global__ void __launch_bounds__(kThreads)
mips_mma_partial_kernel(const typename mips::Slab<ET, NQ>::QT* __restrict__ q,
                        const ET* __restrict__ E,
                        const float* __restrict__ bias, const float* __restrict__ scale,
                        const int* __restrict__ ignore, int n_ignore, int B, int N, int D,
                        int k, int rows_per_split, float* __restrict__ part_v,
                        int* __restrict__ part_i) {
  extern __shared__ __align__(16) char smem[];
  using S = mips::Slab<ET, NQ>;
  constexpr int MT = S::MT;
  static_assert(NQ * kStageLD * sizeof(float) <= S::kBytes, "a staged part fits a stage");
  Selector<NQ> sel(smem + mips::kStages * S::kBytes, k, ignore, n_ignore);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int qb0 = blockIdx.x * NQ, split = blockIdx.y, splits = gridDim.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  sel.init();
  __syncthreads();

  mips::walk_tiles<ET, NQ, VEC>(
      smem, E, q, row_begin, row_end, qb0, B, D,
      [&](mips::Acc<ET, NQ>& acc, int row0, char* scratch) {
        // The tile in parts of 128 rows, in ascending order: the part's
        // warps stage its scores [NQ][kStageLD] in the stage just
        // multiplied and note whether one beats its query's threshold.
        float* st = reinterpret_cast<float*>(scratch);
        __syncthreads();  // every warp is done with the stage
#pragma unroll
        for (int part = 0; part < MT; ++part) {
          bool any = false;
          if (warp / (kWarps / MT) == part) {
            int rp[MT][2];
            float sc[MT][2], bi[MT][2];
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = 16 * (MT * warp + i) + g + 8 * h, row = row0 + r;
                const bool ok = row < row_end;
                rp[i][h] = r - part * mips::kPartRows;
                sc[i][h] = !ok ? 0.f : scale ? scale[row] : 1.f;
                bi[i][h] = !ok ? kNegInf : bias ? bias[row] : 0.f;
              }
#pragma unroll
            for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int qi = 8 * j + 2 * t + e;
                const float th = qb0 + qi < B ? sel.thr[qi] : FLT_MAX;
#pragma unroll
                for (int i = 0; i < MT; ++i)
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    // rows past the split: scale 0, bias -3e38, so s = -3e38
                    const float s = mips::score(acc[i][j][2 * h + e], sc[i][h], bi[i][h]);
                    st[qi * kStageLD + rp[i][h]] = s;
                    any |= s > th;
                  }
              }
          }
          sel.take_part(st, row0 + part * mips::kPartRows, qb0, B, any);
        }
      });
  sel.flush();
  sel.write(qb0, B, split, splits, part_v, part_i);
}

// One warp per query: k selection rounds over its splits*k candidates.
// Removed candidates are overwritten in the scratch buffer.
__global__ void __launch_bounds__(kThreads)
mips_merge_kernel(float* __restrict__ part_v, const int* __restrict__ part_i,
                  int B, int n_cand, int k, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warp
  float* pv = part_v + (long)b * n_cand;
  const int* pi = part_i + (long)b * n_cand;
  for (int r = 0; r < k; ++r) {
    float m = kNegInf;
    for (int j = lane; j < n_cand; j += 32) m = fmaxf(m, pv[j]);
    m = warp_max(m);
    int best = -1;
    if (m > kNegInf) {
      best = INT_MAX;
      for (int j = lane; j < n_cand; j += 32) {
        if (pv[j] == m) {
          best = min(best, pi[j]);
          pv[j] = kNegInf;
        }
      }
      best = warp_min(best);
    }
    if (lane == 0) {
      out_v[(long)b * k + r] = m;
      out_i[(long)b * k + r] = best;
    }
  }
}

struct Args {
  const void *q, *corpus, *bias, *scale, *ignore;
  int n_ignore, B, N, D, k, rows_per_split, splits;
  void *part_v, *part_i;
};

// Each instance below either launches (layout null) or describes itself.
template <typename ET, int NQ, bool VEC>
cudaError_t run_mma(const Args& a, cudaStream_t s, int* layout) {
  using S = mips::Slab<ET, NQ>;
  auto kern = mips_mma_partial_kernel<ET, NQ, VEC>;
  constexpr int kRows = S::ROWS;
  const size_t smem = mips::kStages * S::kBytes + Selector<NQ>::bytes(a.k);
  if (layout) return mips::describe(kern, NQ, kRows, smem, layout);
  if (a.rows_per_split % kRows != 0) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.B + NQ - 1) / NQ, a.splits);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const typename S::QT*>(a.q), static_cast<const ET*>(a.corpus),
      static_cast<const float*>(a.bias), static_cast<const float*>(a.scale),
      static_cast<const int*>(a.ignore), a.n_ignore, a.B, a.N, a.D, a.k, a.rows_per_split,
      static_cast<float*>(a.part_v), static_cast<int*>(a.part_i));
  return cudaGetLastError();
}

template <typename ET, bool VEC>
cudaError_t run_mma_nq(int nq, const Args& a, cudaStream_t s, int* layout) {
  switch (nq) {
    case 8: return run_mma<ET, 8, VEC>(a, s, layout);
    case 16: return run_mma<ET, 16, VEC>(a, s, layout);
    case 32: return run_mma<ET, 32, VEC>(a, s, layout);
    case 64: return run_mma<ET, 64, VEC>(a, s, layout);
    default: return cudaErrorInvalidValue;
  }
}

template <typename ET>
cudaError_t run_mma_vec(int nq, int vec, const Args& a, cudaStream_t s, int* layout) {
  return vec ? run_mma_nq<ET, true>(nq, a, s, layout) : run_mma_nq<ET, false>(nq, a, s, layout);
}

cudaError_t run(int dtype, int nq, int vec, const Args& a, cudaStream_t s, int* layout) {
  if (a.k < 1 || a.k > kMaxK) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return run_mma_vec<float>(nq, vec, a, s, layout);
    case 1: return run_mma_vec<bf16>(nq, vec, a, s, layout);
    case 2: return run_mma_vec<int8_t>(nq, vec, a, s, layout);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32 (q f32 [B, D], split TF32), 1 = bf16, 2 = int8 (q bf16
// [B, D], rounded by the caller); groups of nq = 8, 16 (128-row tiles), 32
// or 64 queries (256-row tiles); vec = 1 when D * sizeof(corpus element)
// and D * sizeof(query element) are multiples of 16 and both pointers
// 16-byte aligned. layout receives the instance's {queries per CTA, corpus
// rows per tile, dynamic shared memory in bytes, CTAs per SM on the
// current device (0: it does not fit)}, which the caller plans its splits
// from.
extern "C" int mips_topk_layout(int dtype, int nq, int vec, int k, int* layout) {
  Args a{};
  a.k = k;
  return (int)run(dtype, nq, vec, a, nullptr, layout);
}

// As above; bias/scale may be null; ignore is [B, n_ignore] int32 or null.
// rows_per_split is a multiple of the tile's rows; part_* are [B, splits,
// k] scratch.
extern "C" int mips_topk_launch(const void* q, const void* corpus, int dtype,
                                const void* bias, const void* scale,
                                const void* ignore, int n_ignore, int B, int N,
                                int D, int k, int nq, int vec, int rows_per_split,
                                int splits, void* part_v, void* part_i, void* out_v,
                                void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, corpus, bias, scale, ignore, n_ignore, B, N, D, k, rows_per_split,
               splits, part_v, part_i};
  const cudaError_t err = run(dtype, nq, vec, a, s, nullptr);
  if (err != cudaSuccess) return (int)err;
  mips_merge_kernel<<<(B + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(
      static_cast<float*>(part_v), static_cast<const int*>(part_i), B, splits * k, k,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
