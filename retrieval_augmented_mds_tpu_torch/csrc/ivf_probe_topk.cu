// Per-query IVF probe top-k, for sm_90a.
//
// Replaces the TPU kernel `_kernel` of retrieval_augmented_mds_tpu/index/
// ivf_serving.py (called from `ivf_search_serving`). Same contract: for each
// query i and each probe p < nprobe, cluster cid = probes[i, p] is scored,
//   s = (q_i . e) * scale[cid, slot] + bias[cid, slot], accumulated in f32
// (the caller rounds q to bf16 for an int8 or bf16 payload, as K1's does),
// and the result is the top-k of the DISTINCT score values over the query's
// probed rows, each with the lowest position p * L + slot holding it (the
// earlier probe rank, then the lower slot). Empty slots are (-3e38, INT_MAX);
// padding rows (bias -3e38) are never selected.
//
// What bounds it on an H100: bytes. At the serving shape (B = 4 queries,
// nprobe = 32, L = 1536 rows of D = 768 int8) the distinct probed clusters
// are ~150 MB, ~45 us at 3.35 TB/s, against 0.3 G multiply-adds. A design
// with one CTA per (query, probe, 256-row slice) stayed at 41% of that: a
// cluster probed by several queries was read once per query; every int8
// element took an I2F conversion (16 a clock on an SM against 128 FMAs) on
// 16 of a warp's 32 lanes; and one CTA per query merged ~2000 candidates
// behind block barriers in every round.
//
// Design. Pass 1 runs a fixed grid of (probe entry b * nprobe + p, row
// split). A CTA whose cluster an earlier entry also probes exits at once;
// the first such CTA (the head) gathers the entries that probe its cluster
// (a block-wide ballot over the probes, no sort, no host sync) and scores
// its split of the cluster's rows once for all of them, 8 queries at a
// time, on the bf16 tensor-core tile of mips_tile.cuh: 128 cluster rows on
// the M side, the gathered queries on the N side, D in 128-byte `cp.async`
// slabs through three stages (each asking L2 for the row's next 128 bytes),
// nothing of the payload copied or padded. int8 rows are widened in the A
// fragments by the tile's byte permutes and FADDs, no conversion
// instruction (11% off the kernel's time at SQ8 against the I2F widening
// the tile had before; one 4-byte load a row for a lane's four k-slots,
// with the query's dims permuted to match, was within 1% either way and
// would tie the wrapper to the fragment layout). f32 rows keep CUDA-core
// products (TF32 would change their numerics) on the same staged slabs,
// each thread a row and half of the queries. The per-row scale is applied
// to the score. Pass 1 is built for 3 CTAs an SM (at most 85 registers a
// thread, a few bytes of spills), which beat 2 CTAs of up to 128 registers.
//
// Selection, per (query, probe) of the run: K1's strict-greater threshold
// filter. A tile's scores are staged in shared memory, a CTA-wide vote skips
// the tile when no score beats its query's threshold (the list's k-th value),
// else each score above it is offered to the query's candidate buffer, which
// is merged into the list (`topk::warp_select`) when half full or overflowed;
// after an overflow the tile is offered again at or above the new threshold
// (the buffer's slots go to whichever warps win the atomics). Rows ascend
// within a split, so a later equal score never has a lower slot. Each
// (query, probe, split) gets one list of k, its positions p * L + slot with
// that query's own probe rank p. Pass 2, one CTA per query with one
// barrier, merges its nprobe * splits lists: each warp an eighth into a
// list of k in registers, then one warp the eight lists. Exact: a value
// among the query's top-k distinct values is among the top-k distinct
// values of every list holding it, reported there with that list's lowest
// position.
//
// Splits: the wrapper plans them from `ivf_probe_topk_layout`, as
// ops/mips_topk.py does for K1: one wave of CTAs when every probe could
// head its own run (B = 4, nprobe = 32: 3 splits of 512 rows), about four
// waves when the probes outnumber the card's CTA slots (B = 16: 4 splits).
// Against 1-12 forced splits this is the fastest, or within 1%, at B = 4,
// 16 and 31, and 3% off at B = 8 (one partial wave).
//
// Measured on an H100 SXM (80 GB HBM3, 700 W limit), 1M-row IVF1024
// indexes, nprobe 32, k 10 (tools/torch_ivf_dissect.py): SQ8 B = 4 0.080
// ms against its 0.045 ms bound (56%), B = 16 0.210 ms (70% of 0.147);
// bf16 B = 4 0.120 ms (74% of 0.089), B = 16 0.343 ms (85% of 0.292). At
// SQ8 B = 4 pass 1 takes 0.067 ms, the merge 0.008 and the query copy
// 0.001: the loads alone take ~0.057 ms and the products and selection,
// with the loads cut, ~0.054; they overlap only in part.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "mips_tile.cuh"
#include "topk_select.cuh"

namespace ivf {

using attn::mma::cp_async16;
using attn::mma::cp_async_commit;
using attn::mma::cp_async_wait;
using mips::bf16;
using mips::kThreads;
using mips::kWarps;
using topk::kNegInf;

constexpr int kMaxD = 8192;
constexpr int kMaxK = 128;
constexpr int kRows = mips::kPartRows;  // cluster rows per tile (one m16 tile per warp)
constexpr int kStageLD = kRows + 4;     // floats per query of a staged tile
constexpr int kNQ = 8;                  // queries of a run scored at a time
constexpr int kCtasPerSm = 3;           // pass 1 at most 85 registers a thread
constexpr int kEmpty = INT_MAX;         // the position of an empty slot

template <typename ET>
constexpr bool kF32 = std::is_same<ET, float>::value;

// 16 bytes of a payload row global -> shared, asynchronously (zeros when
// !ok), asking L2 to fetch the row's next 128 bytes with them: the walk
// reads each row in 128-byte slabs, two slabs apart in time.
__device__ __forceinline__ void cp_async16_row(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
                   attn::mma::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// One pipeline stage: a 128-byte slab of kRows cluster rows, and the same
// dims of the chunk's kNQ queries (bf16, or f32 for an f32 payload). For
// the tensor-core types it is mips::Slab's layout, which mma_slab reads.
template <typename ET>
struct Stage {
  using QT = std::conditional_t<kF32<ET>, float, bf16>;
  static constexpr int KS = mips::kSlabBytes / (int)sizeof(ET);  // dims per slab
  static constexpr int E_LD = mips::kSlabBytes + mips::kPadBytes;
  static constexpr int Q_LD = KS * (int)sizeof(QT) + mips::kPadBytes;
  static constexpr int kBytes = kRows * E_LD + kNQ * Q_LD;
};

// Accumulators of a tile: the tensor-core fragments, or f32 for NQ / 2
// queries of one row per thread.
template <typename ET>
struct Acc {
  std::conditional_t<kF32<ET>, float[kNQ / 2], mips::Acc<ET, kNQ>> a;
};

// Load slab d0 of cluster rows row0 .. row0 + kRows (rows at or past row_end
// are zero) and of the n queries of entries chunk_e[0 .. n) (the rest zero)
// into one stage.
template <typename ET>
__device__ __forceinline__ void load_stage(char* stage, const char* __restrict__ rows,
                                           const void* __restrict__ q, const int* chunk_e,
                                           int n, int P, int row0, int row_end, int D, int d0) {
  using S = Stage<ET>;
  using QT = typename S::QT;
  const long row_bytes = (long)D * sizeof(ET);
  const int db = d0 * (int)sizeof(ET);
  for (int i = threadIdx.x; i < kRows * (mips::kSlabBytes / 16); i += kThreads) {
    const int r = i >> 3, c = i & 7, row = row0 + r;
    const bool ok = row < row_end && db + c * 16 < row_bytes;
    cp_async16_row(stage + r * S::E_LD + c * 16,
                   rows + (ok ? row * row_bytes + db + c * 16 : 0), ok);
  }
  constexpr int kQC = S::KS * (int)sizeof(QT) / 16;  // 16-byte chunks per query row
  constexpr int kQE = 16 / (int)sizeof(QT);          // dims per chunk
  char* qs = stage + kRows * S::E_LD;
  const QT* Q = static_cast<const QT*>(q);
  for (int i = threadIdx.x; i < kNQ * kQC; i += kThreads) {
    const int r = i / kQC, c = i % kQC, d = d0 + c * kQE;
    const bool ok = r < n && d < D;
    const long b = ok ? chunk_e[r] / P : 0;
    cp_async16(qs + r * S::Q_LD + c * 16, Q + (ok ? b * D + d : 0), ok);
  }
}

// f32 products of one staged slab: thread (row r, half h) of queries
// h * NQ / 2 .. (h + 1) * NQ / 2 - 1; 16-byte shared reads of a row (its
// pitch of 9 chunks puts 8 rows on 8 distinct bank groups), the queries'
// reads broadcast.
__device__ __forceinline__ void fma_slab(float (&acc)[kNQ / 2], const char* stage) {
  using S = Stage<float>;
  const int r = threadIdx.x & (kRows - 1), h = threadIdx.x / kRows;
  const float4* er = reinterpret_cast<const float4*>(stage + r * S::E_LD);
  const char* qs = stage + kRows * S::E_LD + h * (kNQ / 2) * S::Q_LD;
#pragma unroll
  for (int c = 0; c < S::KS / 4; ++c) {
    const float4 e = er[c];
#pragma unroll
    for (int i = 0; i < kNQ / 2; ++i) {
      const float4 x = reinterpret_cast<const float4*>(qs + i * S::Q_LD)[c];
      acc[i] = fmaf(x.x, e.x, acc[i]);
      acc[i] = fmaf(x.y, e.y, acc[i]);
      acc[i] = fmaf(x.z, e.z, acc[i]);
      acc[i] = fmaf(x.w, e.w, acc[i]);
    }
  }
}

// The running selection of NQ queries (one (query, probe) list each) in
// dynamic shared memory: candidate buffers of CAP (a tile's rows) per query,
// the running lists, the thresholds, the buffer counts and two flags (0: a
// buffer overflowed, 1: a buffer is at least half full). K1's selector
// (mips_topk.cu) with positions for ids and no ignored ids.
template <int NQ>
struct Selector {
  static constexpr int CAP = kRows;
  float* cv;
  int* ci;
  float* rv;
  int* ri;
  float* thr;
  int* cnt;
  int* flags;
  int k;

  static constexpr size_t bytes(int k) { return (size_t)NQ * (8 * CAP + 8 * k + 8) + 16; }

  __device__ Selector(char* base, int k_) : k(k_) {
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
      ri[i] = kEmpty;
    }
    for (int i = threadIdx.x; i < NQ; i += kThreads) {
      thr[i] = kNegInf;
      cnt[i] = 0;
    }
    if (threadIdx.x < 2) flags[threadIdx.x] = 0;
  }

  // strictly above the query's threshold; on the pass after an overflow
  // (again), at or above it
  __device__ __forceinline__ bool admits(int qi, float s, bool again) const {
    const float th = thr[qi];
    return s > th || (again && s == th && s > kNegInf);
  }

  __device__ __forceinline__ void offer(int qi, int pos, float s) {
    const int slot = atomicAdd(cnt + qi, 1);
    if (slot < CAP) {
      cv[qi * CAP + slot] = s;
      ci[qi * CAP + slot] = pos;
      if (slot >= CAP / 2) flags[1] = 1;
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
        id[s] = j < c ? ci[qi * CAP + j] : kEmpty;
      }
#pragma unroll
      for (int s = 0; s < NR; ++s) {
        const int j = lane + 32 * s;
        v[NC + s] = j < k ? rv[qi * k + j] : kNegInf;
        id[NC + s] = j < k ? ri[qi * k + j] : kEmpty;
      }
      __syncwarp();
      topk::warp_select(v, id, k, rv + qi * k, ri + qi * k, kEmpty);
      __syncwarp();
      if (lane == 0) {
        thr[qi] = rv[qi * k + k - 1];
        cnt[qi] = 0;
      }
    }
    if (threadIdx.x < 2) flags[threadIdx.x] = 0;
    __syncthreads();
  }

  // One tile: the scores st[NQ][kStageLD] of its CAP rows from cluster row
  // `row0`; query qi's positions start at pbase[qi]. Skipped unless some
  // thread's `any` is set; else offered, merged when a buffer is half full,
  // merged and offered again when one overflowed. All threads; on return no
  // thread reads st any more.
  __device__ void take_tile(const float* st, int row0, int n, const int* pbase, bool any) {
    if (!__syncthreads_or(any)) return;
    for (bool again = false;; again = true) {
      for (int x = threadIdx.x; x < NQ * CAP; x += kThreads) {
        const int qi = x / CAP, r = x % CAP;
        const float s = st[qi * kStageLD + r];
        if (qi < n && admits(qi, s, again)) offer(qi, pbase[qi] + row0 + r, s);
      }
      __syncthreads();
      const int overflow = flags[0], half = flags[1];
      __syncthreads();  // every thread has read the flags before flush clears them
      if (!(overflow | half)) return;
      flush();
      if (!overflow) return;
    }
  }

  // The lists of the n queries of entries chunk_e[0 .. n) to
  // part_[v|i][entry, split, :].
  __device__ void write(const int* chunk_e, int n, int split, int splits,
                        float* __restrict__ part_v, int* __restrict__ part_i) {
    for (int i = threadIdx.x; i < NQ * k; i += kThreads) {
      const int qi = i / k, kk = i % k;
      if (qi < n) {
        const long o = ((long)chunk_e[qi] * splits + split) * k + kk;
        part_v[o] = rv[i];
        part_i[o] = ri[i];
      }
    }
  }
};

// Pass 1. grid = (B * nprobe entries b * P + p, splits). A CTA whose
// cluster an earlier entry probes exits at once; the first one (the head)
// gathers the entries that probe its cluster (its run, ascending) NQ at a
// time and walks (row tile, slab) steps of its split through kStages
// buffers for each such chunk.
template <typename ET>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
ivf_partial_kernel(const void* __restrict__ q, const char* __restrict__ payload,
                   const float* __restrict__ bias, const float* __restrict__ scale,
                   const int* __restrict__ probes, int BP, int P, int L, int D, int k,
                   int rows_per_split, float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ __align__(16) char smem[];
  using S = Stage<ET>;
  __shared__ int chunk_e[kNQ];  // the chunk's entries
  __shared__ int pbase[kNQ];    // their first positions, p * L
  __shared__ int warp_n[kWarps];
  const int e = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int c = probes[e];
  bool seen = false;
  for (int i = threadIdx.x; i < e; i += kThreads) seen |= probes[i] == c;
  if (__syncthreads_or(seen)) return;  // not its run's head (CTA-uniform)

  // The entries from e on that probe c: those ranked ch * NQ .. ch * NQ +
  // NQ - 1 to chunk_e → the run's length. All threads.
  auto gather = [&](int ch) {
    int base = 0;
    for (int i0 = e; i0 < BP; i0 += kThreads) {
      const int i = i0 + threadIdx.x;
      const bool m = i < BP && probes[i] == c;
      const unsigned bal = __ballot_sync(0xffffffffu, m);
      if (lane == 0) warp_n[warp] = __popc(bal);
      __syncthreads();
      int before = base, total = base;
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? warp_n[w] : 0;
        total += warp_n[w];
      }
      const int r = before + __popc(bal & ((1u << lane) - 1)) - ch * kNQ;
      if (m && r >= 0 && r < kNQ) chunk_e[r] = i;
      base = total;
      __syncthreads();  // warp_n is rewritten next round
    }
    return base;
  };
  const int n_run = gather(0);
  const int row_begin = split * rows_per_split;
  const int row_end = min(L, row_begin + rows_per_split);
  const int n_tile = row_end > row_begin ? (row_end - row_begin + kRows - 1) / kRows : 0;
  const int n_slab = (D + S::KS - 1) / S::KS, total = n_tile * n_slab;
  const char* rows = payload + (long)c * L * D * (long)sizeof(ET);
  const long crow = (long)c * L;  // the cluster's first row of bias / scale
  Selector<kNQ> sel(smem + mips::kStages * S::kBytes, k);
  Acc<ET> acc;
  auto zero = [&] {
    if constexpr (kF32<ET>) {
#pragma unroll
      for (int i = 0; i < kNQ / 2; ++i) acc.a[i] = 0.f;
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) acc.a[0][0][x] = 0.f;
    }
  };

  for (int ch = 0; ch * kNQ < n_run; ++ch) {
    if (ch > 0) gather(ch);
    const int n = min(kNQ, n_run - ch * kNQ);
    if (threadIdx.x < kNQ)
      pbase[threadIdx.x] = threadIdx.x < n ? (chunk_e[threadIdx.x] % P) * L : 0;
    sel.init();
    __syncthreads();
    auto issue = [&](int step) {
      if (step < total)
        load_stage<ET>(smem + (step % mips::kStages) * S::kBytes, rows, q, chunk_e, n, P,
                       row_begin + (step / n_slab) * kRows, row_end, D,
                       (step % n_slab) * S::KS);
      cp_async_commit();
    };
#pragma unroll
    for (int st = 0; st < mips::kStages - 1; ++st) issue(st);
    zero();
    for (int step = 0; step < total; ++step) {
      cp_async_wait<mips::kStages - 2>();
      __syncthreads();  // this step's stage has landed; the stage refilled below is free
      issue(step + mips::kStages - 1);
      char* stage = smem + (step % mips::kStages) * S::kBytes;
      if constexpr (kF32<ET>) {
        fma_slab(acc.a, stage);
      } else {
        mips::mma_slab<ET, kNQ>(acc.a, stage);
      }
      if (step % n_slab != n_slab - 1) continue;

      // the tile's scores [NQ][kStageLD] in the stage just multiplied
      const int row0 = row_begin + (step / n_slab) * kRows;
      float* st = reinterpret_cast<float*>(stage);
      __syncthreads();  // every warp is done with the stage
      bool any = false;
      if constexpr (kF32<ET>) {
        const int r = threadIdx.x & (kRows - 1), h = threadIdx.x / kRows, row = row0 + r;
        const bool ok = row < row_end;
        const float sc = !ok ? 0.f : scale ? scale[crow + row] : 1.f;
        const float bi = !ok ? kNegInf : bias[crow + row];
#pragma unroll
        for (int i = 0; i < kNQ / 2; ++i) {
          const int qi = h * (kNQ / 2) + i;
          const float sv = mips::score(acc.a[i], sc, bi);
          st[qi * kStageLD + r] = sv;
          any |= qi < n && sv > sel.thr[qi];
        }
      } else {
        float sc[2], bi[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + 16 * warp + g + 8 * hh;
          const bool ok = row < row_end;
          sc[hh] = !ok ? 0.f : scale ? scale[crow + row] : 1.f;
          bi[hh] = !ok ? kNegInf : bias[crow + row];
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int qi = 2 * t + x;
          const float th = qi < n ? sel.thr[qi] : FLT_MAX;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            // rows past the split: scale 0, bias -3e38, so s = -3e38
            const float sv = mips::score(acc.a[0][0][2 * hh + x], sc[hh], bi[hh]);
            st[qi * kStageLD + 16 * warp + g + 8 * hh] = sv;
            any |= sv > th;
          }
        }
      }
      sel.take_tile(st, row0, n, pbase, any);
      zero();
    }
    cp_async_wait<0>();
    sel.flush();
    sel.write(chunk_e, n, split, splits, part_v, part_i);
    __syncthreads();  // chunk_e and the lists are read before the next chunk
  }
}

// k rounds of `topk::warp_select` over the n candidates (v, id) and the
// running list (lv, li) of k in shared memory, 256 candidates a time; the
// list ends holding the top-k distinct values of both. One warp.
__device__ void warp_merge_into(const float* v, const int* id, int n, int k, float* lv,
                                int* li) {
  constexpr int NC = 8, NR = kMaxK / 32;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += 32 * NC) {
    float x[NC + NR];
    int y[NC + NR];
#pragma unroll
    for (int s = 0; s < NC; ++s) {
      const int j = base + lane + 32 * s;
      x[s] = j < n ? v[j] : kNegInf;
      y[s] = j < n ? id[j] : kEmpty;
    }
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      const int j = lane + 32 * s;
      x[NC + s] = j < k ? lv[j] : kNegInf;
      y[NC + s] = j < k ? li[j] : kEmpty;
    }
    __syncwarp();
    topk::warp_select(x, y, k, lv, li, kEmpty);
    __syncwarp();
  }
}

// Pass 2, one CTA per query over its n_cand = P * splits * k candidates:
// each warp takes an eighth into a list of k (registers, 256 at a time),
// then warp 0 merges the eight lists. One barrier.
__global__ void __launch_bounds__(kThreads)
ivf_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                 int n_cand, int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float lv[kWarps * kMaxK], fv[kMaxK];
  __shared__ int li[kWarps * kMaxK], fi[kMaxK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.x;
  const int per = (n_cand + kWarps - 1) / kWarps, lo = min(n_cand, warp * per);
  const int hi = min(n_cand, lo + per);
  for (int j = lane; j < k; j += 32) {
    lv[warp * k + j] = kNegInf;
    li[warp * k + j] = kEmpty;
    if (warp == 0) {
      fv[j] = kNegInf;
      fi[j] = kEmpty;
    }
  }
  __syncwarp();
  const long o = (long)b * n_cand + lo;
  warp_merge_into(part_v + o, part_i + o, hi - lo, k, lv + warp * k, li + warp * k);
  __syncthreads();
  if (warp == 0) {
    warp_merge_into(lv, li, kWarps * k, k, fv, fi);
    for (int j = lane; j < k; j += 32) {
      out_v[(long)b * k + j] = fv[j];
      out_i[(long)b * k + j] = fi[j];
    }
  }
}

struct Args {
  const void *q, *payload, *bias, *scale, *probes;
  int B, P, L, D, k, rows_per_split, splits;
  void *part_v, *part_i;
};

// Each instance either launches (layout null) or describes itself.
template <typename ET>
cudaError_t run_partial(const Args& a, cudaStream_t s, int* layout) {
  auto kern = ivf_partial_kernel<ET>;
  const size_t smem = mips::kStages * Stage<ET>::kBytes + Selector<kNQ>::bytes(a.k);
  if (layout) return mips::describe(kern, kNQ, kRows, smem, layout);
  if constexpr (!kF32<ET>)
    static_assert(Stage<ET>::kBytes == mips::Slab<ET, kNQ>::kBytes, "mma_slab's layout");
  static_assert(kNQ * kStageLD * sizeof(float) <= Stage<ET>::kBytes,
                "a tile fits a stage");
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.B * a.P, a.splits), kThreads, smem, s>>>(
      a.q, static_cast<const char*>(a.payload), static_cast<const float*>(a.bias),
      static_cast<const float*>(a.scale), static_cast<const int*>(a.probes), a.B * a.P, a.P,
      a.L, a.D, a.k, a.rows_per_split, static_cast<float*>(a.part_v),
      static_cast<int*>(a.part_i));
  return cudaGetLastError();
}

cudaError_t run(int dtype, const Args& a, cudaStream_t s, int* layout) {
  if (a.k < 1 || a.k > kMaxK) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return run_partial<float>(a, s, layout);
    case 1: return run_partial<bf16>(a, s, layout);
    case 2: return run_partial<int8_t>(a, s, layout);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ivf

// dtype: 0 = f32 (q f32 [B, D]), 1 = bf16, 2 = int8 (q bf16 [B, D], rounded
// by the caller). layout receives the instance's {queries per chunk,
// cluster rows per tile, dynamic shared memory in bytes, CTAs per SM on the
// current device (0: it does not fit)}, which the caller plans its splits
// from.
extern "C" int ivf_probe_topk_layout(int dtype, int k, int* layout) {
  ivf::Args a{};
  a.k = k;
  return (int)ivf::run(dtype, a, nullptr, layout);
}

// clustered is [C, L, D] with a 16-byte aligned base; bias [C, L] f32;
// scale [C, L] f32 or null; probes [B, P] int32. rows_per_split is a
// multiple of 128 and splits = ceil(L / rows_per_split); part_* are
// [B * P, splits, k] scratch.
extern "C" int ivf_probe_topk_launch(const void* q, const void* clustered, int dtype,
                                     const void* bias, const void* scale, const void* probes,
                                     int B, int P, int L, int D, int k, int rows_per_split,
                                     int splits, void* part_v, void* part_i, void* out_v,
                                     void* out_i, void* stream) {
  if (k < 1 || k > ivf::kMaxK || D % 16 != 0 || D > ivf::kMaxD || B < 1 || P < 1 || L < 1 ||
      rows_per_split < 1 || rows_per_split % ivf::kRows != 0 ||
      splits != (L + rows_per_split - 1) / rows_per_split ||
      reinterpret_cast<uintptr_t>(clustered) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ivf::Args a{q, clustered, bias, scale, probes, B, P, L, D, k, rows_per_split, splits,
                    part_v, part_i};
  const cudaError_t err = ivf::run(dtype, a, s, nullptr);
  if (err != cudaSuccess) return (int)err;
  ivf::ivf_merge_kernel<<<B, ivf::kThreads, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), P * splits * k, k,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
