// The blockwise 8-bit AdamW update over the whole superleaf, for sm_90a.
//
// Replaces the TPU kernel `_kernel` of retrieval_augmented_mds_tpu/ops/
// adam8bit_update.py (called from `adam8bit_superleaf_update`). Same
// contract, per 128-element block (one row of the [NB, 128] superleaf):
//   g   = grad * clip
//   mu  = b1 * (mu_q * mu_scale) + (1 - b1) * g
//   nu  = b2 * exp2(nu_lo + nu_q / 255 * max(nu_hi - nu_lo, 1e-6))
//         + (1 - b2) * g * g
//   upd = -lr * ((mu / bc1) / (sqrt(nu / bc2) + eps) [+ wd * p])
// then mu requantised to int8 by the block's absmax / 127 and nu to uint8
// affine in log2 between the block's min and max (range clamped to
// log_range), both over the lanes below `nvalid` only: padding steers no
// scale, and a block of pure padding gets lo = hi = log2(tiny).
//
// Numerics: every operation is a correctly rounded IEEE one
// (__fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn, which the compiler never
// contracts into an fma), in the association order of the JAX composite
// (q / 255 * rng, not q * (rng / 255)); rintf rounds half to even like
// jnp.round and torch.round. The constants (1 - b1) and (1 - b2) come from
// the host, computed in double and rounded once, as JAX's weak-typed Python
// constants are. exp2f and log2f are the CUDA math library's (1-2 ulp).
//
// What bounds it on an H100: it moves ~12.2 bytes per element and does ~40
// f32 operations on it (6 IEEE divisions among them), so HBM bounds it:
// 613 M parameters (led_base) are ~7.5 GB, ~2.2 ms at 3.35 TB/s.
//
// Design: one warp per 128-element block, 4 elements per lane, so a lane
// reads its gradients (and parameters, only when wd != 0) as one 16-byte
// float4 and its codes as one char4 / uchar4; the block's absmax, min and
// max of log2 are warp reductions with __shfl_xor_sync and need no shared
// memory. A CTA of 8 warps walks the rows with a grid-stride loop; the
// grid is 8 CTAs per SM. The update may be written over the gradients
// (upd == g): each lane reads its 4 gradients before it writes their
// updates, and no other lane touches them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Consts {
  float b1, omb1, b2, omb2, eps, wd, tiny, log_tiny, log_range;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// g and upd may be the same array: neither is __restrict__.
__global__ void __launch_bounds__(kThreads)
adam8bit_kernel(const float* g, const int8_t* __restrict__ mq,
                const float* __restrict__ ms, const uint8_t* __restrict__ nq,
                const float* __restrict__ nlo, const float* __restrict__ nhi,
                const int* __restrict__ nv, const float* __restrict__ p,
                const float* __restrict__ scal, float* upd,
                int8_t* __restrict__ mq2, float* __restrict__ ms2,
                uint8_t* __restrict__ nq2, float* __restrict__ nlo2,
                float* __restrict__ nhi2, long nb, Consts c) {
  const int lane = threadIdx.x & 31;
  const long stride = (long)gridDim.x * kRowsPerCta;
  const float bc1 = scal[0], bc2 = scal[1], lr = scal[2], clip = scal[3];

  for (long row = (long)blockIdx.x * kRowsPerCta + (threadIdx.x >> 5); row < nb;
       row += stride) {
    const long e0 = row * kBlock + lane * 4;
    const float4 g4 = *reinterpret_cast<const float4*>(g + e0);
    const char4 m4 = *reinterpret_cast<const char4*>(mq + e0);
    const uchar4 n4 = *reinterpret_cast<const uchar4*>(nq + e0);
    float4 p4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c.wd != 0.f) p4 = *reinterpret_cast<const float4*>(p + e0);
    const float scale0 = ms[row], lo0 = nlo[row], hi0 = nhi[row];
    const int valid = nv[row];

    const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
    const float mqv[4] = {(float)m4.x, (float)m4.y, (float)m4.z, (float)m4.w};
    const float nqv[4] = {(float)n4.x, (float)n4.y, (float)n4.z, (float)n4.w};
    const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
    const float rng0 = fmaxf(__fsub_rn(hi0, lo0), 1e-6f);

    float mu[4], nu[4], u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float gj = __fmul_rn(gv[j], clip);
      mu[j] = __fadd_rn(__fmul_rn(c.b1, __fmul_rn(mqv[j], scale0)), __fmul_rn(c.omb1, gj));
      const float nu_prev =
          exp2f(__fadd_rn(lo0, __fmul_rn(__fdiv_rn(nqv[j], 255.f), rng0)));
      nu[j] = __fadd_rn(__fmul_rn(c.b2, nu_prev), __fmul_rn(__fmul_rn(c.omb2, gj), gj));
      float step = __fdiv_rn(__fdiv_rn(mu[j], bc1),
                             __fadd_rn(__fsqrt_rn(__fdiv_rn(nu[j], bc2)), c.eps));
      if (c.wd != 0.f) step = __fadd_rn(step, __fmul_rn(c.wd, pv[j]));
      u[j] = __fmul_rn(-lr, step);
    }
    *reinterpret_cast<float4*>(upd + e0) = make_float4(u[0], u[1], u[2], u[3]);

    // requantise mu: symmetric int8 by the block's absmax over valid lanes
    bool ok[4];
    float amax = 0.f, lg[4], hi = -INFINITY, lo = INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = lane * 4 + j < valid;
      if (ok[j]) amax = fmaxf(amax, fabsf(mu[j]));
      lg[j] = ok[j] ? log2f(fmaxf(nu[j], c.tiny)) : c.log_tiny;
      if (ok[j]) {
        hi = fmaxf(hi, lg[j]);
        lo = fminf(lo, lg[j]);
      }
    }
    amax = warp_max(amax);
    const float scale = __fdiv_rn(amax, 127.f);
    const float safe = scale > 0.f ? scale : 1.f;
    int qm[4], qn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      qm[j] = (int)fminf(fmaxf(rintf(__fdiv_rn(mu[j], safe)), -127.f), 127.f);

    // requantise nu: affine in log2 between the block's min and max
    hi = fmaxf(warp_max(hi), c.log_tiny);
    lo = fminf(fmaxf(warp_min(lo), __fsub_rn(hi, c.log_range)), hi);
    const float rng1 = fmaxf(__fsub_rn(hi, lo), 1e-6f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float t = fminf(fmaxf(__fdiv_rn(__fsub_rn(lg[j], lo), rng1), 0.f), 1.f);
      qn[j] = (int)rintf(__fmul_rn(t, 255.f));
    }
    *reinterpret_cast<char4*>(mq2 + e0) =
        make_char4((signed char)qm[0], (signed char)qm[1], (signed char)qm[2],
                   (signed char)qm[3]);
    *reinterpret_cast<uchar4*>(nq2 + e0) =
        make_uchar4((unsigned char)qn[0], (unsigned char)qn[1], (unsigned char)qn[2],
                    (unsigned char)qn[3]);
    if (lane == 0) {
      ms2[row] = scale;
      nlo2[row] = lo;
      nhi2[row] = hi;
    }
  }
}

}  // namespace

// g, p (null when wd == 0), upd: f32 [nb, 128], 16-byte aligned; mq/mq2 int8
// and nq/nq2 uint8 [nb, 128]; ms/nlo/nhi and their outputs f32 [nb, 1]; nv
// int32 [nb, 1]; scal f32 [1, 4] = (bc1, bc2, lr, clip). upd may equal g.
extern "C" int adam8bit_update_launch(
    const void* g, const void* mq, const void* ms, const void* nq, const void* nlo,
    const void* nhi, const void* nv, const void* p, const void* scal, void* upd,
    void* mq2, void* ms2, void* nq2, void* nlo2, void* nhi2, long nb, float b1,
    float omb1, float b2, float omb2, float eps, float wd, float tiny, float log_tiny,
    float log_range, void* stream) {
  if (nb < 1 || (wd != 0.f && p == nullptr)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long ctas = (nb + kRowsPerCta - 1) / kRowsPerCta;
  const int grid = (int)(ctas < 8L * sms ? ctas : 8L * sms);
  const Consts c{b1, omb1, b2, omb2, eps, wd, tiny, log_tiny, log_range};
  adam8bit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int8_t*>(mq),
      static_cast<const float*>(ms), static_cast<const uint8_t*>(nq),
      static_cast<const float*>(nlo), static_cast<const float*>(nhi),
      static_cast<const int*>(nv), static_cast<const float*>(p),
      static_cast<const float*>(scal), static_cast<float*>(upd),
      static_cast<int8_t*>(mq2), static_cast<float*>(ms2), static_cast<uint8_t*>(nq2),
      static_cast<float*>(nlo2), static_cast<float*>(nhi2), nb, c);
  return (int)cudaGetLastError();
}
