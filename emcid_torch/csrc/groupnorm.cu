// Fused GroupNorm(+SiLU), forward (K5f) and backward (K5b), for Hopper
// (sm_90a).
//
// Replaces emcid_tpu/ops/groupnorm.py: _fwd_kernel and _bwd_kernel.  It
// computes what those compute, with flax/torch GroupNorm semantics
// (contiguous channel groups, float32 statistics, the fast variance
// max(E[x^2] - E[x]^2, 0)):
//
//   forward   y = act((x - mean_g) * rstd_g * gamma_c + beta_c), and the
//             per-group (mean, rstd) saved as (B, 2, G) float32;
//   backward  from the saved statistics, dz = g (act none) or
//             g * s * (1 + z (1 - s)) with z the pre-activation and
//             s = sigmoid(z) (act silu); then, per group,
//             dx = rstd * (gamma dz - mean_g(gamma dz) - xhat * mean_g(gamma dz xhat)),
//             and per-(batch, channel) partial sums of dz * xhat (dgamma)
//             and dz (dbeta) as (B, C) float32, summed over the batch by the
//             caller in a fixed order.
//
// Layout.  The port's UNet is NCHW: x is (B, C, S) contiguous with S the
// spatial size, so one (batch, group) is one contiguous span of Cg * S
// elements (Cg = C / G).  One block takes one span: the TPU kernel's
// channel chunks and membership matmuls, which fold per-channel sums into
// groups across the 128 lanes, have no counterpart here.
//
// What bounds it on this card: bytes.  The forward reads x and writes y,
// the backward reads x and g and writes dx, a few flops per element.  The
// forward reads the span twice (statistics, then normalise) and the
// backward twice too (the two group reductions, then dx); the second read
// of a span a block has just read mostly hits the 50 MB L2, so device
// memory sees about one read.  Keeping the span in shared memory (or in a
// cluster's distributed shared memory, for the 512-px spans of up to
// 245 KB) would make that certain; that is later work.  Accesses are
// 16 bytes wide where the spatial size and the pointers allow it.  The
// backward's per-channel sums are taken by warps that each own a channel
// segment (a warp shuffle, no atomics), then folded in a fixed order, so
// the results do not change from run to run.
//
// x, g, y and dx are float32 or bfloat16 (dtype 0 or 1); gamma and beta are
// float32 or bfloat16 (pdtype 0 or 1); all arithmetic is float32.  The C
// entry points launch on the given stream, allocate nothing, and return
// cudaGetLastError().

#include <algorithm>

#include "common.cuh"

using namespace emcid;
using bf16 = __nv_bfloat16;

namespace {

constexpr int kGnThreads = 256;
constexpr int kGnWarps = kGnThreads / 32;

template <typename T, int V>
__global__ void __launch_bounds__(kGnThreads)
    gn_fwd_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                  const void* __restrict__ beta, int pbf16, T* __restrict__ y,
                  float* __restrict__ stats, int C, int S, int G, float eps, int silu) {
  __shared__ float2 red[kGnWarps + 1];
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int Cg = C / G, sv = S / V, nv = Cg * sv, c0 = g * Cg;
  const long long base = ((long long)b * C + c0) * S;
  const T* xs = x + base;

  float s = 0.f, sq = 0.f;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    float f[V];
    load_vec<T, V>(xs + (long long)i * V, f);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s += f[k];
      sq = fmaf(f[k], f[k], sq);
    }
  }
  const float2 t = block_sum2(s, sq, red);
  const float n = (float)Cg * (float)S;
  const float mean = t.x / n;
  const float r = rsqrtf(fmaxf(t.y / n - mean * mean, 0.f) + eps);
  if (threadIdx.x == 0) {
    stats[(long long)b * 2 * G + g] = mean;
    stats[((long long)b * 2 + 1) * G + g] = r;
  }

  T* ys = y + base;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const int c = c0 + i / sv;
    const float a = r * ldparam(gamma, pbf16, c), bb = ldparam(beta, pbf16, c);
    float f[V];
    load_vec<T, V>(xs + (long long)i * V, f);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float z = fmaf(f[k] - mean, a, bb);
      if (silu) z *= sigmoidf(z);
      f[k] = z;
    }
    store_vec<T, V>(ys + (long long)i * V, f);
  }
}

// dz of one element from x, the cotangent g, and the group's statistics;
// xhat comes back through the reference.
__device__ __forceinline__ float gn_dz(float x, float g, float mean, float r, float gam,
                                       float bet, int silu, float& xhat) {
  xhat = (x - mean) * r;
  if (!silu) return g;
  const float z = fmaf(xhat, gam, bet);
  const float sg = sigmoidf(z);
  return g * sg * (1.f + z * (1.f - sg));
}

template <typename T, int V>
__global__ void __launch_bounds__(kGnThreads)
    gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                  const void* __restrict__ gamma, const void* __restrict__ beta, int pbf16,
                  const float* __restrict__ stats, T* __restrict__ dx,
                  float* __restrict__ dgamma, float* __restrict__ dbeta, int C, int S, int G,
                  int silu, int nseg) {
  extern __shared__ float2 part[];  // (Cg * nseg) unit sums of (dz, dz * xhat)
  __shared__ float2 red[kGnWarps + 1];
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int Cg = C / G, sv = S / V, nv = Cg * sv, c0 = g * Cg;
  const long long base = ((long long)b * C + c0) * S;
  const T* xs = x + base;
  const T* gs = gy + base;
  const float mean = stats[(long long)b * 2 * G + g];
  const float r = stats[((long long)b * 2 + 1) * G + g];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // pass 1: per (channel, segment) unit, one warp sums dz and dz * xhat
  const int segv = (sv + nseg - 1) / nseg;
  for (int u = warp; u < Cg * nseg; u += kGnWarps) {
    const int c = u / nseg, seg = u - c * nseg;
    const float gam = ldparam(gamma, pbf16, c0 + c), bet = ldparam(beta, pbf16, c0 + c);
    const T* xc = xs + (long long)c * S;
    const T* gc = gs + (long long)c * S;
    const int end = min(sv, (seg + 1) * segv);
    float a1 = 0.f, a2 = 0.f;
    for (int i = seg * segv + lane; i < end; i += 32) {
      float fx[V], fg[V];
      load_vec<T, V>(xc + (long long)i * V, fx);
      load_vec<T, V>(gc + (long long)i * V, fg);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float xhat;
        const float dz = gn_dz(fx[k], fg[k], mean, r, gam, bet, silu, xhat);
        a1 += dz;
        a2 = fmaf(dz, xhat, a2);
      }
    }
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) part[u] = make_float2(a1, a2);
  }
  __syncthreads();

  // per-channel sums (the dgamma/dbeta partials) and the two group means
  float u1 = 0.f, u2 = 0.f;
  for (int c = threadIdx.x; c < Cg; c += blockDim.x) {
    float a1 = 0.f, a2 = 0.f;
    for (int s = 0; s < nseg; ++s) {
      a1 += part[c * nseg + s].x;
      a2 += part[c * nseg + s].y;
    }
    dbeta[(long long)b * C + c0 + c] = a1;
    dgamma[(long long)b * C + c0 + c] = a2;
    const float gam = ldparam(gamma, pbf16, c0 + c);
    u1 = fmaf(a1, gam, u1);
    u2 = fmaf(a2, gam, u2);
  }
  const float2 w = block_sum2(u1, u2, red);
  const float n = (float)Cg * (float)S;
  const float m1 = w.x / n, m2 = w.y / n;

  // pass 2: dx
  T* ds = dx + base;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const int c = c0 + i / sv;
    const float gam = ldparam(gamma, pbf16, c), bet = ldparam(beta, pbf16, c);
    float fx[V], fg[V];
    load_vec<T, V>(xs + (long long)i * V, fx);
    load_vec<T, V>(gs + (long long)i * V, fg);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float xhat;
      const float dz = gn_dz(fx[k], fg[k], mean, r, gam, bet, silu, xhat);
      fx[k] = r * (dz * gam - m1 - xhat * m2);
    }
    store_vec<T, V>(ds + (long long)i * V, fx);
  }
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

bool bad_shape(int B, int C, int S, int G) {
  return B <= 0 || C <= 0 || S <= 0 || G <= 0 || C % G || (long long)B * G > 0x7fffffffLL ||
         (long long)(C / G) * S > 0x7fffffffLL;
}

template <typename T>
int gn_fwd_launch(const void* x, const void* gamma, const void* beta, int pbf16, void* y,
                  float* stats, int B, int C, int S, int G, float eps, int silu,
                  cudaStream_t stream) {
  if (bad_shape(B, C, S, G)) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, y};
  const int V = pick_vec<T>(S, ptrs, 2);
  const dim3 grid(B * G);
#define EMCID_GN_FWD(VV)                                                                     \
  gn_fwd_kernel<T, VV><<<grid, kGnThreads, 0, stream>>>((const T*)x, gamma, beta, pbf16,    \
                                                         (T*)y, stats, C, S, G, eps, silu)
  switch (V) {
    case 8: EMCID_GN_FWD(8); break;
    case 4: EMCID_GN_FWD(4); break;
    case 2: EMCID_GN_FWD(2); break;
    default: EMCID_GN_FWD(1); break;
  }
#undef EMCID_GN_FWD
  return (int)cudaGetLastError();
}

template <typename T, int V>
int gn_bwd_one(const void* x, const void* gy, const void* gamma, const void* beta, int pbf16,
               const float* stats, void* dx, float* dgamma, float* dbeta, int B, int C, int S,
               int G, int silu, cudaStream_t stream) {
  const int Cg = C / G, sv = S / V;
  // enough segments per channel that the units spread evenly over the
  // warps, but no segment shorter than one pass of the warp
  int nseg = kGnWarps / gcd(Cg, kGnWarps);
  nseg = std::max(1, std::min(nseg, sv / 32));
  const size_t smem = sizeof(float2) * (size_t)Cg * nseg;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gn_bwd_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gn_bwd_kernel<T, V><<<B * G, kGnThreads, smem, stream>>>(
      (const T*)x, (const T*)gy, gamma, beta, pbf16, stats, (T*)dx, dgamma, dbeta, C, S, G,
      silu, nseg);
  return (int)cudaGetLastError();
}

template <typename T>
int gn_bwd_launch(const void* x, const void* gy, const void* gamma, const void* beta,
                  int pbf16, const float* stats, void* dx, float* dgamma, float* dbeta, int B,
                  int C, int S, int G, int silu, cudaStream_t stream) {
  if (bad_shape(B, C, S, G)) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, gy, dx};
  switch (pick_vec<T>(S, ptrs, 3)) {
    case 8:
      return gn_bwd_one<T, 8>(x, gy, gamma, beta, pbf16, stats, dx, dgamma, dbeta, B, C, S, G,
                              silu, stream);
    case 4:
      return gn_bwd_one<T, 4>(x, gy, gamma, beta, pbf16, stats, dx, dgamma, dbeta, B, C, S, G,
                              silu, stream);
    case 2:
      return gn_bwd_one<T, 2>(x, gy, gamma, beta, pbf16, stats, dx, dgamma, dbeta, B, C, S, G,
                              silu, stream);
    default:
      return gn_bwd_one<T, 1>(x, gy, gamma, beta, pbf16, stats, dx, dgamma, dbeta, B, C, S, G,
                              silu, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y); pdtype likewise for gamma and
// beta; act: 0 = none, 1 = silu.  stats is (B, 2, G) float32.
extern "C" int emcid_gn_fwd(const void* x, const void* gamma, const void* beta, void* y,
                            void* stats, int B, int C, int S, int G, float eps, int act,
                            int dtype, int pdtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (pdtype != 0 && pdtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return gn_fwd_launch<float>(x, gamma, beta, pdtype, y, (float*)stats, B, C, S, G, eps, act,
                                st);
  if (dtype == 1)
    return gn_fwd_launch<bf16>(x, gamma, beta, pdtype, y, (float*)stats, B, C, S, G, eps, act,
                               st);
  return (int)cudaErrorInvalidValue;
}

// dgamma and dbeta are (B, C) float32 per-batch partial sums.
extern "C" int emcid_gn_bwd(const void* x, const void* gy, const void* gamma, const void* beta,
                            const void* stats, void* dx, void* dgamma, void* dbeta, int B,
                            int C, int S, int G, int act, int dtype, int pdtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (pdtype != 0 && pdtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return gn_bwd_launch<float>(x, gy, gamma, beta, pdtype, (const float*)stats, dx,
                                (float*)dgamma, (float*)dbeta, B, C, S, G, act, st);
  if (dtype == 1)
    return gn_bwd_launch<bf16>(x, gy, gamma, beta, pdtype, (const float*)stats, dx,
                               (float*)dgamma, (float*)dbeta, B, C, S, G, act, st);
  return (int)cudaErrorInvalidValue;
}
