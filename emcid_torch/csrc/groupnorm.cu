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
//             and dgamma = sum dz * xhat, dbeta = sum dz over the batch
//             and space, in the parameters' type, summed inside the launch.
//
// Layout.  The port's UNet is NCHW: x is (B, C, S) contiguous with S the
// spatial size, so one (batch, group) is one contiguous span of Cg * S
// elements (Cg = C / G).  One block takes one span: the TPU kernel's
// channel chunks and membership matmuls, which fold per-channel sums into
// groups across the 128 lanes, have no counterpart here.
//
// What bounds it on this card: bytes.  The forward reads x and writes y,
// the backward reads x and g and writes dx, a few flops per element.  The
// forward reads the span twice (statistics, then normalise; the second
// read mostly hits L2).  The backward has two routes, picked in
// ops/groupnorm.py, one entry point each:
//
//   resident  every span whose x and g fit one block's shared memory (the
//             UNet's 320- and 640-channel spans at 384 px, 320 at 512 px,
//             and every deeper level).  One thread starts TMA 1-D bulk
//             copies of the whole span, a few KB of x and g per mbarrier,
//             and the warps sum each piece as it lands; both passes then
//             read shared memory, so device memory sees one read of x and
//             of g and one write of dx.
//   stream    larger spans (the 960-channel concat at 384 px, 640 and
//             960 channels at 512 px, float32 spans above 227 KB): both
//             passes read device memory, the second mostly from L2.
//
// The per-channel sums are taken by warps that each own a (channel,
// segment) unit (a warp shuffle, no atomics), folded in a fixed order into
// the batch's row of a (B, 2 C) scratch; the last block to finish sums the
// B rows in order (common.cuh), so one launch computes dx, dgamma and
// dbeta, the same bits on every run.
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

// From a block's unit sums (nseg per channel, segment-major so that the
// threads below read consecutive channels): the per-channel
// sums of dz * xhat and dz into the batch's row of `part` ([dgamma |
// dbeta], 2 C floats), and the group sums of gamma dz and gamma dz xhat
// (every thread gets them).
__device__ __forceinline__ float2 gn_channel_sums(const float2* unit, int nseg, int Cg, int c0,
                                                  int C, int b, const void* gamma, int pbf16,
                                                  float* part, float2* red) {
  float u1 = 0.f, u2 = 0.f;
  float* row = part + (size_t)b * 2 * C;
  for (int c = threadIdx.x; c < Cg; c += blockDim.x) {
    float a1 = 0.f, a2 = 0.f;
    for (int s = 0; s < nseg; ++s) {
      a1 += unit[s * Cg + c].x;
      a2 += unit[s * Cg + c].y;
    }
    row[c0 + c] = a2;
    row[C + c0 + c] = a1;
    const float gam = ldparam(gamma, pbf16, c0 + c);
    u1 = fmaf(a1, gam, u1);
    u2 = fmaf(a2, gam, u2);
  }
  return block_sum2(u1, u2, red);
}

// ---- route `stream`: spans of any size, read twice from device memory ----

template <typename T, int V>
__global__ void __launch_bounds__(kGnThreads)
    gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                  const void* __restrict__ gamma, const void* __restrict__ beta, int pbf16,
                  const float* __restrict__ stats, T* __restrict__ dx, float* __restrict__ part,
                  unsigned* counters, void* __restrict__ dgamma, void* __restrict__ dbeta, int C,
                  int S, int G, int silu, int nseg) {
  extern __shared__ float2 unit[];  // (Cg * nseg) unit sums of (dz, dz * xhat)
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
    if (lane == 0) unit[(u % nseg) * Cg + u / nseg] = make_float2(a1, a2);
  }
  __syncthreads();

  const float2 m = gn_channel_sums(unit, nseg, Cg, c0, C, b, gamma, pbf16, part, red);
  const float n = (float)Cg * (float)S;
  const float m1 = m.x / n, m2 = m.y / n;

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
  if (arrive_last(counters, gridDim.x)) {
    fold_rows(part, gridDim.x / G, 2 * C, nullptr, dgamma, dbeta, pbf16);
    if (threadIdx.x == 0) counters[0] = 0;
  }
}

// ---- route `resident`: the span of x and g brought into shared memory once ----

constexpr int kGnResThreads = 512;
constexpr int kGnResWarps = kGnResThreads / 32;
constexpr int kGnResChunk = 4096;    // bytes of x (and of g) per barrier
constexpr int kGnResReserve = 1024;  // for the block's static shared memory

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the barrier's first phase to complete (the copies it counts have
// landed).  A copy that never lands ends the launch with an error after
// some 2^26 polls (each may sleep a while in the hardware) instead of
// hanging it.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar) {
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(0u)
        : "memory");
  }
}

// TMA 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Dynamic shared memory of the resident route for a span of Cg channels of
// S elements, accessed V at a time: x and g, one barrier per kGnResChunk
// bytes (rounded up to 16 bytes), one (dz, dz * xhat) float2 per unit of a
// channel's 32 accesses.  ops/groupnorm.py decides the route by the same
// arithmetic.
inline size_t gn_res_smem(int Cg, int S, int esize, int V) {
  const size_t span = (size_t)Cg * S * esize;
  const size_t bars = sizeof(unsigned long long) * ((span + kGnResChunk - 1) / kGnResChunk);
  return 2 * span + (bars + 15) / 16 * 16 + sizeof(float2) * (size_t)Cg * ((S / V + 31) / 32);
}

// Wait for the pieces that hold bytes [lo, hi) of the span.
__device__ __forceinline__ void wait_bytes(unsigned long long* bars, size_t lo, size_t hi) {
  for (size_t i = lo / kGnResChunk; i <= (hi - 1) / kGnResChunk; ++i) mbar_wait(&bars[i]);
}

// One block per span.  Several blocks share an SM where their spans fit
// (two at the 320-channel spans of 384 px), so one block's copies land
// while another computes.
template <typename T, int V>
__global__ void __launch_bounds__(kGnResThreads)
    gn_bwd_kernel_resident(const T* __restrict__ x, const T* __restrict__ gy,
                           const void* __restrict__ gamma, const void* __restrict__ beta,
                           int pbf16, const float* __restrict__ stats, T* __restrict__ dx,
                           float* __restrict__ part, unsigned* counters,
                           void* __restrict__ dgamma, void* __restrict__ dbeta, int C, int S,
                           int G, int silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 red[kGnResWarps + 1];
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int Cg = C / G, sv = S / V, nseg = (sv + 31) / 32, c0 = g * Cg;
  const size_t span = (size_t)Cg * S * sizeof(T);
  const int nchunks = (int)((span + kGnResChunk - 1) / kGnResChunk);
  T* sx = reinterpret_cast<T*>(smem);
  T* sg = reinterpret_cast<T*>(smem + span);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + 2 * span);
  float2* unit =
      reinterpret_cast<float2*>(smem + 2 * span + (sizeof(unsigned long long) * nchunks + 15) / 16 * 16);
  const long long base = ((long long)b * C + c0) * S;
  const float mean = stats[(long long)b * 2 * G + g];
  const float r = stats[((long long)b * 2 + 1) * G + g];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // warp 0 asks for the whole span, kGnResChunk bytes of x and of g per
  // barrier, one lane a piece; pass 1 starts on each piece as it lands
  if (warp == 0) {
    for (int i = lane; i < nchunks; i += 32) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncwarp();
    const char* xb = reinterpret_cast<const char*>(x + base);
    const char* gb = reinterpret_cast<const char*>(gy + base);
    for (int i = lane; i < nchunks; i += 32) {
      const size_t off = (size_t)i * kGnResChunk;
      const size_t rest = span - off;
      const unsigned bytes = (unsigned)(rest < (size_t)kGnResChunk ? rest : kGnResChunk);
      mbar_expect_tx(&bars[i], 2 * bytes);
      bulk_g2s(smem + off, xb + off, bytes, &bars[i]);
      bulk_g2s(smem + span + off, gb + off, bytes, &bars[i]);
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits

  // pass 1: per (channel, 32-access segment) unit, one warp sums dz and
  // dz * xhat
  for (int u = warp; u < Cg * nseg; u += kGnResWarps) {
    const int c = u / nseg, i0 = (u - c * nseg) * 32, i = i0 + lane;
    const size_t e0 = (size_t)c * S + (size_t)i0 * V;
    wait_bytes(bars, e0 * sizeof(T), (e0 + (size_t)(min(sv, i0 + 32) - i0) * V) * sizeof(T));
    float a1 = 0.f, a2 = 0.f;
    if (i < sv) {
      const float gam = ldparam(gamma, pbf16, c0 + c), bet = ldparam(beta, pbf16, c0 + c);
      float fx[V], fg[V];
      load_vec<T, V>(sx + (size_t)c * S + (size_t)i * V, fx);
      load_vec<T, V>(sg + (size_t)c * S + (size_t)i * V, fg);
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
    if (lane == 0) unit[(u % nseg) * Cg + u / nseg] = make_float2(a1, a2);
  }
  __syncthreads();

  const float2 m = gn_channel_sums(unit, nseg, Cg, c0, C, b, gamma, pbf16, part, red);
  const float n = (float)Cg * (float)S;
  const float m1 = m.x / n, m2 = m.y / n;

  // pass 2: dx from shared memory, by the same units
  wait_bytes(bars, 0, span);
  T* ds = dx + base;
  for (int u = warp; u < Cg * nseg; u += kGnResWarps) {
    const int c = u / nseg, i = (u - c * nseg) * 32 + lane;
    if (i >= sv) continue;
    const float gam = ldparam(gamma, pbf16, c0 + c), bet = ldparam(beta, pbf16, c0 + c);
    float fx[V], fg[V];
    load_vec<T, V>(sx + (size_t)c * S + (size_t)i * V, fx);
    load_vec<T, V>(sg + (size_t)c * S + (size_t)i * V, fg);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float xhat;
      const float dz = gn_dz(fx[k], fg[k], mean, r, gam, bet, silu, xhat);
      fx[k] = r * (dz * gam - m1 - xhat * m2);
    }
    store_vec<T, V>(ds + (long long)c * S + (long long)i * V, fx);
  }
  if (arrive_last(counters, gridDim.x)) {
    fold_rows(part, gridDim.x / G, 2 * C, nullptr, dgamma, dbeta, pbf16);
    if (threadIdx.x == 0) counters[0] = 0;
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
int gn_stream_one(const void* x, const void* gy, const void* gamma, const void* beta, int pbf16,
                  const float* stats, void* dx, float* part, unsigned* counters, void* dgamma,
                  void* dbeta, int B, int C, int S, int G, int silu, cudaStream_t stream) {
  const int Cg = C / G, sv = S / V;
  // enough segments per channel that the units spread evenly over the
  // warps, but no segment shorter than one pass of the warp
  int nseg = kGnWarps / gcd(Cg, kGnWarps);
  nseg = std::max(1, std::min(nseg, sv / 32));
  static size_t allowed[kMaxDevices];
  const size_t smem = sizeof(float2) * (size_t)Cg * nseg;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(gn_bwd_kernel<T, V>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  gn_bwd_kernel<T, V><<<B * G, kGnThreads, smem, stream>>>(
      (const T*)x, (const T*)gy, gamma, beta, pbf16, stats, (T*)dx, part, counters, dgamma,
      dbeta, C, S, G, silu, nseg);
  return (int)cudaGetLastError();
}

template <typename T>
int gn_stream_launch(const void* x, const void* gy, const void* gamma, const void* beta,
                     int pbf16, const float* stats, void* dx, float* part, unsigned* counters,
                     void* dgamma, void* dbeta, int B, int C, int S, int G, int silu,
                     cudaStream_t stream) {
  if (bad_shape(B, C, S, G)) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, gy, dx};
  switch (pick_vec<T>(S, ptrs, 3)) {
    case 8:
      return gn_stream_one<T, 8>(x, gy, gamma, beta, pbf16, stats, dx, part, counters, dgamma,
                                 dbeta, B, C, S, G, silu, stream);
    case 4:
      return gn_stream_one<T, 4>(x, gy, gamma, beta, pbf16, stats, dx, part, counters, dgamma,
                                 dbeta, B, C, S, G, silu, stream);
    case 2:
      return gn_stream_one<T, 2>(x, gy, gamma, beta, pbf16, stats, dx, part, counters, dgamma,
                                 dbeta, B, C, S, G, silu, stream);
    default:
      return gn_stream_one<T, 1>(x, gy, gamma, beta, pbf16, stats, dx, part, counters, dgamma,
                                 dbeta, B, C, S, G, silu, stream);
  }
}

template <typename T, int V>
int gn_resident_one(const void* x, const void* gy, const void* gamma, const void* beta,
                    int pbf16, const float* stats, void* dx, float* part, unsigned* counters,
                    void* dgamma, void* dbeta, int B, int C, int S, int G, int silu,
                    cudaStream_t stream) {
  static size_t allowed[kMaxDevices];
  const size_t smem = gn_res_smem(C / G, S, sizeof(T), V);
  if (smem + kGnResReserve > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(gn_bwd_kernel_resident<T, V>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  gn_bwd_kernel_resident<T, V><<<B * G, kGnResThreads, smem, stream>>>(
      (const T*)x, (const T*)gy, gamma, beta, pbf16, stats, (T*)dx, part, counters, dgamma,
      dbeta, C, S, G, silu);
  return (int)cudaGetLastError();
}

template <typename T>
int gn_resident_launch(const void* x, const void* gy, const void* gamma, const void* beta,
                       int pbf16, const float* stats, void* dx, float* part,
                       unsigned* counters, void* dgamma, void* dbeta, int B, int C, int S,
                       int G, int silu, cudaStream_t stream) {
  const void* ptrs[] = {x, gy, dx};
  if (bad_shape(B, C, S, G) || (size_t)(C / G) * S * sizeof(T) % 16 || !aligned16(ptrs, 3))
    return (int)cudaErrorInvalidValue;
  // the span's pieces start 16-byte aligned; the access width follows S
  switch (pick_vec<T>(S, nullptr, 0)) {
    case 8:
      if constexpr (sizeof(T) == 2)
        return gn_resident_one<T, 8>(x, gy, gamma, beta, pbf16, stats, dx, part, counters,
                                     dgamma, dbeta, B, C, S, G, silu, stream);
      return (int)cudaErrorInvalidValue;
    case 4:
      return gn_resident_one<T, 4>(x, gy, gamma, beta, pbf16, stats, dx, part, counters,
                                   dgamma, dbeta, B, C, S, G, silu, stream);
    case 2:
      return gn_resident_one<T, 2>(x, gy, gamma, beta, pbf16, stats, dx, part, counters,
                                   dgamma, dbeta, B, C, S, G, silu, stream);
    default:
      return gn_resident_one<T, 1>(x, gy, gamma, beta, pbf16, stats, dx, part, counters,
                                   dgamma, dbeta, B, C, S, G, silu, stream);
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

// The backward's two routes, one entry point each, with one signature.
// stats is the forward's (B, 2, G) float32; dgamma and dbeta are (C,) in
// the parameters' type; part is (B, 2 C) float32 scratch and counters one
// int, 0 on entry and on return (common.cuh, the in-kernel fold).
#define EMCID_GN_BWD_ENTRY(NAME, LAUNCH)                                                      \
  extern "C" int NAME(const void* x, const void* gy, const void* gamma, const void* beta,    \
                      const void* stats, void* dx, void* dgamma, void* dbeta, void* part,    \
                      void* counters, int B, int C, int S, int G, int act, int dtype,        \
                      int pdtype, void* stream) {                                            \
    cudaStream_t st = (cudaStream_t)stream;                                                  \
    if (pdtype != 0 && pdtype != 1) return (int)cudaErrorInvalidValue;                       \
    if (dtype == 0)                                                                          \
      return LAUNCH<float>(x, gy, gamma, beta, pdtype, (const float*)stats, dx, (float*)part, \
                           (unsigned*)counters, dgamma, dbeta, B, C, S, G, act, st);         \
    if (dtype == 1)                                                                          \
      return LAUNCH<bf16>(x, gy, gamma, beta, pdtype, (const float*)stats, dx, (float*)part,  \
                          (unsigned*)counters, dgamma, dbeta, B, C, S, G, act, st);          \
    return (int)cudaErrorInvalidValue;                                                       \
  }

// route `resident`: a span of a multiple of 16 bytes, x, g and dx 16-byte
// aligned, and gn_res_smem + 1 KB within one block's 227 KB
EMCID_GN_BWD_ENTRY(emcid_gn_bwd_resident, gn_resident_launch)
// route `stream`: any shape with C % G == 0
EMCID_GN_BWD_ENTRY(emcid_gn_bwd, gn_stream_launch)
#undef EMCID_GN_BWD_ENTRY
