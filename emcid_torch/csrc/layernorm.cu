// Fused row LayerNorm(+act), forward (K6f) and backward (K6b), for Hopper
// (sm_90a).
//
// Replaces emcid_tpu/ops/layernorm.py: _fwd_kernel and _bwd_kernel.  It
// computes what those compute, with flax/torch LayerNorm semantics over
// the last axis (float32 statistics, the fast variance
// max(E[x^2] - E[x]^2, 0)):
//
//   forward   y = act((x - mean) * rstd * gamma + beta); nothing is saved;
//   backward  the row statistics recomputed from x; dz = g (act none) or
//             g * s * (1 + z (1 - s)) with z the pre-activation and
//             s = sigmoid(z) (act silu); dxhat = gamma dz;
//             dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat xhat));
//             and per-block partial sums of dz * xhat (dgamma) and dz
//             (dbeta) as (nblocks, C) float32, summed by the caller.
//
// Layout.  The rows are the transformer's (B, N, C) tokens, contiguous.
// One warp takes one row at a time (a grid-stride loop over rows): the row
// reductions are warp shuffles, with no shared memory and no block
// barrier.  The TPU kernel's row chunks sized to VMEM have no counterpart.
//
// What bounds it on this card: bytes.  The forward reads x and writes y,
// the backward reads x and g and writes dx.  A warp reads its row again
// for each pass (statistics, then normalise; or statistics, the two row
// means, then dx); a row is at most a few KB, so the second and third
// reads hit L1.  In the backward each warp adds its rows' dz * xhat and dz
// into its own float32 slice of shared memory, each lane into its own
// channels (no atomics), and the block folds its warps' slices in a fixed
// order at the end, so the results do not change from run to run.
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

constexpr int kLnWarps = 8;

template <typename T, int V>
__device__ __forceinline__ void row_stats(const T* xr, int cv, int C, float eps, float& mean,
                                          float& r) {
  const int lane = threadIdx.x % 32;
  float s = 0.f, sq = 0.f;
  for (int i = lane; i < cv; i += 32) {
    float f[V];
    load_vec<T, V>(xr + (long long)i * V, f);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s += f[k];
      sq = fmaf(f[k], f[k], sq);
    }
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  mean = s / C;
  r = rsqrtf(fmaxf(sq / C - mean * mean, 0.f) + eps);
}

template <typename T, int V>
__global__ void __launch_bounds__(kLnWarps * 32)
    ln_fwd_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                  const void* __restrict__ beta, int pbf16, T* __restrict__ y, long long rows,
                  int C, float eps, int silu) {
  const int lane = threadIdx.x % 32, nw = blockDim.x / 32;
  const int cv = C / V;
  for (long long row = (long long)blockIdx.x * nw + threadIdx.x / 32; row < rows;
       row += (long long)gridDim.x * nw) {
    const T* xr = x + row * C;
    float mean, r;
    row_stats<T, V>(xr, cv, C, eps, mean, r);
    T* yr = y + row * C;
    for (int i = lane; i < cv; i += 32) {
      float f[V];
      load_vec<T, V>(xr + (long long)i * V, f);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int c = i * V + k;
        float z = fmaf((f[k] - mean) * r, ldparam(gamma, pbf16, c), ldparam(beta, pbf16, c));
        if (silu) z *= sigmoidf(z);
        f[k] = z;
      }
      store_vec<T, V>(yr + (long long)i * V, f);
    }
  }
}

// dz of one element (see gn_dz in groupnorm.cu); xhat comes back through
// the reference.
__device__ __forceinline__ float ln_dz(float x, float g, float mean, float r, float gam,
                                       float bet, int silu, float& xhat) {
  xhat = (x - mean) * r;
  if (!silu) return g;
  const float z = fmaf(xhat, gam, bet);
  const float sg = sigmoidf(z);
  return g * sg * (1.f + z * (1.f - sg));
}

template <typename T, int V>
__global__ void __launch_bounds__(kLnWarps * 32)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                  const void* __restrict__ gamma, const void* __restrict__ beta, int pbf16,
                  T* __restrict__ dx, float* __restrict__ dgamma, float* __restrict__ dbeta,
                  long long rows, int C, float eps, int silu) {
  // per warp: C sums of dz * xhat, then C sums of dz; channel i * V + k at
  // k * cv + i, so the lanes of a warp hit consecutive banks
  extern __shared__ float acc[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  const int cv = C / V;
  float* mine = acc + (size_t)warp * 2 * C;
  for (int j = lane; j < 2 * C; j += 32) mine[j] = 0.f;
  __syncwarp();

  for (long long row = (long long)blockIdx.x * nw + warp; row < rows;
       row += (long long)gridDim.x * nw) {
    const T* xr = x + row * C;
    const T* gr = gy + row * C;
    float mean, r;
    row_stats<T, V>(xr, cv, C, eps, mean, r);
    float m1 = 0.f, m2 = 0.f;
    for (int i = lane; i < cv; i += 32) {
      float fx[V], fg[V];
      load_vec<T, V>(xr + (long long)i * V, fx);
      load_vec<T, V>(gr + (long long)i * V, fg);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int c = i * V + k;
        const float gam = ldparam(gamma, pbf16, c);
        float xhat;
        const float dxh = gam * ln_dz(fx[k], fg[k], mean, r, gam, ldparam(beta, pbf16, c),
                                      silu, xhat);
        m1 += dxh;
        m2 = fmaf(dxh, xhat, m2);
      }
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
    T* dr = dx + row * C;
    for (int i = lane; i < cv; i += 32) {
      float fx[V], fg[V];
      load_vec<T, V>(xr + (long long)i * V, fx);
      load_vec<T, V>(gr + (long long)i * V, fg);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int c = i * V + k;
        const float gam = ldparam(gamma, pbf16, c);
        float xhat;
        const float dz = ln_dz(fx[k], fg[k], mean, r, gam, ldparam(beta, pbf16, c), silu, xhat);
        mine[k * cv + i] = fmaf(dz, xhat, mine[k * cv + i]);
        mine[C + k * cv + i] += dz;
        fx[k] = r * (gam * dz - m1 - xhat * m2);
      }
      store_vec<T, V>(dr + (long long)i * V, fx);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int j = (c % V) * cv + c / V;
    float a2 = 0.f, a1 = 0.f;
    for (int w = 0; w < nw; ++w) {
      a2 += acc[(size_t)w * 2 * C + j];
      a1 += acc[(size_t)w * 2 * C + C + j];
    }
    dgamma[(long long)blockIdx.x * C + c] = a2;
    dbeta[(long long)blockIdx.x * C + c] = a1;
  }
}

// Warps per backward block: as many as 8 whose float32 slices (2 C each)
// fit the shared memory a block may have; 0 when not even one does.
int ln_bwd_warps(int C) {
  return std::min(kLnWarps, kMaxSmem / (int)(2 * sizeof(float) * (size_t)C));
}

template <typename T, int V>
int ln_launch_one(bool bwd, const void* x, const void* gy, const void* gamma, const void* beta,
                  int pbf16, void* out, float* dgamma, float* dbeta, long long rows, int C,
                  float eps, int silu, int nblocks, cudaStream_t stream) {
  if (!bwd) {
    const long long blocks = std::min((rows + kLnWarps - 1) / kLnWarps, 0x7fffffffLL);
    ln_fwd_kernel<T, V><<<(unsigned)blocks, kLnWarps * 32, 0, stream>>>(
        (const T*)x, gamma, beta, pbf16, (T*)out, rows, C, eps, silu);
    return (int)cudaGetLastError();
  }
  const int nw = ln_bwd_warps(C);
  const size_t smem = 2 * sizeof(float) * (size_t)C * nw;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_bwd_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ln_bwd_kernel<T, V><<<nblocks, nw * 32, smem, stream>>>((const T*)x, (const T*)gy, gamma,
                                                          beta, pbf16, (T*)out, dgamma, dbeta,
                                                          rows, C, eps, silu);
  return (int)cudaGetLastError();
}

template <typename T>
int ln_launch(bool bwd, const void* x, const void* gy, const void* gamma, const void* beta,
              int pbf16, void* out, float* dgamma, float* dbeta, long long rows, int C,
              float eps, int silu, int nblocks, cudaStream_t stream) {
  if (rows <= 0 || C <= 0 || (bwd && (nblocks <= 0 || ln_bwd_warps(C) < 1)))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, gy, out};
  switch (pick_vec<T>(C, ptrs, 3)) {
    case 8:
      return ln_launch_one<T, 8>(bwd, x, gy, gamma, beta, pbf16, out, dgamma, dbeta, rows, C,
                                 eps, silu, nblocks, stream);
    case 4:
      return ln_launch_one<T, 4>(bwd, x, gy, gamma, beta, pbf16, out, dgamma, dbeta, rows, C,
                                 eps, silu, nblocks, stream);
    case 2:
      return ln_launch_one<T, 2>(bwd, x, gy, gamma, beta, pbf16, out, dgamma, dbeta, rows, C,
                                 eps, silu, nblocks, stream);
    default:
      return ln_launch_one<T, 1>(bwd, x, gy, gamma, beta, pbf16, out, dgamma, dbeta, rows, C,
                                 eps, silu, nblocks, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y); pdtype likewise for gamma and
// beta; act: 0 = none, 1 = silu.
extern "C" int emcid_ln_fwd(const void* x, const void* gamma, const void* beta, void* y,
                            long long rows, int C, float eps, int act, int dtype, int pdtype,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (pdtype != 0 && pdtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return ln_launch<float>(false, x, nullptr, gamma, beta, pdtype, y, nullptr, nullptr, rows,
                            C, eps, act, 0, st);
  if (dtype == 1)
    return ln_launch<bf16>(false, x, nullptr, gamma, beta, pdtype, y, nullptr, nullptr, rows, C,
                           eps, act, 0, st);
  return (int)cudaErrorInvalidValue;
}

// The number of blocks the backward launches for `rows` rows of C channels
// (one block's worth of warps on each row at most, and no more blocks than
// fit the card at once); the caller sizes the (nblocks, C) partials by it.
// 0 when C is too wide for the kernel.
extern "C" int emcid_ln_bwd_blocks(long long rows, int C) {
  const int nw = ln_bwd_warps(C);
  if (nw < 1 || rows <= 0) return 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const size_t smem = 2 * sizeof(float) * (size_t)C * nw;
  // 2048 threads and 228 KB of shared memory (1 KB of it reserved per
  // block) on each SM
  const int per_sm = std::max(1, std::min(2048 / (nw * 32), (int)(233472 / (smem + 1024))));
  return (int)std::min<long long>((rows + nw - 1) / nw, (long long)sms * per_sm);
}

// dgamma and dbeta are (nblocks, C) float32 per-block partial sums, with
// nblocks = emcid_ln_bwd_blocks(rows, C).
extern "C" int emcid_ln_bwd(const void* x, const void* gy, const void* gamma, const void* beta,
                            void* dx, void* dgamma, void* dbeta, long long rows, int C,
                            float eps, int act, int nblocks, int dtype, int pdtype,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (pdtype != 0 && pdtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return ln_launch<float>(true, x, gy, gamma, beta, pdtype, dx, (float*)dgamma,
                            (float*)dbeta, rows, C, eps, act, nblocks, st);
  if (dtype == 1)
    return ln_launch<bf16>(true, x, gy, gamma, beta, pdtype, dx, (float*)dgamma,
                           (float*)dbeta, rows, C, eps, act, nblocks, st);
  return (int)cudaErrorInvalidValue;
}
