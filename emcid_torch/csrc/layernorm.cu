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
//             and dgamma = sum dz * xhat, dbeta = sum dz over the rows, in
//             the parameters' type, summed inside the launch.
//
// Layout.  The rows are the transformer's (B, N, C) tokens, contiguous.
// One warp takes one row at a time (a grid-stride loop over rows): the row
// reductions are warp shuffles, with no shared memory and no block
// barrier.  The TPU kernel's row chunks sized to VMEM have no counterpart.
//
// What bounds it on this card: bytes.  The forward reads x and writes y,
// the backward reads x and g and writes dx.  The forward reads its row
// twice (statistics, then normalise; the second read hits L1).  The
// backward has two routes, picked in ops/layernorm.py, one entry point
// each:
//
//   rows     C = 32 * V * nv with nv <= 5 and accesses of 4 to 16 bytes
//            (the UNet's 320, 640 and 1280 channels).  Lane l owns channels
//            (j * 32 + l) * V + k in every row, so each access of the warp
//            is whole 128-byte lines.  Each lane copies its pieces of x and
//            g with cp.async into its warp's ring of four rows in shared
//            memory, three rows ahead of the one it computes, and reads them
//            back once into registers: device memory sees one read of x and
//            of g, and the statistics, the two row means and dx all come
//            from the registers (with act none, all four row sums in one
//            round of shuffles).  gamma and beta sit in shared memory,
//            loaded once per block; each lane's sums of dz * xhat and dz
//            for its channels stay in registers across its rows, and the
//            block adds its warps' sums in warp order.
//   generic  any other C: three passes over each row (statistics, the two
//            means, dx), the later ones from L1, each warp's sums in its
//            own float32 slice of shared memory.
//
// Both end in the in-kernel two-level fold of common.cuh (the blocks'
// partial rows summed in a fixed order by the last blocks to finish), so
// one launch computes dx, dgamma and dbeta, the same bits on every run.
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

// ---- route `rows`: C = 32 * V * nv with nv <= kRowsMaxNV ----

constexpr int kRowsMaxNV = 5;
constexpr int kRowStages = 4;  // rows of x and g in flight per warp: this one, three ahead

// Resident blocks per SM the budgets are sized for, by the bytes of one
// access (V elements): 85 registers and 45 KB of shared memory a block for
// 4-byte accesses (bf16 C = 320), 128 and 90 KB for 8-byte, 255 and up to
// 180 KB for 16-byte.  ops/layernorm.py sizes the grid by the same rule.
constexpr int rows_min_blocks(int access_bytes) {
  return access_bytes <= 4 ? 3 : access_bytes <= 8 ? 2 : 1;
}

// One asynchronous copy of BYTES (4, 8 or 16, aligned) into shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async_piece(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES)
                 : "memory");
}

// Start copying a lane's pieces of one row (channels (j * 32 + lane) * V
// + k) into the same places of a row of shared memory.
template <typename T, int V>
__device__ __forceinline__ void copy_row(T* dst, const T* __restrict__ src, int lane, int nv) {
#pragma unroll
  for (int j = 0; j < kRowsMaxNV; ++j)
    if (j < nv) cp_async_piece<V * sizeof(T)>(dst + (j * 32 + lane) * V, src + (j * 32 + lane) * V);
}

// The lane-interleaved shared-memory slot of channel c = (j * 32 + l) * V + k:
// (j * V + k) * 32 + l.
template <int V>
__device__ __forceinline__ int lane_slot(int c) {
  const int j = c / (32 * V), l = (c / V) % 32, k = c % V;
  return (j * V + k) * 32 + l;
}

template <typename T, int V>
__device__ __forceinline__ void read_row(const T* src, int lane, int nv,
                                         Pack<T, V> (&dst)[kRowsMaxNV]) {
#pragma unroll
  for (int j = 0; j < kRowsMaxNV; ++j)
    if (j < nv) dst[j] = *reinterpret_cast<const Pack<T, V>*>(src + (j * 32 + lane) * V);
}

template <typename T, int V>
__global__ void __launch_bounds__(kLnWarps * 32, rows_min_blocks(V * sizeof(T)))
    ln_bwd_kernel_rows(const T* __restrict__ x, const T* __restrict__ gy,
                       const void* __restrict__ gamma, const void* __restrict__ beta, int pbf16,
                       T* __restrict__ dx, float* __restrict__ part, unsigned* counters,
                       void* __restrict__ dgamma, void* __restrict__ dbeta, long long rows,
                       int nv, float eps, int silu) {
  // gamma and beta, lane-interleaved (slot (j * V + k) * 32 + lane for
  // channel (j * 32 + lane) * V + k) so that a warp's reads hit 32
  // distinct banks
  constexpr int kMaxC = 32 * V * kRowsMaxNV;
  constexpr int kPerThread = (kMaxC + kLnWarps * 32 - 1) / (kLnWarps * 32);
  __shared__ float sgam[kMaxC], sbet[kMaxC];
  // per warp, kRowStages rows of [x | g]
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  using P = Pack<T, V>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int C = 32 * V * nv;
  T* ring = reinterpret_cast<T*>(ring_bytes) + (size_t)warp * kRowStages * 2 * C;

  // gamma and beta are asked for first, ahead of the rows
  float pg[kPerThread], pb[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kLnWarps * 32;
    pg[i] = c < C ? ldparam(gamma, pbf16, c) : 0.f;
    pb[i] = c < C ? ldparam(beta, pbf16, c) : 0.f;
  }

  // each lane copies, and later reads, only its own channels of each row,
  // so the ring needs no barrier: the lane's own cp.async groups order it
  const long long stride = (long long)gridDim.x * kLnWarps;
  const long long row0 = (long long)blockIdx.x * kLnWarps + warp;
#pragma unroll
  for (int st = 0; st < kRowStages - 1; ++st) {
    const long long r = row0 + st * stride;
    if (r < rows) {
      copy_row<T, V>(ring + st * 2 * C, x + r * C, lane, nv);
      copy_row<T, V>(ring + st * 2 * C + C, gy + r * C, lane, nv);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kLnWarps * 32;
    if (c < C) {
      sgam[lane_slot<V>(c)] = pg[i];
      sbet[lane_slot<V>(c)] = pb[i];
    }
  }
  __syncthreads();

  // lane owns channels (j * 32 + lane) * V + k in every row: its running
  // sums of dz * xhat and dz stay in registers across its rows
  float ag[kRowsMaxNV][V], ab[kRowsMaxNV][V];
#pragma unroll
  for (int j = 0; j < kRowsMaxNV; ++j)
#pragma unroll
    for (int k = 0; k < V; ++k) ag[j][k] = ab[j][k] = 0.f;

  int it = 0;
  for (long long row = row0; row < rows; row += stride, ++it) {
    const long long ahead = row + (kRowStages - 1) * stride;
    T* st = ring + ((it + kRowStages - 1) % kRowStages) * 2 * C;  // read at it - 1
    if (ahead < rows) {
      copy_row<T, V>(st, x + ahead * C, lane, nv);
      copy_row<T, V>(st + C, gy + ahead * C, lane, nv);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRowStages - 1) : "memory");
    P cx[kRowsMaxNV], cg[kRowsMaxNV];
    const T* cur = ring + (it % kRowStages) * 2 * C;
    read_row<T, V>(cur, lane, nv, cx);
    read_row<T, V>(cur + C, lane, nv, cg);

    // the row's statistics and the two means m1 = mean(gamma dz) and
    // m2 = mean(gamma dz xhat): with act none dz = g does not need them, so
    // all four sums go in one round of shuffles (m2 = r (mean(gamma g x) -
    // mean m1)); with silu dz needs xhat, so two rounds
    float s = 0.f, sq = 0.f, m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < kRowsMaxNV; ++j)
      if (j < nv) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float f = ldf(&cx[j].v[k]);
          s += f;
          sq = fmaf(f, f, sq);
          if (!silu) {
            const float gg = sgam[(j * V + k) * 32 + lane] * ldf(&cg[j].v[k]);
            m1 += gg;
            m2 = fmaf(gg, f, m2);
          }
        }
      }
    s = warp_sum(s);
    sq = warp_sum(sq);
    if (!silu) {
      m1 = warp_sum(m1);
      m2 = warp_sum(m2);
    }
    const float mean = s / C;
    const float r = rsqrtf(fmaxf(sq / C - mean * mean, 0.f) + eps);
    if (!silu) {
      m1 /= C;
      m2 = r * (m2 / C - mean * m1);
    } else {
#pragma unroll
      for (int j = 0; j < kRowsMaxNV; ++j)
        if (j < nv) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const int slot = (j * V + k) * 32 + lane;
            const float gam = sgam[slot];
            float xhat;
            const float dxh = gam * ln_dz(ldf(&cx[j].v[k]), ldf(&cg[j].v[k]), mean, r, gam,
                                          sbet[slot], silu, xhat);
            m1 += dxh;
            m2 = fmaf(dxh, xhat, m2);
          }
        }
      m1 = warp_sum(m1) / C;
      m2 = warp_sum(m2) / C;
    }

    T* dr = dx + row * C;
#pragma unroll
    for (int j = 0; j < kRowsMaxNV; ++j)
      if (j < nv) {
        float o[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int slot = (j * V + k) * 32 + lane;
          const float gam = sgam[slot];
          float xhat;
          const float dz =
              ln_dz(ldf(&cx[j].v[k]), ldf(&cg[j].v[k]), mean, r, gam, sbet[slot], silu, xhat);
          o[k] = r * (gam * dz - m1 - xhat * m2);
          ag[j][k] = fmaf(dz, xhat, ag[j][k]);
          ab[j][k] += dz;
        }
        store_vec<T, V>(dr + (j * 32 + lane) * V, o);
      }
  }

  // the block's sums: each warp parks its sums in its own ring, now idle
  // (lane-interleaved float slots, 2 C of them), and thread t adds slot t
  // of the warps' slices in warp order into the block's row of `part`
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  float* slice = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < kRowsMaxNV; ++j)
    if (j < nv) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        slice[(j * V + k) * 32 + lane] = ag[j][k];
        slice[C + (j * V + k) * 32 + lane] = ab[j][k];
      }
    }
  __syncthreads();
  const size_t warp_stride = (size_t)kRowStages * 2 * C * sizeof(T) / sizeof(float);
  const float* slices = reinterpret_cast<const float*>(ring_bytes);
  float* mine = part + (size_t)blockIdx.x * 2 * C;
  for (int s = threadIdx.x; s < 2 * C; s += blockDim.x) {
    float a = 0.f;
    for (int w = 0; w < kLnWarps; ++w) a += slices[w * warp_stride + s];
    const int hi = s >= C, t = s - hi * C;  // slot t = (j * V + k) * 32 + l
    const int l = t % 32, j = t / 32 / V, k = t / 32 % V;
    mine[hi * C + (j * 32 + l) * V + k] = a;
  }
  fold_blocks(part, counters, gridDim.x, C, dgamma, dbeta, pbf16);
}

template <typename T, int V>
int ln_rows_one(const void* x, const void* gy, const void* gamma, const void* beta, int pbf16,
                void* dx, float* part, unsigned* counters, void* dgamma, void* dbeta,
                long long rows, int nv, float eps, int silu, int nblocks, cudaStream_t stream) {
  static size_t allowed[kMaxDevices];
  const size_t smem = (size_t)kLnWarps * kRowStages * 2 * 32 * V * nv * sizeof(T);
  const cudaError_t err = allow_smem(ln_bwd_kernel_rows<T, V>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  ln_bwd_kernel_rows<T, V><<<nblocks, kLnWarps * 32, smem, stream>>>(
      (const T*)x, (const T*)gy, gamma, beta, pbf16, (T*)dx, part, counters, dgamma, dbeta,
      rows, nv, eps, silu);
  return (int)cudaGetLastError();
}

template <typename T>
int ln_rows_launch(const void* x, const void* gy, const void* gamma, const void* beta, int pbf16,
                   void* dx, float* part, unsigned* counters, void* dgamma, void* dbeta,
                   long long rows, int C, float eps, int silu, int nblocks,
                   cudaStream_t stream) {
  const void* ptrs[] = {x, gy, dx};
  if (rows <= 0 || C <= 0 || C % 32 || nblocks <= 0 || !aligned16(ptrs, 3))
    return (int)cudaErrorInvalidValue;
  const int per = C / 32;
  int V = 16 / (int)sizeof(T);
  while (per % V) V /= 2;
  const int nv = per / V;
  // a copy moves 4, 8 or 16 bytes
  if (nv > kRowsMaxNV || V * sizeof(T) < 4) return (int)cudaErrorInvalidValue;
  switch (V) {
    case 8:
      if constexpr (sizeof(T) == 2)
        return ln_rows_one<T, 8>(x, gy, gamma, beta, pbf16, dx, part, counters, dgamma, dbeta,
                                 rows, nv, eps, silu, nblocks, stream);
      return (int)cudaErrorInvalidValue;
    case 4:
      return ln_rows_one<T, 4>(x, gy, gamma, beta, pbf16, dx, part, counters, dgamma, dbeta,
                               rows, nv, eps, silu, nblocks, stream);
    case 2:
      return ln_rows_one<T, 2>(x, gy, gamma, beta, pbf16, dx, part, counters, dgamma, dbeta,
                               rows, nv, eps, silu, nblocks, stream);
    default:
      if constexpr (sizeof(T) == 4)
        return ln_rows_one<T, 1>(x, gy, gamma, beta, pbf16, dx, part, counters, dgamma, dbeta,
                                 rows, nv, eps, silu, nblocks, stream);
      return (int)cudaErrorInvalidValue;
  }
}

// ---- route `generic`: any C, three passes over each row ----

template <typename T, int V>
__global__ void __launch_bounds__(kLnWarps * 32)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                  const void* __restrict__ gamma, const void* __restrict__ beta, int pbf16,
                  T* __restrict__ dx, float* __restrict__ part, unsigned* counters,
                  void* __restrict__ dgamma, void* __restrict__ dbeta, long long rows, int C,
                  float eps, int silu) {
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
  float* out = part + (size_t)blockIdx.x * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int j = (c % V) * cv + c / V;
    float a2 = 0.f, a1 = 0.f;
    for (int w = 0; w < nw; ++w) {
      a2 += acc[(size_t)w * 2 * C + j];
      a1 += acc[(size_t)w * 2 * C + C + j];
    }
    out[c] = a2;
    out[C + c] = a1;
  }
  fold_blocks(part, counters, gridDim.x, C, dgamma, dbeta, pbf16);
}

// Warps per generic backward block: as many as 8 whose float32 slices (2 C
// each) fit the shared memory a block may have; 0 when not even one does.
// ops/layernorm.py sizes the grid by the same rule.
int ln_bwd_warps(int C) {
  return std::min(kLnWarps, kMaxSmem / (int)(2 * sizeof(float) * (size_t)C));
}

template <typename T, int V>
int ln_generic_one(const void* x, const void* gy, const void* gamma, const void* beta, int pbf16,
                   void* dx, float* part, unsigned* counters, void* dgamma, void* dbeta,
                   long long rows, int C, float eps, int silu, int nblocks,
                   cudaStream_t stream) {
  static size_t allowed[kMaxDevices];
  const int nw = ln_bwd_warps(C);
  const size_t smem = 2 * sizeof(float) * (size_t)C * nw;
  const cudaError_t err = allow_smem(ln_bwd_kernel<T, V>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  ln_bwd_kernel<T, V><<<nblocks, nw * 32, smem, stream>>>(
      (const T*)x, (const T*)gy, gamma, beta, pbf16, (T*)dx, part, counters, dgamma, dbeta,
      rows, C, eps, silu);
  return (int)cudaGetLastError();
}

template <typename T>
int ln_generic_launch(const void* x, const void* gy, const void* gamma, const void* beta,
                      int pbf16, void* dx, float* part, unsigned* counters, void* dgamma,
                      void* dbeta, long long rows, int C, float eps, int silu, int nblocks,
                      cudaStream_t stream) {
  if (rows <= 0 || C <= 0 || nblocks <= 0 || ln_bwd_warps(C) < 1)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, gy, dx};
  switch (pick_vec<T>(C, ptrs, 3)) {
    case 8:
      return ln_generic_one<T, 8>(x, gy, gamma, beta, pbf16, dx, part, counters, dgamma, dbeta,
                                  rows, C, eps, silu, nblocks, stream);
    case 4:
      return ln_generic_one<T, 4>(x, gy, gamma, beta, pbf16, dx, part, counters, dgamma, dbeta,
                                  rows, C, eps, silu, nblocks, stream);
    case 2:
      return ln_generic_one<T, 2>(x, gy, gamma, beta, pbf16, dx, part, counters, dgamma, dbeta,
                                  rows, C, eps, silu, nblocks, stream);
    default:
      return ln_generic_one<T, 1>(x, gy, gamma, beta, pbf16, dx, part, counters, dgamma, dbeta,
                                  rows, C, eps, silu, nblocks, stream);
  }
}

template <typename T>
int ln_fwd_launch(const void* x, const void* gamma, const void* beta, int pbf16, void* y,
                  long long rows, int C, float eps, int silu, cudaStream_t stream) {
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, y};
  const long long blocks = std::min((rows + kLnWarps - 1) / kLnWarps, 0x7fffffffLL);
#define EMCID_LN_FWD(VV)                                                                     \
  ln_fwd_kernel<T, VV><<<(unsigned)blocks, kLnWarps * 32, 0, stream>>>(                     \
      (const T*)x, gamma, beta, pbf16, (T*)y, rows, C, eps, silu)
  switch (pick_vec<T>(C, ptrs, 2)) {
    case 8: EMCID_LN_FWD(8); break;
    case 4: EMCID_LN_FWD(4); break;
    case 2: EMCID_LN_FWD(2); break;
    default: EMCID_LN_FWD(1); break;
  }
#undef EMCID_LN_FWD
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y); pdtype likewise for gamma and
// beta; act: 0 = none, 1 = silu.
extern "C" int emcid_ln_fwd(const void* x, const void* gamma, const void* beta, void* y,
                            long long rows, int C, float eps, int act, int dtype, int pdtype,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (pdtype != 0 && pdtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return ln_fwd_launch<float>(x, gamma, beta, pdtype, y, rows, C, eps, act, st);
  if (dtype == 1) return ln_fwd_launch<bf16>(x, gamma, beta, pdtype, y, rows, C, eps, act, st);
  return (int)cudaErrorInvalidValue;
}

// The backward's two routes, one entry point each, with one signature.
// dgamma and dbeta are (C,) in the parameters' type; part is float32
// scratch of (nblocks + groups) rows of 2 C floats, groups =
// ceil(nblocks / fold_group_size(nblocks)); counters holds 1 + groups ints,
// 0 on entry and on return (common.cuh, the in-kernel fold).
#define EMCID_LN_BWD_ENTRY(NAME, LAUNCH)                                                      \
  extern "C" int NAME(const void* x, const void* gy, const void* gamma, const void* beta,    \
                      void* dx, void* dgamma, void* dbeta, void* part, void* counters,       \
                      long long rows, int C, float eps, int act, int nblocks, int dtype,     \
                      int pdtype, void* stream) {                                            \
    cudaStream_t st = (cudaStream_t)stream;                                                  \
    if (pdtype != 0 && pdtype != 1) return (int)cudaErrorInvalidValue;                       \
    if (dtype == 0)                                                                          \
      return LAUNCH<float>(x, gy, gamma, beta, pdtype, dx, (float*)part, (unsigned*)counters, \
                           dgamma, dbeta, rows, C, eps, act, nblocks, st);                   \
    if (dtype == 1)                                                                          \
      return LAUNCH<bf16>(x, gy, gamma, beta, pdtype, dx, (float*)part, (unsigned*)counters,  \
                          dgamma, dbeta, rows, C, eps, act, nblocks, st);                    \
    return (int)cudaErrorInvalidValue;                                                       \
  }

// route `rows`: C = 32 * V * nv (V elements of 4 to 16 bytes, nv <= 5), x,
// g and dx 16-byte aligned; nblocks up to SMs x rows_min_blocks
EMCID_LN_BWD_ENTRY(emcid_ln_bwd_rows, ln_rows_launch)
// route `generic`: any C up to 29,056; nblocks up to SMs x the resident
// blocks of ln_bwd_warps(C) warps
EMCID_LN_BWD_ENTRY(emcid_ln_bwd, ln_generic_launch)
#undef EMCID_LN_BWD_ENTRY
