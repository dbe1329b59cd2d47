// Online-softmax flash attention for Hopper (sm_90a): forward (K1), dQ (K2)
// and dK/dV (K3).
//
// Replaces emcid_tpu/ops/flash_v2.py: _fwd_kernel (K1), _dq_kernel (K2) and
// _dkv_kernel (K3).  The math is the TPU kernels' own: the forward keeps a
// running row max m and row sum l, rescales the output accumulator by
// exp(m_old - m_new) per key tile and returns O and lse = m + log(l); the
// backward recomputes P = exp(s - lse) from the saved lse, forms
// dS = P * (dO.V^T - delta) with delta = rowsum(dO * O) (computed by the
// caller), and accumulates dQ = scale * dS.K over key tiles (K2) and
// dV = P^T.dO, dK = scale * dS^T.Q over query tiles (K3).  Keys past M score
// -1e30 so they get zero weight; query rows past N are never stored.  The
// TPU layout tricks (transposed scores, 128-lane padding, VMEM block sizes)
// are not carried over.
//
// The forward has three routes, each with its own C entry point; the
// wrapper (emcid_torch/ops/flash_v2.py: fwd_route) picks one:
//
// * mma (emcid_flash_fwd_mma): bf16 with 32 < D <= 80, D % 8 == 0, the
//   UNet's level-0 and level-1 heads (D = 40, 80).  At D = 40 each score
//   costs 2 * 40 + 2 * 40 tensor flops and one exponential, and the SFU
//   does 16 exponentials per clock per SM against the tensor cores' 4096
//   dense bf16 flops: the exponentials bound it first, then the flops; the
//   N x M scores never touch memory.  So everything between the two
//   products stays in registers (mma.cuh): S = Q.K^T by mma.sync m16n8k16
//   (and one m16n8k8 step where D % 16 == 8, so no flop is spent on
//   padding) from ldmatrix fragments, the online softmax with the scale
//   folded into one FFMA per score before ex2, P rounded to bf16 straight
//   into A fragments, O rescaled in registers.  Q's fragments load once per
//   warp; K/V tiles of 64 keys arrive by cp.async in a ring of stages (rows
//   padded to a multiple of 16 plus 8 elements: 16-byte rows, no ldmatrix
//   bank conflicts), each thread copying fixed 16-byte chunks so a tile
//   costs it a few integer operations; the first tile (no rescale) is its
//   own copy of the loop body; O leaves through shared memory in 16-byte
//   stores.  At these sizes the kernel is bound by instruction dispatch and
//   latency more than by any one pipe, so the block shape is the one that
//   keeps the most warps resident: see FwdMma below.
// * d512 (emcid_flash_fwd_d512): bf16 with D = 512, the VAE's single
//   mid-block head, bound by the tensor flops.  A warp's 16 x 512 f32
//   accumulator would need 256 registers a thread, so the head dim is split:
//   8 warps = 4 row groups of 16 x 2 halves of D.  The 64 x 512 Q tile
//   stays in shared memory; K/V tiles of 32 keys come in two stages; each
//   warp computes its half's partial scores, the two warps of a pair swap
//   them through shared memory and add (in the same order, so both hold the
//   same scores), both run the softmax of their 16 rows, and each
//   accumulates P.V for its 256 output columns (128 registers).  One block
//   of 256 threads per SM (211 KB of shared memory).
// * fma (emcid_flash_fwd): float32, and bf16 at any other head dim, on float
//   FMAs out of shared memory, bounded by the shared-memory load rate (two
//   loads per FMA).  Every operand of a tile is kept as float with row
//   stride D + 1, so a column walk across rows is free of bank conflicts,
//   and the softmax row reductions run one warp per row with shuffles.
//
// K2/K3 pick their route here: bf16 with 32 < D <= 80 runs the products as
// 16x16x16 WMMA fragments whose score tiles round-trip through shared
// memory (the next redesign puts them on mma.cuh too); everything else on
// float FMAs.  Every kernel reads each K/V (K1, K2) or Q/dO (K3) tile from
// device memory once per block.
//
// Tensors are (B, L, H, D) contiguous, bf16 or f32; lse and delta are
// (B, H, N) f32, lse in natural-log units.  Accumulation is f32 throughout.
// Each C entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include "common.cuh"  // cuda_bf16.h first: mma.h's bf16 fragments need it
#include "mma.cuh"

#include <mma.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

using namespace emcid;
using namespace nvcuda;

namespace {

struct Tiles {
  int bq, bk;
};

// Forward (fma route): head dims up to 128 fit 64 x 64 tiles; wider heads
// need a short query tile to keep Q, K, V and the output accumulator
// inside 227 KB.
Tiles fwd_tiles(int D) { return D <= 128 ? Tiles{64, 64} : Tiles{16, 32}; }
// Backward holds Q, dO, K, V, two score tiles and two accumulators.
Tiles bwd_tiles(int D) { return D <= 64 ? Tiles{64, 64} : Tiles{32, 32}; }

size_t fwd_smem(int D, Tiles t) {
  const size_t ld = D + 1;
  return sizeof(float) * (t.bq * ld + 2 * t.bk * ld + (size_t)t.bq * t.bk +
                          (size_t)t.bq * D + 3 * t.bq);
}

size_t dq_smem(int D, Tiles t) {
  const size_t ld = D + 1;
  return sizeof(float) * (2 * t.bq * ld + 2 * t.bk * ld + (size_t)t.bq * t.bk +
                          (size_t)t.bq * D + 2 * t.bq);
}

size_t dkv_smem(int D, Tiles t) {
  const size_t ld = D + 1;
  return sizeof(float) * (2 * t.bk * ld + 2 * t.bq * ld + 2 * (size_t)t.bq * t.bk +
                          2 * (size_t)t.bk * D + 2 * t.bq);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, int H, int N, int M, int D,
               int BQ, int BK, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;           // BQ x ld, pre-scaled
  float* sK = sQ + BQ * ld;   // BK x ld
  float* sV = sK + BK * ld;   // BK x ld
  float* sS = sV + BK * ld;   // BQ x BK scores, then probabilities
  float* sO = sS + BQ * BK;   // BQ x D output accumulator
  float* sM = sO + BQ * D;    // running row max
  float* sL = sM + BQ;        // running row sum
  float* sC = sL + BQ;        // this tile's rescale factor
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  load_tile(sQ, q, b, h, q0, BQ, N, H, D, ld, scale);
  for (int e = tid; e < BQ * D; e += blockDim.x) sO[e] = 0.f;
  for (int i = tid; i < BQ; i += blockDim.x) {
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }
  for (int k0 = 0; k0 < M; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(sK, k, b, h, k0, BK, M, H, D, ld);
    load_tile(sV, v, b, h, k0, BK, M, H, D, ld);
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += blockDim.x) {
      const int i = e / BK, j = e - i * BK;
      sS[e] = k0 + j < M ? dot_rows(sQ + i * ld, sK + j * ld, D) : kNegInf;
    }
    __syncthreads();
    for (int i = warp; i < BQ; i += kWarps) {
      float* row = sS + i * BK;
      float mx = kNegInf;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, row[j]);
      const float m_old = sM[i];
      mx = fmaxf(warp_max(mx), m_old);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = __expf(row[j] - mx);
        row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = __expf(m_old - mx);
        sC[i] = c;
        sL[i] = sL[i] * c + sum;
        sM[i] = mx;
      }
    }
    __syncthreads();
    for (int e = tid; e < BQ * D; e += blockDim.x) {
      const int i = e / D, d = e - i * D;
      const float* p = sS + i * BK;
      float acc = sO[e] * sC[i];
      for (int j = 0; j < BK; ++j) acc = fmaf(p[j], sV[j * ld + d], acc);
      sO[e] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < BQ * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D, n = q0 + i;
    if (n < N)
      stf(o + (((long long)b * N + n) * H + h) * D + d, sO[e] / fmaxf(sL[i], 1e-30f));
  }
  for (int i = tid; i < BQ; i += blockDim.x) {
    const int n = q0 + i;
    if (n < N) lse[((long long)b * H + h) * N + n] = sM[i] + logf(fmaxf(sL[i], 1e-30f));
  }
}

// Row statistics (lse, delta) of query rows [q0, q0 + R) into shared memory;
// rows past N read as zero.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int b, int h, int q0,
                                          int R, int H, int N) {
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    const int n = q0 + i;
    dst[i] = n < N ? src[((long long)b * H + h) * N + n] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int H, int N, int M, int D,
              int BQ, int BK, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;            // BQ x ld
  float* sdO = sQ + BQ * ld;   // BQ x ld
  float* sK = sdO + BQ * ld;   // BK x ld
  float* sV = sK + BK * ld;    // BK x ld
  float* sdS = sV + BK * ld;   // BQ x BK
  float* sdQ = sdS + BQ * BK;  // BQ x D accumulator
  float* sLse = sdQ + BQ * D;  // BQ
  float* sDelta = sLse + BQ;   // BQ
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;

  load_tile(sQ, q, b, h, q0, BQ, N, H, D, ld);
  load_tile(sdO, dout, b, h, q0, BQ, N, H, D, ld);
  load_rows(sLse, lse, b, h, q0, BQ, H, N);
  load_rows(sDelta, delta, b, h, q0, BQ, H, N);
  for (int e = tid; e < BQ * D; e += blockDim.x) sdQ[e] = 0.f;
  for (int k0 = 0; k0 < M; k0 += BK) {
    __syncthreads();
    load_tile(sK, k, b, h, k0, BK, M, H, D, ld);
    load_tile(sV, v, b, h, k0, BK, M, H, D, ld);
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += blockDim.x) {
      const int i = e / BK, j = e - i * BK;
      float ds = 0.f;
      if (k0 + j < M) {
        const float p = __expf(dot_rows(sQ + i * ld, sK + j * ld, D) * scale - sLse[i]);
        ds = p * (dot_rows(sdO + i * ld, sV + j * ld, D) - sDelta[i]);
      }
      sdS[e] = ds;
    }
    __syncthreads();
    for (int e = tid; e < BQ * D; e += blockDim.x) {
      const int i = e / D, d = e - i * D;
      const float* ds = sdS + i * BK;
      float acc = sdQ[e];
      for (int j = 0; j < BK; ++j) acc = fmaf(ds[j], sK[j * ld + d], acc);
      sdQ[e] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < BQ * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D, n = q0 + i;
    if (n < N) stf(dq + (((long long)b * N + n) * H + h) * D + d, sdQ[e] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
               int N, int M, int D, int BQ, int BK, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sK = smem;             // BK x ld
  float* sV = sK + BK * ld;     // BK x ld
  float* sQ = sV + BK * ld;     // BQ x ld
  float* sdO = sQ + BQ * ld;    // BQ x ld
  float* sP = sdO + BQ * ld;    // BQ x BK
  float* sdS = sP + BQ * BK;    // BQ x BK
  float* sdK = sdS + BQ * BK;   // BK x D accumulator
  float* sdV = sdK + BK * D;    // BK x D accumulator
  float* sLse = sdV + BK * D;   // BQ
  float* sDelta = sLse + BQ;    // BQ
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int j0 = blockIdx.x * BK;
  const int tid = threadIdx.x;

  load_tile(sK, k, b, h, j0, BK, M, H, D, ld);
  load_tile(sV, v, b, h, j0, BK, M, H, D, ld);
  for (int e = tid; e < BK * D; e += blockDim.x) {
    sdK[e] = 0.f;
    sdV[e] = 0.f;
  }
  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();
    load_tile(sQ, q, b, h, q0, BQ, N, H, D, ld);
    load_tile(sdO, dout, b, h, q0, BQ, N, H, D, ld);
    load_rows(sLse, lse, b, h, q0, BQ, H, N);
    load_rows(sDelta, delta, b, h, q0, BQ, H, N);
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += blockDim.x) {
      const int i = e / BK, j = e - i * BK;
      float p = 0.f, ds = 0.f;
      if (q0 + i < N && j0 + j < M) {
        p = __expf(dot_rows(sQ + i * ld, sK + j * ld, D) * scale - sLse[i]);
        ds = p * (dot_rows(sdO + i * ld, sV + j * ld, D) - sDelta[i]);
      }
      sP[e] = p;
      sdS[e] = ds;
    }
    __syncthreads();
    for (int e = tid; e < BK * D; e += blockDim.x) {
      const int j = e / D, d = e - j * D;
      float acc_v = sdV[e], acc_k = sdK[e];
      for (int i = 0; i < BQ; ++i) {
        acc_v = fmaf(sP[i * BK + j], sdO[i * ld + d], acc_v);
        acc_k = fmaf(sdS[i * BK + j], sQ[i * ld + d], acc_k);
      }
      sdV[e] = acc_v;
      sdK[e] = acc_k;
    }
  }
  __syncthreads();
  for (int e = tid; e < BK * D; e += blockDim.x) {
    const int j = e / D, d = e - j * D, m = j0 + j;
    if (m < M) {
      const long long off = (((long long)b * M + m) * H + h) * D + d;
      stf(dk + off, sdK[e] * scale);
      stf(dv + off, sdV[e]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2/K3 tensor-core path: bf16 inputs with 32 < D <= 80 and D % 8 == 0.
// Four warps per block; each warp owns 16 rows of the block's 64-row tile
// (query rows in dQ, key rows in dK/dV), so the row reductions need only
// the warp.  Products are 16x16x16 bf16 WMMA fragments with f32
// accumulators, out of bf16 tiles in shared memory whose head dim is
// zero-padded to DP (a multiple of 16).  The streamed tiles (K/V, or Q/dO
// with their row statistics) arrive by 16-byte cp.async copies in two
// stages, so the next tile's copy overlaps this tile's products.  P and dS
// are rounded to bf16 before their products with K, dO or Q; every sum is
// f32.
// ---------------------------------------------------------------------------

constexpr int kTcTile = 64;  // query and key rows per tile
constexpr int kTcThreads = 128;
constexpr int kLdS = kTcTile + 4;  // f32 score tile row stride
constexpr int kLdP = kTcTile + 8;  // bf16 probability tile row stride

template <int DP>
struct TcLayout {
  static constexpr int kLdH = DP + 8;           // bf16 operand tile row stride
  static constexpr int kLdO = DP + 4;           // f32 accumulator tile row stride
  static constexpr int kHalf = kTcTile * kLdH;  // elements of one bf16 operand tile
  static constexpr size_t kHalfTile = sizeof(bf16) * kHalf;
  static constexpr size_t kScoreTile = sizeof(float) * kTcTile * kLdS;
  static constexpr size_t kProbTile = sizeof(bf16) * kTcTile * kLdP;
  static constexpr size_t kOutTile = sizeof(float) * kTcTile * kLdO;
  static constexpr size_t kRows = sizeof(float) * kTcTile;
  static_assert(kOutTile <= 2 * kScoreTile, "dQ/dK/dV epilogue reuses the score tiles");
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Start copying rows [r0, r0 + 64) of head (b, h) into a bf16 tile with row
// stride ld; columns [D, DP) and rows at or past L are zero.
template <int DP>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src, int b, int h, int r0,
                                           int L, int H, int D, int ld) {
  constexpr int kChunks = DP / 8;
  const int real = D / 8;
  for (int e = threadIdx.x; e < kTcTile * kChunks; e += blockDim.x) {
    const int i = e / kChunks, c = e - i * kChunks, r = r0 + i;
    const bool ok = r < L && c < real;
    cp_async16(dst + i * ld + c * 8, ok ? src + (((long long)b * L + r) * H + h) * D + c * 8 : src,
               ok);
  }
}

// Start copying the row statistics (lse, delta) of query rows [q0, q0 + 64);
// zeros past N.
__device__ __forceinline__ void rows_async(float* dst, const float* src, int b, int h, int q0,
                                           int H, int N) {
  for (int i = threadIdx.x; i < kTcTile; i += blockDim.x) {
    const int n = q0 + i;
    cp_async4(dst + i, n < N ? src + ((long long)b * H + h) * N + n : src, n < N);
  }
}

// acc[j] (16 x 16, j < 4) = A[16 rows, DP] . B[64 rows, DP]^T: the 16 x 64
// product of this warp's rows of A with every row of B.
template <int DP>
__device__ __forceinline__ void rows_times_rows_t(FragC (&acc)[kTcTile / 16], const bf16* a,
                                                  const bf16* b, int ld) {
#pragma unroll
  for (int j = 0; j < kTcTile / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, ld);
#pragma unroll
    for (int j = 0; j < kTcTile / 16; ++j) {
      FragBCol fb;
      wmma::load_matrix_sync(fb, b + j * 16 * ld + kk, ld);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// acc[n] (16 x 16, n < DP / 16) += P[16 rows, 64] . B[64 rows, DP].
template <int DP>
__device__ __forceinline__ void rows_times_tile(FragC (&acc)[DP / 16], const bf16* p,
                                                const bf16* b, int ldb) {
#pragma unroll
  for (int kk = 0; kk < kTcTile; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, p + kk, kLdP);
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + kk * ldb + n * 16, ldb);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// This warp's 16 x 64 block of A.B^T into rows r0.. of a f32 tile.
template <int DP>
__device__ __forceinline__ void scores_to_smem(float* dst, const bf16* a, const bf16* b, int ld) {
  FragC s[kTcTile / 16];
  rows_times_rows_t<DP>(s, a, b, ld);
#pragma unroll
  for (int j = 0; j < kTcTile / 16; ++j)
    wmma::store_matrix_sync(dst + j * 16, s[j], kLdS, wmma::mem_row_major);
}

// Write this warp's rows of an accumulator (16 x DP) to a (B, L, H, D) bf16
// tensor, times `mul`, through the f32 tile `stage` (row stride ldo); rows
// at or past L are not written.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* dst, FragC (&acc)[DP / 16], float* stage,
                                           int ldo, int b, int h, int row0, int L, int H, int D,
                                           float mul) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < DP / 16; ++n)
    wmma::store_matrix_sync(stage + n * 16, acc[n], ldo, wmma::mem_row_major);
  __syncwarp();
  for (int i = 0; i < 16 && row0 + i < L; ++i)
    for (int d = lane; d < D; d += 32)
      dst[(((long long)b * L + row0 + i) * H + h) * D + d] =
          __float2bfloat16(stage[i * ldo + d] * mul);
  __syncwarp();
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
    dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int H, int N, int M, int D, float scale) {
  using Lay = TcLayout<DP>;
  constexpr int ldh = Lay::kLdH, ldo = Lay::kLdO, half = Lay::kHalf;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + half;
  bf16* sKV = sdO + half;                                   // 2 stages of (K, V)
  float* sS = reinterpret_cast<float*>(sKV + 4 * half);     // Q.K^T
  float* sdP = sS + kTcTile * kLdS;                         // dO.V^T
  bf16* sdS = reinterpret_cast<bf16*>(sdP + kTcTile * kLdS);
  float* sLse = reinterpret_cast<float*>(sdS + kTcTile * kLdP);
  float* sDelta = sLse + kTcTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * kTcTile;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  const int tiles = (M + kTcTile - 1) / kTcTile;

  tile_async<DP>(sQ, q, b, h, q0, N, H, D, ldh);
  tile_async<DP>(sdO, dout, b, h, q0, N, H, D, ldh);
  rows_async(sLse, lse, b, h, q0, H, N);
  rows_async(sDelta, delta, b, h, q0, H, N);
  tile_async<DP>(sKV, k, b, h, 0, M, H, D, ldh);
  tile_async<DP>(sKV + half, v, b, h, 0, M, H, D, ldh);
  cp_async_commit();
  FragC acc[DP / 16];
#pragma unroll
  for (int n = 0; n < DP / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTcTile;
    const bf16* sK = sKV + (t & 1) * 2 * half;
    const bf16* sV = sK + half;
    if (t + 1 < tiles) {
      bf16* next = sKV + ((t + 1) & 1) * 2 * half;
      tile_async<DP>(next, k, b, h, k0 + kTcTile, M, H, D, ldh);
      tile_async<DP>(next + half, v, b, h, k0 + kTcTile, M, H, D, ldh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    scores_to_smem<DP>(sS + r0 * kLdS, sQ + r0 * ldh, sK, ldh);
    scores_to_smem<DP>(sdP + r0 * kLdS, sdO + r0 * ldh, sV, ldh);
    __syncwarp();
    for (int i = r0; i < r0 + 16; ++i) {
      for (int c = lane; c < kTcTile; c += 32) {
        float ds = 0.f;
        if (k0 + c < M) {
          const float p = __expf(sS[i * kLdS + c] * scale - sLse[i]);
          ds = p * (sdP[i * kLdS + c] - sDelta[i]);
        }
        sdS[i * kLdP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    rows_times_tile<DP>(acc, sdS + r0 * kLdP, sK, ldh);
    __syncthreads();
  }
  cp_async_wait<0>();
  // the score tiles are free now: stage the output through them
  store_rows<DP>(dq, acc, sS + r0 * ldo, ldo, b, h, q0 + r0, N, H, D, scale);
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
    dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int N, int M, int D,
                  float scale) {
  using Lay = TcLayout<DP>;
  constexpr int ldh = Lay::kLdH, ldo = Lay::kLdO, half = Lay::kHalf;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + half;
  bf16* sQdO = sV + half;                                     // 2 stages of (Q, dO)
  float* sSt = reinterpret_cast<float*>(sQdO + 4 * half);     // K.Q^T (key rows)
  float* sdPt = sSt + kTcTile * kLdS;                         // V.dO^T
  bf16* sPt = reinterpret_cast<bf16*>(sdPt + kTcTile * kLdS);
  bf16* sdSt = sPt + kTcTile * kLdP;
  float* sRows = reinterpret_cast<float*>(sdSt + kTcTile * kLdP);  // 2 stages of (lse, delta)
  const int b = blockIdx.y / H, h = blockIdx.y % H, j0 = blockIdx.x * kTcTile;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  const int tiles = (N + kTcTile - 1) / kTcTile;

  tile_async<DP>(sK, k, b, h, j0, M, H, D, ldh);
  tile_async<DP>(sV, v, b, h, j0, M, H, D, ldh);
  tile_async<DP>(sQdO, q, b, h, 0, N, H, D, ldh);
  tile_async<DP>(sQdO + half, dout, b, h, 0, N, H, D, ldh);
  rows_async(sRows, lse, b, h, 0, H, N);
  rows_async(sRows + kTcTile, delta, b, h, 0, H, N);
  cp_async_commit();
  FragC acc_k[DP / 16], acc_v[DP / 16];
#pragma unroll
  for (int n = 0; n < DP / 16; ++n) {
    wmma::fill_fragment(acc_k[n], 0.f);
    wmma::fill_fragment(acc_v[n], 0.f);
  }
  for (int t = 0; t < tiles; ++t) {
    const int q0 = t * kTcTile;
    const bf16* sQ = sQdO + (t & 1) * 2 * half;
    const bf16* sdO = sQ + half;
    const float* sLse = sRows + (t & 1) * 2 * kTcTile;
    const float* sDelta = sLse + kTcTile;
    if (t + 1 < tiles) {
      bf16* next = sQdO + ((t + 1) & 1) * 2 * half;
      float* next_rows = sRows + ((t + 1) & 1) * 2 * kTcTile;
      tile_async<DP>(next, q, b, h, q0 + kTcTile, N, H, D, ldh);
      tile_async<DP>(next + half, dout, b, h, q0 + kTcTile, N, H, D, ldh);
      rows_async(next_rows, lse, b, h, q0 + kTcTile, H, N);
      rows_async(next_rows + kTcTile, delta, b, h, q0 + kTcTile, H, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    scores_to_smem<DP>(sSt + r0 * kLdS, sK + r0 * ldh, sQ, ldh);
    scores_to_smem<DP>(sdPt + r0 * kLdS, sV + r0 * ldh, sdO, ldh);
    __syncwarp();
    for (int jr = r0; jr < r0 + 16; ++jr) {
      for (int c = lane; c < kTcTile; c += 32) {
        float p = 0.f, ds = 0.f;
        if (q0 + c < N) {
          p = __expf(sSt[jr * kLdS + c] * scale - sLse[c]);
          ds = p * (sdPt[jr * kLdS + c] - sDelta[c]);
        }
        sPt[jr * kLdP + c] = __float2bfloat16(p);
        sdSt[jr * kLdP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    rows_times_tile<DP>(acc_v, sPt + r0 * kLdP, sdO, ldh);
    rows_times_tile<DP>(acc_k, sdSt + r0 * kLdP, sQ, ldh);
    __syncthreads();
  }
  cp_async_wait<0>();
  // the score tiles are free now: stage the outputs through them
  store_rows<DP>(dv, acc_v, sSt + r0 * ldo, ldo, b, h, j0 + r0, M, H, D, 1.f);
  store_rows<DP>(dk, acc_k, sSt + r0 * ldo, ldo, b, h, j0 + r0, M, H, D, scale);
}

template <int DP>
constexpr size_t dq_tc_smem() {
  using L = TcLayout<DP>;
  return 6 * L::kHalfTile + 2 * L::kScoreTile + L::kProbTile + 2 * L::kRows;
}
template <int DP>
constexpr size_t dkv_tc_smem() {
  using L = TcLayout<DP>;
  return 6 * L::kHalfTile + 2 * L::kScoreTile + 2 * L::kProbTile + 4 * L::kRows;
}

// ---------------------------------------------------------------------------
// K1, mma route (bf16, 32 < D <= 80, D % 8 == 0): 128 query rows per block,
// K/V tiles of 64 keys.  At D = 40 four warps own 32 rows each and four
// stages are in flight (70 KB); ptxas fits the warp's state (scores 64,
// output 40, Q 24 registers) in the 168 registers that three resident
// blocks leave, without spills, so 12 warps share an SM.  Wider heads give
// each of eight warps 16 rows, with three stages and two blocks per SM.
// ---------------------------------------------------------------------------

template <int D>
struct FwdMma {
  static constexpr bool kTwo = D <= 40;             // two m16 row tiles per warp
  static constexpr int kMt = kTwo ? 2 : 1;
  static constexpr int kWarps = kTwo ? 4 : 8;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kStages = kTwo ? 4 : 3;       // K/V tiles in flight
  static constexpr int kMinBlocks = kTwo ? 3 : 2;    // resident blocks the registers must allow
  static constexpr int kBk = 64;                     // keys per K/V tile
  static constexpr int kBq = kWarps * 16 * kMt;      // query rows per block
  static constexpr int kLd = (D + 15) / 16 * 16 + 8;  // shared-memory row stride
  static constexpr int kTile = kBk * kLd;            // elements of one K or V tile
  static constexpr size_t kSmem = sizeof(bf16) * (size_t)(kBq * kLd + 2 * kStages * kTile);
};

template <int D>
__global__ void __launch_bounds__(FwdMma<D>::kThreads, FwdMma<D>::kMinBlocks)
    fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                   int H, int N, int M, float sl2) {
  using C = FwdMma<D>;
  constexpr int ld = C::kLd, MT = C::kMt, BK = C::kBk, S = C::kStages, tile = C::kTile;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kBq x ld; O is staged here at the end
  bf16* sKV = sQ + C::kBq * ld;                  // S stages of (K, V)
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * C::kBq;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16 * MT;
  const int tiles = (M + BK - 1) / BK, HD = H * D;
  const bf16* k0 = head_row(k, b, 0, h, M, H, D);
  const bf16* v0 = head_row(v, b, 0, h, M, H, D);
  // start copying K/V tile t into its stage; one commit group per tile,
  // empty past the last, so the count of groups in flight stays fixed
  auto fetch = [&](int t) {
    if (t < tiles) {
      bf16* dst = sKV + (t % S) * 2 * tile;
      const long long off = (long long)t * BK * HD;
      copy_rows<BK, D, C::kThreads>(dst, ld, k0 + off, HD, M - t * BK);
      copy_rows<BK, D, C::kThreads>(dst + tile, ld, v0 + off, HD, M - t * BK);
    }
    cp_async_commit();
  };

  copy_rows<C::kBq, D, C::kThreads>(sQ, ld, head_row(q, b, q0, h, N, H, D), HD, N - q0);
#pragma unroll
  for (int t = 0; t < S - 1; ++t) fetch(t);  // Q joins tile 0's group
  RowState<MT, D / 8> st;
  row_state_init(st);
  uint32_t qf[MT][(D + 15) / 16][4];
  // tile t: wait for it, hand tile t - 1's stage to tile t + S - 1, attend;
  // the first tile (no rescale, Q's fragments to load) is its own copy
  auto step = [&](int t, auto first) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if constexpr (decltype(first)::value) load_q(qf, sQ + r0 * ld, ld);
    fetch(t + S - 1);
    const bf16* sK = sKV + (t % S) * 2 * tile;
    attend_tile<MT, D, BK>(st, qf, sK, sK + tile, ld, M - t * BK, sl2, decltype(first)::value);
  };
  step(0, std::true_type{});
  for (int t = 1; t < tiles; ++t) step(t, std::false_type{});
  cp_async_wait<0>();  // no copy is left in flight at exit
  float row_lse[MT][2];
  finish_rows(st, row_lse);
  // only this warp read its rows of the Q tile: stage O there
  __syncwarp();
  stage_rows(sQ + r0 * ld, st, ld);
  __syncwarp();
  store_staged(o, sQ + r0 * ld, ld, 16 * MT, D, b, h, q0 + r0, 0, N, H, D);
  if (lane % 4 == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int n = q0 + r0 + mt * 16 + lane / 4 + 8 * hr;
        if (n < N) lse[((long long)b * H + h) * N + n] = row_lse[mt][hr];
      }
  }
}

// ---------------------------------------------------------------------------
// K1, d512 route (bf16, D = 512): 8 warps = 4 row groups of 16 query rows x
// 2 halves of the head dim.
// ---------------------------------------------------------------------------

constexpr int kBigD = 512;
constexpr int kBigHalf = kBigD / 2;  // a warp's share of the head dim
constexpr int kBigLd = kBigD + 8;
constexpr int kBigBq = 64;  // query rows per block
constexpr int kBigBk = 32;  // keys per K/V tile
constexpr int kBigWarps = 8;
constexpr int kBigTile = kBigBk * kBigLd;
constexpr int kBigSwap = 16 * 32;  // a warp's 16 x 32 partial scores, one float per lane and reg
constexpr size_t kBigSmem =
    sizeof(bf16) * (size_t)(kBigBq * kBigLd + 4 * kBigTile) + sizeof(float) * kBigWarps * kBigSwap;

// Named barrier of the two warps of row group rg (barrier 0 is __syncthreads).
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg) : "memory");
}

__global__ void __launch_bounds__(kBigWarps * 32, 1)
    fwd_d512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int H, int N, int M, float sl2) {
  constexpr int ld = kBigLd, NT = kBigBk / 8, ND = kBigHalf / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kBigBq x ld; O is staged here at the end
  bf16* sKV = sQ + kBigBq * ld;                  // 2 stages of (K, V)
  float* sSwap = reinterpret_cast<float*>(sKV + 4 * kBigTile);
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * kBigBq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp / 2, half = warp % 2, r0 = rg * 16, c0 = half * kBigHalf;
  const int tiles = (M + kBigBk - 1) / kBigBk;
  float* mine = sSwap + warp * kBigSwap;
  const float* theirs = sSwap + (warp ^ 1) * kBigSwap;

  constexpr int T = kBigWarps * 32;
  const int hd = H * kBigD;
  const bf16* k0 = head_row(k, b, 0, h, M, H, kBigD);
  const bf16* v0 = head_row(v, b, 0, h, M, H, kBigD);
  copy_rows<kBigBq, kBigD, T>(sQ, ld, head_row(q, b, q0, h, N, H, kBigD), hd, N - q0);
  copy_rows<kBigBk, kBigD, T>(sKV, ld, k0, hd, M);
  copy_rows<kBigBk, kBigD, T>(sKV + kBigTile, ld, v0, hd, M);
  cp_async_commit();
  RowState<1, ND> st;
  row_state_init(st);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1 and its swap
    if (t + 1 < tiles) {
      bf16* next = sKV + ((t + 1) & 1) * 2 * kBigTile;
      const long long off = (long long)(t + 1) * kBigBk * hd;
      copy_rows<kBigBk, kBigD, T>(next, ld, k0 + off, hd, M - (t + 1) * kBigBk);
      copy_rows<kBigBk, kBigD, T>(next + kBigTile, ld, v0 + off, hd, M - (t + 1) * kBigBk);
      cp_async_commit();
    }
    const bf16* sK = sKV + (t & 1) * 2 * kBigTile;
    const bf16* sV = sK + kBigTile;
    // this warp's half of the scores: Q fragments come from shared memory
    // per k16 step (64 more registers would not fit beside O)
    float s[1][NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[0][n][r] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < kBigHalf / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sQ + r0 * ld + c0 + kk * 16, ld);
#pragma unroll
      for (int j = 0; j < kBigBk / 16; ++j) {
        uint32_t bk[4];
        load_b_rows(bk, sK + j * 16 * ld + c0 + kk * 16, ld);
        mma_bf16(s[0][2 * j], a, bk[0], bk[1]);
        mma_bf16(s[0][2 * j + 1], a, bk[2], bk[3]);
      }
    }
    // swap halves with the other warp of the row group and add: both warps
    // add the same two numbers, so both hold the same scores
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) mine[(n * 4 + r) * 32 + lane] = s[0][n][r];
    pair_sync(rg);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[0][n][r] += theirs[(n * 4 + r) * 32 + lane];
    const int valid = M - t * kBigBk;
    if (valid < kBigBk) mask_keys<1, NT>(s, valid);
    softmax_tile<1, NT, ND>(st, s, sl2, t == 0);
    p_times_v<1, kBigBk, ND>(st, s, sV + c0, ld);
  }
  float row_lse[1][2];
  finish_rows(st, row_lse);
  // only this warp read its rows and half of the Q tile: stage O there
  __syncwarp();
  stage_rows(sQ + r0 * ld + c0, st, ld);
  __syncwarp();
  store_staged(o, sQ + r0 * ld + c0, ld, 16, kBigHalf, b, h, q0 + r0, c0, N, H, kBigD);
  if (half == 0 && lane % 4 == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int n = q0 + r0 + lane / 4 + 8 * hr;
      if (n < N) lse[((long long)b * H + h) * N + n] = row_lse[0][hr];
    }
  }
}

template <typename Kern, typename... Args>
int launch(Kern kern, dim3 grid, int threads, size_t smem, void* stream, Args... args) {
  if (smem > (size_t)kMaxSmem || grid.y > 65535u || grid.x == 0u || grid.y == 0u)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// The K2/K3 tensor-core path's padded head dim, or 0 where it does not apply.
int tc_dp(int D, std::initializer_list<const void*> tensors) {
  return mma_route_ok(D, tensors) ? (D + 15) / 16 * 16 : 0;
}

template <int D>
int fwd_mma_launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                   int N, int M, float scale, void* stream) {
  using C = FwdMma<D>;
  dim3 grid((N + C::kBq - 1) / C::kBq, B * H);
  return launch(fwd_mma_kernel<D>, grid, C::kThreads, C::kSmem, stream, (const bf16*)q,
                (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, H, N, M, scale * kLog2e);
}

template <int DP>
int dq_tc_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, int B, int H, int N, int M, int D, float scale,
                 void* stream) {
  dim3 grid((N + kTcTile - 1) / kTcTile, B * H);
  return launch(dq_tc_kernel<DP>, grid, kTcThreads, dq_tc_smem<DP>(), stream, (const bf16*)q,
                (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
                (const float*)delta, (bf16*)dq, H, N, M, D, scale);
}

template <int DP>
int dkv_tc_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* delta, void* dk, void* dv, int B, int H, int N, int M, int D,
                  float scale, void* stream) {
  dim3 grid((M + kTcTile - 1) / kTcTile, B * H);
  return launch(dkv_tc_kernel<DP>, grid, kTcThreads, dkv_tc_smem<DP>(), stream, (const bf16*)q,
                (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
                (const float*)delta, (bf16*)dk, (bf16*)dv, H, N, M, D, scale);
}

// Calls LAUNCH<DP> with the padded head dims the tensor-core path is built for.
#define EMCID_TC_DISPATCH(dp, LAUNCH, ...)                     \
  switch (dp) {                                                \
    case 48: return LAUNCH<48>(__VA_ARGS__);                   \
    case 64: return LAUNCH<64>(__VA_ARGS__);                   \
    case 80: return LAUNCH<80>(__VA_ARGS__);                   \
    default: return (int)cudaErrorInvalidValue;                \
  }

template <typename T>
int fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
               int N, int M, int D, float scale, void* stream) {
  const Tiles t = fwd_tiles(D);
  dim3 grid((N + t.bq - 1) / t.bq, B * H);
  return launch(fwd_kernel<T>, grid, kThreads, fwd_smem(D, t), stream, (const T*)q, (const T*)k,
                (const T*)v, (T*)o, (float*)lse, H, N, M, D, t.bq, t.bk, scale);
}

template <typename T>
int dq_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int H, int N, int M, int D, float scale,
              void* stream) {
  const Tiles t = bwd_tiles(D);
  dim3 grid((N + t.bq - 1) / t.bq, B * H);
  return launch(dq_kernel<T>, grid, kThreads, dq_smem(D, t), stream, (const T*)q, (const T*)k,
                (const T*)v, (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, H,
                N, M, D, t.bq, t.bk, scale);
}

template <typename T>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int H, int N, int M, int D,
               float scale, void* stream) {
  const Tiles t = bwd_tiles(D);
  dim3 grid((M + t.bk - 1) / t.bk, B * H);
  return launch(dkv_kernel<T>, grid, kThreads, dkv_smem(D, t), stream, (const T*)q, (const T*)k,
                (const T*)v, (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk,
                (T*)dv, H, N, M, D, t.bq, t.bk, scale);
}

}  // namespace

// The forward's three routes (fwd_route in emcid_torch/ops/flash_v2.py),
// one C entry point each, all with one signature.  dtype: 0 = float32,
// 1 = bfloat16; a route given what it does not take returns
// cudaErrorInvalidValue and launches nothing.

// fma: the float-FMA kernel, float32 or bf16, any head dim.
extern "C" int emcid_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int H, int N, int M, int D, float scale, int dtype,
                               void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return fwd_launch<float>(q, k, v, o, lse, B, H, N, M, D, scale, stream);
  if (dtype == 1) return fwd_launch<bf16>(q, k, v, o, lse, B, H, N, M, D, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// mma: bf16, 32 < D <= 80, D % 8 == 0, 16-byte aligned tensors.
extern "C" int emcid_flash_fwd_mma(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int H, int N, int M, int D, float scale,
                                   int dtype, void* stream) {
  if (dtype != 1 || M <= 0 || !mma_route_ok(D, {q, k, v, o})) return (int)cudaErrorInvalidValue;
  EMCID_MMA_DISPATCH(D, fwd_mma_launch, q, k, v, o, lse, B, H, N, M, scale, stream)
}

// d512: bf16, D = 512, 16-byte aligned tensors.
extern "C" int emcid_flash_fwd_d512(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int H, int N, int M, int D, float scale,
                                    int dtype, void* stream) {
  if (dtype != 1 || M <= 0 || D != kBigD || !aligned16({q, k, v, o}))
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + kBigBq - 1) / kBigBq, B * H);
  return launch(fwd_d512_kernel, grid, kBigWarps * 32, kBigSmem, stream, (const bf16*)q,
                (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, H, N, M, scale * kLog2e);
}

extern "C" int emcid_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dq, int B, int H, int N,
                              int M, int D, float scale, int dtype, void* stream) {
  if (dtype == 0)
    return dq_launch<float>(q, k, v, dout, lse, delta, dq, B, H, N, M, D, scale, stream);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (const int dp = tc_dp(D, {q, k, v, dout, dq}))
    EMCID_TC_DISPATCH(dp, dq_tc_launch, q, k, v, dout, lse, delta, dq, B, H, N, M, D, scale,
                      stream)
  return dq_launch<bf16>(q, k, v, dout, lse, delta, dq, B, H, N, M, D, scale, stream);
}

extern "C" int emcid_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dk, void* dv, int B,
                               int H, int N, int M, int D, float scale, int dtype,
                               void* stream) {
  if (dtype == 0)
    return dkv_launch<float>(q, k, v, dout, lse, delta, dk, dv, B, H, N, M, D, scale, stream);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (const int dp = tc_dp(D, {q, k, v, dout, dk, dv}))
    EMCID_TC_DISPATCH(dp, dkv_tc_launch, q, k, v, dout, lse, delta, dk, dv, B, H, N, M, D,
                      scale, stream)
  return dkv_launch<bf16>(q, k, v, dout, lse, delta, dk, dv, B, H, N, M, D, scale, stream);
}
