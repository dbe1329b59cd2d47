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
// K2 and K3 have two routes each, one C entry point each; the wrapper
// (bwd_route in emcid_torch/ops/flash_v2.py) picks one for both:
//
// * mma (emcid_flash_dq_mma, emcid_flash_dkv_mma): bf16 with 32 < D <= 80,
//   D % 8 == 0.  Per score K2 does three products of depth D (S = Q.K^T,
//   dP = dO.V^T, dQ += dS.K) and K3 four (S, dP, dV += P^T.dO,
//   dK += dS^T.Q), and each one exponential: at D = 40 the tensor flops
//   bound them (K2 0.124 ms, K3 0.165 ms at (12, 2304, 8, 40)), the
//   exponentials just below (0.122 ms).  So, as in K1's mma route, nothing
//   between the products leaves registers: S and dP come from the warp's
//   A fragments (Q and dO in K2, K and V in K3; loaded once) against the
//   streamed tile's rows, P = exp2(S * sl2 - lse2) (lse2 = lse * log2(e))
//   and dS = P * (dP - delta) are formed in the C layout and, rounded to
//   bf16 as the JAX kernels round them, are the A fragments of the next
//   products.  K3 works on the transposed scores (key rows, query columns),
//   so P^T and dS^T are already in the A layout of dV and dK.  See BwdMma
//   below for the block shape.
// * fma (emcid_flash_dq, emcid_flash_dkv): float32, and bf16 at any other
//   head dim, on float FMAs out of shared memory, like K1's fma route.
//
// K2 and K3 stay two kernels, as in the JAX package: each block owns its
// rows of dQ (K2) or of dK and dV (K3), so no sum crosses blocks, nothing
// is added atomically, and every run gives the same gradients.  Every
// kernel reads each K/V (K1, K2) or Q/dO (K3) tile from device memory once
// per block.
//
// Tensors are (B, L, H, D) contiguous, bf16 or f32; lse and delta are
// (B, H, N) f32, lse in natural-log units.  Accumulation is f32 throughout.
// Each C entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include "common.cuh"
#include "mma.cuh"

#include <cstdint>
#include <type_traits>

using namespace emcid;

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
  stage_rows(sQ + r0 * ld, st.o, ld);
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
    p_times_v<1, kBigBk, ND>(st.o, s, sV + c0, ld);
  }
  float row_lse[1][2];
  finish_rows(st, row_lse);
  // only this warp read its rows and half of the Q tile: stage O there
  __syncwarp();
  stage_rows(sQ + r0 * ld + c0, st.o, ld);
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

// ---------------------------------------------------------------------------
// K2/K3, mma route (bf16, 32 < D <= 80, D % 8 == 0).  A block of 4 warps
// owns 16 * kMt rows per warp (query rows in K2, key rows in K3) and
// streams the other side in tiles of 64 rows through a ring of cp.async
// stages (K2: K and V; K3: Q, dO and their 64 lse and delta values), each
// thread copying fixed 16-byte chunks (copy_rows, as in K1).  A warp's own
// rows load once as A fragments (K2: Q and dO; K3: K and V); the scores of
// kSub streamed rows at a time live in registers.
//
// What bounds it is the shared-memory port, not the tensor cores: every B
// fragment of a streamed tile (for S and dP, then for the dS/P products)
// comes through ldmatrix at 128 bytes a clock per SM.  With one m16 row
// tile per warp, K3 at D = 40 moved ~80 clocks of ldmatrix per warp and 32
// columns against ~40 clocks of tensor work.  So at D <= 48 each warp owns
// two row tiles (kMt = 2), which halves the fragment traffic per flop, at
// the cost of registers: K3 holds K, V 48, dK, dV 80 and S, dP 32 (16
// columns) and runs two blocks per SM (8 warps, up to 255 registers);
// that took K3 from 0.60 to 0.52 ms and K2 from 0.42 to 0.39 ms at (12,
// 2304, 8, 40) over the best one-tile shapes (scripts/torch_bwd_shapes.py
// times the alternatives).  Wider heads keep one row tile: K2 three blocks
// per SM (168 registers) with two stages (shared memory), K3 two blocks
// per SM (K, V, dK and dV take 120 registers at D = 80).  ptxas spills
// nothing at these budgets.  The outputs leave through the warp's own rows
// of its resident tiles in 16-byte stores.
// ---------------------------------------------------------------------------

// The block shape of K2 (DKV false) or K3 (DKV true) at head dim D.
template <int D, bool DKV>
struct BwdMma {
  static constexpr bool kNarrow = D <= 48;
  static constexpr int kMt = kNarrow ? 2 : 1;  // m16 row tiles per warp
  static constexpr int kWarps = 4;
  static constexpr int kThreads = kWarps * 32;
  // resident blocks the registers must allow
  static constexpr int kMinBlocks = kNarrow || DKV ? 2 : 3;
  static constexpr int kStages = kNarrow || DKV ? 3 : 2;  // streamed tiles in flight
  static constexpr int kRows = kWarps * 16 * kMt;         // rows a block owns
  static constexpr int kBt = 64;                          // rows of a streamed tile
  static constexpr int kSub = DKV && !kNarrow ? 32 : 16;  // score columns in registers at once
  static constexpr int kKd = (D + 15) / 16;               // k16 steps of the head dim
  static constexpr int kNd = D / 8;                       // n8 tiles of the head dim
  static constexpr int kLd = (D + 15) / 16 * 16 + 8;      // shared-memory row stride
  static constexpr int kTile = kBt * kLd;                 // elements of one streamed tile
  // two own tiles (Q, dO or K, V), kStages pairs of streamed tiles and, in
  // K3, the streamed rows' lse and delta
  static constexpr size_t kSmem = sizeof(bf16) * (size_t)(2 * kRows * kLd + 2 * kStages * kTile) +
                                  (DKV ? sizeof(float) * 2 * kStages * kBt : 0);
};
template <int D>
using DqMma = BwdMma<D, false>;
template <int D>
using DkvMma = BwdMma<D, true>;

// dQ += dS.K over kSub keys of a K/V tile (sK, sV at those keys): S and dP
// from the warp's Q and dO fragments (MT row tiles), P = exp2(S * sl2 -
// lse2) with keys at or past `valid` at zero, dS = P * (dP - delta),
// rounded to bf16 in p_times_v.  lse2/delta[mt]: the thread's rows g and
// g + 8 of row tile mt.
template <int D, int MT = DqMma<D>::kMt>
__device__ __forceinline__ void dq_sub(float (&acc)[MT][DqMma<D>::kNd][4],
                                       const uint32_t (&qf)[MT][DqMma<D>::kKd][4],
                                       const uint32_t (&dof)[MT][DqMma<D>::kKd][4],
                                       const bf16* sK, const bf16* sV, int ld, int valid,
                                       float sl2, const float (&lse2)[MT][2],
                                       const float (&delta)[MT][2]) {
  constexpr int SUB = DqMma<D>::kSub, NT = SUB / 8;
  float s[MT][NT][4], dp[MT][NT][4];
  scores<MT, D, SUB>(s, qf, sK, ld);
  scores<MT, D, SUB>(dp, dof, sV, ld);
  if (valid < SUB) mask_keys<MT, NT>(s, valid);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = exp2_approx(fmaf(s[mt][n][r], sl2, -lse2[mt][r / 2]));
        dp[mt][n][r] = p * (dp[mt][n][r] - delta[mt][r / 2]);
      }
  p_times_v<MT, SUB, D / 8>(acc, dp, sK, ld);
}

// dV += P^T.dO and dK += dS^T.Q (dK unscaled) over kSub query rows of a
// Q/dO tile (sQ, sdO and their lse/delta at those rows): S^T and dP^T from
// the warp's K and V fragments (MT row tiles of keys); a thread's columns
// are 8n + 2t and 8n + 2t + 1, whose lse and delta it reads from shared
// memory; columns at or past `valid` (query rows past N, whose lse reads
// zero) get P = 0.
template <int D, int MT = DkvMma<D>::kMt>
__device__ __forceinline__ void dkv_sub(float (&dk)[MT][DkvMma<D>::kNd][4],
                                        float (&dv)[MT][DkvMma<D>::kNd][4],
                                        const uint32_t (&kf)[MT][DkvMma<D>::kKd][4],
                                        const uint32_t (&vf)[MT][DkvMma<D>::kKd][4],
                                        const bf16* sQ, const bf16* sdO, const float* sLse,
                                        const float* sDelta, int ld, int valid, float sl2) {
  constexpr int SUB = DkvMma<D>::kSub, NT = SUB / 8;
  float st[MT][NT][4], dpt[MT][NT][4];
  scores<MT, D, SUB>(st, kf, sQ, ld);
  scores<MT, D, SUB>(dpt, vf, sdO, ld);
  if (valid < SUB) mask_keys<MT, NT>(st, valid);
  const int c = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(sLse + n * 8 + c);
    const float2 d = *reinterpret_cast<const float2*>(sDelta + n * 8 + c);
    const float l2[2] = {l.x * kLog2e, l.y * kLog2e}, dl[2] = {d.x, d.y};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = exp2_approx(fmaf(st[mt][n][r], sl2, -l2[r & 1]));
        st[mt][n][r] = p;
        dpt[mt][n][r] = p * (dpt[mt][n][r] - dl[r & 1]);
      }
  }
  p_times_v<MT, SUB, D / 8>(dv, st, sdO, ld);
  p_times_v<MT, SUB, D / 8>(dk, dpt, sQ, ld);
}

template <int D>
__global__ void __launch_bounds__(DqMma<D>::kThreads, DqMma<D>::kMinBlocks)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, int H, int N, int M, float scale) {
  using C = DqMma<D>;
  constexpr int ld = C::kLd, BT = C::kBt, S = C::kStages, tile = C::kTile, T = C::kThreads;
  constexpr int MT = C::kMt;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kRows x ld; dQ is staged here at the end
  bf16* sdO = sQ + C::kRows * ld;                // kRows x ld
  bf16* sKV = sdO + C::kRows * ld;               // S stages of (K, V)
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * C::kRows;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16 * MT;
  const int tiles = (M + BT - 1) / BT, HD = H * D;
  const float sl2 = scale * kLog2e;
  const bf16* k0 = head_row(k, b, 0, h, M, H, D);
  const bf16* v0 = head_row(v, b, 0, h, M, H, D);
  // start copying K/V tile t into its stage; one commit group per tile,
  // empty past the last, so the count of groups in flight stays fixed
  auto fetch = [&](int t) {
    if (t < tiles) {
      bf16* dst = sKV + (t % S) * 2 * tile;
      const long long off = (long long)t * BT * HD;
      copy_rows<BT, D, T>(dst, ld, k0 + off, HD, M - t * BT);
      copy_rows<BT, D, T>(dst + tile, ld, v0 + off, HD, M - t * BT);
    }
    cp_async_commit();
  };

  copy_rows<C::kRows, D, T>(sQ, ld, head_row(q, b, q0, h, N, H, D), HD, N - q0);
  copy_rows<C::kRows, D, T>(sdO, ld, head_row(dout, b, q0, h, N, H, D), HD, N - q0);
#pragma unroll
  for (int t = 0; t < S - 1; ++t) fetch(t);  // Q and dO join tile 0's group
  float lse2[MT][2], dl[MT][2];  // rows g and g + 8 of each row tile; zero past N
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int n = q0 + r0 + mt * 16 + lane / 4 + 8 * hr;
      const long long i = ((long long)b * H + h) * N + n;
      lse2[mt][hr] = n < N ? lse[i] * kLog2e : 0.f;
      dl[mt][hr] = n < N ? delta[i] : 0.f;
    }
  uint32_t qf[MT][C::kKd][4], dof[MT][C::kKd][4];
  float acc[MT][C::kNd][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int d = 0; d < C::kNd; ++d)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][d][r] = 0.f;
  // tile t: wait for it, hand tile t - 1's stage to tile t + S - 1, add its
  // keys' share of dQ; the first tile also loads Q's and dO's fragments
  auto step = [&](int t, auto first) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if constexpr (decltype(first)::value) {
      load_q(qf, sQ + r0 * ld, ld);
      load_q(dof, sdO + r0 * ld, ld);
    }
    fetch(t + S - 1);
    const bf16* sK = sKV + (t % S) * 2 * tile;
#pragma unroll
    for (int c = 0; c < BT; c += C::kSub)
      dq_sub<D>(acc, qf, dof, sK + c * ld, sK + tile + c * ld, ld, M - t * BT - c, sl2, lse2, dl);
  };
  step(0, std::true_type{});
  for (int t = 1; t < tiles; ++t) step(t, std::false_type{});
  cp_async_wait<0>();  // no copy is left in flight at exit
  // only this warp read its rows of the Q tile: stage dQ there
  __syncwarp();
  stage_rows(sQ + r0 * ld, acc, ld, scale);
  __syncwarp();
  store_staged(dq, sQ + r0 * ld, ld, 16 * MT, D, b, h, q0 + r0, 0, N, H, D);
}

template <int D>
__global__ void __launch_bounds__(DkvMma<D>::kThreads, DkvMma<D>::kMinBlocks)
    dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int N, int M,
                   float scale) {
  using C = DkvMma<D>;
  constexpr int ld = C::kLd, BT = C::kBt, S = C::kStages, tile = C::kTile, T = C::kThreads;
  constexpr int MT = C::kMt;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // kRows x ld; dK is staged here at the end
  bf16* sV = sK + C::kRows * ld;                 // kRows x ld; dV is staged here at the end
  bf16* sQdO = sV + C::kRows * ld;               // S stages of (Q, dO)
  float* sRows = reinterpret_cast<float*>(sQdO + 2 * S * tile);  // S stages of (lse, delta)
  const int b = blockIdx.y / H, h = blockIdx.y % H, j0 = blockIdx.x * C::kRows;
  const int r0 = (threadIdx.x / 32) * 16 * MT;
  const int tiles = (N + BT - 1) / BT, HD = H * D;
  const float sl2 = scale * kLog2e;
  const bf16* qh = head_row(q, b, 0, h, N, H, D);
  const bf16* doh = head_row(dout, b, 0, h, N, H, D);
  const float* lseh = lse + ((long long)b * H + h) * N;
  const float* deltah = delta + ((long long)b * H + h) * N;
  // start copying Q/dO tile t and its rows' lse and delta into its stage
  auto fetch = [&](int t) {
    if (t < tiles) {
      bf16* dst = sQdO + (t % S) * 2 * tile;
      float* rows = sRows + (t % S) * 2 * BT;
      const long long off = (long long)t * BT * HD;
      const int left = N - t * BT;
      copy_rows<BT, D, T>(dst, ld, qh + off, HD, left);
      copy_rows<BT, D, T>(dst + tile, ld, doh + off, HD, left);
      copy_floats<BT, T>(rows, lseh + t * BT, left);
      copy_floats<BT, T>(rows + BT, deltah + t * BT, left);
    }
    cp_async_commit();
  };

  copy_rows<C::kRows, D, T>(sK, ld, head_row(k, b, j0, h, M, H, D), HD, M - j0);
  copy_rows<C::kRows, D, T>(sV, ld, head_row(v, b, j0, h, M, H, D), HD, M - j0);
#pragma unroll
  for (int t = 0; t < S - 1; ++t) fetch(t);  // K and V join tile 0's group
  uint32_t kf[MT][C::kKd][4], vf[MT][C::kKd][4];
  float dk_acc[MT][C::kNd][4], dv_acc[MT][C::kNd][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int d = 0; d < C::kNd; ++d)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dk_acc[mt][d][r] = 0.f;
        dv_acc[mt][d][r] = 0.f;
      }
  auto step = [&](int t, auto first) {
    cp_async_wait<S - 2>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if constexpr (decltype(first)::value) {
      load_q(kf, sK + r0 * ld, ld);
      load_q(vf, sV + r0 * ld, ld);
    }
    fetch(t + S - 1);
    const bf16* sQ = sQdO + (t % S) * 2 * tile;
    const float* sLse = sRows + (t % S) * 2 * BT;
#pragma unroll
    for (int c = 0; c < BT; c += C::kSub)
      dkv_sub<D>(dk_acc, dv_acc, kf, vf, sQ + c * ld, sQ + tile + c * ld, sLse + c,
                 sLse + BT + c, ld, N - t * BT - c, sl2);
  };
  step(0, std::true_type{});
  for (int t = 1; t < tiles; ++t) step(t, std::false_type{});
  cp_async_wait<0>();
  // only this warp read its rows of the K and V tiles: stage dK and dV there
  __syncwarp();
  stage_rows(sK + r0 * ld, dk_acc, ld, scale);
  stage_rows(sV + r0 * ld, dv_acc, ld);
  __syncwarp();
  store_staged(dk, sK + r0 * ld, ld, 16 * MT, D, b, h, j0 + r0, 0, M, H, D);
  store_staged(dv, sV + r0 * ld, ld, 16 * MT, D, b, h, j0 + r0, 0, M, H, D);
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

template <int D>
int fwd_mma_launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                   int N, int M, float scale, void* stream) {
  using C = FwdMma<D>;
  dim3 grid((N + C::kBq - 1) / C::kBq, B * H);
  return launch(fwd_mma_kernel<D>, grid, C::kThreads, C::kSmem, stream, (const bf16*)q,
                (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, H, N, M, scale * kLog2e);
}

template <int D>
int dq_mma_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* delta, void* dq, int B, int H, int N, int M, float scale,
                  void* stream) {
  using C = DqMma<D>;
  dim3 grid((N + C::kRows - 1) / C::kRows, B * H);
  return launch(dq_mma_kernel<D>, grid, C::kThreads, C::kSmem, stream, (const bf16*)q,
                (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
                (const float*)delta, (bf16*)dq, H, N, M, scale);
}

template <int D>
int dkv_mma_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, void* dk, void* dv, int B, int H, int N, int M, float scale,
                   void* stream) {
  using C = DkvMma<D>;
  dim3 grid((M + C::kRows - 1) / C::kRows, B * H);
  return launch(dkv_mma_kernel<D>, grid, C::kThreads, C::kSmem, stream, (const bf16*)q,
                (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
                (const float*)delta, (bf16*)dk, (bf16*)dv, H, N, M, scale);
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

// K2's and K3's two routes each (bwd_route in emcid_torch/ops/flash_v2.py),
// one C entry point per route and kernel; the two of a kernel share one
// signature and the forward's conventions.

// fma: the float-FMA kernels, float32 or bf16, any head dim.
extern "C" int emcid_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dq, int B, int H, int N,
                              int M, int D, float scale, int dtype, void* stream) {
  if (dtype == 0)
    return dq_launch<float>(q, k, v, dout, lse, delta, dq, B, H, N, M, D, scale, stream);
  if (dtype == 1)
    return dq_launch<bf16>(q, k, v, dout, lse, delta, dq, B, H, N, M, D, scale, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int emcid_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dk, void* dv, int B,
                               int H, int N, int M, int D, float scale, int dtype,
                               void* stream) {
  if (dtype == 0)
    return dkv_launch<float>(q, k, v, dout, lse, delta, dk, dv, B, H, N, M, D, scale, stream);
  if (dtype == 1)
    return dkv_launch<bf16>(q, k, v, dout, lse, delta, dk, dv, B, H, N, M, D, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// mma: bf16, 32 < D <= 80, D % 8 == 0, 16-byte aligned tensors.
extern "C" int emcid_flash_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, int B, int H,
                                  int N, int M, int D, float scale, int dtype, void* stream) {
  if (dtype != 1 || N <= 0 || M <= 0 || !mma_route_ok(D, {q, k, v, dout, dq}))
    return (int)cudaErrorInvalidValue;
  EMCID_MMA_DISPATCH(D, dq_mma_launch, q, k, v, dout, lse, delta, dq, B, H, N, M, scale, stream)
}

extern "C" int emcid_flash_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dk, void* dv, int B,
                                   int H, int N, int M, int D, float scale, int dtype,
                                   void* stream) {
  if (dtype != 1 || N <= 0 || M <= 0 || !mma_route_ok(D, {q, k, v, dout, dk, dv}))
    return (int)cudaErrorInvalidValue;
  EMCID_MMA_DISPATCH(D, dkv_mma_launch, q, k, v, dout, lse, delta, dk, dv, B, H, N, M, scale,
                     stream)
}
