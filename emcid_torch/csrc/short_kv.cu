// Single-pass softmax attention for a short key set (K4), for Hopper (sm_90a).
//
// Replaces emcid_tpu/ops/attention.py: _flash_kernel.  It computes what the
// TPU kernel computes: with every key of a head (M < 256, the 77-token text
// context of the UNet's cross-attention) beside one query tile, s = scale *
// Q.K^T, p = exp(s - rowmax), O = (p.V) / rowsum(p), with no lse.  The
// backward is not a kernel: as in the JAX package, it is the chunked
// recompute in plain torch (emcid_torch/ops/attention.py).
//
// Two routes, one C entry point each; the wrapper (short_kv_route in
// emcid_torch/ops/attention.py) picks one:
//
// * mma (emcid_short_kv_fwd_mma): bf16 with 32 < D <= 80, D % 8 == 0 (the
//   UNet's cross-attention heads, D = 40 and 80).  Per query row it reads
//   D values of Q and writes D values of O and does 4 * M * D flops (about
//   150 per byte at M = 77, D = 40), below the card's ridge of about 295:
//   the bytes of Q and O bound it, 21.8 us at (24, 2304, 77, 8, 40).  So
//   the arithmetic runs on the tensor cores out of registers (mma.cuh) and
//   stays off the critical path: one block per (b, h, 128 query rows), 8
//   warps of 16 rows; all M keys of the head are copied once by 16-byte
//   cp.async into bf16 shared memory (rows padded to a multiple of 80 keys
//   and zero past M; the Q.K^T depth ends in an m16n8k8 step where D % 16
//   == 8, so nothing past column D is read); the scores of a chunk of 80
//   keys sit in registers, so M = 77 is one chunk with no rescale and 80
//   exponentials per row, and the online rescale runs only past the first
//   chunk (80 <= M < 256); keys past M score -1e30.  p is rounded to bf16
//   before P.V, as the JAX kernel rounds it to V's type; the row sum is
//   f32.  O leaves through the Q tile's shared memory in 16-byte stores.
// * fma (emcid_short_kv_fwd): float32, and bf16 at other head dims, on
//   float FMAs out of shared memory (bounded by the shared-memory load
//   rate): K, V, the query tile and the score tile as float with row stride
//   D + 1 (bank-conflict free column walks), the softmax one warp per row
//   with shuffles, the query tile shrunk until the whole head fits 227 KB.
//
// Tensors are (B, L, H, D) contiguous, bf16 or f32; accumulation is f32.
// Each C entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include "common.cuh"
#include "mma.cuh"

using namespace emcid;

namespace {

constexpr int kShortMax = 256;  // K4 takes fewer keys than this

size_t short_smem(int D, int M, int BQ) {
  const size_t ld = D + 1;
  return sizeof(float) * (2 * (size_t)M * ld + BQ * ld + (size_t)BQ * M + BQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    short_kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, int H, int N, int M, int D, int BQ, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sK = smem;           // M x ld
  float* sV = sK + M * ld;    // M x ld
  float* sQ = sV + M * ld;    // BQ x ld, pre-scaled
  float* sS = sQ + BQ * ld;   // BQ x M scores, then probabilities
  float* sInv = sS + BQ * M;  // 1 / rowsum
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  load_tile(sK, k, b, h, 0, M, M, H, D, ld);
  load_tile(sV, v, b, h, 0, M, M, H, D, ld);
  load_tile(sQ, q, b, h, q0, BQ, N, H, D, ld, scale);
  __syncthreads();
  for (int e = tid; e < BQ * M; e += blockDim.x) {
    const int i = e / M, j = e - i * M;
    sS[e] = dot_rows(sQ + i * ld, sK + j * ld, D);
  }
  __syncthreads();
  for (int i = warp; i < BQ; i += kWarps) {
    float* row = sS + i * M;
    float mx = kNegInf;
    for (int j = lane; j < M; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < M; j += 32) {
      const float p = __expf(row[j] - mx);
      row[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) sInv[i] = 1.f / sum;
  }
  __syncthreads();
  for (int e = tid; e < BQ * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D, n = q0 + i;
    if (n >= N) continue;
    const float* p = sS + i * M;
    float acc = 0.f;
    for (int j = 0; j < M; ++j) acc = fmaf(p[j], sV[j * ld + d], acc);
    stf(o + (((long long)b * N + n) * H + h) * D + d, acc * sInv[i]);
  }
}

template <typename T>
int short_launch(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                 int M, int D, float scale, void* stream) {
  int bq = 64;
  while (bq > 8 && short_smem(D, M, bq) > (size_t)kMaxSmem) bq /= 2;
  const size_t smem = short_smem(D, M, bq);
  dim3 grid((N + bq - 1) / bq, B * H);
  if (smem > (size_t)kMaxSmem || grid.y > 65535u || N <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      short_kv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  short_kv_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, N, M, D, bq, scale);
  return (int)cudaGetLastError();
}

// ---- mma route ----

constexpr int kShortWarps = 8;
constexpr int kShortBq = kShortWarps * 16;  // query rows per block
constexpr int kShortChunk = 80;             // keys per score chunk

template <int D>
struct ShortMma {
  static constexpr int kLd = (D + 15) / 16 * 16 + 8;  // shared-memory row stride
  static size_t smem(int chunks) {
    return sizeof(bf16) * (size_t)(kShortBq + 2 * chunks * kShortChunk) * kLd;
  }
};

template <int D>
__global__ void __launch_bounds__(kShortWarps * 32)
    short_kv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o, int H, int N, int M,
                        float sl2) {
  constexpr int ld = ShortMma<D>::kLd, T = kShortWarps * 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int chunks = (M + kShortChunk - 1) / kShortChunk, mp = chunks * kShortChunk;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kShortBq x ld; O is staged here at the end
  bf16* sK = sQ + kShortBq * ld;                  // mp x ld, zero past M
  bf16* sV = sK + mp * ld;                        // mp x ld, zero past M
  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * kShortBq;
  const int r0 = (threadIdx.x / 32) * 16, HD = H * D;

  copy_rows<kShortBq, D, T>(sQ, ld, head_row(q, b, q0, h, N, H, D), HD, N - q0);
  for (int c = 0; c < chunks; ++c) {
    const int j0 = c * kShortChunk;
    copy_rows<kShortChunk, D, T>(sK + j0 * ld, ld, head_row(k, b, j0, h, M, H, D), HD, M - j0);
    copy_rows<kShortChunk, D, T>(sV + j0 * ld, ld, head_row(v, b, j0, h, M, H, D), HD, M - j0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[1][(D + 15) / 16][4];
  load_q(qf, sQ + r0 * ld, ld);
  RowState<1, D / 8> st;
  row_state_init(st);
  for (int c = 0; c < chunks; ++c)
    attend_tile<1, D, kShortChunk>(st, qf, sK + c * kShortChunk * ld, sV + c * kShortChunk * ld,
                                   ld, M - c * kShortChunk, sl2, c == 0);
  float row_lse[1][2];
  finish_rows(st, row_lse);
  // only this warp read its rows of the Q tile: stage O there
  __syncwarp();
  stage_rows(sQ + r0 * ld, st.o, ld);
  __syncwarp();
  store_staged(o, sQ + r0 * ld, ld, 16, D, b, h, q0 + r0, 0, N, H, D);
}

template <int D>
int short_mma_launch(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                     int M, float scale, void* stream) {
  const size_t smem = ShortMma<D>::smem((M + kShortChunk - 1) / kShortChunk);
  dim3 grid((N + kShortBq - 1) / kShortBq, B * H);
  if (smem > (size_t)kMaxSmem || grid.y > 65535u) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      short_kv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  short_kv_mma_kernel<D><<<grid, kShortWarps * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, H, N, M, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// The two routes (short_kv_route in emcid_torch/ops/attention.py), one C
// entry point each, with one signature.  dtype: 0 = float32, 1 = bfloat16;
// a route given what it does not take returns cudaErrorInvalidValue.

// fma: float32 or bf16, any head dim.
extern "C" int emcid_short_kv_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                  int H, int N, int M, int D, float scale, int dtype,
                                  void* stream) {
  if (dtype == 0) return short_launch<float>(q, k, v, o, B, H, N, M, D, scale, stream);
  if (dtype == 1) return short_launch<bf16>(q, k, v, o, B, H, N, M, D, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// mma: bf16, 32 < D <= 80, D % 8 == 0, 16-byte aligned tensors, 0 < M < 256.
extern "C" int emcid_short_kv_fwd_mma(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int N, int M, int D, float scale, int dtype,
                                      void* stream) {
  if (dtype != 1 || N <= 0 || M <= 0 || M >= kShortMax || !mma_route_ok(D, {q, k, v, o}))
    return (int)cudaErrorInvalidValue;
  EMCID_MMA_DISPATCH(D, short_mma_launch, q, k, v, o, B, H, N, M, scale, stream)
}

extern "C" const char* emcid_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
