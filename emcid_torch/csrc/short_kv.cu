// Single-pass softmax attention for a short key set (K4), for Hopper (sm_90a).
//
// Replaces emcid_tpu/ops/attention.py: _flash_kernel.  It computes what the
// TPU kernel computes: with every key of a head (M < 256, the 77-token text
// context of the UNet's cross-attention) beside one query tile, s = scale *
// Q.K^T, p = exp(s - rowmax), O = (p.V) / rowsum(p), with no online
// rescaling.  The backward is not a kernel: as in the JAX package, it is the
// chunked recompute in plain torch (emcid_torch/ops/attention.py).
//
// What bounds it on this card: per query row it reads D values of Q and
// writes D values of O, and does 4*M*D flops (about 150 per byte at M = 77,
// D = 40 in bf16), which puts it near the card's ridge; the K/V of a head are
// read once per query tile and stay in shared memory.  This first version
// uses float FMAs out of shared memory (no tensor cores), so in practice it
// is bounded by the shared-memory load rate.  Its design keeps K, V, the
// query tile and the score tile in shared memory as float with row stride
// D + 1 (bank-conflict free column walks), does the softmax one warp per
// row with shuffles, and shrinks the query tile until the whole head fits
// 227 KB.
//
// Tensors are (B, L, H, D) contiguous, bf16 or f32; accumulation is f32.
// The C entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include "common.cuh"

using namespace emcid;
using bf16 = __nv_bfloat16;

namespace {

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int emcid_short_kv_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                  int H, int N, int M, int D, float scale, int dtype,
                                  void* stream) {
  if (dtype == 0) return short_launch<float>(q, k, v, o, B, H, N, M, D, scale, stream);
  if (dtype == 1) return short_launch<bf16>(q, k, v, o, B, H, N, M, D, scale, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* emcid_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
