// Shared helpers of the kernels: typed loads/stores that widen to float,
// warp and block reductions.  The attention kernels take the UNet's native
// (B, L, H, D) layout, contiguous; element (b, l, h, d) sits at
// ((b * L + l) * H + h) * D + d.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace emcid {

constexpr float kNegInf = -1e30f;  // masked score (the TPU kernels' NEG_INF)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // 227 KB: the most dynamic smem a block may ask for

template <typename T> __device__ __forceinline__ float ldf(const T* p);
template <> __device__ __forceinline__ float ldf<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float ldf<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ void stf(T* p, float v);
template <> __device__ __forceinline__ void stf<float>(float* p, float v) { *p = v; }
template <> __device__ __forceinline__ void stf<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy rows [r0, r0 + R) of head (b, h) of a (B, L, H, D) tensor into a
// float tile with row stride ld (D + 1, odd, so column walks across rows
// hit distinct banks).  Rows at or past L read as zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b, int h, int r0,
                                          int R, int L, int H, int D, int ld,
                                          float mul = 1.f) {
  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const int i = e / D, d = e - i * D, r = r0 + i;
    dst[i * ld + d] =
        r < L ? ldf(src + (((long long)b * L + r) * H + h) * D + d) * mul : 0.f;
  }
}

// Dot product of two float rows in shared memory.
__device__ __forceinline__ float dot_rows(const float* a, const float* b, int D) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// ---- helpers of the normalisation kernels (groupnorm.cu, layernorm.cu) ----

// V consecutive elements moved as one access of V * sizeof(T) bytes (up to
// 16): the caller guarantees the alignment.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = ldf(&pk.v[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  Pack<T, V> pk;
#pragma unroll
  for (int k = 0; k < V; ++k) stf(&pk.v[k], f[k]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

// A scale or bias value: the parameters come as float32 or bfloat16
// (pbf16 = 1), whatever the activations' type, and widen to float.
__device__ __forceinline__ float ldparam(const void* p, int pbf16, int i) {
  return pbf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
               : static_cast<const float*>(p)[i];
}

// 1 / (1 + e^-z) with the fast exponential and divide (about 2 ulp; the
// IEEE divide made the SiLU passes compute-bound); e^-z = inf gives 0.
__device__ __forceinline__ float sigmoidf(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}

// Sums of a and b over the block, in a fixed order (warps, then warp 0
// over the warps' sums), so the result does not change between runs.
// red must hold one float2 per warp plus one; every thread gets the sums.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = make_float2(0.f, 0.f);
    for (int w = 0; w < nw; ++w) {
      t.x += red[w].x;
      t.y += red[w].y;
    }
    red[nw] = t;
  }
  __syncthreads();
  const float2 t = red[nw];
  __syncthreads();  // red may be reused right after
  return t;
}

// Widest access (in elements, at most 16 bytes) that divides n and keeps
// every given pointer aligned; a null pointer is ignored.
template <typename T>
inline int pick_vec(int n, const void* const* ptrs, int nptrs) {
  for (int v = 16 / (int)sizeof(T); v > 1; v /= 2) {
    bool ok = n % v == 0;
    for (int i = 0; i < nptrs && ok; ++i)
      ok = ptrs[i] == nullptr || reinterpret_cast<size_t>(ptrs[i]) % (v * sizeof(T)) == 0;
    if (ok) return v;
  }
  return 1;
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) for `kernel`, only when
// `bytes` is more than was allowed before on the current device (`allowed`:
// the caller's static record, one entry per device), so that launches after
// the first make no attribute call for it.
constexpr int kMaxDevices = 16;

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

inline bool aligned16(const void* const* ptrs, int nptrs) {
  for (int i = 0; i < nptrs; ++i)
    if (reinterpret_cast<size_t>(ptrs[i]) % 16) return false;
  return true;
}

// ---- the in-kernel dgamma/dbeta fold of the norm backwards ----
//
// Every block of a backward writes its float32 partial sums of dgamma and
// dbeta as rows of 2 C floats ([dgamma | dbeta]) into a scratch buffer the
// caller allocates; the block that finishes last sums the rows in row
// order and writes dgamma and dbeta in the parameters' type.  Blocks count
// themselves on int counters in device memory that are 0 before the launch
// and that the last blocks set back to 0, so the next launch on the stream
// finds them so; two backwards running at once on two streams would need
// two sets of counters.  The sums are taken in a fixed order, so the
// results are the same bits on every run.

__device__ __forceinline__ void stparam(void* p, int pbf16, int i, float v) {
  if (pbf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// Called by every thread of each of `total` blocks after it wrote its
// partial sums; true in the last block to arrive (in all its threads), which
// may then read every block's sums.  The barrier orders the block's writes
// before thread 0's release fence and count (as CUTLASS's split-K
// semaphore does), so the other threads need no fence of their own.
__device__ __forceinline__ bool arrive_last(unsigned* counter, unsigned total) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1u) == total - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  return last;
}

__device__ __forceinline__ void fold_out(float* dst, void* dgamma, void* dbeta, int pbf16, int C,
                                         int i, float v) {
  if (dgamma == nullptr)
    dst[i] = v;
  else if (i < C)
    stparam(dgamma, pbf16, i, v);
  else
    stparam(dbeta, pbf16, i - C, v);
}

// dst[i] = sum over r < R, in order, of src[r * n + i], for i < n; src is
// read past L1 (the rows were written by other SMs), 16 bytes at a time
// where n % 4 == 0, eight rows in flight per thread (few registers: they
// count against every block of the kernel, and only one block folds).
// With dgamma set, the sums go out as the parameters' type: i < n / 2 to
// dgamma, the rest to dbeta.
__device__ __forceinline__ void fold_rows(const float* src, int R, int n, float* dst,
                                          void* dgamma = nullptr, void* dbeta = nullptr,
                                          int pbf16 = 0) {
  const int C = n / 2;
  if (n % 4) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < R; ++r) s += __ldcg(src + (size_t)r * n + i);
      fold_out(dst, dgamma, dbeta, pbf16, C, i, s);
    }
    return;
  }
  const int q = n / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < q; i += blockDim.x) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = 0; r0 < R; r0 += 8) {
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = r0 + k < R ? __ldcg(s4 + (size_t)(r0 + k) * q + i) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 8; ++k) a.x += v[k].x, a.y += v[k].y, a.z += v[k].z, a.w += v[k].w;
    }
    fold_out(dst, dgamma, dbeta, pbf16, C, 4 * i, a.x);
    fold_out(dst, dgamma, dbeta, pbf16, C, 4 * i + 1, a.y);
    fold_out(dst, dgamma, dbeta, pbf16, C, 4 * i + 2, a.z);
    fold_out(dst, dgamma, dbeta, pbf16, C, 4 * i + 3, a.w);
  }
}

// Blocks per fold group when `parts` blocks write partial rows: about the
// square root, so that neither fold below reads more than ~sqrt(parts)
// rows.
__host__ __device__ inline int fold_group_size(int parts) {
  int gs = 1;
  while (gs * gs < parts) ++gs;
  return gs;
}

// Two-level fold for a grid of `parts` blocks, each of which wrote row
// blockIdx.x of `part` ((parts + groups, 2 C) floats): the last block of
// each group of fold_group_size(parts) consecutive blocks sums its group's
// rows into row parts + group; the last of those sums the group rows into
// dgamma/dbeta.  counters: 1 + groups ints (the groups' and then the
// whole grid's count).
__device__ __forceinline__ void fold_blocks(float* part, unsigned* counters, int parts, int C,
                                            void* dgamma, void* dbeta, int pbf16) {
  const int gs = fold_group_size(parts), groups = (parts + gs - 1) / gs, n = 2 * C;
  const int grp = blockIdx.x / gs, members = min(gs, parts - grp * gs);
  if (!arrive_last(counters + 1 + grp, members)) return;
  fold_rows(part + (size_t)grp * gs * n, members, n, part + (size_t)(parts + grp) * n);
  if (threadIdx.x == 0) counters[1 + grp] = 0;
  if (!arrive_last(counters, groups)) return;
  fold_rows(part + (size_t)parts * n, groups, n, nullptr, dgamma, dbeta, pbf16);
  if (threadIdx.x == 0) counters[0] = 0;
}

}  // namespace emcid
