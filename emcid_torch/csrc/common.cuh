// Shared helpers for the attention kernels: typed loads/stores that widen
// to float, and warp reductions.  Tensors arrive in the UNet's native
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

}  // namespace emcid
