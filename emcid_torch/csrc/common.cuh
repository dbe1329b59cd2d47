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

}  // namespace emcid
