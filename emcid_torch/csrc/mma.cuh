// Register-fragment building blocks of the tensor-core attention kernels
// (K1's mma and d512 routes and K2/K3's mma routes in flash_v2.cu, K4's mma
// route in short_kv.cu).
//
// Products are mma.sync.m16n8k16 (bf16 in, f32 accumulators), written in
// inline PTX, with operands brought from shared memory by ldmatrix.  The
// fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// lane = 4 * g + t (g = lane / 4, t = lane % 4):
//
//   A (16 x 16, row-major), 4 regs of bf16x2: a0 = (g, 2t..2t+1),
//     a1 = (g + 8, 2t..), a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..);
//   B (16 x 8, "col"), 2 regs: b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g);
//   C (16 x 8, f32), 4 regs: c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..).
//
// So two adjacent C tiles (columns 0-7 and 8-15) are, rounded to bf16, the
// A fragment of one k16 step: the probabilities P never leave registers
// between S = Q.K^T and O += P.V.  A row's values sit in the four lanes of
// a quad (same g), so row reductions are two xor-shuffles (offsets 1, 2).
//
// The attention step below keeps a warp's query rows (MT tiles of 16 rows)
// in registers: Q as A fragments, the scores S and probabilities P of one
// key tile, the running row max m (log2 units: the scores are scaled by
// scale * log2(e), so each exponential is one FFMA and one ex2), each
// thread's share of the row sum l, and the output accumulator O over ND
// n8 tiles of the head dim.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace emcid {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- asynchronous copies, device to shared memory (cp.async) ----

// 16 bytes when pred holds, else 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
// 4 bytes when pred holds, else 4 zero bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Element (b, r, h, 0) of a (B, L, H, D) tensor: the first of row r of
// head (b, h).
__device__ __forceinline__ const bf16* head_row(const bf16* t, int b, int r, int h, int L, int H,
                                                int D) {
  return t + (((long long)b * L + r) * H + h) * D;
}

// Start copying R rows of a head into a tile with row stride ld, 16 bytes
// per cp.async (D % 8 == 0, 16-byte aligned): `src` is the head's first row
// (head_row), HD = H * D the row pitch, and rows at or past `left` are
// zero-filled.  The T threads of the block take fixed chunks, so a tile
// costs a few integer operations per chunk.  Columns [D, ld) are not
// written: the products never read them.
template <int R, int D, int T>
__device__ __forceinline__ void copy_rows(bf16* dst, int ld, const bf16* src, int HD, int left) {
  constexpr int kCh = D / 8, kN = R * kCh;
#pragma unroll
  for (int i = 0; i < (kN + T - 1) / T; ++i) {
    const int e = threadIdx.x + i * T;
    if (kN % T == 0 || e < kN) {
      const int r = e / kCh, c = (e - r * kCh) * 8;
      const bool ok = r < left;
      cp_async16(dst + r * ld + c, src + (ok ? r * HD + c : 0), ok);
    }
  }
}

// Start copying R consecutive floats (one 4-byte cp.async each); those at
// or past `left` are zero-filled.
template <int R, int T>
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int left) {
  for (int i = threadIdx.x; i < R; i += T) {
    const bool ok = i < left;
    cp_async4(dst + i, src + (ok ? i : 0), ok);
  }
}

// ---- fragments ----

// d += a . b, one m16n8k16 product.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b, one m16n8k8 product: the k8 step of a head dim with D % 16
// == 8.  a0/a1 are the first two registers of an m16n8k16 A fragment
// (columns 0-7), b0 one B register.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i (16-byte aligned), register i receives matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// Two matrices (lanes 0-15 give the addresses).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
// The same as ldsm_x4, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// Two matrices, transposed (lanes 0-15 give the addresses).
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// A fragment of rows [0, 16) x columns [0, 16) of a row-major bf16 tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, tile + (lane % 16) * ld + (lane / 16) * 8);
}

// A fragments of a warp's MT x 16 query rows (row stride ld) over the
// (D + 15) / 16 k16 steps of the head dim.
template <int MT, int KD>
__device__ __forceinline__ void load_q(uint32_t (&qf)[MT][KD][4], const bf16* rows, int ld) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) load_a(qf[mt][kk], rows + mt * 16 * ld + kk * 16, ld);
}

// B fragments of two n8 tiles for S = A.K^T: rows [0, 16) of K (keys, the
// n axis) x columns [0, 16) (the k axis); b0/b1 of keys 0-7 in r[0]/r[1],
// of keys 8-15 in r[2]/r[3].
__device__ __forceinline__ void load_b_rows(uint32_t (&r)[4], const bf16* tile, int ld) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(r, tile + ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8);
}

// B fragments of two n8 tiles for O = P.V: rows [0, 16) of V (keys, the k
// axis) x columns [0, 16) (the n axis); columns 0-7 in r[0]/r[1], 8-15 in
// r[2]/r[3].
__device__ __forceinline__ void load_b_cols(uint32_t (&r)[4], const bf16* tile, int ld) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_t(r, tile + (lane % 16) * ld + (lane / 16) * 8);
}
// One n8 tile of the same: columns [0, 8).
__device__ __forceinline__ void load_b_cols8(uint32_t (&r)[2], const bf16* tile, int ld) {
  const int lane = threadIdx.x % 32;
  ldsm_x2_t(r, tile + (lane % 16) * ld);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two adjacent m16n8 f32 accumulator tiles (columns 0-7 in c0, 8-15 in c1),
// rounded to bf16, as the A fragment of one m16n8k16 product.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- the attention step of one warp ----

// Running softmax state of a warp's MT x 16 query rows; index [mt][hr]
// is row mt * 16 + g + 8 * hr of the warp's rows.
template <int MT, int ND>
struct RowState {
  float m[MT][2];      // running max of scale * log2(e) * s
  float l[MT][2];      // this thread's share of the row sum
  float o[MT][ND][4];  // output accumulator, ND n8 tiles
};

template <int MT, int ND>
__device__ __forceinline__ void row_state_init(RowState<MT, ND>& st) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      st.m[mt][hr] = kNegInf;
      st.l[mt][hr] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int r = 0; r < 4; ++r) st.o[mt][d][r] = 0.f;
  }
}

// s[mt][n] = Q.K^T for the warp's row tiles and NK keys (NK % 16 == 0):
// qf holds the warp's Q as A fragments, sK the keys' rows (stride ld).
// D / 16 full k16 steps; where D % 16 == 8 a last k8 step (on the first
// half of the last A fragment), so no product reads past column D.
template <int MT, int D, int NK>
__device__ __forceinline__ void scores(float (&s)[MT][NK / 8][4],
                                       const uint32_t (&qf)[MT][(D + 15) / 16][4], const bf16* sK,
                                       int ld) {
  constexpr int kFull = D / 16;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NK / 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[mt][n][r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kFull; ++kk) {
#pragma unroll
    for (int j = 0; j < NK / 16; ++j) {
      uint32_t b[4];
      load_b_rows(b, sK + j * 16 * ld + kk * 16, ld);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][2 * j], qf[mt][kk], b[0], b[1]);
        mma_bf16(s[mt][2 * j + 1], qf[mt][kk], b[2], b[3]);
      }
    }
  }
  if constexpr (D % 16 != 0) {
    // columns [16 kFull, D) of 32 keys per ldmatrix.x4: matrix i holds
    // keys 8i..8i+7, one n8 tile each
    const int lane = threadIdx.x % 32;
    const bf16* col = sK + kFull * 16;
#pragma unroll
    for (int j = 0; j < NK / 32; ++j) {
      uint32_t b[4];
      ldsm_x4(b, col + (j * 32 + lane) * ld);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mma_bf16_k8(s[mt][4 * j + i], qf[mt][kFull][0], qf[mt][kFull][1], b[i]);
    }
    if constexpr (NK % 32 != 0) {
      uint32_t b[2];
      ldsm_x2(b, col + ((NK / 32) * 32 + lane % 16) * ld);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_bf16_k8(s[mt][(NK / 32) * 4 + i], qf[mt][kFull][0], qf[mt][kFull][1], b[i]);
    }
  }
}

// Keys at or past `valid` (a column index within the tile) score kNegInf.
template <int MT, int NT>
__device__ __forceinline__ void mask_keys(float (&s)[MT][NT][4], int valid) {
  const int c0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (n * 8 + c0 + (r & 1) >= valid) s[mt][n][r] = kNegInf;
}

// Online softmax over one key tile: s becomes p = exp2(s * sl2 - m) with
// m the new running max (sl2 = scale * log2(e)); l and O are rescaled by
// exp2(m_old - m) unless this is the first tile.
template <int MT, int NT, int ND>
__device__ __forceinline__ void softmax_tile(RowState<MT, ND>& st, float (&s)[MT][NT][4],
                                             float sl2, bool first) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[mt][n][2 * hr], s[mt][n][2 * hr + 1]));
      mx = quad_max(mx) * sl2;
      const float m_new = first ? mx : fmaxf(st.m[mt][hr], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2_approx(fmaf(s[mt][n][2 * hr + e], sl2, -m_new));
          s[mt][n][2 * hr + e] = p;
          sum += p;
        }
      if (first) {
        st.l[mt][hr] = sum;
      } else {
        const float alpha = exp2_approx(st.m[mt][hr] - m_new);
        st.l[mt][hr] = fmaf(st.l[mt][hr], alpha, sum);
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          st.o[mt][d][2 * hr] *= alpha;
          st.o[mt][d][2 * hr + 1] *= alpha;
        }
      }
      st.m[mt][hr] = m_new;
    }
  }
}

// O += P.V: p holds the tile's probabilities (NK keys as NK / 8 n8 tiles,
// rounded to bf16 here), sV the keys' rows of V from the warp's first
// output column (stride ld); ND n8 output tiles in o.  The backward uses it
// for every product whose depth is the score axis: dQ += dS.K, dV += P^T.dO
// and dK += dS^T.Q.
template <int MT, int NK, int ND>
__device__ __forceinline__ void p_times_v(float (&o)[MT][ND][4], const float (&p)[MT][NK / 8][4],
                                          const bf16* sV, int ld) {
#pragma unroll
  for (int j = 0; j < NK / 16; ++j) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) acc_to_a(a[mt], p[mt][2 * j], p[mt][2 * j + 1]);
    const bf16* vj = sV + j * 16 * ld;
#pragma unroll
    for (int d = 0; d + 1 < ND; d += 2) {
      uint32_t b[4];
      load_b_cols(b, vj + d * 8, ld);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][d], a[mt], b[0], b[1]);
        mma_bf16(o[mt][d + 1], a[mt], b[2], b[3]);
      }
    }
    if (ND % 2) {
      uint32_t b[2];
      load_b_cols8(b, vj + (ND - 1) * 8, ld);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(o[mt][ND - 1], a[mt], b[0], b[1]);
    }
  }
}

// One key tile of NK keys through a warp's rows: S = Q.K^T, mask keys at
// or past `valid`, online softmax, O += P.V (head dim D).
template <int MT, int D, int NK>
__device__ __forceinline__ void attend_tile(RowState<MT, D / 8>& st,
                                            const uint32_t (&qf)[MT][(D + 15) / 16][4],
                                            const bf16* sK, const bf16* sV, int ld, int valid,
                                            float sl2, bool first) {
  float s[MT][NK / 8][4];
  scores<MT, D, NK>(s, qf, sK, ld);
  if (valid < NK) mask_keys<MT, NK / 8>(s, valid);
  softmax_tile<MT, NK / 8, D / 8>(st, s, sl2, first);
  p_times_v<MT, NK, D / 8>(st.o, s, sV, ld);
}

// The epilogue: sum l over the quad, O /= l.  lse[mt][hr] receives the
// row's log-sum-exp of the scaled scores, in natural-log units.
template <int MT, int ND>
__device__ __forceinline__ void finish_rows(RowState<MT, ND>& st, float (&lse)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float l = fmaxf(quad_sum(st.l[mt][hr]), 1e-30f);
      const float inv = 1.f / l;
      lse[mt][hr] = st.m[mt][hr] * kLn2 + logf(l);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        st.o[mt][d][2 * hr] *= inv;
        st.o[mt][d][2 * hr + 1] *= inv;
      }
    }
}

// Write a warp's accumulator o (MT x 16 rows, ND n8 tiles) times `mul` as
// bf16 into a tile with row stride ld (the warp's own rows of a staging
// tile).
template <int MT, int ND>
__device__ __forceinline__ void stage_rows(bf16* tile, const float (&o)[MT][ND][4], int ld,
                                           float mul = 1.f) {
  const int lane = threadIdx.x % 32, g = lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      bf16* row = tile + (mt * 16 + g + 8 * hr) * ld + c;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<uint32_t*>(row + d * 8) =
            pack_bf16(o[mt][d][2 * hr] * mul, o[mt][d][2 * hr + 1] * mul);
    }
}

// Copy R staged rows of W columns (W % 8 == 0; `tile` points at the first,
// row stride ld) to columns [c0, c0 + W) of rows [row0, row0 + R) of head
// (b, h) of a (B, L, H, D) tensor, 16 bytes per lane per step; rows at or
// past L are not written.  One warp.
__device__ __forceinline__ void store_staged(bf16* dst, const bf16* tile, int ld, int R, int W,
                                             int b, int h, int row0, int c0, int L, int H, int D) {
  const int lane = threadIdx.x % 32, chunks = W / 8;
  for (int e = lane; e < R * chunks; e += 32) {
    const int i = e / chunks, c = e - i * chunks, r = row0 + i;
    if (r < L)
      *reinterpret_cast<uint4*>(dst + (((long long)b * L + r) * H + h) * D + c0 + c * 8) =
          *reinterpret_cast<const uint4*>(tile + i * ld + c * 8);
  }
}

// ---- host side ----

inline bool aligned16(std::initializer_list<const void*> tensors) {
  for (const void* t : tensors)
    if (reinterpret_cast<uintptr_t>(t) % 16) return false;
  return true;
}

// Whether the mma routes take head dim D: 16-byte copies need D % 8 == 0
// and aligned tensors; the register budget of a warp's rows holds D <= 80.
inline bool mma_route_ok(int D, std::initializer_list<const void*> tensors) {
  return D > 32 && D <= 80 && D % 8 == 0 && aligned16(tensors);
}

}  // namespace emcid

// Calls LAUNCH<D> for the head dims the mma routes are built for.
#define EMCID_MMA_DISPATCH(D, LAUNCH, ...)       \
  switch (D) {                                   \
    case 40: return LAUNCH<40>(__VA_ARGS__);     \
    case 48: return LAUNCH<48>(__VA_ARGS__);     \
    case 56: return LAUNCH<56>(__VA_ARGS__);     \
    case 64: return LAUNCH<64>(__VA_ARGS__);     \
    case 72: return LAUNCH<72>(__VA_ARGS__);     \
    case 80: return LAUNCH<80>(__VA_ARGS__);     \
    default: return (int)cudaErrorInvalidValue;  \
  }
