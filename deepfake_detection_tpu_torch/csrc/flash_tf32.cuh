// The flash kernels' f32-accurate tensor-core pieces (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): staged tiles, fragments, and products
// as three TF32 products.
//
// Products.  Hopper's tensor cores take f32 only as TF32 (a 10-bit
// mantissa).  Each f32 operand x is split into big = x rounded to TF32
// (to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds, but as an
// integer add and mask: the cvt costs more instructions) and
// small = x - big (exact in f32; the tensor core reads its top 19 bits,
// so it enters with an error below 2^-21 of x), and a product is taken as
//   small_a * big_b + big_a * small_b + big_a * big_b
// (small_a * small_b, below 2^-22 of the product, is dropped), each term an
// mma.sync.m16n8k8 TF32 product accumulated in f32 registers: CUTLASS's
// OpMultiplyAddFastF32, the arithmetic of PyTorch's own f32
// memory-efficient attention.  An operand widened from bf16 is exact in
// TF32, so its small part is zero and its terms are skipped (kExact).
//
// Accumulation.  The tensor core adds its products to the accumulator and
// truncates the sum toward zero, so each mma can lose up to an ulp of the
// accumulator, always toward zero; 216 of them into one dV sum (576
// queries, 3 terms each) drift by ~1e-5 of the result.  So the small terms
// of a score go to their own accumulator (the big one takes D/8 truncating
// steps, not 3 D/8), and the second products run in passes of kSub rows,
// each in a fresh accumulator (12 steps) added into the running sum with
// an f32 add, which rounds to nearest: on the card dQ, dK and dV stay
// within 3.2e-6 of their max of the plain f32 version.
//
// Tiles.  A block runs 4 warps (128 threads); warp w owns rows
// [16 w, 16 w + 16) of the block's 64 output rows.  Every input tile
// (64 rows of q, k, v or dO) is staged once, row-major as f32, with rows
// DT + 4 floats apart.  That padding keeps both reads free of bank
// conflicts (bank = 4 r + c mod 32):
//   - ldmatrix (8 rows, one 16-byte chunk each) for an operand whose
//     contracted index runs along the row (A of q k^T, dO v^T; B of the
//     same products, a [n][k] tile);
//   - the 4-byte reads of rows 2t and 2t + 1 (t = lane % 4) at column
//     n0 + lane / 4 for an operand contracted along its rows (dO and q in
//     dV = P^T dO and dK = dS^T q, k in dQ = dS k, v in O = P v);
// and leaves every fragment at a fixed offset from the thread's base.
// f32 tiles arrive by cp.async (16 bytes where D % 4 == 0 and the base is
// 16-byte aligned, else 4 bytes), zero-filled past the rows and past D;
// bf16 tiles are widened by the threads.
//
// Fragments (PTX ISA, m16n8k8 .tf32; g = lane / 4, t = lane % 4):
//   A a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B b0 (k t, n g)  b1 (k t+4, n g)
//   C c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// A C fragment of the scores is used again as the A fragment of the
// second product without leaving the registers: the contraction may visit
// k in any order, so k-block kk is taken in the order 0 2 4 6 1 3 5 7, in
// which {c0, c2, c1, c3} of n-tile kk is exactly (a0, a1, a2, a3), and the
// B fragment reads rows 2t and 2t + 1 of the k-block.

#pragma once

#include <type_traits>

#include "flash_common.cuh"
#include "sm90.cuh"

// What else the flash kernels take from the card, as PTX.
namespace sm90 {

__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ float4 smem4[];
  return reinterpret_cast<float*>(smem4);
}

// Four 8 x 4 f32 matrices (8 rows of 16 bytes each, row addresses from
// lanes 8i..8i+7): lane l gets word l % 4 of row l / 4 of matrix i in r[i].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 2^x by ex2.approx: relative error below 2^-22, results below 2^-126
// flushed to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c += a b, m16n8k8, TF32 in, f32 accumulation.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace sm90

namespace flash {

constexpr int kBlockThreads = 128;  // 4 warps of 16 rows
constexpr int kSub = 32;            // rows of the second product a pass

template <typename T>
constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;

constexpr float kLog2e = 1.4426950408889634f;

// Whether every (query, key) pair of the tile at (q0, k0) is visible, so
// that no element needs the mask.
__device__ __forceinline__ bool tile_visible(int q0, int k0, int Lq,
                                             int seq_len, bool causal,
                                             int q_off, int kv_off) {
  return q0 + kTile <= Lq && k0 + kTile <= seq_len &&
         !(causal && kv_off + k0 + kTile - 1 > q_off + q0);
}

// Whether the f32 tiles may arrive as 16-byte copies: rows of D % 4 == 0
// floats from 16-byte aligned bases (else 4-byte copies; bf16 is widened).
template <typename T>
inline bool copies16(const Args& a) {
  return std::is_same<T, float>::value && a.D % 4 == 0 &&
         ((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
          (uintptr_t)a.dout) % 16 == 0;
}

// Row stride and size, in floats, of a staged [64][DT] tile.
template <int DT>
constexpr int kStride = DT + 4;
template <int DT>
constexpr int kTileFloats = kTile * kStride<DT>;

// Index of element (r, c) in a staged tile.
template <int DT>
__device__ __forceinline__ int at(int r, int c) {
  return r * kStride<DT> + c;
}

// Stages rows [0, min(rows, 64)) of the (rows, D) row-major matrix at src
// into the tile dst, zero-filled; vec: 16-byte copies are allowed.
template <int DT>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int rows, int D, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < kTile * DT / 4; i += kBlockThreads) {
      const int r = i / (DT / 4), c = i % (DT / 4) * 4;
      const bool in = r < rows && c < D;
      sm90::cp_async16(dst + at<DT>(r, c),
                       in ? src + (int64_t)r * D + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * DT; i += kBlockThreads) {
      const int r = i / DT, c = i % DT;
      const bool in = r < rows && c < D;
      sm90::cp_async4(dst + at<DT>(r, c),
                      in ? src + (int64_t)r * D + c : src, in ? 4 : 0);
    }
  }
}

template <int DT>
__device__ __forceinline__ void stage_tile(float* dst,
                                           const __nv_bfloat16* src, int rows,
                                           int D, bool) {
  for (int i = threadIdx.x; i < kTile * DT; i += kBlockThreads) {
    const int r = i / DT, c = i % DT;
    dst[at<DT>(r, c)] =
        r < rows && c < D ? to_f32(src[(int64_t)r * D + c]) : 0.f;
  }
}

// An operand fragment as its TF32 parts.
template <int N>
struct Frag {
  uint32_t big[N], small[N];
};

template <bool kX, int N>
__device__ __forceinline__ void split(Frag<N>& f, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (kX) {
      f.big[i] = __float_as_uint(x[i]);
    } else {
      f.big[i] = (__float_as_uint(x[i]) + 0x1000u) & 0xFFFFE000u;
      f.small[i] = __float_as_uint(x[i] - __uint_as_float(f.big[i]));
    }
  }
}

template <bool kX, int N>
__device__ __forceinline__ void split_bits(Frag<N>& f,
                                           const uint32_t (&bits)[N]) {
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = __uint_as_float(bits[i]);
  split<kX>(f, x);
}

// A fragment of rows [m0, m0 + 16), columns [8 kk, 8 kk + 8) of a tile.
template <int DT, bool kX>
__device__ __forceinline__ void ld_a(Frag<4>& a, const float* tile, int m0,
                                     int kk, int lane) {
  uint32_t r[4];
  sm90::ldsm_x4(r, tile + at<DT>(m0 + (lane & 7) + (lane >> 3 & 1) * 8,
                                  8 * kk + (lane >> 4) * 4));
  split_bits<kX>(a, r);
}

// B fragments of the N n-tiles [n0 + 8 j, n0 + 8 j + 8) at columns
// [8 kk, 8 kk + 8) of a [n][k] tile (N even).
template <int DT, bool kX, int N>
__device__ __forceinline__ void ld_b(Frag<2> (&b)[N], const float* tile,
                                     int n0, int kk, int lane) {
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    uint32_t r[4];
    sm90::ldsm_x4(r, tile + at<DT>(n0 + 8 * j + (lane & 7) + (lane >> 4) * 8,
                                    8 * kk + (lane >> 3 & 1) * 4));
    split_bits<kX>(b[j], {r[0], r[1]});
    split_bits<kX>(b[j + 1], {r[2], r[3]});
  }
}

// B fragments of the N n-tiles at columns n0 + 8 j of a [k][n] tile, for
// the k-block of rows [k0, k0 + 8) in the register A fragment's order:
// rows k0 + 2t and k0 + 2t + 1.
template <int DT, bool kX, int N>
__device__ __forceinline__ void ld_bt(Frag<2> (&b)[N], const float* tile,
                                      int k0, int n0, int lane) {
  const int r = k0 + 2 * (lane & 3), c = n0 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < N; ++j)
    split<kX>(b[j], {tile[at<DT>(r, c + 8 * j)],
                     tile[at<DT>(r + 1, c + 8 * j)]});
}

// The A fragment held by a C fragment c of the scores (see the top).
__device__ __forceinline__ void a_of_c(Frag<4>& a, const float (&c)[4]) {
  split<false>(a, {c[0], c[2], c[1], c[3]});
}

// acc[j] += A B[j] for the N n-tiles, as three TF32 products (two where
// one operand is exact, one where both are), the small terms into
// acc_small (which may be acc), term by term over the n-tiles so that the
// N accumulations run side by side.
template <bool kXA, bool kXB, int N>
__device__ __forceinline__ void mma3(float (*acc)[4], float (*acc_small)[4],
                                     const Frag<4>& a,
                                     const Frag<2> (&b)[N]) {
  if constexpr (!kXA) {
#pragma unroll
    for (int j = 0; j < N; ++j) sm90::mma(acc_small[j], a.small, b[j].big);
  }
  if constexpr (!kXB) {
#pragma unroll
    for (int j = 0; j < N; ++j) sm90::mma(acc_small[j], a.big, b[j].small);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) sm90::mma(acc[j], a.big, b[j].big);
}

// s[j] = A B^T for rows [m0, m0 + 16) of tile A and rows [n0 + 8 j,
// n0 + 8 j + 8) of tile B over their DT columns: the scores of NS n-tiles,
// the small terms summed apart and added at the end.
template <int DT, bool kX, int NS>
__device__ __forceinline__ void tile_scores(float (&s)[NS][4], const float* A,
                                            int m0, const float* B, int n0,
                                            int lane) {
  float small[NS][4] = {};
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DT / 8; ++kk) {
    Frag<4> a;
    Frag<2> b[NS];
    ld_a<DT, kX>(a, A, m0, kk, lane);
    ld_b<DT, kX, NS>(b, B, n0, kk, lane);
    mma3<kX, kX, NS>(s, small, a, b);
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += small[j][e];
}

// acc += C T for one pass: C the register scores c[kk] (kSub columns as
// A fragments), T rows [k0, k0 + kSub) of a [k][n] tile; in a fresh
// accumulator per group of 8 n-tiles, added to acc in f32.
template <int DT, bool kXB, int ND>
__device__ __forceinline__ void scores_times_tile(
    float (&acc)[ND][4], const float (&c)[kSub / 8][4], const float* tile,
    int k0, int lane) {
  constexpr int NB = ND < 8 ? ND : 8;
#pragma unroll
  for (int jb = 0; jb < ND; jb += NB) {
    float part[NB][4] = {};
#pragma unroll
    for (int kk = 0; kk < kSub / 8; ++kk) {
      Frag<4> a;
      Frag<2> b[NB];
      a_of_c(a, c[kk]);
      ld_bt<DT, kXB, NB>(b, tile, k0 + 8 * kk, 8 * jb, lane);
      mma3<false, kXB, NB>(part, part, a, b);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jb + j][e] += part[j][e];
  }
}

// Stores the C fragments acc[j] of rows [m0, m0 + 16) of a (rows, D) f32
// matrix at dst, columns 8 j + 2t and 8 j + 2t + 1, inside rows and D.
template <int ND>
__device__ __forceinline__ void store_c(float* dst, const float (&acc)[ND][4],
                                        int m0, int rows, int D, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      if (r < rows && c < D) dst[(int64_t)r * D + c] = acc[j][e];
    }
}

}  // namespace flash
