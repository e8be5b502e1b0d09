// Flash attention, forward: O and the per-row log-sum-exp.
//
// Replaces the Pallas TPU kernel deepfake_detection_tpu/ops/flash_attention.py
// ::_fwd_kernel (launched by _fwd): blocked online-softmax attention over
// (BH, L, D) with a key-padding mask (seq_len) and a causal mask from the
// global offsets q_off / kv_off, skipping tiles with no visible key, with
// the same guards (m_safe for rows that have seen no key, corr = 0 from
// -inf, l >= 1e-30, lse = m_safe + log l), so a row that the mask hides
// completely gives o = 0 and lse = log(1e-30), as on the TPU.  The scale
// multiplies q in f32 before QK^T; bf16 inputs are widened to f32 at the
// load; O is written in the input's type, lse as (BH, Lq) float32 (the TPU
// copy across 128 lanes is not kept).
//
// What bounds it on an H100: operations.  4 BH L^2 D flops against
// 4 BH L D values moved: at the TimeSformer's spatial attention (BH 384,
// L 576, D 64, f32) 32.6 GFLOP, 0.49 ms at 67 TFLOP/s, against 0.07 ms of
// bytes.  With no tensor cores in f32, the design keeps the FMA units fed
// from shared memory: one block per (bh, 64 query rows); q (scaled) stays
// in a transposed tile, each 64-key tile of K (permuted transposed) and V
// (rows) is staged once and reused by all 64 rows; a thread computes a
// 4 x 4 block of scores with two float4 loads per 16 FMAs, keeps its rows'
// running max, sum and 4 x D/16 accumulators in registers, and the P tile
// goes through shared memory into P V.  The loop over key tiles inside the
// block takes the place of the TPU's sequential key-tile grid axis.  No
// tensor cores (f32), no TMA, no warp specialisation: later work.

#include "flash_common.cuh"

namespace flash {
namespace {

// A block owns one (bh, 64-row tile) and runs 256 threads as a 16 x 16
// grid: ty = tid / 16 owns 4 consecutive rows of its 64-row tile, tx =
// tid % 16 owns 4 columns of a 64-column score tile (columns tx, tx+16,
// tx+32, tx+48) and D/16 consecutive columns of a (64, D) product.  The 16
// threads of one ty are one half-warp, so a row's max and sum are 4
// shuffles.
//
// Shared-memory tiles, all float32 (bf16 is widened at the load, as the TPU
// kernel casts every tile to f32):
//   T  "transposed"  [DT][68]: tile[d][r] = x[r][d]; a thread reads its 4
//                    rows as one float4 (a broadcast within the half-warp);
//   P  "permuted"    [DT][68]: tile[d][(r % 16) * 4 + r / 16] = x[r][d];
//                    thread tx reads rows tx, tx+16, tx+32, tx+48 as one
//                    float4 at [d][4 tx];
//   R  "rows"        [64][DT]: tile[r][d] = x[r][d], read as float4 along d.
// The row stride 68 = 64 + 4 keeps float4 alignment and spreads the
// transposed stores over the banks.  Rows past the end of the buffer and
// columns past D read as 0.
constexpr int kThreads = 256;
constexpr int kTS = kTile + 4;  // row stride of the T and P tiles

enum class Layout { kT, kP, kR };

// Loads rows [0, min(rows, 64)) of the (rows, D) matrix at src into dst in
// the given layout, each value times mul (the scale of q), zero-filled.
template <Layout L, int DT, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int rows, int D, float mul) {
  for (int i = threadIdx.x; i < kTile * DT; i += kThreads) {
    const int r = i / DT, d = i % DT;
    float v = 0.f;
    if (r < rows && d < D) v = to_f32(src[(int64_t)r * D + d]) * mul;
    if (L == Layout::kT) dst[d * kTS + r] = v;
    if (L == Layout::kP) dst[d * kTS + (r % 16) * 4 + r / 16] = v;
    if (L == Layout::kR) dst[r * DT + d] = v;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Loads NC consecutive floats of a row (NC = DT / 16: 2, 4 or 8).
template <int NC>
__device__ __forceinline__ void ld_row(const float* p, float (&out)[NC]) {
  if constexpr (NC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < NC; c += 4) {
      const float4 v = ld4(p + c);
      out[c] = v.x; out[c + 1] = v.y; out[c + 2] = v.z; out[c + 3] = v.w;
    }
  }
}

// acc[a][b] += sum_d A[d][a-th of 4] * B[d][b-th of 4] over d < DT, with A
// and B two T/P tiles read at the thread's float4 offsets.
template <int DT>
__device__ __forceinline__ void outer_4x4(float (&acc)[4][4], const float* A,
                                          int a_off, const float* B,
                                          int b_off) {
#pragma unroll 8
  for (int d = 0; d < DT; ++d) {
    const float4 a = ld4(A + d * kTS + a_off);
    const float4 b = ld4(B + d * kTS + b_off);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][c] += sum_j S[j][4 ty + i] * R[j][NC tx + c] over the 64 rows j:
// S a [64][68] score tile stored row-of-R-major, R a [64][DT] rows tile.
template <int DT>
__device__ __forceinline__ void scores_times_rows(float (&acc)[4][DT / 16],
                                                  const float* S, int ty,
                                                  const float* R, int tx) {
  constexpr int NC = DT / 16;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    const float4 s = ld4(S + j * kTS + 4 * ty);
    const float sv[4] = {s.x, s.y, s.z, s.w};
    float r[NC];
    ld_row<NC>(R + j * DT + NC * tx, r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(sv[i], r[c], acc[i][c]);
  }
}

// Max and sum over the 16 threads of a half-warp (one row group).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DT>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * DT * kTS + kTile * DT + kTile * kTS);
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Lq, int Lk, int D,
                     int seq_len, int causal, int q_off, int kv_off,
                     float scale) {
  constexpr int NC = DT / 16;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // T: q * scale
  float* Kp = Qt + DT * kTS;                    // P: k
  float* Vr = Kp + DT * kTS;                    // R: v
  float* Ps = Vr + kTile * DT;                  // [key][q row]: P

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = q + ((int64_t)bh * Lq + q0) * D;
  const T* kb = k + (int64_t)bh * Lk * D;
  const T* vb = v + (int64_t)bh * Lk * D;

  load_tile<Layout::kT, DT>(Qt, qb, Lq - q0, D, scale);

  float acc[4][NC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int nk = (Lk + kTile - 1) / kTile;
  for (int jt = 0; jt < nk; ++jt) {
    const int k0 = jt * kTile;
    // tiles only grow less relevant with jt: stop at the first skipped one
    if (!tile_relevant(q0, k0, seq_len, causal, q_off, kv_off)) break;
    __syncthreads();  // the previous tile's readers are done
    load_tile<Layout::kP, DT>(Kp, kb + (int64_t)k0 * D, Lk - k0, D, 1.f);
    load_tile<Layout::kR, DT>(Vr, vb + (int64_t)k0 * D, Lk - k0, D, 1.f);
    __syncthreads();

    float s[4][4] = {};
    outer_4x4<DT>(s, Qt, 4 * ty, Kp, 4 * tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qg = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (masked(qg, k0 + tx + 16 * j, seq_len, causal, q_off, kv_off))
          s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_safe);  // exp(-inf) = 0 where masked
        rs += s[i][j];
      }
      rs = half_warp_sum(rs);
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st4(Ps + (tx + 16 * j) * kTS + 4 * ty, s[0][j], s[1][j], s[2][j],
          s[3][j]);
    __syncthreads();
    scores_times_rows<DT>(acc, Ps, ty, Vr, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qg = q0 + 4 * ty + i;
    if (qg >= Lq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + ((int64_t)bh * Lq + qg) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = NC * tx + c;
      if (d < D) store_as(orow + d, acc[i][c] / lc);
    }
    if (tx == 0)
      lse[(int64_t)bh * Lq + qg] =
          (m[i] == -INFINITY ? 0.f : m[i]) + logf(lc);
  }
}

template <typename T, int DT>
cudaError_t run(const Args& a) {
  const dim3 grid((a.Lq + kTile - 1) / kTile, a.BH);
  static bool configured = false;
  return launch(flash_fwd_kernel<T, DT>, configured, grid, kThreads,
                fwd_smem<DT>(), a.stream,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), static_cast<T*>(a.out0),
                static_cast<float*>(a.out1), a.Lq, a.Lk, a.D, a.seq_len,
                a.causal, a.q_off, a.kv_off, a.scale);
}

template <typename T>
cudaError_t run_d(const Args& a) {
  switch (head_tile(a.D)) {
    case 32: return run<T, 32>(a);
    case 64: return run<T, 64>(a);
    case 128: return run<T, 128>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace flash

// q, k, v: (BH, Lq|Lk|Lk, D) in dtype (0 = float32, 1 = bfloat16), D <= 128;
// o: (BH, Lq, D) in dtype; lse: (BH, Lq) float32.  Keys at or past seq_len
// (<= Lk) are padding.  Returns the cudaError_t of the launch; the caller
// raises on anything but 0.
extern "C" int dfd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int BH, int Lq, int Lk, int D,
                             int seq_len, int causal, int q_off, int kv_off,
                             float scale, int dtype, void* stream) {
  const flash::Args a{q, k, v, nullptr, nullptr, nullptr, o, lse,
                      BH, Lq, Lk, D, seq_len, causal != 0, q_off, kv_off,
                      scale, static_cast<cudaStream_t>(stream)};
  if (!flash::valid(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)flash::run_d<float>(a);
  if (dtype == 1) return (int)flash::run_d<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
