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
  return launch(flash_fwd_kernel<T, DT>, configured, grid, fwd_smem<DT>(),
                a.stream,
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
