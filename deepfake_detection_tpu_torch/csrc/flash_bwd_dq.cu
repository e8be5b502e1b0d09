// Flash attention, backward: dQ.
//
// Replaces the Pallas TPU kernel deepfake_detection_tpu/ops/flash_attention.py
// ::_bwd_dq_kernel (launched by _bwd_dq): dQ = sum_k dS K with
// P = exp((q scale) k^T - lse) (0 where masked), dP = dO V^T and
// dS = P (dP - delta) scale, delta = rowsum(dO o) computed outside.  The
// same masks, offsets and tile skipping as the forward; dQ is written in
// float32 and the caller casts it to the input's type.
//
// What bounds it on an H100: operations, 6 BH L^2 D flops (S, dP and dS K)
// against 0.73 ms at the TimeSformer's spatial shape in f32; bytes are a
// tenth of that.  One block per (bh, 64 query rows), looping over key
// tiles: q (scaled) and dO stay in transposed tiles; each key tile of K and
// V is staged once (K twice: permuted transposed for the scores, rows for
// dS K) and reused by the block's 64 rows.  S and dP share one pass over d
// (four float4 loads per 32 FMAs).  Each block owns its rows of dQ, so
// there are no atomics and two calls give bitwise-equal dQ.

#include "flash_common.cuh"

namespace flash {
namespace {

template <int DT>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * DT * kTS + kTile * DT + kTile * kTS);
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int Lq, int Lk, int D,
                        int seq_len, int causal, int q_off, int kv_off,
                        float scale) {
  constexpr int NC = DT / 16;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // T: q * scale
  float* dOt = Qt + DT * kTS;                   // T: dO
  float* Kp = dOt + DT * kTS;                   // P: k
  float* Vp = Kp + DT * kTS;                    // P: v
  float* Kr = Vp + DT * kTS;                    // R: k
  float* dSs = Kr + kTile * DT;                 // [key][q row]: dS

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t qrow0 = (int64_t)bh * Lq + q0;
  const T* kb = k + (int64_t)bh * Lk * D;
  const T* vb = v + (int64_t)bh * Lk * D;

  load_tile<Layout::kT, DT>(Qt, q + qrow0 * D, Lq - q0, D, scale);
  load_tile<Layout::kT, DT>(dOt, dout + qrow0 * D, Lq - q0, D, 1.f);

  float row_lse[4], row_delta[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool in = q0 + 4 * ty + i < Lq;
    row_lse[i] = in ? lse[qrow0 + 4 * ty + i] : 0.f;
    row_delta[i] = in ? delta[qrow0 + 4 * ty + i] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int nk = (Lk + kTile - 1) / kTile;
  for (int jt = 0; jt < nk; ++jt) {
    const int k0 = jt * kTile;
    if (!tile_relevant(q0, k0, seq_len, causal, q_off, kv_off)) break;
    __syncthreads();
    load_tile<Layout::kP, DT>(Kp, kb + (int64_t)k0 * D, Lk - k0, D, 1.f);
    load_tile<Layout::kP, DT>(Vp, vb + (int64_t)k0 * D, Lk - k0, D, 1.f);
    load_tile<Layout::kR, DT>(Kr, kb + (int64_t)k0 * D, Lk - k0, D, 1.f);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DT; ++d) {
      const float4 a = ld4(Qt + d * kTS + 4 * ty);
      const float4 b = ld4(Kp + d * kTS + 4 * tx);
      const float4 g = ld4(dOt + d * kTS + 4 * ty);
      const float4 h = ld4(Vp + d * kTS + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
      const float gv[4] = {g.x, g.y, g.z, g.w}, hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i], bv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], hv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qg = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool hide = qg >= Lq || masked(qg, k0 + tx + 16 * j, seq_len,
                                             causal, q_off, kv_off);
        const float p = hide ? 0.f : expf(s[i][j] - row_lse[i]);
        s[i][j] = p * (dp[i][j] - row_delta[i]) * scale;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st4(dSs + (tx + 16 * j) * kTS + 4 * ty, s[0][j], s[1][j], s[2][j],
          s[3][j]);
    __syncthreads();
    scores_times_rows<DT>(acc, dSs, ty, Kr, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (q0 + 4 * ty + i >= Lq) continue;
    float* row = dq + (qrow0 + 4 * ty + i) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = NC * tx + c;
      if (d < D) row[d] = acc[i][c];
    }
  }
}

template <typename T, int DT>
cudaError_t run(const Args& a) {
  const dim3 grid((a.Lq + kTile - 1) / kTile, a.BH);
  static bool configured = false;
  return launch(flash_bwd_dq_kernel<T, DT>, configured, grid, dq_smem<DT>(),
                a.stream,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
                a.lse, a.delta, static_cast<float*>(a.out0), a.Lq, a.Lk, a.D,
                a.seq_len, a.causal, a.q_off, a.kv_off, a.scale);
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

// q, k, v, dout: (BH, L, D) in dtype (0 = float32, 1 = bfloat16); lse and
// delta: (BH, Lq) float32; dq: (BH, Lq, D) float32.  Returns the
// cudaError_t of the launch.
extern "C" int dfd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int BH, int Lq,
                                int Lk, int D, int seq_len, int causal,
                                int q_off, int kv_off, float scale, int dtype,
                                void* stream) {
  const flash::Args a{q, k, v, dout, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), dq, nullptr,
                      BH, Lq, Lk, D, seq_len, causal != 0, q_off, kv_off,
                      scale, static_cast<cudaStream_t>(stream)};
  if (!flash::valid(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)flash::run_d<float>(a);
  if (dtype == 1) return (int)flash::run_d<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
