// Flash attention, backward: dK and dV.
//
// Replaces the Pallas TPU kernel deepfake_detection_tpu/ops/flash_attention.py
// ::_bwd_dkv_kernel (launched by _bwd_dkv): dV = sum_q P^T dO and
// dK = sum_q dS^T q with P = exp((q scale) k^T - lse) (0 where masked),
// dS = P (dO V^T - delta) scale, delta = rowsum(dO o) computed outside.  The
// same masks, offsets and tile skipping as the forward; dK and dV are
// written in float32 and the caller casts them to the input's type.
//
// What bounds it on an H100: operations, 8 BH L^2 D flops (S, dP, P^T dO,
// dS^T q) against 0.97 ms at the TimeSformer's spatial shape in f32.  One
// block per (bh, 64 keys), looping over query tiles (the TPU's sequential
// q-tile grid axis): k and v stay in transposed tiles for the block's
// life; each query tile of q and dO is staged once in two layouts
// (permuted transposed for the transposed scores S^T and dP^T, rows for the
// two products) and reused by the block's 64 keys.  P^T and then dS^T pass
// through one shared score tile.  Each block owns its rows of dK and dV, so
// there are no atomics and two calls give bitwise-equal results.  The
// tiles take 117 KB of shared memory at D = 64, one block per SM.

#include "flash_common.cuh"

namespace flash {
namespace {

template <int DT>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * DT * kTS + 2 * kTile * DT + kTile * kTS);
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int Lq, int Lk, int D, int seq_len, int causal,
                         int q_off, int kv_off, float scale) {
  constexpr int NC = DT / 16;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // T: k
  float* Vt = Kt + DT * kTS;                    // T: v
  float* Qp = Vt + DT * kTS;                    // P: q * scale
  float* dOp = Qp + DT * kTS;                   // P: dO
  float* Qr = dOp + DT * kTS;                   // R: q
  float* dOr = Qr + kTile * DT;                 // R: dO
  float* Ss = dOr + kTile * DT;                 // [q row][key]: P, then dS

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t krow0 = (int64_t)bh * Lk + k0;
  const T* qb = q + (int64_t)bh * Lq * D;
  const T* ob = dout + (int64_t)bh * Lq * D;

  load_tile<Layout::kT, DT>(Kt, k + krow0 * D, Lk - k0, D, 1.f);
  load_tile<Layout::kT, DT>(Vt, v + krow0 * D, Lk - k0, D, 1.f);

  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[i][c] = adv[i][c] = 0.f;

  const int nq = (Lq + kTile - 1) / kTile;
  for (int it = 0; it < nq; ++it) {
    const int q0 = it * kTile;
    // later query tiles may become relevant (causal): skip, do not stop
    if (!tile_relevant(q0, k0, seq_len, causal, q_off, kv_off)) continue;
    __syncthreads();
    const T* qt = qb + (int64_t)q0 * D;
    const T* ot = ob + (int64_t)q0 * D;
    load_tile<Layout::kP, DT>(Qp, qt, Lq - q0, D, scale);
    load_tile<Layout::kP, DT>(dOp, ot, Lq - q0, D, 1.f);
    load_tile<Layout::kR, DT>(Qr, qt, Lq - q0, D, 1.f);
    load_tile<Layout::kR, DT>(dOr, ot, Lq - q0, D, 1.f);
    float q_lse[4], q_delta[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qg = q0 + tx + 16 * j;
      const bool in = qg < Lq;
      q_lse[j] = in ? lse[(int64_t)bh * Lq + qg] : 0.f;
      q_delta[j] = in ? delta[(int64_t)bh * Lq + qg] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are this thread's 4 keys, columns its 4
    // queries tx, tx+16, tx+32, tx+48
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DT; ++d) {
      const float4 a = ld4(Kt + d * kTS + 4 * ty);
      const float4 b = ld4(Qp + d * kTS + 4 * tx);
      const float4 g = ld4(Vt + d * kTS + 4 * ty);
      const float4 h = ld4(dOp + d * kTS + 4 * tx);
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
    for (int j = 0; j < 4; ++j) {
      const int qg = q0 + tx + 16 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool hide = qg >= Lq || masked(qg, k0 + 4 * ty + i, seq_len,
                                             causal, q_off, kv_off);
        s[i][j] = hide ? 0.f : expf(s[i][j] - q_lse[j]);           // P^T
        dp[i][j] = s[i][j] * (dp[i][j] - q_delta[j]) * scale;      // dS^T
      }
      st4(Ss + (tx + 16 * j) * kTS + 4 * ty, s[0][j], s[1][j], s[2][j],
          s[3][j]);
    }
    __syncthreads();
    scores_times_rows<DT>(adv, Ss, ty, dOr, tx);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st4(Ss + (tx + 16 * j) * kTS + 4 * ty, dp[0][j], dp[1][j], dp[2][j],
          dp[3][j]);
    __syncthreads();
    scores_times_rows<DT>(adk, Ss, ty, Qr, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (k0 + 4 * ty + i >= Lk) continue;
    float* krow = dk + (krow0 + 4 * ty + i) * D;
    float* vrow = dv + (krow0 + 4 * ty + i) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = NC * tx + c;
      if (d < D) {
        krow[d] = adk[i][c];
        vrow[d] = adv[i][c];
      }
    }
  }
}

template <typename T, int DT>
cudaError_t run(const Args& a) {
  const dim3 grid((a.Lk + kTile - 1) / kTile, a.BH);
  static bool configured = false;
  return launch(flash_bwd_dkv_kernel<T, DT>, configured, grid, dkv_smem<DT>(),
                a.stream,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
                a.lse, a.delta, static_cast<float*>(a.out0),
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

// q, k, v, dout: (BH, L, D) in dtype (0 = float32, 1 = bfloat16); lse and
// delta: (BH, Lq) float32; dk, dv: (BH, Lk, D) float32.  Returns the
// cudaError_t of the launch.
extern "C" int dfd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int BH,
                                 int Lq, int Lk, int D, int seq_len,
                                 int causal, int q_off, int kv_off,
                                 float scale, int dtype, void* stream) {
  const flash::Args a{q, k, v, dout, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), dk, dv,
                      BH, Lq, Lk, D, seq_len, causal != 0, q_off, kv_off,
                      scale, static_cast<cudaStream_t>(stream)};
  if (!flash::valid(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)flash::run_d<float>(a);
  if (dtype == 1) return (int)flash::run_d<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
