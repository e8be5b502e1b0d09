// Flash attention, backward: dQ.
//
// Replaces the Pallas TPU kernel deepfake_detection_tpu/ops/flash_attention.py
// ::_bwd_dq_kernel (launched by _bwd_dq): dQ = sum_k dS K with
// P = exp((q scale) k^T - lse) (0 where masked), dP = dO V^T and
// dS = P (dP - delta) scale, delta = rowsum(dO o) computed outside.  The
// same masks, offsets and tile skipping as the forward; dQ is written in
// float32 and the caller casts it to the input's type.
//
// What bounds it on an H100: operations, 6 BH L^2 D flops (S, dP and dS K): at
// the TimeSformer's spatial shape in f32 49 GFLOP, 0.73 ms at the f32 SIMT
// rate and 0.30 ms as three TF32 products at the tensor cores' 495 TFLOP/s;
// bytes are a tenth of that.  So the products run on the tensor cores at f32
// accuracy (flash_tf32.cuh: mma.sync m16n8k8 TF32, each product as three).  On
// the card the kernel is bound by instruction issue (~10 a HMMA: splits, exp,
// fragment loads), at 31% of the 3xTF32 bound.  One block of 4 warps per (bh,
// 64 query rows) loops over the key tiles; warp w owns rows [16 w, 16 w +
// 16).  q and dO are staged once for the block's life; each key tile of k and v
// is staged once, by cp.async into a two-stage ring, so the next tile arrives
// while this one is multiplied.  Per tile, in passes of kSub keys: S = q k^T
// and dP = dO v^T from ldmatrix fragments, then dS in the registers, which is
// the A fragment of dQ += dS k (no score tile in shared memory).  102 KB of
// shared memory at D = 64, two blocks per SM.  Each block owns its rows of dQ,
// so there are no atomics and two calls give bitwise-equal dQ.

#include "flash_tf32.cuh"

namespace flash {
namespace {

template <int DT>
constexpr size_t dq_smem() {
  return sizeof(float) * 6 * kTileFloats<DT>;
}

template <typename T, int DT>
__global__ void __launch_bounds__(kBlockThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int Lq, int Lk, int D,
                        int seq_len, int causal, int q_off, int kv_off,
                        float scale, int vec) {
  constexpr bool kX = kExact<T>;
  constexpr int TS = kTileFloats<DT>;
  constexpr int NS = kSub / 8, ND = DT / 8;
  float* Qs = sm90::dyn_smem();
  float* dOs = Qs + TS;
  float* Ks = dOs + TS;       // [2 stages][TS]
  float* Vs = Ks + 2 * TS;    // [2 stages][TS]

  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x % 32, m0 = 16 * (threadIdx.x / 32);
  const int g = lane / 4, t = lane % 4;
  const int64_t qrow0 = (int64_t)bh * Lq + q0, krow0 = (int64_t)bh * Lk;

  // lse (times log2 e) and delta of the thread's rows m0 + g and m0 + g + 8
  const float scale_log2 = scale * kLog2e;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + g + 8 * i;
    const bool in = q0 + r < Lq;
    row_lse[i] = in ? lse[qrow0 + r] * kLog2e : 0.f;
    row_delta[i] = in ? delta[qrow0 + r] : 0.f;
  }

  // tiles only grow less relevant with the key tile: the relevant ones
  // are a prefix
  const int nkt = (Lk + kTile - 1) / kTile;
  int nk = 0;
  while (nk < nkt &&
         tile_relevant(q0, nk * kTile, seq_len, causal, q_off, kv_off))
    ++nk;
  auto stage_kv = [&](int jt, int s) {
    const int k0 = jt * kTile;
    stage_tile<DT>(Ks + s * TS, k + (krow0 + k0) * D, Lk - k0, D, vec);
    stage_tile<DT>(Vs + s * TS, v + (krow0 + k0) * D, Lk - k0, D, vec);
  };

  float acc[ND][4] = {};
  if (nk > 0) {
    stage_tile<DT>(Qs, q + qrow0 * D, Lq - q0, D, vec);
    stage_tile<DT>(dOs, dout + qrow0 * D, Lq - q0, D, vec);
    stage_kv(0, 0);
  }
  sm90::cp_async_commit();
  for (int jt = 0; jt < nk; ++jt) {
    const int s = jt & 1;
    if (jt + 1 < nk) stage_kv(jt + 1, s ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();

    const int k0 = jt * kTile;
    const float* Kt = Ks + s * TS;
    const float* Vt = Vs + s * TS;
    const bool visible =
        tile_visible(q0, k0, Lq, seq_len, causal, q_off, kv_off);
#pragma unroll 1
    for (int h = 0; h < kTile; h += kSub) {
      // scores: rows are the warp's 16 queries, columns keys
      // [h, h + kSub) of the tile
      float sc[NS][4], dp[NS][4];
      tile_scores<DT, kX, NS>(sc, Qs, m0, Kt, h, lane);
      tile_scores<DT, kX, NS>(dp, dOs, m0, Vt, h, lane);
      auto grads = [&](auto mask) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qg = q0 + m0 + g + 8 * (e >> 1);
            const int key = k0 + h + 8 * j + 2 * t + (e & 1);
            const bool hide =
                decltype(mask)::value &&
                (qg >= Lq || masked(qg, key, seq_len, causal, q_off, kv_off));
            const float p =
                hide ? 0.f
                     : sm90::ex2(sc[j][e] * scale_log2 - row_lse[e >> 1]);
            sc[j][e] = p * (dp[j][e] - row_delta[e >> 1]) * scale;  // dS
          }
      };
      if (visible)
        grads(std::false_type());
      else
        grads(std::true_type());
      // dS is the A fragment of dQ += dS k
      scores_times_tile<DT, kX, ND>(acc, sc, Kt, h, lane);
    }
    __syncthreads();  // this stage's readers are done before it refills
  }

  store_c<ND>(dq + qrow0 * D, acc, m0, Lq - q0, D, lane);
}

// One flag per instantiation: its shared-memory limit is raised.
template <typename T, int DT>
bool& configured() {
  static bool flag = false;
  return flag;
}

template <typename T, int DT>
cudaError_t run(const Args& a) {
  const dim3 grid((a.Lq + kTile - 1) / kTile, a.BH);
  return launch(flash_bwd_dq_kernel<T, DT>, configured<T, DT>(), grid,
                kBlockThreads, dq_smem<DT>(), a.stream,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
                a.lse, a.delta, static_cast<float*>(a.out0), a.Lq, a.Lk, a.D,
                a.seq_len, a.causal, a.q_off, a.kv_off, a.scale,
                (int)copies16<T>(a));
}

template <typename T, int DT>
cudaError_t info(int* out) {
  return kernel_info(flash_bwd_dq_kernel<T, DT>, configured<T, DT>(),
                     kBlockThreads, dq_smem<DT>(), out);
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

template <typename T>
cudaError_t info_d(int D, int* out) {
  switch (head_tile(D)) {
    case 32: return info<T, 32>(out);
    case 64: return info<T, 64>(out);
    case 128: return info<T, 128>(out);
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

// The kernel's registers, local bytes, dynamic shared bytes and resident
// blocks per SM for head dim D and dtype, into out[0..4).
extern "C" int dfd_flash_bwd_dq_info(int D, int dtype, int* out) {
  if (dtype == 0) return (int)flash::info_d<float>(D, out);
  if (dtype == 1) return (int)flash::info_d<__nv_bfloat16>(D, out);
  return (int)cudaErrorInvalidValue;
}
