// Flash attention, backward: dK and dV.
//
// Replaces the Pallas TPU kernel deepfake_detection_tpu/ops/flash_attention.py
// ::_bwd_dkv_kernel (launched by _bwd_dkv): dV = sum_q P^T dO and
// dK = sum_q dS^T q with P = exp((q scale) k^T - lse) (0 where masked),
// dS = P (dO V^T - delta) scale, delta = rowsum(dO o) computed outside.  The
// same masks, offsets and tile skipping as the forward; dK and dV are
// written in float32 and the caller casts them to the input's type.
//
// What bounds it on an H100: operations, 8 BH L^2 D flops (S, dP, P^T dO, dS^T
// q): at the TimeSformer's spatial shape in f32 65 GFLOP, 0.97 ms at the f32
// SIMT rate and 0.40 ms as three TF32 products at the tensor cores' 495
// TFLOP/s.  So the products run on the tensor cores at f32 accuracy
// (flash_tf32.cuh: mma.sync m16n8k8 TF32, each product as three).  On the card
// the kernel is bound by instruction issue (~10 a HMMA: splits, exp, fragment
// loads), at 34% of the 3xTF32 bound.  One block of 4 warps per (bh, 64 keys)
// loops over the query tiles (the TPU's sequential q-tile grid axis); warp w
// owns keys [16 w, 16 w + 16).  k and v are staged once for the block's life;
// each relevant query tile of q, dO, lse and delta is staged once, by cp.async
// into a two-stage ring, so the next tile arrives while this one is
// multiplied.  Per tile, in passes of kSub queries: S^T = k q^T and dP^T = v
// dO^T from ldmatrix fragments, then P^T and dS^T in the registers, which are
// the A fragments of dV += P^T dO and dK += dS^T q (no score tile in shared
// memory).  103 KB of shared memory at D = 64, two blocks per SM.  Each block
// owns its rows of dK and dV, so there are no atomics and two calls give
// bitwise-equal results.

#include "flash_tf32.cuh"

namespace flash {
namespace {

template <int DT>
constexpr size_t dkv_smem() {
  return sizeof(float) * (6 * kTileFloats<DT> + 4 * kTile);
}

template <typename T, int DT>
__global__ void __launch_bounds__(kBlockThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int Lq, int Lk, int D, int seq_len, int causal,
                         int q_off, int kv_off, float scale, int vec) {
  constexpr bool kX = kExact<T>;
  constexpr int TS = kTileFloats<DT>;
  constexpr int NS = kSub / 8, ND = DT / 8;
  static_assert(kBlockThreads == 2 * kTile, "one lse or delta a thread");
  float* Ks = sm90::dyn_smem();
  float* Vs = Ks + TS;
  float* Qs = Vs + TS;        // [2 stages][TS]
  float* dOs = Qs + 2 * TS;   // [2 stages][TS]
  float* Rs = dOs + 2 * TS;   // [2 stages][lse 64, delta 64]

  const int bh = blockIdx.y, k0 = blockIdx.x * kTile;
  const int lane = threadIdx.x % 32, m0 = 16 * (threadIdx.x / 32);
  const int g = lane / 4, t = lane % 4;
  const int64_t krow0 = (int64_t)bh * Lk + k0, qrow0 = (int64_t)bh * Lq;
  const int nq = (Lq + kTile - 1) / kTile;
  const float scale_log2 = scale * kLog2e;

  // later query tiles may become relevant (causal): skip, do not stop
  auto relevant_from = [&](int it) {
    while (it < nq &&
           !tile_relevant(it * kTile, k0, seq_len, causal, q_off, kv_off))
      ++it;
    return it;
  };
  auto stage_q = [&](int it, int s) {
    const int q0 = it * kTile, i = threadIdx.x % kTile;
    const int64_t row0 = qrow0 + q0;
    stage_tile<DT>(Qs + s * TS, q + row0 * D, Lq - q0, D, vec);
    stage_tile<DT>(dOs + s * TS, dout + row0 * D, Lq - q0, D, vec);
    const float* src = (threadIdx.x < kTile ? lse : delta) + row0;
    sm90::cp_async4(Rs + s * 2 * kTile + threadIdx.x,
                    q0 + i < Lq ? src + i : src, q0 + i < Lq ? 4 : 0);
  };

  float adk[ND][4] = {}, adv[ND][4] = {};
  int it = relevant_from(0);
  if (it < nq) {
    stage_tile<DT>(Ks, k + krow0 * D, Lk - k0, D, vec);
    stage_tile<DT>(Vs, v + krow0 * D, Lk - k0, D, vec);
    stage_q(it, 0);
  }
  sm90::cp_async_commit();
  for (int s = 0; it < nq; s ^= 1) {
    const int next = relevant_from(it + 1);
    if (next < nq) stage_q(next, s ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();

    const int q0 = it * kTile;
    const float* Qt = Qs + s * TS;
    const float* Ot = dOs + s * TS;
    const float* Rt = Rs + s * 2 * kTile;
    const bool visible =
        tile_visible(q0, k0, Lq, seq_len, causal, q_off, kv_off);
#pragma unroll 1
    for (int h = 0; h < kTile; h += kSub) {
      // transposed scores: rows are the warp's 16 keys, columns queries
      // [h, h + kSub) of the tile
      float st[NS][4], dpt[NS][4];
      tile_scores<DT, kX, NS>(st, Ks, m0, Qt, h, lane);
      tile_scores<DT, kX, NS>(dpt, Vs, m0, Ot, h, lane);
      auto grads = [&](auto mask) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + m0 + g + 8 * (e >> 1);
            const int qi = h + 8 * j + 2 * t + (e & 1), qg = q0 + qi;
            const bool hide =
                decltype(mask)::value &&
                (qg >= Lq || masked(qg, key, seq_len, causal, q_off, kv_off));
            const float p =
                hide ? 0.f
                     : sm90::ex2(st[j][e] * scale_log2 - Rt[qi] * kLog2e);
            dpt[j][e] = p * (dpt[j][e] - Rt[kTile + qi]) * scale;  // dS^T
            st[j][e] = p;                                          // P^T
          }
      };
      if (visible)
        grads(std::false_type());
      else
        grads(std::true_type());
      // the scores are the A fragments of dV += P^T dO and dK += dS^T q
      scores_times_tile<DT, kX, ND>(adv, st, Ot, h, lane);
      scores_times_tile<DT, kX, ND>(adk, dpt, Qt, h, lane);
    }
    __syncthreads();  // this stage's readers are done before it refills
    it = next;
  }

  store_c<ND>(dk + krow0 * D, adk, m0, Lk - k0, D, lane);
  store_c<ND>(dv + krow0 * D, adv, m0, Lk - k0, D, lane);
}

// One flag per instantiation: its shared-memory limit is raised.
template <typename T, int DT>
bool& configured() {
  static bool flag = false;
  return flag;
}

template <typename T, int DT>
cudaError_t run(const Args& a) {
  const dim3 grid((a.Lk + kTile - 1) / kTile, a.BH);
  return launch(flash_bwd_dkv_kernel<T, DT>, configured<T, DT>(), grid,
                kBlockThreads, dkv_smem<DT>(), a.stream,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
                a.lse, a.delta, static_cast<float*>(a.out0),
                static_cast<float*>(a.out1), a.Lq, a.Lk, a.D, a.seq_len,
                a.causal, a.q_off, a.kv_off, a.scale,
                (int)copies16<T>(a));
}

template <typename T, int DT>
cudaError_t info(int* out) {
  return kernel_info(flash_bwd_dkv_kernel<T, DT>, configured<T, DT>(),
                     kBlockThreads, dkv_smem<DT>(), out);
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

// The kernel's registers, local bytes, dynamic shared bytes and resident
// blocks per SM for head dim D and dtype, into out[0..4).
extern "C" int dfd_flash_bwd_dkv_info(int D, int dtype, int* out) {
  if (dtype == 0) return (int)flash::info_d<float>(D, out);
  if (dtype == 1) return (int)flash::info_d<__nv_bfloat16>(D, out);
  return (int)cudaErrorInvalidValue;
}
