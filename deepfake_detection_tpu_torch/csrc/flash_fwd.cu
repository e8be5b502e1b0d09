// Flash attention, forward: O and the per-row log-sum-exp.
//
// Replaces the Pallas TPU kernel deepfake_detection_tpu/ops/flash_attention.py
// ::_fwd_kernel (launched by _fwd): blocked online-softmax attention over
// (BH, L, D) with a key-padding mask (seq_len) and a causal mask from the
// global offsets q_off / kv_off, skipping tiles with no visible key, with
// the same guards (m_safe for rows that have seen no key, corr = 0 from
// -inf, l >= 1e-30, lse = m_safe + log l), so a row that the mask hides
// completely gives o = 0 and lse = log(1e-30), as on the TPU.  The scale
// multiplies q in f32 before QK^T; bf16 inputs are widened to f32; O is
// written in the input's type, lse as (BH, Lq) float32 (the TPU copy across
// 128 lanes is not kept).
//
// What bounds it on an H100: operations, 4 BH L^2 D flops against 4 BH L D
// values moved: at the TimeSformer's spatial attention (BH 384, L 576, D 64,
// f32) 32.6 GFLOP, 0.49 ms at the f32 SIMT rate and 0.20 ms as three TF32
// products at the tensor cores' 495 TFLOP/s, against 0.07 ms of bytes.  So
// both products run on the tensor cores at f32 accuracy, with the backward's
// pieces (flash_tf32.cuh: mma.sync m16n8k8 TF32, each product as three).
// One block of 4 warps per (bh, 64 query rows) loops over the key tiles;
// warp w owns rows [16 w, 16 w + 16).  q is staged once, and (at D <= 64)
// its fragments, times the scale, are split into their TF32 parts once for
// the block's life and kept in registers (at D = 128 they are read again
// from shared memory per tile).  Each key tile of k and v is staged once,
// by cp.async into a two-stage ring, so the next tile arrives while this one
// is multiplied.  Per tile: S = (q scale) k^T as two halves of 32 keys (the
// small terms in their own accumulator), the online softmax on the C
// fragments (row max and sum over the quad, ex2 with log2 e folded in, the
// mask only on tiles that need one), then O = O corr + P V, where P's C
// fragments are the A fragments of P V in registers (no P tile in shared
// memory) and each half's P V runs in a fresh accumulator added to O in
// f32.  87 KB of shared memory at D = 64, two blocks per SM.  Each block
// owns its rows of O, so two calls give bitwise-equal results.  On an H100
// 80GB HBM3 (700 W) it takes 0.64 ms at the shape above, 31% of the 3xTF32
// bound.

#include "flash_tf32.cuh"

namespace flash {
namespace {

template <int DT>
constexpr size_t fwd_smem() {
  return sizeof(float) * 5 * kTileFloats<DT>;
}

// The q fragment kk of rows [m0, m0 + 16), times scale, split into its TF32
// parts (q scale is not exact in TF32, even from bf16).
template <int DT>
__device__ __forceinline__ void ld_q(Frag<4>& a, const float* Qs, int m0,
                                     int kk, int lane, float scale) {
  uint32_t r[4];
  sm90::ldsm_x4(r, Qs + at<DT>(m0 + (lane & 7) + (lane >> 3 & 1) * 8,
                                8 * kk + (lane >> 4) * 4));
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(r[i]) * scale;
  split<false>(a, x);
}

// Max and sum over the quad (the 4 lanes that hold one row's columns).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, int DT>
__global__ void __launch_bounds__(kBlockThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Lq, int Lk, int D,
                     int seq_len, int causal, int q_off, int kv_off,
                     float scale, int vec) {
  constexpr bool kX = kExact<T>;
  constexpr bool kQRegs = DT <= 64;  // q's fragments live in registers
  constexpr int TS = kTileFloats<DT>;
  constexpr int NQ = DT / 8, ND = DT / 8, NH = kSub / 8;
  float* Qs = sm90::dyn_smem();
  float* Ks = Qs + TS;       // [2 stages][TS]
  float* Vs = Ks + 2 * TS;   // [2 stages][TS]

  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x % 32, m0 = 16 * (threadIdx.x / 32);
  const int g = lane / 4, t = lane % 4;
  const int64_t qrow0 = (int64_t)bh * Lq + q0, krow0 = (int64_t)bh * Lk;

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

  // m (the running max), lp (this lane's part of the running sum) of the
  // thread's rows m0 + g and m0 + g + 8; O as C fragments
  float m[2] = {-INFINITY, -INFINITY}, lp[2] = {0.f, 0.f};
  float acc[ND][4] = {};
  Frag<4> qf[kQRegs ? NQ : 1];
  if (nk > 0) {
    stage_tile<DT>(Qs, q + qrow0 * D, Lq - q0, D, vec);
    sm90::cp_async_commit();
    stage_kv(0, 0);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();
    if constexpr (kQRegs) {
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk)
        ld_q<DT>(qf[kk], Qs, m0, kk, lane, scale);
    }
  }
  for (int jt = 0; jt < nk; ++jt) {
    const int s = jt & 1;
    if (jt + 1 < nk) stage_kv(jt + 1, s ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();

    const int k0 = jt * kTile;
    const float* Kt = Ks + s * TS;
    const float* Vt = Vs + s * TS;

    // scores of the warp's 16 rows against the tile's 64 keys, as two
    // halves of 32: sc[h][j] is the C fragment of keys [32 h + 8 j, +8)
    float sc[2][NH][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float small[NH][4] = {};
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[h][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        Frag<4> a;
        if constexpr (kQRegs)
          a = qf[kk];
        else
          ld_q<DT>(a, Qs, m0, kk, lane, scale);
        Frag<2> b[NH];
        ld_b<DT, kX, NH>(b, Kt, kSub * h, kk, lane);
        mma3<false, kX, NH>(sc[h], small, a, b);
      }
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[h][j][e] += small[j][e];
    }

    // the mask, only where some element of the tile may be hidden (rows
    // past Lq are never stored, so they need none)
    if (!tile_visible(q0, k0, q0 + kTile, seq_len, causal, q_off, kv_off)) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NH; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qg = q0 + m0 + g + 8 * (e >> 1);
            const int key = k0 + kSub * h + 8 * j + 2 * t + (e & 1);
            if (masked(qg, key, seq_len, causal, q_off, kv_off))
              sc[h][j][e] = -INFINITY;
          }
    }

    // online softmax: P = exp(S - m_safe) in place, l and O rescaled
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NH; ++j)
          mx = fmaxf(mx, fmaxf(sc[h][j][2 * i], sc[h][j][2 * i + 1]));
      mx = quad_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      corr[i] = m[i] == -INFINITY ? 0.f
                                  : sm90::ex2((m[i] - m_safe) * kLog2e);
      m[i] = m_new;
      const float neg = -m_safe * kLog2e;
      float rs = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NH; ++j)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            // exp(-inf) = 0 where masked
            sc[h][j][e] = sm90::ex2(fmaf(sc[h][j][e], kLog2e, neg));
            rs += sc[h][j][e];
          }
      lp[i] = lp[i] * corr[i] + rs;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];

    // O += P V, P's C fragments as the A fragments, one fresh accumulator
    // per half of the keys and group of 8 n-tiles
#pragma unroll
    for (int h = 0; h < 2; ++h)
      scores_times_tile<DT, kX, ND>(acc, sc[h], Vt, kSub * h, lane);
    __syncthreads();  // this stage's readers are done before it refills
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(quad_sum(lp[i]), 1e-30f);
    inv[i] = 1.f / lc;
    const int r = q0 + m0 + g + 8 * i;
    if (t == 0 && r < Lq)
      lse[(int64_t)bh * Lq + r] =
          (m[i] == -INFINITY ? 0.f : m[i]) + logf(lc);
  }
  T* ob = o + qrow0 * D;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      if (q0 + r < Lq && c < D)
        store_as(ob + (int64_t)r * D + c, acc[j][e] * inv[e >> 1]);
    }
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
  return launch(flash_fwd_kernel<T, DT>, configured<T, DT>(), grid,
                kBlockThreads, fwd_smem<DT>(), a.stream,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), static_cast<T*>(a.out0),
                static_cast<float*>(a.out1), a.Lq, a.Lk, a.D, a.seq_len,
                a.causal, a.q_off, a.kv_off, a.scale, (int)copies16<T>(a));
}

template <typename T, int DT>
cudaError_t info(int* out) {
  return kernel_info(flash_fwd_kernel<T, DT>, configured<T, DT>(),
                     kBlockThreads, fwd_smem<DT>(), out);
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

// The kernel's registers, local bytes, dynamic shared bytes and resident
// blocks per SM for head dim D and dtype, into out[0..4).
extern "C" int dfd_flash_fwd_info(int D, int dtype, int* out) {
  if (dtype == 0) return (int)flash::info_d<float>(D, out);
  if (dtype == 1) return (int)flash::info_d<__nv_bfloat16>(D, out);
  return (int)cudaErrorInvalidValue;
}
