// Depthwise conv input gradient, NHWC, as a direct transposed kernel:
//   dx[b, h, w, c] = sum over the taps (r, s) with h + top - r and
//                    w + left - s both multiples of S, and the dz index
//                    ((h + top - r) / S, (w + left - s) / S) inside
//                    [0, Ho) x [0, Wo), of w[r, s, c] * dz[b, ., ., c]
// dz and w f32, f32 accumulation, dx in x's dtype (f32 or bf16) with one
// rounding, written at exactly x's H x W for any non-negative padding.
//
// Replaces the TPU backward's reuse of the Pallas forward kernel
// (deepfake_detection_tpu/ops/depthwise_pallas.py::_fwd_kernel, called by
// fused_depthwise's _op_bwd over dz dilated by S - 1 with the kernel
// flipped, then cropped).  Here nothing is dilated: at stride 2 each dx
// pixel takes only the taps of its phase class, ((h + top) mod 2,
// (w + left) mod 2): 4/2/2/1 of them at k = 3 and 9/6/6/4 at k = 5, so a
// pixel costs k*k/S^2 multiply-adds on average and dz is read once.
//
// What bounds it on an H100: memory, as the forward: read dz once, write dx
// once, 2*k*k/S^2 FLOP per dx element.  The walk is the forward's
// (depthwise_common.cuh), over groups of S x S dx pixels, group (g, q)
// holding dx rows S*g + ph - top and columns S*q + pw - left (ph, pw <
// S), so every group's pixels read dz rows g - d and columns q - e for
// d, e <= D = (K-1)/S:
//
// * work items: one image's band of at most 8 group rows by a segment of
//   at most 16 group columns, for a strip of 32 channels; one wave of
//   blocks takes items i, i + grid, ...;
// * a block stages the dz rows and columns an item reads, the item plus a
//   halo of D before it, and the weights by two TMA loads (zeros outside
//   dz) into one of two shared-memory slots while it computes the previous
//   item from the other;
// * a thread owns 4 channels and units of U groups along a row: for each
//   of the D + 1 dz rows the unit reads, it loads U + D dz vectors once
//   into registers and adds each into the dx pixels of every phase class
//   it reaches.  The sum of a dx pixel runs over its taps by r descending,
//   then s ascending, by fused multiply-adds in f32.
//
// At stride 1 this is the correlation of dz with the flipped kernel; the
// groups start at dx row and column 0, so a forward padding beyond k-1 is
// no crop either.  A C that is not a multiple of 4, or an unaligned base,
// takes the scalar path: the threads stage the slots by 4-byte cp.async and
// store one value at a time.  All offsets into dz and dx are 64-bit.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes by deepfake_detection_tpu_torch/ops/depthwise.py.

#include "depthwise_common.cuh"

namespace {

using namespace dwk;

// a thread's unit: U groups along a row (4 dx pixels at stride 1, 8 at 2)
template <int S> constexpr int kU = S == 1 ? 4 : 2;

// the largest work item, in groups
struct Item {
  static constexpr int rows = 8, cols = 16;
};

template <int K, int S>
constexpr int slot_bytes_max() {
  constexpr int D = (K - 1) / S;
  return round128(K * K * kCW * 4) +
         round128((Item::rows + D) * (Item::cols + D) * kCW * 4);
}

template <typename T, int K, int S, bool VEC>
__global__ void __launch_bounds__(kThreads)
dw_dx_kernel(const __grid_constant__ CUtensorMap zmap,
             const __grid_constant__ CUtensorMap wmap,
             const float* __restrict__ dz, const float* __restrict__ w,
             T* __restrict__ dx, int64_t H, int64_t W, int64_t C, int64_t Ho,
             int64_t Wo, int pad_top, int pad_left, int64_t g_row0,
             int64_t g_col0, int64_t n_grows, int64_t n_gcols, Walk p) {
  constexpr int D = (K - 1) / S;
  constexpr int U = kU<S>;
  constexpr int NWIN = U + D;  // dz columns a unit reads
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kSlots * p.slot_bytes);
  const int tx = threadIdx.x;
  const int tid = threadIdx.y * kTX + tx, nt = kTX * blockDim.y;

  // work item i: (strip, image, band of group rows starting at g0, segment
  // of group columns starting at q0), the segment fastest
  auto where = [&](int i, int64_t& c0, int64_t& b, int64_t& g0,
                   int64_t& q0) {
    q0 = g_col0 + i % p.segs * p.cols;
    i /= p.segs;
    g0 = g_row0 + i % p.bands * p.rows;
    i /= p.bands;
    b = i % p.B;
    c0 = i / p.B * kCW;
  };
  // stages item i's weights and the dz rows and columns it reads (from
  // D before its first group on) into slot
  auto stage = [&](int i, int slot) {
    int64_t c0, b, g0, q0;
    where(i, c0, b, g0, q0);
    float* ws = reinterpret_cast<float*>(smem + slot * p.slot_bytes);
    float* zs = reinterpret_cast<float*>(smem + slot * p.slot_bytes +
                                         p.w_bytes);
    if (VEC) {
      if (tid == 0) {
        sm90::fence_proxy_async();
        sm90::mbar_expect_tx(&bars[slot], p.tx_bytes);
        sm90::tma_load_2d(ws, &wmap, (int)c0, 0, &bars[slot]);
        sm90::tma_load_4d(zs, &zmap, (int)c0, (int)(q0 - D), (int)(g0 - D),
                          (int)b, &bars[slot]);
      }
    } else {
      stage_weights(ws, w, K * K, C, c0, tid, nt);
      stage_tile<float>(zs, dz + b * Ho * Wo * C, g0 - D, q0 - D,
                               p.in_rows, p.in_cols, Ho, Wo, C, c0, tid, nt);
    }
  };

  if (VEC && tid == 0) {
    for (int s = 0; s < kSlots; ++s) sm90::mbar_init(&bars[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  // items blockIdx.x + j * gridDim.x go to slot j % kSlots, kSlots - 1
  // items ahead of the one computed
  const int grid = gridDim.x;
  for (int s = 0; s < kSlots - 1; ++s) {
    if ((int)blockIdx.x + s * grid < p.items) stage(blockIdx.x + s * grid, s);
    sm90::cp_async_commit();
  }

  int k = 0;
  for (int i = blockIdx.x; i < p.items; i += grid, ++k) {
    const int slot = k % kSlots;
    const int ahead = i + (kSlots - 1) * grid;
    if (ahead < p.items) stage(ahead, (k + kSlots - 1) % kSlots);
    sm90::cp_async_commit();
    if (VEC) {
      sm90::mbar_wait(&bars[slot], (k / kSlots) & 1);
    } else {
      sm90::cp_async_wait<kSlots - 1>();
      __syncthreads();
    }

    int64_t c0, b, g0, q0;
    where(i, c0, b, g0, q0);
    const float* ws =
        reinterpret_cast<const float*>(smem + slot * p.slot_bytes);
    const float* zs = reinterpret_cast<const float*>(
        smem + slot * p.slot_bytes + p.w_bytes);
    const int rows = (int)(g_row0 + n_grows - g0 < p.rows
                               ? g_row0 + n_grows - g0 : p.rows);
    const int cols = (int)(g_col0 + n_gcols - q0 < p.cols
                               ? g_col0 + n_gcols - q0 : p.cols);
    const int cu = (cols + U - 1) / U;
    const int64_t c = c0 + 4 * tx;
    for (int u = threadIdx.y; u < rows * cu; u += blockDim.y) {
      const int gr = u / cu, gq = u % cu * U;
      float acc[S][U][S][4];
#pragma unroll
      for (int ph = 0; ph < S; ++ph)
#pragma unroll
        for (int j = 0; j < U; ++j)
#pragma unroll
          for (int pw = 0; pw < S; ++pw)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[ph][j][pw][v] = 0.0f;

      // staged row gr + qq is dz row g0 + gr + qq - D: the group row's
      // taps r = ph + S * (D - qq)
#pragma unroll
      for (int qq = 0; qq <= D; ++qq) {
        const int d = D - qq;
        const float* row = zs + ((gr + qq) * p.in_cols + gq) * kCW + 4 * tx;
        float win[NWIN][4];
#pragma unroll
        for (int j = 0; j < NWIN; ++j) lds4(row + j * kCW, win[j]);
#pragma unroll
        for (int ph = 0; ph < S; ++ph) {
          const int r = ph + S * d;
          if (r >= K) continue;
#pragma unroll
          for (int pw = 0; pw < S; ++pw) {
#pragma unroll
            for (int e = 0; e <= D; ++e) {
              const int s = pw + S * e;
              if (s >= K) continue;
              float wt[4];
              lds4(ws + (r * K + s) * kCW + 4 * tx, wt);
#pragma unroll
              for (int j = 0; j < U; ++j)
#pragma unroll
                for (int v = 0; v < 4; ++v)
                  acc[ph][j][pw][v] =
                      fmaf(win[j + D - e][v], wt[v], acc[ph][j][pw][v]);
            }
          }
        }
      }

#pragma unroll
      for (int ph = 0; ph < S; ++ph) {
        const int64_t h = S * (g0 + gr) + ph - pad_top;
        if (h < 0 || h >= H) continue;
#pragma unroll
        for (int j = 0; j < U; ++j) {
#pragma unroll
          for (int pw = 0; pw < S; ++pw) {
            const int64_t x = S * (q0 + gq + j) + pw - pad_left;
            if (gq + j >= cols || x < 0 || x >= W) continue;
            store4<T, VEC>(dx + ((b * H + h) * W + x) * C + c,
                           acc[ph][j][pw], c, C);
          }
        }
      }
    }
    __syncthreads();  // the slot is read before it refills
  }
  sm90::cp_async_wait<0>();
}

struct Args {
  const float* dz; const float* w; void* dx;
  int64_t B, H, W, C, Ho, Wo;
  int pad_top, pad_left;
  cudaStream_t stream;
};

template <typename T, int K, int S, bool VEC>
bool& configured() {
  static bool flag = false;
  return flag;
}

// The groups whose pixels hold some dx row (column): g from floor(pad / S)
// while S*g - pad <= n - 1.
inline void group_range(int64_t n, int pad, int S, int64_t& first,
                        int64_t& count) {
  first = pad / S;
  count = (n - 1 + pad) / S + 1 - first;
}

template <typename T, int K, int S, bool VEC>
cudaError_t launch(const Args& a) {
  if (a.B * a.H * a.W * a.C == 0) return cudaSuccess;
  constexpr int D = (K - 1) / S;
  auto kernel = dw_dx_kernel<T, K, S, VEC>;
  constexpr size_t smem_max = kSlots * (slot_bytes_max<K, S>() + 8);
  cudaError_t err =
      sm90::configure(kernel, configured<T, K, S, VEC>(), smem_max);
  if (err != cudaSuccess) return err;
  int64_t gr0, ngr, gc0, ngc;
  group_range(a.H, a.pad_top, S, gr0, ngr);
  group_range(a.W, a.pad_left, S, gc0, ngc);
  Walk p = walk(a.B, ngr, ngc, a.C, Item::rows, Item::cols, 1, kU<S>);
  p.in_rows = p.rows + D;
  p.in_cols = p.cols + D;
  p.w_bytes = round128(K * K * kCW * 4);
  p.slot_bytes = p.w_bytes + round128(p.in_rows * p.in_cols * kCW * 4);
  p.tx_bytes = (K * K + p.in_rows * p.in_cols) * kCW * 4;
  const size_t smem = kSlots * ((size_t)p.slot_bytes + 8);
  const int64_t units = p.rows * (p.cols / kU<S>);
  const dim3 block(kTX, (unsigned)(units < kWorkers ? units : kWorkers));
  unsigned grid = 0;
  if (p.items < 0) return cudaErrorInvalidValue;
  err = wave(kernel, block, smem, p.items, grid);
  if (err != cudaSuccess) return err;

  CUtensorMap zmap{}, wmap{};
  if (VEC) {
    const uint64_t zdims[4] = {(uint64_t)a.C, (uint64_t)a.Wo,
                               (uint64_t)a.Ho, (uint64_t)a.B};
    const uint64_t zstrides[3] = {a.C * 4, a.Wo * a.C * 4,
                                  a.Ho * a.Wo * a.C * 4};
    const uint32_t zbox[4] = {kCW, (uint32_t)p.in_cols, (uint32_t)p.in_rows,
                              1};
    err = sm90::encode_tiled(&zmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.dz,
                             zdims, zstrides, zbox);
    if (err != cudaSuccess) return err;
    const uint64_t wdims[2] = {(uint64_t)a.C, (uint64_t)(K * K)};
    const uint64_t wstrides[1] = {a.C * 4};
    const uint32_t wbox[2] = {kCW, K * K};
    err = sm90::encode_tiled(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a.w,
                             wdims, wstrides, wbox);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, block, smem, a.stream>>>(
      zmap, wmap, a.dz, a.w, static_cast<T*>(a.dx), a.H, a.W, a.C, a.Ho,
      a.Wo, a.pad_top, a.pad_left, gr0, gc0, ngr, ngc, p);
  return cudaGetLastError();
}

// TMA loads of dz and w (C % 4 == 0, 16-byte aligned bases), vector stores
// of dx
template <typename T, int K, int S>
cudaError_t launch_vec(const Args& a) {
  const bool vec = a.C % 4 == 0 && aligned(a.dz, 16) &&
                   aligned(a.w, 16) && aligned(a.dx, 4 * sizeof(T));
  return vec ? launch<T, K, S, true>(a) : launch<T, K, S, false>(a);
}

template <typename T>
cudaError_t launch_ks(const Args& a, int k, int stride) {
  if (k == 3 && stride == 1) return launch_vec<T, 3, 1>(a);
  if (k == 3 && stride == 2) return launch_vec<T, 3, 2>(a);
  if (k == 5 && stride == 1) return launch_vec<T, 5, 1>(a);
  if (k == 5 && stride == 2) return launch_vec<T, 5, 2>(a);
  return cudaErrorInvalidValue;
}

template <typename T, int K, int S, bool VEC>
cudaError_t info(int* out) {
  return kernel_info(dw_dx_kernel<T, K, S, VEC>, configured<T, K, S, VEC>(),
                     kSlots * (slot_bytes_max<K, S>() + 8), out);
}

template <typename T, int K, int S>
cudaError_t info_vec(int vec, int* out) {
  return vec ? info<T, K, S, true>(out) : info<T, K, S, false>(out);
}

template <typename T>
cudaError_t info_ks(int k, int stride, int vec, int* out) {
  if (k == 3 && stride == 1) return info_vec<T, 3, 1>(vec, out);
  if (k == 3 && stride == 2) return info_vec<T, 3, 2>(vec, out);
  if (k == 5 && stride == 1) return info_vec<T, 5, 1>(vec, out);
  if (k == 5 && stride == 2) return info_vec<T, 5, 2>(vec, out);
  return cudaErrorInvalidValue;
}

}  // namespace

// dz (B, Ho, Wo, C) and w (k, k, C) float32; dx (B, H, W, C) in dtype
// (0 = float32, 1 = bfloat16), every element written.  pad_top and
// pad_left are the forward's (non-negative, any size); Ho and Wo its
// output size.  Returns the cudaError_t of the launch; the caller raises
// on anything but 0.
extern "C" int dfd_depthwise_dx(const void* dz, const void* w, void* dx,
                                int64_t B, int64_t H, int64_t W, int64_t C,
                                int64_t Ho, int64_t Wo, int k, int stride,
                                int pad_top, int pad_left, int dtype,
                                void* stream) {
  if (pad_top < 0 || pad_left < 0) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(dz), static_cast<const float*>(w),
               dx, B, H, W, C, Ho, Wo, pad_top, pad_left,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_ks<float>(a, k, stride);
  if (dtype == 1) return (int)launch_ks<__nv_bfloat16>(a, k, stride);
  return (int)cudaErrorInvalidValue;
}

// The instantiation's registers, local bytes, largest dynamic shared bytes
// and resident blocks per SM at those bytes, into out[0..4); vec selects
// the 16-byte path.
extern "C" int dfd_depthwise_dx_info(int k, int stride, int dtype, int vec,
                                     int* out) {
  if (dtype == 0) return (int)info_ks<float>(k, stride, vec, out);
  if (dtype == 1) return (int)info_ks<__nv_bfloat16>(k, stride, vec, out);
  return (int)cudaErrorInvalidValue;
}
