// Fused depthwise conv -> per-channel affine -> activation, forward, NHWC.
//
// Replaces the Pallas TPU kernel deepfake_detection_tpu/ops/depthwise_pallas.py
// ::_fwd_kernel (launched by _dw_call): y = act(dwconv(x, w) * scale + bias),
// f32 accumulation and epilogue, y in x's dtype.  When z is not null it also
// writes z = dwconv(x, w) in f32, the pre-affine output the backward of a
// non-identity epilogue needs (the TPU version's want_z); inference and the
// identity epilogue of training pass null and pay nothing for it.  dx of
// the backward has its own kernel, depthwise_dx.cu.
//
// What bounds it on an H100: memory.  The stage must read x once and write y
// once (w, scale and bias are k*k*C + 2*C floats); at the flagship's shapes
// that is ~3 FLOP per byte in f32, far below the card's ratio of f32 rate to
// memory rate.  So each x value should come from device memory about once,
// the k x k reuse should happen in shared memory, and the loads should keep
// flowing while the SM computes:
//
// * work items (depthwise_common.cuh's walk): one image's band of at most
//   8 (k = 5, stride 1) or 4 output rows by a segment of at most 16
//   columns, for a strip of 32 channels; the bands are halved for an
//   output too small to spread over the card.  One wave of blocks takes
//   items i, i + grid, ...;
// * a block stages an item's input box, ((rows-1)*S + K) x ((cols-1)*S + K)
//   pixels of 32 channels, and its k*k x 32 weights by two TMA loads,
//   which put zeros where the box leaves x (the padding), into one of two
//   shared-memory slots, while it computes the previous item from the other
//   slot; bf16 x stays bf16 there and is widened on read;
// * a thread owns 4 channels (8 threads along the strip, so each quarter
//   warp reads one contiguous 128-byte pixel) and units of kTW output
//   pixels along a row: for each of the K input rows it loads the
//   (kTW-1)*S + K columns once from shared memory into registers and
//   reuses them across the K column taps and the kTW outputs;
// * each output's k*k products are added in the order (r, s), by fused
//   multiply-adds in f32, as the plain version's sum is.
//
// A C that is not a multiple of 16 bytes' values, or an unaligned base,
// takes the scalar path: the threads stage the same slots by cp.async, one
// value a copy.  All offsets into x, y and z are 64-bit.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes by deepfake_detection_tpu_torch/ops/depthwise.py.

#include "depthwise_common.cuh"

namespace {

using namespace dwk;

constexpr int kTW = 4;  // output columns a thread's unit

// the largest work item, in output rows and columns
template <int K, int S> struct Item {
  static constexpr int rows = S == 1 && K == 5 ? 8 : 4, cols = 16;
};

template <typename T, int K, int S>
constexpr int slot_bytes_max() {
  return round128(K * K * kCW * 4) +
         round128(((Item<K, S>::rows - 1) * S + K) *
                  ((Item<K, S>::cols - 1) * S + K) * kCW * (int)sizeof(T));
}

template <typename T, int K, int S, bool VEC>
__global__ void __launch_bounds__(kThreads)
dw_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap,
              const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ scale, const float* __restrict__ bias,
              T* __restrict__ y, float* __restrict__ z, int64_t H, int64_t W,
              int64_t C, int64_t Ho, int64_t Wo, int pad_top, int pad_left,
              int act, Walk p) {
  constexpr int NCOL = (kTW - 1) * S + K;  // input columns a unit reads
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kSlots * p.slot_bytes);
  const int tx = threadIdx.x;
  const int tid = threadIdx.y * kTX + tx, nt = kTX * blockDim.y;

  // work item i: (strip, image, band of rows, segment of columns), the
  // segment fastest
  auto where = [&](int i, int64_t& c0, int64_t& b, int64_t& oh0,
                   int64_t& ow0) {
    ow0 = i % p.segs * p.cols;
    i /= p.segs;
    oh0 = i % p.bands * p.rows;
    i /= p.bands;
    b = i % p.B;
    c0 = i / p.B * kCW;
  };
  // stages item i's weights and input box into slot
  auto stage = [&](int i, int slot) {
    int64_t c0, b, oh0, ow0;
    where(i, c0, b, oh0, ow0);
    float* ws = reinterpret_cast<float*>(smem + slot * p.slot_bytes);
    T* xs = reinterpret_cast<T*>(smem + slot * p.slot_bytes + p.w_bytes);
    if (VEC) {
      if (tid == 0) {
        sm90::fence_proxy_async();
        sm90::mbar_expect_tx(&bars[slot], p.tx_bytes);
        sm90::tma_load_2d(ws, &wmap, (int)c0, 0, &bars[slot]);
        sm90::tma_load_4d(xs, &xmap, (int)c0, (int)(ow0 * S - pad_left),
                          (int)(oh0 * S - pad_top), (int)b, &bars[slot]);
      }
    } else {
      stage_weights(ws, w, K * K, C, c0, tid, nt);
      stage_tile<T>(xs, x + b * H * W * C, oh0 * S - pad_top,
                           ow0 * S - pad_left, p.in_rows, p.in_cols, H, W, C,
                           c0, tid, nt);
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
    // the loads kSlots - 1 items ahead go out before this one is computed
    const int ahead = i + (kSlots - 1) * grid;
    if (ahead < p.items) stage(ahead, (k + kSlots - 1) % kSlots);
    sm90::cp_async_commit();
    if (VEC) {
      sm90::mbar_wait(&bars[slot], (k / kSlots) & 1);
    } else {
      sm90::cp_async_wait<kSlots - 1>();
      __syncthreads();
    }

    int64_t c0, b, oh0, ow0;
    where(i, c0, b, oh0, ow0);
    const float* ws =
        reinterpret_cast<const float*>(smem + slot * p.slot_bytes);
    const T* xs =
        reinterpret_cast<const T*>(smem + slot * p.slot_bytes + p.w_bytes);
    const int rows = (int)(Ho - oh0 < p.rows ? Ho - oh0 : p.rows);
    const int cols = (int)(Wo - ow0 < p.cols ? Wo - ow0 : p.cols);
    const int cu = (cols + kTW - 1) / kTW;
    const int64_t c = c0 + 4 * tx;
    float sc[4], bi[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      sc[v] = scale != nullptr && c + v < C ? __ldg(scale + c + v) : 1.0f;
      bi[v] = bias != nullptr && c + v < C ? __ldg(bias + c + v) : 0.0f;
    }

    for (int u = threadIdx.y; u < rows * cu; u += blockDim.y) {
      const int r0 = u / cu, q0 = u % cu * kTW;
      float acc[kTW][4];
#pragma unroll
      for (int t = 0; t < kTW; ++t)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[t][v] = 0.0f;

#pragma unroll
      for (int r = 0; r < K; ++r) {
        const T* row = xs + ((r0 * S + r) * p.in_cols + q0 * S) * kCW + 4 * tx;
        float win[NCOL][4];
#pragma unroll
        for (int j = 0; j < NCOL; ++j) lds4(row + j * kCW, win[j]);
#pragma unroll
        for (int s = 0; s < K; ++s) {
          float wt[4];
          lds4(ws + (r * K + s) * kCW + 4 * tx, wt);
#pragma unroll
          for (int t = 0; t < kTW; ++t)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              acc[t][v] = fmaf(win[t * S + s][v], wt[v], acc[t][v]);
        }
      }

#pragma unroll
      for (int t = 0; t < kTW; ++t) {
        if (q0 + t >= cols) continue;
        const int64_t off = ((b * Ho + oh0 + r0) * Wo + ow0 + q0 + t) * C + c;
        if (z != nullptr) store4<float, VEC>(z + off, acc[t], c, C);
        float out[4];
#pragma unroll
        for (int v = 0; v < 4; ++v)
          out[v] = apply_act(acc[t][v] * sc[v] + bi[v], act);
        store4<T, VEC>(y + off, out, c, C);
      }
    }
    __syncthreads();  // the slot is read before it refills
  }
  sm90::cp_async_wait<0>();
}

struct Args {
  const void* x; const float* w; const float* scale; const float* bias;
  void* y; float* z;
  int64_t B, H, W, C, Ho, Wo;
  int pad_top, pad_left, act;
  cudaStream_t stream;
};

template <typename T, int K, int S, bool VEC>
bool& configured() {
  static bool flag = false;
  return flag;
}

template <typename T, int K, int S, bool VEC>
cudaError_t launch(const Args& a) {
  if (a.B * a.Ho * a.Wo * a.C == 0) return cudaSuccess;
  auto kernel = dw_fwd_kernel<T, K, S, VEC>;
  constexpr size_t smem_max = kSlots * (slot_bytes_max<T, K, S>() + 8);
  cudaError_t err =
      sm90::configure(kernel, configured<T, K, S, VEC>(), smem_max);
  if (err != cudaSuccess) return err;
  Walk p = walk(a.B, a.Ho, a.Wo, a.C, Item<K, S>::rows, Item<K, S>::cols, 1,
                kTW);
  p.in_rows = (p.rows - 1) * S + K;
  p.in_cols = (p.cols - 1) * S + K;
  p.w_bytes = round128(K * K * kCW * 4);
  p.slot_bytes =
      p.w_bytes + round128(p.in_rows * p.in_cols * kCW * (int)sizeof(T));
  p.tx_bytes = K * K * kCW * 4 + p.in_rows * p.in_cols * kCW * (int)sizeof(T);
  const size_t smem = kSlots * ((size_t)p.slot_bytes + 8);
  const int64_t units = p.rows * (p.cols / kTW);
  const dim3 block(kTX, (unsigned)(units < kWorkers ? units : kWorkers));
  unsigned grid = 0;
  if (p.items < 0) return cudaErrorInvalidValue;
  err = wave(kernel, block, smem, p.items, grid);
  if (err != cudaSuccess) return err;

  CUtensorMap xmap{}, wmap{};
  if (VEC) {
    const CUtensorMapDataType type = sizeof(T) == 4
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const uint64_t es = sizeof(T);
    const uint64_t xdims[4] = {(uint64_t)a.C, (uint64_t)a.W, (uint64_t)a.H,
                               (uint64_t)a.B};
    const uint64_t xstrides[3] = {a.C * es, a.W * a.C * es,
                                  a.H * a.W * a.C * es};
    const uint32_t xbox[4] = {kCW, (uint32_t)p.in_cols, (uint32_t)p.in_rows,
                              1};
    err = sm90::encode_tiled(&xmap, type, 4, a.x, xdims, xstrides, xbox);
    if (err != cudaSuccess) return err;
    const uint64_t wdims[2] = {(uint64_t)a.C, (uint64_t)(K * K)};
    const uint64_t wstrides[1] = {a.C * 4};
    const uint32_t wbox[2] = {kCW, K * K};
    err = sm90::encode_tiled(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a.w,
                             wdims, wstrides, wbox);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, block, smem, a.stream>>>(
      xmap, wmap, static_cast<const T*>(a.x), a.w, a.scale, a.bias,
      static_cast<T*>(a.y), a.z, a.H, a.W, a.C, a.Ho, a.Wo, a.pad_top,
      a.pad_left, a.act, p);
  return cudaGetLastError();
}

// TMA loads of x and w (their strides a multiple of 16 bytes, 16-byte
// aligned bases), vector stores of y and z
template <typename T>
bool vec_path(const Args& a) {
  return a.C % (16 / sizeof(T)) == 0 && aligned(a.x, 16) &&
         aligned(a.w, 16) && aligned(a.y, 4 * sizeof(T)) &&
         aligned(a.z, 16);
}

template <typename T, int K, int S>
cudaError_t launch_vec(const Args& a) {
  return vec_path<T>(a) ? launch<T, K, S, true>(a)
                        : launch<T, K, S, false>(a);
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
  return kernel_info(dw_fwd_kernel<T, K, S, VEC>, configured<T, K, S, VEC>(),
                     kSlots * (slot_bytes_max<T, K, S>() + 8), out);
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

// dtype: 0 = float32, 1 = bfloat16 (x and y); w, scale, bias and z are
// float32, scale and bias may be null (identity), z may be null (not
// written).  Pads may exceed k-1 (rows or columns whose taps all fall
// outside x get 0); Ho and Wo are the caller's.  Returns the cudaError_t of
// the launch; the caller raises on anything but 0.
extern "C" int dfd_depthwise_fwd(const void* x, const void* w,
                                 const void* scale, const void* bias, void* y,
                                 void* z, int64_t B, int64_t H, int64_t W,
                                 int64_t C, int64_t Ho, int64_t Wo, int k,
                                 int stride,
                                 int pad_top, int pad_left, int act, int dtype,
                                 void* stream) {
  if (act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  const Args a{x, static_cast<const float*>(w),
               static_cast<const float*>(scale),
               static_cast<const float*>(bias), y, static_cast<float*>(z),
               B, H, W, C, Ho, Wo,
               pad_top, pad_left, act, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_ks<float>(a, k, stride);
  if (dtype == 1) return (int)launch_ks<__nv_bfloat16>(a, k, stride);
  return (int)cudaErrorInvalidValue;
}

// The instantiation's registers, local bytes, largest dynamic shared bytes
// and resident blocks per SM at those bytes, into out[0..4); vec selects
// the 16-byte path.
extern "C" int dfd_depthwise_fwd_info(int k, int stride, int dtype, int vec,
                                      int* out) {
  if (dtype == 0) return (int)info_ks<float>(k, stride, vec, out);
  if (dtype == 1) return (int)info_ks<__nv_bfloat16>(k, stride, vec, out);
  return (int)cudaErrorInvalidValue;
}
