// LeakyReLU followed by a 2x2 stride-2 max pool, forward and backward, on
// channels-last tensors, with no index tensor:
//   out    = maxpool2x2(LeakyReLU(x))
//   grad_x = LeakyReLU'(x) * (the pool's gradient routed to each window's max)
//
// Replaces no TPU kernel. The JAX package leaves LeakyReLU and the pool of
// every conv block's train step to XLA, which fuses them on the TPU; torch
// runs them as four passes (leaky_relu, max_pool2d_with_indices and their
// two backwards) with an int64 index per pooled output. Per element at the
// pool's input (bf16) that chain moves 19 bytes a train step: LeakyReLU 4,
// pool forward 4.5 (2 of them the index), pool backward 4.5, LeakyReLU
// backward 6. This pair moves 7: the forward reads x (2) and writes the
// pooled value (0.5); the backward reads x (2) and the pooled gradient
// (0.5), recomputes each window's max from x and writes grad_x (2). f32
// moves twice as many bytes. Both are bound by device memory (3.35 TB/s);
// on an H100 a train step's calls run at 79-81% of that bound (PERF.md, section 6).
//
// The results are torch's bit for bit (CUDA build, same inputs):
//  * y = LeakyReLU(x) in float, x > 0 ? x : x * slope, rounded to the
//    storage type (torch's leaky_relu kernel);
//  * the pool's rule (DilatedMaxPool2d.cu, max_pool_forward_nhwc): a running
//    max from -inf over the window in (h, w) order, replaced where y > max
//    or y is NaN, so the first maximum wins and the last NaN; a window of
//    -inf alone keeps the index torch initialises, 0, the image's first
//    element, which only window (0, 0) holds: elsewhere its gradient goes
//    nowhere, as in torch's max_pool_backward_nhwc;
//  * the pooled gradient g goes to the max as it is (a -0 stays -0, as
//    torch's CUDA backward leaves it) and 0 to the other three; then
//    LeakyReLU's backward, x > 0 ? g : g * slope in float, rounded (torch's
//    leaky_relu_backward).
//
// Design. One thread item is one pooled pixel and one 16-byte vector of
// channels (8 bf16, 4 f32): channel vector fastest, then the output column,
// so neighbouring threads read and write neighbouring 16-byte vectors and
// every 32-byte sector a warp touches is used whole. The forward issues 4
// vector loads and 1 store an item, the backward 5 loads and 4 stores, all
// independent, which keeps enough bytes in flight without shared memory or
// TMA: the kernels stream, and their cure is fewer bytes at full vector
// width. A grid-stride loop over blocks resident on every SM covers the
// small deep layers (8x8 x 512) and the 2^31-element first one alike.
// Element offsets are 64-bit; the item's decomposition uses 32-bit division
// where the item count fits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWaves = 4;  // resident blocks per SM x this = the largest grid

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as c10::BFloat16 on sm_80+
}

template <typename T>
union Vec {
  static constexpr int N = 16 / sizeof(T);
  uint4 raw;
  T v[N];
};

template <typename T>
__device__ __forceinline__ Vec<T> load(const T* p) {
  Vec<T> r;
  r.raw = __ldg(reinterpret_cast<const uint4*>(p));
  return r;
}

template <typename T>
__device__ __forceinline__ void store(T* p, const Vec<T>& r) {
  *reinterpret_cast<uint4*>(p) = r.raw;
}

// The item's element offset in x (its window's first element) and in the
// pooled tensor, from the item index: channel vector fastest, then the
// output column, then (image, output row).
struct Item {
  int64_t in, out;
  bool origin;  // the item lies in window (0, 0) of its image
};

template <typename I>
__device__ __forceinline__ Item item_at(I t, I vecs, I wo, int64_t w, int64_t c,
                                           I ho, int vec) {
  const I v = t % vecs;
  const I p = t / vecs;  // pooled pixel over (image, output row, column)
  const I j = p % wo;
  const I r = p / wo;    // image * ho + output row
  Item it;
  it.out = (int64_t)p * c + (int64_t)v * vec;
  it.in = ((int64_t)r * 2 * w + 2 * (int64_t)j) * c + (int64_t)v * vec;
  it.origin = j == 0 && r % ho == 0;
  return it;
}

template <typename T>
__device__ __forceinline__ float leaky(float x, float slope) {
  return to_float(from_float<T>(x > 0.0f ? x : x * slope));
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
leaky_pool_forward_kernel(const T* __restrict__ x, T* __restrict__ out, I items,
                          I vecs, I wo, I ho, int64_t w, int64_t c, float slope) {
  constexpr int N = Vec<T>::N;
  const int64_t phase[4] = {0, c, w * c, w * c + c};
  for (I t = (I)blockIdx.x * kThreads + threadIdx.x; t < items;
       t += (I)gridDim.x * kThreads) {
    const Item it = item_at<I>(t, vecs, wo, w, c, ho, N);
    Vec<T> in[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) in[k] = load(x + it.in + phase[k]);
    Vec<T> res;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float best = -INFINITY;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float y = leaky<T>(to_float(in[k].v[e]), slope);
        if (y > best || isnan(y)) best = y;
      }
      res.v[e] = from_float<T>(best);  // exact: best is a T value
    }
    store(out + it.out, res);
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
leaky_pool_backward_kernel(const T* __restrict__ x, const T* __restrict__ grad_out,
                           T* __restrict__ grad_x, I items, I vecs, I wo, I ho,
                           int64_t w, int64_t c, float slope) {
  constexpr int N = Vec<T>::N;
  const int64_t phase[4] = {0, c, w * c, w * c + c};
  for (I t = (I)blockIdx.x * kThreads + threadIdx.x; t < items;
       t += (I)gridDim.x * kThreads) {
    const Item it = item_at<I>(t, vecs, wo, w, c, ho, N);
    const Vec<T> g = load(grad_out + it.out);
    Vec<T> in[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) in[k] = load(x + it.in + phase[k]);
    Vec<T> res[4];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float best = -INFINITY;
      int arg = it.origin ? 0 : -1;  // torch's initial index, see the note
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float y = leaky<T>(to_float(in[k].v[e]), slope);
        if (y > best || isnan(y)) {
          best = y;
          arg = k;
        }
      }
      const float routed = to_float(g.v[e]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float gy = k == arg ? routed : 0.0f;
        res[k].v[e] = from_float<T>(to_float(in[k].v[e]) > 0.0f ? gy : gy * slope);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) store(grad_x + it.in + phase[k], res[k]);
  }
}

// Blocks of kThreads for `items`: at most kWaves x the blocks resident on
// every SM (asked once per kernel in `most`), the rest taken by the
// grid-stride loop.
template <typename K>
cudaError_t grid_for(K kernel, int64_t items, int64_t* most, int* grid) {
  if (*most == 0) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    *most = (int64_t)sms * per_sm * kWaves;
  }
  const int64_t need = (items + kThreads - 1) / kThreads;
  *grid = (int)(need < *most ? need : *most);
  return cudaSuccess;
}

template <typename T, typename I>
cudaError_t launch(const T* x, const T* grad_out, T* out, int64_t n, int64_t h,
                   int64_t w, int64_t c, float slope, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const I vecs = (I)(c / N), wo = (I)(w / 2), ho = (I)(h / 2);
  const int64_t items = n * (h / 2) * (w / 2) * (c / N);
  if (items == 0) return cudaSuccess;
  static int64_t most[2] = {0, 0};  // per direction, for this T and I
  int grid = 0;
  cudaError_t err;
  if (grad_out == nullptr) {
    if ((err = grid_for(leaky_pool_forward_kernel<T, I>, items, &most[0], &grid)) != cudaSuccess)
      return err;
    leaky_pool_forward_kernel<T, I><<<grid, kThreads, 0, stream>>>(
        x, out, (I)items, vecs, wo, ho, w, c, slope);
  } else {
    if ((err = grid_for(leaky_pool_backward_kernel<T, I>, items, &most[1], &grid)) != cudaSuccess)
      return err;
    leaky_pool_backward_kernel<T, I><<<grid, kThreads, 0, stream>>>(
        x, grad_out, out, (I)items, vecs, wo, ho, w, c, slope);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* grad_out, void* out, int64_t n,
                     int64_t h, int64_t w, int64_t c, float slope, void* stream) {
  constexpr int N = Vec<T>::N;
  if (n < 0 || h < 0 || w < 0 || c < 0 || h % 2 || w % 2 || c % N)
    return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(grad_out);
  T* ot = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 32-bit item arithmetic where the items (and the stride past the last
  // one) fit, 64-bit beyond
  const int64_t items = n * (h / 2) * (w / 2) * (c / N);
  if (items < (int64_t)1 << 31) return launch<T, uint32_t>(xt, gt, ot, n, h, w, c, slope, s);
  return launch<T, uint64_t>(xt, gt, ot, n, h, w, c, slope, s);
}

cudaError_t by_dtype(int dtype, const void* x, const void* grad_out, void* out,
                     int64_t n, int64_t h, int64_t w, int64_t c, float slope,
                     void* stream) {
  switch (dtype) {
    case 0: return dispatch<__nv_bfloat16>(x, grad_out, out, n, h, w, c, slope, stream);
    case 1: return dispatch<float>(x, grad_out, out, n, h, w, c, slope, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points for ctypes. dtype 0 = bf16, 1 = f32. Every tensor is
// channels-last (N, H, W, C) contiguous memory, 16-byte aligned, C a
// multiple of 8 (bf16) or 4 (f32), H and W even. Each returns
// cudaGetLastError() after the launch (0 = launched).
//
// leaky_pool_forward_launch: out (N, H/2, W/2, C) = the pooled LeakyReLU(x).
extern "C" int leaky_pool_forward_launch(int dtype, const void* x, void* out,
                                         int64_t n, int64_t h, int64_t w, int64_t c,
                                         float slope, void* stream) {
  return by_dtype(dtype, x, nullptr, out, n, h, w, c, slope, stream);
}

// leaky_pool_backward_launch: grad_x (N, H, W, C) from x and grad_out
// (N, H/2, W/2, C); every element of grad_x is written.
extern "C" int leaky_pool_backward_launch(int dtype, const void* x, const void* grad_out,
                                          void* grad_x, int64_t n, int64_t h, int64_t w,
                                          int64_t c, float slope, void* stream) {
  if (grad_out == nullptr) return cudaErrorInvalidValue;
  return by_dtype(dtype, x, grad_out, grad_x, n, h, w, c, slope, stream);
}
