// Fused input block for Hopper (sm_90a), on the tensor cores:
//   out = maxpool2x2(LeakyReLU(conv3x3_SAME(bf16(x)) * scale + bias))
//
// Replaces the TPU kernel crosstalk_tpu/ops/pallas/input_block.py::
// fused_input_block (pl.pallas_call at :168, body _gemm_max_body at :101).
// Same function: x is rounded to bf16, the weights are (kernel * scale)
// rounded to bf16 (the BN scale sits inside the conv sum, so a negative
// scale flips which pool phase wins exactly as it should), products are
// summed in f32, the 2x2 max comes before + bias and LeakyReLU (exact:
// both are monotone per channel once the scale is inside the sum), and the
// output is bf16.
//
// GEMM view (direct, not the TPU's space-to-depth phase kernel): M is
// pre-pool pixels, N is F, K is the 9*C taps in (dh, dw, c) order, padded
// with zeros to K' = 16 * k16 + 8 * k8 (KSteps below: C=1 16, C=2 24,
// C=3 32, C=4 40) and run as k16 steps of mma.sync m16n8k16 plus at most
// one m16n8k8 tail, bf16 in, f32 accumulate. The wrapper packs the weights
// once as wt (F', K') bf16, row n holding output channel n, F' = F rounded
// up to 128, padded rows and columns zero.
//
// Design.
//  * Phase max in registers. A warp takes 8 adjacent pooled pixels of one
//    row as two m16 tiles: tile 0 row g = phase (0,0) of pooled pixel g,
//    row g+8 = phase (0,1); tile 1 the phases (1,0), (1,1). A thread's two
//    C fragments then hold all four phases of pixel g at two channels
//    (g = lane/4, t = lane%4), so max, bias, LeakyReLU and the bf16x2 cast
//    stay in registers.
//  * A fragments from shared memory. A block stages kRows pooled rows x
//    kCols pooled columns of input with the 1-pixel halo (zero at the image
//    border), rounded to bf16; the next tile's window is loaded into
//    registers while the current one multiplies. For even C a fragment
//    register (k pair 2t, 2t+1) is one 32-bit load of two adjacent
//    channels; padded k columns are zero registers, not loads.
//  * B fragments and bias stay in registers: each warp owns one 64-channel
//    span of the 128-channel slice for as long as the block walks tiles of
//    that slice.
//  * Stores straight from registers. The B rows are loaded in a permuted
//    channel order (see the kernel) so that a thread ends a span holding
//    channels [8t, 8t+8) and [32+8t, 32+8t+8) of its pixel: two 16-byte
//    stores, the four lanes of a pixel covering 64 contiguous bytes each.
//    No shared staging, no shuffles. The grid is persistent (resident
//    blocks x SMs) over (channel slice, image, row strip, column strip)
//    tiles, so stores drain while other warps load and multiply.
//
// Measured on an H100 with edited copies of this source: the work per
// output byte (fragment loads, phase max, bias, LeakyReLU, casts,
// addressing), not the stores, sets the time; removing the stores alone
// barely moves it.
//
// Bound at 256x256, C=2, F=128 per tile: 524,288 B of f32 input read,
// 4,194,304 B of bf16 output written -> 4.72 MB, 1.41 us at 3.35 TB/s. The
// padded products are 2*24*128*256^2 = 0.40 GFLOP per tile, 0.4 us at the
// 989 TFLOP/s bf16 tensor-core peak: the kernel is bound by its stores.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;            // resident blocks per SM asked of ptxas
constexpr int kRows = 8;                 // pooled rows per tile
constexpr int kCols = 64;                // pooled columns per tile
constexpr int kNT = 16;                  // n8 tiles per channel slice
constexpr int kFB = 8 * kNT;             // channels per slice
constexpr int kWarpNT = 8;               // n8 tiles of one warp's span (4k)
constexpr int kSpans = kNT / kWarpNT;    // warp items per group of 8 pixels
constexpr int kInRows = 2 * kRows + 2;   // input rows incl. halo
constexpr int kInCols = 2 * kCols + 2;   // input columns incl. halo
constexpr int kGroups = kRows * kCols / 8;  // 8-pixel groups per tile

// K split into m16n8k16 steps and at most one m16n8k8 tail.
template <int C>
struct KSteps {
  static constexpr int K = 9 * C;
  static constexpr int kRem = K % 16;
  static constexpr int k16 = K / 16 + (kRem > 8 ? 1 : 0);
  static constexpr int k8 = (kRem > 0 && kRem <= 8) ? 1 : 0;
  static constexpr int kPadded = 16 * k16 + 8 * k8;
  static constexpr int kPairs = 2 * k16 + k8;  // 32-bit k pairs per fragment row
};

// Tile index -> (channel slice, image, row strip, column strip); the
// channel slice is outermost so a block mostly keeps its B fragments.
struct Tile {
  int fc, b, a0, j0;
};

__device__ __forceinline__ Tile tile_at(int tile, int B, int nr, int nc) {
  Tile tl;
  tl.j0 = tile % nc * kCols;
  tile /= nc;
  tl.a0 = tile % nr * kRows;
  tile /= nr;
  tl.b = tile % B;
  tl.fc = tile / B;
  return tl;
}

// First k of the i-th 32-bit k pair a thread holds in a fragment row:
// pairs 2s and 2s+1 are the halves (k 2t, 2t+8) of k16 step s, the last
// pair (if k8) the tail step.
template <int C>
__device__ __forceinline__ int pair_k(int i, int t) {
  using KS = KSteps<C>;
  return (i < 2 * KS::k16 ? 16 * (i / 2) + 8 * (i % 2) : 16 * KS::k16) + 2 * t;
}

__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t* a,
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t* a,
                                     uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ float leaky(float y, float slope) {
  return y >= 0.0f ? y : slope * y;
}

template <int C>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_input_block_kernel(const float* __restrict__ x,           // (B,H,W,C)
                         const __nv_bfloat16* __restrict__ wt,  // (F',K')
                         const float* __restrict__ bias,        // (F',)
                         __nv_bfloat16* __restrict__ out,       // (B,H/2,W/2,F)
                         int B, int H, int W, int F, float slope) {
  using KS = KSteps<C>;
  constexpr int kA = 4 * KS::k16 + 2 * KS::k8;  // A registers per m16 tile
  __shared__ __align__(16) uint16_t xs[kInRows * kInCols * C];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int H2 = H / 2, W2 = W / 2;
  const int nr = (H2 + kRows - 1) / kRows, nc = (W2 + kCols - 1) / kCols;
  const int tiles = B * nr * nc * ((F + kFB - 1) / kFB);  // < INT_MAX (launch)

  // Shared-memory offset of each k pair this thread feeds (relative to a
  // pre-pool pixel), per element; -1 where k is padding.
  int off[KS::kPairs][2];
#pragma unroll
  for (int i = 0; i < KS::kPairs; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = pair_k<C>(i, t) + e, tap = k / C, c = k - tap * C;
      off[i][e] = k < KS::K ? ((tap / 3) * kInCols + tap % 3) * C + c : -1;
    }
  }
  auto pair = [&](int base, int i) -> uint32_t {
    const bool real = pair_k<C>(i, 3) + 1 < KS::K;  // no lane reads padding
    if constexpr (C % 2 == 0) {  // adjacent channels of one tap: one load
      const uint32_t* p = reinterpret_cast<const uint32_t*>(&xs[base + off[i][0]]);
      return real ? *p : (off[i][0] >= 0 ? *p : 0u);
    } else {
      const uint32_t lo = real || off[i][0] >= 0 ? xs[base + off[i][0]] : 0u;
      const uint32_t hi = real || off[i][1] >= 0 ? xs[base + off[i][1]] : 0u;
      return lo | (hi << 16);
    }
  };

  // A warp keeps one span of kWarpNT n8 tiles of the channel slice, its B
  // fragments and bias in registers. Within the span, fragment column 2t+e
  // of n-tile j is channel 32 (j / 4) + 8t + 2 (j % 4) + e: the B rows are
  // loaded in that order, so after the span each thread holds 8 adjacent
  // channels of its pixel per 4 n-tiles, stored as 16 B straight from
  // registers (no shared staging).
  const int span = warp % kSpans;
  uint32_t bw[kWarpNT][KS::kPairs];
  float2 bv[kWarpNT];
  int loaded_fc = -1;

  // The input window of a tile, kInRows x kInCols x C values with the halo
  // (zero outside the image), is fetched into registers one tile ahead so
  // that its loads are in flight while the current tile multiplies.
  constexpr int kWin = kInRows * kInCols * C;
  constexpr int kFetch = (kWin + kThreads - 1) / kThreads;
  float win[kFetch];
  auto fetch = [&](int tile) {
    const Tile tl = tile_at(tile, B, nr, nc);
    const float* xb = x + (size_t)tl.b * H * W * C;
    const int gy0 = 2 * tl.a0 - 1, gxc0 = (2 * tl.j0 - 1) * C;
#pragma unroll
    for (int u = 0; u < kFetch; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / (kInCols * C);
      const int gy = gy0 + r, gxc = gxc0 + (i - r * (kInCols * C));
      win[u] = (i < kWin && gy >= 0 && gy < H && gxc >= 0 && gxc < W * C)
                   ? xb[(size_t)gy * W * C + gxc] : 0.0f;
    }
  };
  if (blockIdx.x < tiles) fetch(blockIdx.x);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile tl = tile_at(tile, B, nr, nc);
    const int a0 = tl.a0, j0 = tl.j0, fs = tl.fc * kFB + 8 * kWarpNT * span;

    __syncthreads();  // the last tile's fragments are read
#pragma unroll
    for (int u = 0; u < kFetch; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < kWin) xs[i] = __bfloat16_as_ushort(__float2bfloat16_rn(win[u]));
    }
    if (tl.fc != loaded_fc) {
#pragma unroll
      for (int j = 0; j < kWarpNT; ++j) {
        const int row = fs + 32 * (j / 4) + 8 * (g / 2) + 2 * (j % 4) + g % 2;
#pragma unroll
        for (int i = 0; i < KS::kPairs; ++i)
          bw[j][i] = *reinterpret_cast<const uint32_t*>(
              wt + (size_t)row * KS::kPadded + pair_k<C>(i, t));
        bv[j] = *reinterpret_cast<const float2*>(
            &bias[fs + 32 * (j / 4) + 8 * t + 2 * (j % 4)]);
      }
      loaded_fc = tl.fc;
    }
    __syncthreads();
    if (tile + gridDim.x < tiles) fetch(tile + gridDim.x);

    for (int q = warp / kSpans; q < kGroups; q += kWarps / kSpans) {
      const int la = q / (kCols / 8), lj0 = (q % (kCols / 8)) * 8;
      const int a = a0 + la, jg = j0 + lj0;
      if (a >= H2 || jg >= W2) continue;  // warp-uniform

      // A fragments of both m16 tiles (pool rows 0 and 1), phase columns
      // 0 (rows g) and 1 (rows g+8)
      uint32_t af[2][kA];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int base0 = ((2 * la + mt) * kInCols + 2 * (lj0 + g)) * C, base1 = base0 + C;
#pragma unroll
        for (int s = 0; s < KS::k16; ++s) {
          af[mt][4 * s + 0] = pair(base0, 2 * s);
          af[mt][4 * s + 1] = pair(base1, 2 * s);
          af[mt][4 * s + 2] = pair(base0, 2 * s + 1);
          af[mt][4 * s + 3] = pair(base1, 2 * s + 1);
        }
        if constexpr (KS::k8) {
          af[mt][4 * KS::k16 + 0] = pair(base0, 2 * KS::k16);
          af[mt][4 * KS::k16 + 1] = pair(base1, 2 * KS::k16);
        }
      }

      uint32_t res[kWarpNT];
#pragma unroll
      for (int j = 0; j < kWarpNT; ++j) {
        float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int s = 0; s < KS::k16; ++s) {
          mma16(d0, &af[0][4 * s], bw[j][2 * s], bw[j][2 * s + 1]);
          mma16(d1, &af[1][4 * s], bw[j][2 * s], bw[j][2 * s + 1]);
        }
        if constexpr (KS::k8) {
          mma8(d0, &af[0][4 * KS::k16], bw[j][2 * KS::k16]);
          mma8(d1, &af[1][4 * KS::k16], bw[j][2 * KS::k16]);
        }
        // d[0..1]: row g (phase column 0), d[2..3]: row g+8 (column 1)
        const float m0 = fmaxf(fmaxf(d0[0], d0[2]), fmaxf(d1[0], d1[2]));
        const float m1 = fmaxf(fmaxf(d0[1], d0[3]), fmaxf(d1[1], d1[3]));
        const __nv_bfloat162 y = __floats2bfloat162_rn(leaky(m0 + bv[j].x, slope),
                                                       leaky(m1 + bv[j].y, slope));
        res[j] = *reinterpret_cast<const uint32_t*>(&y);
      }

      if (jg + g >= W2) continue;
      __nv_bfloat16* dst = out + (((size_t)tl.b * H2 + a) * W2 + jg + g) * F + fs + 8 * t;
#pragma unroll
      for (int r = 0; r < kWarpNT / 4; ++r) {
        const int f = fs + 32 * r + 8 * t;
        if (F % 8 == 0) {
          if (f < F)
            *reinterpret_cast<uint4*>(dst + 32 * r) =
                make_uint4(res[4 * r], res[4 * r + 1], res[4 * r + 2], res[4 * r + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (f + e < F)
              dst[32 * r + e] = __ushort_as_bfloat16((uint16_t)(res[4 * r + e / 2] >> (16 * (e % 2))));
        }
      }
    }
  }
}

template <int C>
cudaError_t launch(const float* x, const __nv_bfloat16* wt, const float* bias,
                   __nv_bfloat16* out, int B, int H, int W, int F, float slope,
                   cudaStream_t stream) {
  const long long tiles = (long long)B * ((F + kFB - 1) / kFB) *
                          ((H / 2 + kRows - 1) / kRows) *
                          ((W / 2 + kCols - 1) / kCols);
  if (tiles == 0) return cudaSuccess;
  if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  static int per_sm = 0;  // resident blocks per SM, asked once per C
  cudaError_t err;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_input_block_kernel<C>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long grid = tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm;
  fused_input_block_kernel<C><<<(int)grid, kThreads, 0, stream>>>(
      x, wt, bias, out, B, H, W, F, slope);
  return cudaGetLastError();
}

template <int C>
cudaError_t resources(int* regs, int* shared_bytes, int* local_bytes,
                      int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fused_input_block_kernel<C>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *shared_bytes = (int)attr.sharedSizeBytes;
  *local_bytes = (int)attr.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fused_input_block_kernel<C>, kThreads, 0);
}

}  // namespace

// Plain C entry points for ctypes.
//
// fused_input_block_launch: x f32 (B,H,W,C) NHWC contiguous; wt bf16
// (F',K') packed weights (kernel * scale, K in (dh, dw, c) order, K' as in
// KSteps, F' = F rounded up to 128, zero padded); bias f32 (F',); out bf16
// (B,H/2,W/2,F), 16-byte aligned. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int fused_input_block_launch(const void* x, const void* wt,
                                        const void* bias, void* out, int B,
                                        int H, int W, int C, int F,
                                        float slope, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const __nv_bfloat16* wf = static_cast<const __nv_bfloat16*>(wt);
  const float* bf = static_cast<const float*>(bias);
  __nv_bfloat16* of = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(xf, wf, bf, of, B, H, W, F, slope, s);
    case 2: return launch<2>(xf, wf, bf, of, B, H, W, F, slope, s);
    case 3: return launch<3>(xf, wf, bf, of, B, H, W, F, slope, s);
    case 4: return launch<4>(xf, wf, bf, of, B, H, W, F, slope, s);
    default: return cudaErrorInvalidValue;
  }
}

// fused_input_block_resources: the kernel's registers per thread, static
// shared memory and local (spill) memory per block in bytes, and resident
// blocks per SM at its block size, for input channels C. Returns a CUDA
// error code (0 = ok).
extern "C" int fused_input_block_resources(int C, int* regs, int* shared_bytes,
                                           int* local_bytes, int* blocks_per_sm,
                                           int* threads) {
  *threads = kThreads;
  switch (C) {
    case 1: return resources<1>(regs, shared_bytes, local_bytes, blocks_per_sm);
    case 2: return resources<2>(regs, shared_bytes, local_bytes, blocks_per_sm);
    case 3: return resources<3>(regs, shared_bytes, local_bytes, blocks_per_sm);
    case 4: return resources<4>(regs, shared_bytes, local_bytes, blocks_per_sm);
    default: return cudaErrorInvalidValue;
  }
}
