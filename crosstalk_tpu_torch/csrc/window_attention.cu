// SwinV2's scaled cosine attention in windows of 64 tokens, head size 32,
// forward and backward, bf16 in and out, f32 inside:
//   u = q / sqrt(|q|^2 + 32 eps),  w = k / sqrt(|k|^2 + 32 eps)
//   out = softmax(s_h u w^T + bias) v
// for every (window, head) of a SwinV2 block (ops/window_attention.py says
// what each input holds, and gives the same algorithm in plain PyTorch).
//
// Replaces no TPU kernel (the JAX package has no SwinV2). It was added
// because torch's chain for this attention (q and k permuted and cast for
// rms_norm, two norm passes each way, SDPA with a float mask whose
// gradient it writes for every window and then sums over the batch, the
// output's transpose) took most of a SwinV2-B train step on an H100.
//
// Bound. An item (one window, one head) is 64 x 32 of q, k and v (12 KB
// of bf16 read, 4 KB of output written) and ~1 MFLOP of products: ~60
// FLOP a byte, far below the ~295 at which the tensor cores would bind,
// so both directions are bound by device memory (3.35 TB/s). The forward
// moves 16 KB and 768 B of f32 statistics an item, the backward reads
// q, k, v, dout and the statistics and writes dq, dk, dv (28.75 KB), plus
// its f32 partial sums of the bias's gradient (16 KB per block, shared by
// 16 or more items). Nothing else reaches device memory: not the
// normalised q and k, not P or dS, not the (windows x heads, 64, 64)
// gradient of the bias that SDPA writes.
//
// Design.
//  * Straight from the qkv GEMM's output. q, k and v of a head are 64-byte
//    row segments of the (bw, 64, 3, h, 32) tensor, each token's segments
//    whole 16-byte cp.async copies, four threads a segment; blocks that run
//    together take neighbouring heads and windows, so together they read
//    whole token rows. The output is written as (bw, 64, h x 32) with
//    16-byte stores, rows staged through shared memory.
//  * Shared-memory tiles of 64-byte rows, each 16-byte chunk XOR-swizzled
//    by (row / 2) mod 4 (rows of 128 bytes: by row mod 8), so that
//    ldmatrix, the row-per-thread norm pass and the fragment stores are
//    free of bank conflicts.
//  * Each block works through items one after another with two item
//    buffers: the copies of the next item are in flight while it computes
//    one, so the block's own loads overlap its products (a block per item,
//    loading then computing, ran the backward 22% slower on an H100).
//  * The forward: blocks of 4 warps, as many as are resident (5 an SM at
//    96 registers), each walking items a grid apart; each warp 16 query
//    rows: the norms (one row a thread, f32), s u and w rounded to bf16
//    in place, S = (s u) w^T + bias by mma.sync m16n8k16 (bf16 in, f32
//    accumulate), the softmax in registers (a row over the 4 lanes of a
//    quad), P V with P's accumulator reused as the A fragments. The
//    m16n8k16 tiles of a 64 x 64 x 32 product are enough: the tensor
//    cores are not the limit.
//  * The backward: a block owns one row of the bias (one head, and one
//    window position where the bias holds the region mask) and a chunk of
//    the windows that share it (ops/window_attention.chunk_size sizes the
//    chunks so that the blocks fill whole waves of the 3 resident an SM
//    that ~66 KB of shared memory allow). Per item it recomputes P from the
//    saved logsumexp, forms dP = dO V^T, dS = P (dP - rowsum(P dP)) and dq
//    from dS w (query rows per warp), then, after P and dS go to shared
//    memory as bf16, dV = P^T dO and dk from dS^T (s u) (key rows per
//    warp), and the norms' gradients in f32. dS is summed over the chunk's
//    items in registers and the scale's gradient per block; a second
//    kernel adds the chunks' f32 partials in chunk order and rounds. No
//    float atomics: two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kN = 64;        // tokens of a window
constexpr int kD = 32;        // channels of a head
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// resident blocks per SM asked of ptxas: the forward's registers allow 5,
// the backward's shared memory (two item buffers) 3
constexpr int kMinBlocksForward = 5;
constexpr int kMinBlocksBackward = 3;
constexpr float kNormEps = 1e-12f;
constexpr int kTile = kN * kD * 2 / 16;   // 16-byte chunks of a 64 x 32 bf16 tile
constexpr int kSquare = kN * kN * 2 / 16;  // of a 64 x 64 bf16 tile
constexpr int kStats = 3 * kN;            // floats of statistics an item
constexpr int kReduceThreads = 256;

// chunk index of (row, 16-byte chunk c) in a swizzled tile of 64-byte rows
__device__ __forceinline__ int sw64(int row, int c) { return row * 4 + (c ^ ((row >> 1) & 3)); }
// ... of 128-byte rows
__device__ __forceinline__ int sw128(int row, int c) { return row * 8 + (c ^ (row & 7)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 (round to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// the 32-bit word holding columns (col, col + 1) of a row in a swizzled tile
__device__ __forceinline__ uint32_t* word64(uint4* tile, int row, int col) {
  return reinterpret_cast<uint32_t*>(&tile[sw64(row, col >> 3)]) + ((col & 7) >> 1);
}
__device__ __forceinline__ uint32_t* word128(uint4* tile, int row, int col) {
  return reinterpret_cast<uint32_t*>(&tile[sw128(row, col >> 3)]) + ((col & 7) >> 1);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// One row of q or k of the item, a thread each, rounded to bf16 after
// scaling by f (r s for q, r for k) into `normed`: r = 1 / sqrt(|x|^2 +
// 32 eps) computed in f32 and written to `r_out`, or, where `r_out` is
// null, the saved `r_saved`.
__device__ __forceinline__ void norm_row(const uint4* raw, uint4* normed, int row, float r_saved,
                                         float scale, bool is_q, float* r_out) {
  uint4 v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = raw[sw64(row, c)];
  float r = r_saved;
  if (r_out != nullptr) {
    float ss = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&v[c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = unpack(w[e]);
        ss += x.x * x.x;
        ss += x.y * x.y;
      }
    }
    r = 1.0f / sqrtf(ss + kD * kNormEps);
    *r_out = r;
  }
  const float f = is_q ? r * scale : r;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t* w = reinterpret_cast<uint32_t*>(&v[c]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = unpack(w[e]);
      w[e] = pack(x.x * f, x.y * f);
    }
    normed[sw64(row, c)] = v[c];
  }
}

// acc (16 x 64, a warp's rows) = A (rows a_row0.., 64-byte rows, k = 32)
// times B^T (64 rows of 64 bytes): S = (s u) w^T, or dP = dO V^T
__device__ __forceinline__ void rows_times_rows(float (&acc)[8][4], const uint4* a_tile,
                                                const uint4* b_tile, int a_row0, int lane) {
  uint32_t a[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    ldsm4(a[kk], &a_tile[sw64(a_row0 + (lane & 15), 2 * kk + (lane >> 4))]);
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jn][e] = 0.0f;
    uint32_t b[4];
    ldsm4(b, &b_tile[sw64(jn * 8 + (lane & 7), lane >> 3)]);
    mma16(acc[jn], a[0], b[0], b[1]);
    mma16(acc[jn], a[1], b[2], b[3]);
  }
}

// out (16 x 32) += A (16 x 64, k16 step kk's A fragments) times the 16
// rows kk.. of a 64 x 32 tile of 64-byte rows (ldmatrix.trans)
__device__ __forceinline__ void step_times_tile(float (&out)[4][4], const uint32_t (&a)[4],
                                                const uint4* tile, int kk, int lane) {
  const int row = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int jd = 0; jd < 4; jd += 2) {
    uint32_t b[4];
    ldsm4t(b, &tile[sw64(row, jd + (lane >> 4))]);
    mma16(out[jd], a, b[0], b[1]);
    mma16(out[jd + 1], a, b[2], b[3]);
  }
}

// A fragments of k16 step kk from a 16 x 64 accumulator (rows g, g + 8)
__device__ __forceinline__ void acc_as_a(uint32_t (&a)[4], const float (&acc)[8][4], int kk) {
  a[0] = pack(acc[2 * kk][0], acc[2 * kk][1]);
  a[1] = pack(acc[2 * kk][2], acc[2 * kk][3]);
  a[2] = pack(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  a[3] = pack(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

// out (16 x 32, a warp's key rows key0..) = T^T (T: 64 x 64 bf16 tile of
// 128-byte rows, its columns key0..) times a 64 x 32 tile
__device__ __forceinline__ void cols_times_tile(float (&out)[4][4], const uint4* t_tile,
                                                const uint4* tile, int key0, int lane) {
#pragma unroll
  for (int jd = 0; jd < 4; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[jd][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    ldsm4t(a, &t_tile[sw128(16 * kk + (lane & 7) + (lane >> 4) * 8,
                            key0 / 8 + ((lane >> 3) & 1))]);
    step_times_tile(out, a, tile, kk, lane);
  }
}

// The gradient through x -> x r (r = 1 / sqrt(|x|^2 + 32 eps)) for the
// thread's two rows: g (16 x 32 fragments, the gradient of x r times f / r)
// becomes f (g - x r (x r . g)), written as bf16 over x's rows in `raw`.
// Returns the rows' x r . g summed over the thread's two rows (whole rows
// after the quad sum).
__device__ __forceinline__ float norm_grad(uint4* raw, const float (&g)[4][4], int row0, int t,
                                           float r0, float r1, float f0, float f1) {
  float u[4][4];
  float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
  for (int jd = 0; jd < 4; ++jd) {
    const float2 x0 = unpack(*word64(raw, row0, 8 * jd + 2 * t));
    const float2 x1 = unpack(*word64(raw, row0 + 8, 8 * jd + 2 * t));
    u[jd][0] = x0.x * r0;
    u[jd][1] = x0.y * r0;
    u[jd][2] = x1.x * r1;
    u[jd][3] = x1.y * r1;
    p0 += u[jd][0] * g[jd][0] + u[jd][1] * g[jd][1];
    p1 += u[jd][2] * g[jd][2] + u[jd][3] * g[jd][3];
  }
  p0 = quad_sum(p0);
  p1 = quad_sum(p1);
  __syncwarp();
#pragma unroll
  for (int jd = 0; jd < 4; ++jd) {
    *word64(raw, row0, 8 * jd + 2 * t) =
        pack(f0 * (g[jd][0] - u[jd][0] * p0), f0 * (g[jd][1] - u[jd][1] * p0));
    *word64(raw, row0 + 8, 8 * jd + 2 * t) =
        pack(f1 * (g[jd][2] - u[jd][2] * p1), f1 * (g[jd][3] - u[jd][3] * p1));
  }
  return p0 + p1;
}

// Copies of q, k, v (tiles 0-2) and, where `tiles` is 4, dO (tile 3) of
// window w, head hd into `buf`: 16-byte cp.async copies, four threads a
// 64-byte row segment.
__device__ __forceinline__ void load_item(uint4* buf, const bf16* qkv, const bf16* dout, int w,
                                          int hd, int64_t c, int tiles, int tid) {
  const bf16* src = qkv + (int64_t)w * kN * 3 * c + hd * kD;
  for (int i = tid; i < tiles * kTile; i += kThreads) {
    const int mat = i / kTile, row = (i >> 2) & (kN - 1), ch = i & 3;
    cp_async16(&buf[mat * kTile + sw64(row, ch)],
               mat < 3 ? src + row * 3 * c + mat * c + ch * 8
                       : dout + ((int64_t)w * kN + row) * c + hd * kD + ch * 8);
  }
}

// A block walks items blockIdx.x, + gridDim.x, ... (item = window x heads
// + head), the copies of the next in flight while it computes one.
__global__ void __launch_bounds__(kThreads, kMinBlocksForward)
window_attention_forward_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                                const bf16* __restrict__ scale, bf16* __restrict__ out,
                                float* __restrict__ stats, int items, int heads,
                                int bias_windows) {
  __shared__ __align__(128) uint4 tiles[2][3 * kTile];  // q, k, v of two items
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * wid + g;  // the thread's query rows row0, row0 + 8
  const int64_t c = (int64_t)heads * kD;
  int item = blockIdx.x;
  load_item(tiles[0], qkv, nullptr, item / heads, item % heads, c, 3, tid);
  cp_async_commit();
  for (int it = 0; item < items; ++it, item += gridDim.x) {
    uint4* qt = tiles[it & 1];
    uint4* kt = qt + kTile;
    uint4* vt = qt + 2 * kTile;
    const int w = item / heads, hd = item - w * heads;
    const int next = item + gridDim.x;
    if (next < items) {
      load_item(tiles[(it + 1) & 1], qkv, nullptr, next / heads, next % heads, c, 3, tid);
      cp_async_commit();
    }
    // the bias at the thread's accumulator positions, while the copies fly
    const uint32_t* bp = reinterpret_cast<const uint32_t*>(
        bias + (int64_t)((w % bias_windows) * heads + hd) * kN * kN);
    uint32_t bfrag[8][2];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      bfrag[jn][0] = __ldg(bp + (row0 * kN + 8 * jn + 2 * t) / 2);
      bfrag[jn][1] = __ldg(bp + ((row0 + 8) * kN + 8 * jn + 2 * t) / 2);
    }
    const float s_h = __bfloat162float(scale[hd]);
    float* item_stats = stats + (int64_t)item * kStats;
    if (next < items)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();

    {  // q rows (threads 0-63) and k rows (64-127), normalised in place
      const int mat = tid >> 6, row = tid & (kN - 1);
      float r;
      norm_row(qt + mat * kTile, qt + mat * kTile, row, 0.0f, s_h, mat == 0, &r);
      item_stats[mat * kN + row] = r;
    }
    __syncthreads();

    float s[8][4];
    rows_times_rows(s, qt, kt, 16 * wid, lane);
    float top0 = -INFINITY, top1 = -INFINITY;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float2 b0 = unpack(bfrag[jn][0]), b1 = unpack(bfrag[jn][1]);
      s[jn][0] += b0.x;
      s[jn][1] += b0.y;
      s[jn][2] += b1.x;
      s[jn][3] += b1.y;
      top0 = fmaxf(top0, fmaxf(s[jn][0], s[jn][1]));
      top1 = fmaxf(top1, fmaxf(s[jn][2], s[jn][3]));
    }
    top0 = quad_max(top0);
    top1 = quad_max(top1);
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      s[jn][0] = __expf(s[jn][0] - top0);
      s[jn][1] = __expf(s[jn][1] - top0);
      s[jn][2] = __expf(s[jn][2] - top1);
      s[jn][3] = __expf(s[jn][3] - top1);
      l0 += s[jn][0] + s[jn][1];
      l1 += s[jn][2] + s[jn][3];
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);

    float o[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_as_a(a, s, kk);
      step_times_tile(o, a, vt, kk, lane);
    }
    // the warp's rows of q are its own: stage the output there
    __syncwarp();
#pragma unroll
    for (int jd = 0; jd < 4; ++jd) {
      *word64(qt, row0, 8 * jd + 2 * t) = pack(o[jd][0] / l0, o[jd][1] / l0);
      *word64(qt, row0 + 8, 8 * jd + 2 * t) = pack(o[jd][2] / l1, o[jd][3] / l1);
    }
    if (t == 0) {
      item_stats[2 * kN + row0] = top0 + logf(l0);
      item_stats[2 * kN + row0 + 8] = top1 + logf(l1);
    }
    __syncwarp();
    bf16* dst = out + (int64_t)w * kN * c + hd * kD;
#pragma unroll
    for (int i = lane; i < 16 * 4; i += 32) {
      const int row = 16 * wid + (i >> 2), ch = i & 3;
      *reinterpret_cast<uint4*>(dst + row * c + ch * 8) = qt[sw64(row, ch)];
    }
    __syncthreads();  // before the copies of item it + 2 land in this buffer
  }
}

// shared memory of the backward, in 16-byte chunks
constexpr int kItemChunks = 4 * kTile + kStats * 4 / 16;  // q, k, v, dO; rq, rk, lse
constexpr int kItems = 0;                                 // two item buffers
constexpr int kNormedQ = kItems + 2 * kItemChunks;        // s u
constexpr int kNormedK = kNormedQ + kTile;                // w
constexpr int kP = kNormedK + kTile;                      // P, bf16, 128-byte rows
constexpr int kDS = kP + kSquare;                         // dS, bf16
constexpr int kBias = kDS + kSquare;                      // the block's bias row
constexpr int kRedAt = kBias + kSquare;                   // 4 floats
constexpr int kBackwardSmem = (kRedAt + 1) * 16;

// q, k, v, dO and the statistics of window w, head hd into an item buffer
__device__ __forceinline__ void load_backward_item(uint4* buf, const bf16* qkv, const bf16* dout,
                                                   const float* stats, int w, int hd,
                                                   int heads, int tid) {
  load_item(buf, qkv, dout, w, hd, (int64_t)heads * kD, 4, tid);
  if (tid < kStats / 4)
    cp_async16(buf + 4 * kTile + tid, stats + ((int64_t)w * heads + hd) * kStats + 4 * tid);
}

__global__ void __launch_bounds__(kThreads, kMinBlocksBackward)
window_attention_backward_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                                 const bf16* __restrict__ scale,
                                 const float* __restrict__ stats,
                                 const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                                 float* __restrict__ partial, int heads, int bias_windows,
                                 int windows, int chunk, int chunks) {
  extern __shared__ __align__(128) uint4 smem[];
  uint4* nq = smem + kNormedQ;
  uint4* nk = smem + kNormedK;
  uint4* pt = smem + kP;
  uint4* ds_tile = smem + kDS;
  uint4* bt = smem + kBias;
  float* red = reinterpret_cast<float*>(smem + kRedAt);

  const int rows = bias_windows * heads;
  const int r = blockIdx.x % rows, chunk_i = blockIdx.x / rows;
  const int hd = r % heads, wi = r / heads;
  const int m_begin = chunk_i * chunk, m_end = min(m_begin + chunk, windows);
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * wid + g;  // query rows (first half), key rows (second)
  const int64_t c = (int64_t)heads * kD;

  const bf16* bsrc = bias + (int64_t)r * kN * kN;
  for (int i = tid; i < kSquare; i += kThreads)
    cp_async16(&bt[sw128(i >> 3, i & 7)], bsrc + i * 8);
  load_backward_item(smem + kItems, qkv, dout, stats, wi + bias_windows * m_begin, hd, heads,
                     tid);
  cp_async_commit();
  const float s_h = __bfloat162float(scale[hd]);

  float dbias[8][4] = {};
  float dscale = 0.0f;
  for (int m = m_begin; m < m_end; ++m) {
    uint4* raw = smem + kItems + ((m - m_begin) & 1) * kItemChunks;
    const float* st = reinterpret_cast<const float*>(raw + 4 * kTile);
    const int w = wi + bias_windows * m;
    if (m + 1 < m_end) {
      load_backward_item(smem + kItems + ((m + 1 - m_begin) & 1) * kItemChunks, qkv, dout,
                         stats, w + bias_windows, hd, heads, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    {  // s u (threads 0-63) and w (64-127) from the saved inverse norms
      const int mat = tid >> 6, row = tid & (kN - 1);
      norm_row(raw + mat * kTile, mat == 0 ? nq : nk, row, st[mat * kN + row], s_h, mat == 0,
               nullptr);
    }
    __syncthreads();

    // query rows row0, row0 + 8: dP, then P and dS over it
    float dp[8][4], p[8][4];
    rows_times_rows(dp, raw + 3 * kTile, raw + 2 * kTile, 16 * wid, lane);
    rows_times_rows(p, nq, nk, 16 * wid, lane);
    const float lse0 = st[2 * kN + row0], lse1 = st[2 * kN + row0 + 8];
    float dd0 = 0.0f, dd1 = 0.0f;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float2 b0 = unpack(*word128(bt, row0, 8 * jn + 2 * t));
      const float2 b1 = unpack(*word128(bt, row0 + 8, 8 * jn + 2 * t));
      p[jn][0] = __expf(p[jn][0] + b0.x - lse0);
      p[jn][1] = __expf(p[jn][1] + b0.y - lse0);
      p[jn][2] = __expf(p[jn][2] + b1.x - lse1);
      p[jn][3] = __expf(p[jn][3] + b1.y - lse1);
      dd0 += p[jn][0] * dp[jn][0] + p[jn][1] * dp[jn][1];
      dd1 += p[jn][2] * dp[jn][2] + p[jn][3] * dp[jn][3];
    }
    dd0 = quad_sum(dd0);
    dd1 = quad_sum(dd1);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      dp[jn][0] = p[jn][0] * (dp[jn][0] - dd0);
      dp[jn][1] = p[jn][1] * (dp[jn][1] - dd0);
      dp[jn][2] = p[jn][2] * (dp[jn][2] - dd1);
      dp[jn][3] = p[jn][3] * (dp[jn][3] - dd1);
#pragma unroll
      for (int e = 0; e < 4; ++e) dbias[jn][e] += dp[jn][e];
      *word128(pt, row0, 8 * jn + 2 * t) = pack(p[jn][0], p[jn][1]);
      *word128(pt, row0 + 8, 8 * jn + 2 * t) = pack(p[jn][2], p[jn][3]);
      *word128(ds_tile, row0, 8 * jn + 2 * t) = pack(dp[jn][0], dp[jn][1]);
      *word128(ds_tile, row0 + 8, 8 * jn + 2 * t) = pack(dp[jn][2], dp[jn][3]);
    }
    {  // d(s u) = dS w, then dq over q's rows (the warp's own)
      float dn[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        acc_as_a(a, dp, kk);
        step_times_tile(dn, a, nk, kk, lane);
      }
      const float r0 = st[row0], r1 = st[row0 + 8];
      const float along = norm_grad(raw, dn, row0, t, r0, r1, r0 * s_h, r1 * s_h);
      if (t == 0) dscale += along;
    }
    __syncthreads();  // P, dS stored; every warp done with V

    // key rows row0, row0 + 8: dV = P^T dO over v's rows, dk over k's
    {
      float dv[4][4];
      cols_times_tile(dv, pt, raw + 3 * kTile, 16 * wid, lane);
      __syncwarp();
#pragma unroll
      for (int jd = 0; jd < 4; ++jd) {
        *word64(raw + 2 * kTile, row0, 8 * jd + 2 * t) = pack(dv[jd][0], dv[jd][1]);
        *word64(raw + 2 * kTile, row0 + 8, 8 * jd + 2 * t) = pack(dv[jd][2], dv[jd][3]);
      }
    }
    {
      float dn[4][4];
      cols_times_tile(dn, ds_tile, nq, 16 * wid, lane);
      const float r0 = st[kN + row0], r1 = st[kN + row0 + 8];
      norm_grad(raw + kTile, dn, row0, t, r0, r1, r0, r1);
    }
    __syncthreads();
    bf16* out = dqkv + (int64_t)w * kN * 3 * c + hd * kD;
    for (int i = tid; i < 3 * kTile; i += kThreads) {
      const int mat = i / kTile, row = (i >> 2) & (kN - 1), ch = i & 3;
      *reinterpret_cast<uint4*>(out + row * 3 * c + mat * c + ch * 8) =
          raw[mat * kTile + sw64(row, ch)];
    }
    __syncthreads();  // before the copies of item m + 2 land in this buffer
  }

  float* pb = partial + ((int64_t)chunk_i * rows + r) * kN * kN;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    *reinterpret_cast<float2*>(pb + row0 * kN + 8 * jn + 2 * t) =
        make_float2(dbias[jn][0], dbias[jn][1]);
    *reinterpret_cast<float2*>(pb + (row0 + 8) * kN + 8 * jn + 2 * t) =
        make_float2(dbias[jn][2], dbias[jn][3]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dscale += __shfl_xor_sync(0xffffffffu, dscale, off);
  if (lane == 0) red[wid] = dscale;
  __syncthreads();
  if (tid == 0)
    partial[(int64_t)chunks * rows * kN * kN + (int64_t)chunk_i * rows + r] =
        red[0] + red[1] + red[2] + red[3];
}

// dbias = the chunks' partial sums added in chunk order; the last block
// adds each head's scale partials (chunk, then bias row) into dscale.
__global__ void __launch_bounds__(kReduceThreads)
window_attention_reduce_kernel(const float* __restrict__ partial, bf16* __restrict__ dbias,
                               bf16* __restrict__ dscale, int rows, int chunks, int heads) {
  const int64_t total = (int64_t)rows * kN * kN;
  if (blockIdx.x == gridDim.x - 1) {
    const float* ps = partial + (int64_t)chunks * total;
    for (int h = threadIdx.x; h < heads; h += kReduceThreads) {
      float acc = 0.0f;
      for (int ch = 0; ch < chunks; ++ch)
        for (int r = h; r < rows; r += heads) acc += ps[(int64_t)ch * rows + r];
      dscale[h] = __float2bfloat16(acc);
    }
    return;
  }
  const int64_t e = (int64_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= total) return;
  float acc = 0.0f;
  for (int ch = 0; ch < chunks; ++ch) acc += partial[(int64_t)ch * total + e];
  dbias[e] = __float2bfloat16(acc);
}

bool valid(int64_t windows, int heads, int bias_rows) {
  return windows > 0 && heads > 0 && bias_rows > 0 && bias_rows % heads == 0 &&
         windows % (bias_rows / heads) == 0 && windows * heads < ((int64_t)1 << 31);
}

}  // namespace

// Plain C entry points for ctypes. Every tensor is contiguous, bf16 but
// the f32 stats and partial, 16-byte aligned: qkv (windows, 64, 3, heads,
// 32), bias (bias_rows, 64, 64) with bias_rows = m heads, m dividing
// windows (window w reads row (w mod m) heads + head), scale (heads). Each
// returns cudaGetLastError() after its launches (0 = launched).
//
// window_attention_forward_launch: out (windows, 64, heads x 32); stats
// (windows, heads, 3, 64) f32 = 1/|q|, 1/|k|, logsumexp.
extern "C" int window_attention_forward_launch(const void* qkv, const void* bias,
                                               const void* scale, void* out, void* stats,
                                               int64_t windows, int heads, int bias_rows,
                                               void* stream) {
  if (!valid(windows, heads, bias_rows) || stats == nullptr) return cudaErrorInvalidValue;
  // one block per resident slot of every SM (asked once per device), each
  // walking items a grid apart
  static int resident[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int slots = dev < 64 ? resident[dev] : 0;
  if (slots == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_attention_forward_kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    slots = per_sm * sms;
    if (dev < 64) resident[dev] = slots;
  }
  const int items = (int)(windows * heads);
  window_attention_forward_kernel<<<items < slots ? items : slots, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(scale), static_cast<bf16*>(out), static_cast<float*>(stats),
      items, heads, bias_rows / heads);
  return cudaGetLastError();
}

// window_attention_backward_launch: dqkv like qkv, dbias like bias, dscale
// (heads), from the forward's stats and dout (windows, 64, heads x 32).
// `chunk`: windows of one bias row per block; partial: f32 scratch of
// chunks x bias_rows x (64 x 64 + 1), chunks = ceil(windows / m / chunk).
extern "C" int window_attention_backward_launch(const void* qkv, const void* bias,
                                                const void* scale, const void* stats,
                                                const void* dout, void* dqkv, void* dbias,
                                                void* dscale, void* partial, int64_t windows,
                                                int heads, int bias_rows, int chunk,
                                                void* stream) {
  if (!valid(windows, heads, bias_rows) || chunk <= 0 || stats == nullptr)
    return cudaErrorInvalidValue;
  static bool sized[64] = {};  // per device: the kernel's shared memory above 48 KB
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(window_attention_backward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kBackwardSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) sized[dev] = true;
  }
  const int per_row = (int)(windows / (bias_rows / heads));
  const int chunks = (per_row + chunk - 1) / chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  window_attention_backward_kernel<<<chunks * bias_rows, kThreads, kBackwardSmem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(scale), static_cast<const float*>(stats),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), static_cast<float*>(partial),
      heads, bias_rows / heads, per_row, chunk, chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t total = (int64_t)bias_rows * kN * kN;
  const int blocks = (int)((total + kReduceThreads - 1) / kReduceThreads) + 1;
  window_attention_reduce_kernel<<<blocks, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<bf16*>(dbias), static_cast<bf16*>(dscale),
      bias_rows, chunks, heads);
  return cudaGetLastError();
}
