// Hand-written Hopper (sm_90a) kernels for the pipeline-M adapters (K1-K3,
// forward and backward) and the T/V feature adapter (K6, at the end).
//
// Port of the Pallas TPU kernels in vlm_clip_tpu/ops/fused_adapter.py:
//
//   seq_adapter_fwd       <- _seq_fwd_kernel   (fused_adapter.py:310)
//       y = LN(x + gelu(x@W1 + b1)@W2 + b2), all math fp32 (weights fp32)
//   cross_attn_block_fwd  <- _cab_fwd_kernel   (fused_adapter.py:796)
//       u = LN(x@Wt + bt); q = u@Wq + bq;
//       o = per-head softmax(q.k^T * scale).v against a K/V shared by
//       every row; y = u + o@Wo + bo
//   prenorm_mlp_fwd       <- _pnmlp_fwd_kernel (fused_adapter.py:532)
//       y = x + gelu(LN(x)@W1 + b1)@W2 + b2, the 4H hidden walked in
//       128-column chunks and never stored
//
// Precision follows each TPU kernel: K1 computes in fp32 on the input
// widened to fp32. K2 and K3 round every matmul operand to the input
// type T (bf16 under the serving policy) and accumulate in fp32; LN and
// softmax statistics are fp32. Products of bf16 values are exact in
// fp32, so fp32 FMAs on rounded operands give what a bf16 MMA with fp32
// accumulation gives, up to summation order. GELU uses erff (the TPU
// kernels use an erf polynomial because Mosaic has no erf).
//
// Design (first, simple version). One block of 256 threads owns a tile
// of 32 rows and keeps every intermediate of those rows in shared memory
// (at most 180 KB, so one block per SM). Each matmul walks its weight in
// 32-deep slabs staged through shared memory; a thread accumulates a
// 4-row by 4-column register tile in fp32 on the CUDA cores. The ragged
// last row tile is masked, not padded, and so is a ragged last column
// chunk: the kernels take every width, as the TPU kernels do (K2 heads
// of any width, at most SMAX shared K/V rows). What bounds these kernels
// on the H100: they are compute-bound in fp32 FMA (about 14-31 GFLOP per
// call at the B=96 shapes against 67 TFLOP/s of fp32 FMA) and move little
// memory (weights stay in the 50 MB L2, each row is read and written
// once), so the next step is wgmma on bf16 operands, which this layout
// leaves open.
//
// In bf16, K3 and K2 (forward and backward) and the bf16 x bf16 weight
// gradients are redesigned for the tensor cores (the sections "bf16 on
// the tensor cores" below): at the train step's shapes fp32 FMAs bound
// the first versions at 0.4-1.2 ms a call, the tensor cores at 0.03-0.08
// ms, so each row pass is split into mma.sync products over 128-row
// tiles that fill the card, with the GELU, its derivative, the roundings
// and the column sums fused into their epilogues, and K2's attention in
// one pass per (row tile, head). The fp32 instantiations keep the
// CUDA-core row passes: one TF32 pass would round fp32 operands. K1,
// whose function is fp32 in both dtypes, runs forward and backward on the
// TF32 tensor cores error-compensated (the last section), as do the fp32
// weight gradients; its first, CUDA-core kernels stay for the widths
// those passes do not take. So does K2's forward in fp32 and, in bf16, at
// widths its tensor-core passes do not take (heads not a multiple of 8
// columns, or wider than 128).
//
// K2 does not port the TPU kernel's block-diagonal K/V packing (a lane
// trick): it loops over the heads on K^T [H, Tk] and V [Tk, H] directly,
// and takes the softmax max per head (the TPU kernel takes one max per
// row over all heads, which can underflow a head far below another).
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"
#include "mma.cuh"

namespace {

constexpr int ROWS = 32;   // rows of x per block
constexpr int NT = 256;    // threads per block: 8 warps
constexpr int KC = 32;     // depth of one staged weight slab
constexpr int SMAX = 256;  // max shared K/V rows in cross_attn_block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v after a round trip through T: the reference's .astype(mm)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Matmul of the block's row tile against a slice of a weight:
//   acc[i][j] = sum_{k < kd} A[(ty*RPW + i)*lda + k] * W(k, col0 + tx + 32*j)
// with ty = warp, tx = lane, W(k, c) = W[k*ldw + c] (row-major weight) or,
// when TR, W[c*ldw + k] (the product with the weight's transpose, as the
// backward kernels need). A is a [RPW*8, >= kd] fp32 tile in shared
// memory, rounded to TA as it is read when RA. W lies in global memory
// and is staged through `slab` (KC x 32*NJ floats, one more per row when
// TR so the transposing store hits distinct banks); columns at or past
// ncols read as 0. Starts with a barrier, so writes made to A before the
// call are visible; leaves `slab` in use until the next call's barrier.
template <int NJ, bool RA, typename TA, bool TR = false, int RPW = 4,
          typename TW = float>
__device__ __forceinline__ void tile_gemm(const float* A, int lda, int kd,
                                          const TW* __restrict__ W, int ldw,
                                          int col0, int ncols, float* slab,
                                          float (&acc)[RPW][NJ]) {
  constexpr int NC = 32 * NJ;
  constexpr int SLD = TR ? NC + 1 : NC;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  const float* a_rows = A + (ty * RPW) * lda;
  for (int k0 = 0; k0 < kd; k0 += KC) {
    __syncthreads();
    if (TR) {
      // neighbouring threads read neighbouring k (contiguous in W)
      for (int e = tid; e < KC * NC; e += NT) {
        const int kk = e % KC, c = e / KC;
        const int k = k0 + kk, col = col0 + c;
        slab[kk * SLD + c] =
            (k < kd && col < ncols) ? to_f(W[(size_t)col * ldw + k]) : 0.f;
      }
    } else {
      for (int e = tid; e < KC * NC; e += NT) {
        const int kk = e / NC, c = e % NC;
        const int k = k0 + kk, col = col0 + c;
        slab[e] = (k < kd && col < ncols) ? to_f(W[(size_t)k * ldw + col])
                                          : 0.f;
      }
    }
    __syncthreads();
    const int kn = min(KC, kd - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float a[RPW], w[NJ];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        a[i] = a_rows[i * lda + k0 + kk];
        if (RA) a[i] = round_to<TA>(a[i]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) w[j] = slab[kk * SLD + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
}

// x rows [r0, r0 + R) -> fp32 tile X (ld = ldx); rows past n are 0.
template <typename T, int R = ROWS>
__device__ void load_rows(const T* __restrict__ x, int n, int h, int r0,
                          float* X, int ldx) {
  for (int e = threadIdx.x; e < R * h; e += NT) {
    const int r = e / h, c = e % h;
    X[r * ldx + c] = (r0 + r < n) ? to_f(x[(size_t)(r0 + r) * h + c]) : 0.f;
  }
}

// U = LN(Z) row by row (R rows, one warp per row), rounded to TR. U may
// alias Z. Statistics in fp32: mean, then the mean of squared deviations.
template <typename TR, int R = ROWS>
__device__ void ln_rows(const float* Z, float* U, int h,
                        const float* __restrict__ ls,
                        const float* __restrict__ lb, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += NT / 32) {
    const float* z = Z + r * h;
    float s = 0.f;
    for (int c = lane; c < h; c += 32) s += z[c];
    const float mean = warp_sum(s) / h;
    float v = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float d = z[c] - mean;
      v += d * d;
    }
    const float inv = rsqrtf(warp_sum(v) / h + eps);
    for (int c = lane; c < h; c += 32)
      U[r * h + c] = round_to<TR>((z[c] - mean) * inv * ls[c] + lb[c]);
  }
}

// fp32 tile -> y rows [r0, min(r0 + R, n)) in T.
template <typename T, int R = ROWS>
__device__ void store_rows(const float* Y, int h, T* __restrict__ y, int r0,
                           int n) {
  for (int e = threadIdx.x; e < R * h; e += NT) {
    const int r = e / h, c = e % h;
    if (r0 + r < n) y[(size_t)(r0 + r) * h + c] = from_f<T>(Y[e]);
  }
}

// ---------------------------------------------------------------------------
// K1: sequence adapter, y = LN(x + gelu(x@W1 + b1)@W2 + b2), fp32 math
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT)
    seq_adapter_fwd_kernel(const T* __restrict__ x,
                           const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           const float* __restrict__ w2,
                           const float* __restrict__ b2,
                           const float* __restrict__ ls,
                           const float* __restrict__ lb, float eps,
                           T* __restrict__ y, int n, int h, int k) {
  extern __shared__ float smem[];
  float* X = smem;             // [ROWS][h]: x, then z = x + up + b2
  float* G = X + ROWS * h;     // [ROWS][k]: gelu(x@W1 + b1)
  float* slab = G + ROWS * k;  // [KC][128]
  const int r0 = blockIdx.x * ROWS;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[4][4];

  load_rows(x, n, h, r0, X, h);
  for (int c0 = 0; c0 < k; c0 += 128) {
    tile_gemm<4, false, float>(X, h, h, w1, k, c0, k, slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c < k) G[(ty * 4 + i) * k + c] = gelu_erf(acc[i][j] + b1[c]);
      }
  }
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, float>(G, k, k, w2, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c >= h) continue;
        float* z = &X[(ty * 4 + i) * h + c];
        *z = (*z + acc[i][j]) + b2[c];
      }
  }
  __syncthreads();
  ln_rows<float>(X, X, h, ls, lb, eps);
  __syncthreads();
  store_rows(X, h, y, r0, n);
}

// ---------------------------------------------------------------------------
// K3: pre-norm MLP, y = x + gelu(LN(x)@W1 + b1)@W2 + b2
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT)
    prenorm_mlp_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                           const float* __restrict__ b1,
                           const T* __restrict__ w2,
                           const float* __restrict__ b2,
                           const float* __restrict__ ls,
                           const float* __restrict__ lb, float eps,
                           T* __restrict__ y, int n, int h, int k) {
  extern __shared__ float smem[];
  float* X = smem;              // [ROWS][h]: x, then x + b2 + sum of chunks
  float* U = X + ROWS * h;      // [ROWS][h]: LN(x) rounded to T
  float* G = U + ROWS * h;      // [ROWS][128]: one hidden chunk, rounded
  float* slab = G + ROWS * 128;  // [KC][128]
  const int r0 = blockIdx.x * ROWS;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[4][4];

  load_rows(x, n, h, r0, X, h);
  __syncthreads();
  ln_rows<T>(X, U, h, ls, lb, eps);
  __syncthreads();
  for (int e = threadIdx.x; e < ROWS * h; e += NT) X[e] += b2[e % h];
  for (int k0 = 0; k0 < k; k0 += 128) {
    const int kc = min(128, k - k0);  // columns of this chunk
    tile_gemm<4, false, T>(U, h, h, w1, k, k0, k, slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 32 * j;
        if (c < kc)
          G[(ty * 4 + i) * 128 + c] =
              round_to<T>(gelu_erf(acc[i][j] + b1[k0 + c]));
      }
    for (int c0 = 0; c0 < h; c0 += 128) {
      tile_gemm<4, false, T>(G, 128, kc, w2 + (size_t)k0 * h, h, c0, h,
                             slab, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 32 * j;
          if (c < h) X[(ty * 4 + i) * h + c] += acc[i][j];
        }
    }
  }
  __syncthreads();
  store_rows(X, h, y, r0, n);
}

// ---------------------------------------------------------------------------
// K2: cross-modal attention block against a batch-shared K/V, heads of
// hd = h / heads columns (any width). R rows a block: 32, or 16 where 32
// rows' tiles would not fit in shared memory (H or Din past about 700).
// fp32, and bf16 at the widths the tensor-core passes do not take.
// ---------------------------------------------------------------------------
template <typename T, int R>
__global__ void __launch_bounds__(NT)
    cross_attn_block_fwd_kernel(
        const T* __restrict__ x, const T* __restrict__ wt,
        const float* __restrict__ bt, const float* __restrict__ ls,
        const float* __restrict__ lb, const T* __restrict__ wq,
        const float* __restrict__ bq, const T* __restrict__ kt,
        const T* __restrict__ v, const T* __restrict__ wo,
        const float* __restrict__ bo, float eps, float scale,
        T* __restrict__ y, int n, int din, int h, int heads, int tk) {
  constexpr int RPW = R / 8;  // rows a warp
  extern __shared__ float smem[];
  const int ldq = max(din, h);
  float* Q = smem;               // [R][ldq]: x, then q (rounded), then
                                 // the attention output o (rounded), head
                                 // by head in place of q
  float* U = Q + R * ldq;        // [R][h]: t, then u = LN(t) in fp32
  float* S = U + R * h;          // [R][SMAX]: scores, then probs
  float* slab = S + R * SMAX;    // [KC][128]
  const int r0 = blockIdx.x * R;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int lane = tx, warp = ty;
  const int hd = h / heads;
  float acc[RPW][4];
  float acc2[RPW][2];

  load_rows<T, R>(x, n, din, r0, Q, ldq);
  // t = x @ Wt + bt
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, T, false, RPW>(Q, ldq, din, wt, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c < h) U[(ty * RPW + i) * h + c] = acc[i][j] + bt[c];
      }
  }
  __syncthreads();
  ln_rows<float, R>(U, U, h, ls, lb, eps);
  // q = round(u) @ Wq + bq, kept rounded: it is the scores' operand
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, true, T, false, RPW>(U, h, h, wq, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c < h)
          Q[(ty * RPW + i) * ldq + c] = round_to<T>(acc[i][j] + bq[c]);
      }
  }
  for (int hh = 0; hh < heads; ++hh) {
    const int ho = hh * hd;
    // scores = q_h . k^T * scale over the shared rows, -inf past tk
    for (int c0 = 0; c0 < SMAX; c0 += 128) {
      tile_gemm<4, false, T, false, RPW>(Q + ho, ldq, hd,
                                         kt + (size_t)ho * tk, tk, c0, tk,
                                         slab, acc);
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 32 * j;
          S[(ty * RPW + i) * SMAX + c] =
              (c < tk) ? acc[i][j] * scale : -INFINITY;
        }
    }
    __syncthreads();
    // per-head softmax in fp32, one warp per row; probs rounded to T
    for (int r = warp; r < R; r += NT / 32) {
      float* s = S + r * SMAX;
      float m = -INFINITY;
      for (int c = lane; c < tk; c += 32) m = fmaxf(m, s[c]);
      m = warp_max(m);
      float sum = 0.f;
      for (int c = lane; c < tk; c += 32) {
        const float e = expf(s[c] - m);
        s[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int c = lane; c < tk; c += 32) s[c] = round_to<T>(s[c] / sum);
    }
    // o_h = probs @ v_h, 64 columns at a time, written over q_h (no
    // longer read)
    for (int c0 = 0; c0 < hd; c0 += 64) {
      tile_gemm<2, false, T, false, RPW>(S, SMAX, tk, v + ho, h, c0, hd,
                                         slab, acc2);
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = c0 + tx + 32 * j;
          if (c < hd)
            Q[(ty * RPW + i) * ldq + ho + c] = round_to<T>(acc2[i][j]);
        }
    }
  }
  // y = u + (o @ Wo + bo)
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, T, false, RPW>(Q, ldq, h, wo, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c >= h) continue;
        float* u = &U[(ty * RPW + i) * h + c];
        *u = *u + (acc[i][j] + bo[c]);
      }
  }
  __syncthreads();
  store_rows<T, R>(U, h, y, r0, n);
}

// ===========================================================================
// Backward kernels
// ===========================================================================
//
// The TPU kernels accumulate the weight gradients across their sequential
// grid in VMEM (dW_ref[:] += ...). Hopper blocks run in no order, so each
// backward is split in two deterministic passes (no atomics):
//
//   1. a row pass, one block per row tile: recompute the forward (nothing
//      but the inputs is saved), write dx, write the per-row operands of
//      each weight-gradient product to device memory, rounded where the
//      TPU kernel rounds them, and write the tile's column sums of each
//      vector gradient (biases, LN scale/shift) to a [tiles, V] buffer;
//   2. wgrad_kernel, shared by K1-K3: out = A^T B summed over all rows
//      (fp32), one 64x64 output tile per block, the rows split in chunks
//      when the output tiles alone cannot fill the card, the chunks'
//      partials then summed in chunk order; and colsum_kernel: the
//      [tiles, V] partials summed in tile order.
//
// The row passes are bound on the H100 by their fp32 FMAs (the same
// 32-row SIMT tiles as the forward, about twice the forward's products);
// the intermediates they write (K2: about 12 KB a row in bf16) cost
// device-memory bandwidth a fused tensor-core version would not spend.

constexpr int SLAB_T = KC * (128 + 1);  // slab that also takes TR loads
constexpr int R2 = 16;  // rows per block in K2's backward (8 past ~560 wide)

__device__ __forceinline__ float gelu_erf_grad(float v) {
  // d/dv of 0.5 v (1 + erf(v / sqrt 2)) = Phi(v) + v phi(v), exactly
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * 0.39894228040143268f * expf(-0.5f * v * v);
}

// gelu_erf(v) and gelu_erf_grad(v), the same operations, one erff.
__device__ __forceinline__ void gelu_and_grad(float v, float& h, float& d) {
  const float e = erff(v * 0.70710678118654752f);
  h = 0.5f * v * (1.f + e);
  d = 0.5f * (1.f + e) + v * 0.39894228040143268f * expf(-0.5f * v * v);
}

// Per-row mean and 1/std of an fp32 tile Z (R rows, ld = ldz, width h),
// one warp per row, as the forward's LN takes them.
template <int R>
__device__ void row_stats(const float* Z, int ldz, int h, float eps,
                          float* mean, float* inv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += NT / 32) {
    const float* z = Z + r * ldz;
    float s = 0.f;
    for (int c = lane; c < h; c += 32) s += z[c];
    const float m = warp_sum(s) / h;
    float v = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float d = z[c] - m;
      v += d * d;
    }
    const float iv = rsqrtf(warp_sum(v) / h + eps);
    if (lane == 0) {
      mean[r] = m;
      inv[r] = iv;
    }
  }
}

// out[c] = sum over the first nv rows of tile X (ld = ldx), c < w.
__device__ void col_sums(const float* X, int ldx, int w, int nv,
                         float* __restrict__ out) {
  for (int c = threadIdx.x; c < w; c += NT) {
    float s = 0.f;
    for (int r = 0; r < nv; ++r) s += X[r * ldx + c];
    out[c] = s;
  }
}

// fp32 tile (R rows, ld = ldx) -> rows [r0, r0 + nv) of y [., w] in T.
template <typename T, int R>
__device__ void store_tile(const float* X, int ldx, int w, int nv,
                           T* __restrict__ y, int r0) {
  for (int e = threadIdx.x; e < R * w; e += NT) {
    const int r = e / w, c = e % w;
    if (r < nv) y[(size_t)(r0 + r) * w + c] = from_f<T>(X[r * ldx + c]);
  }
}

// ---------------------------------------------------------------------------
// K1 backward (replaces _seq_bwd_kernel, fused_adapter.py:328): fp32 math.
// Writes dx (when asked), h = gelu(pre) [n, k], dpre [n, k], dz [n, h] in
// fp32 for dW1 = x^T dpre and dW2 = h^T dz, and per tile the column sums
// [db1 (k) | db2 (h) | dls = sum g*xhat (h) | dlb = sum g (h)].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT)
    seq_adapter_bwd_kernel(const T* __restrict__ x,
                           const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           const float* __restrict__ w2,
                           const float* __restrict__ b2,
                           const float* __restrict__ ls,
                           const T* __restrict__ g, float eps,
                           T* __restrict__ dx, float* __restrict__ h_out,
                           float* __restrict__ dpre_out,
                           float* __restrict__ dz_out,
                           float* __restrict__ part, int n, int h, int k) {
  extern __shared__ float smem[];
  float* X = smem;              // [ROWS][h]: x, z, xhat, then dz
  float* P = X + ROWS * h;      // [ROWS][k]: pre
  float* Hs = P + ROWS * k;     // [ROWS][k]: gelu(pre), then dpre
  float* slab = Hs + ROWS * k;  // SLAB_T
  float* mean = slab + SLAB_T;  // [ROWS]
  float* inv = mean + ROWS;     // [ROWS]
  const int r0 = blockIdx.x * ROWS, nv = min(ROWS, n - r0);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int lane = tx, warp = ty;
  float* pt = part + (size_t)blockIdx.x * (k + 3 * h);
  float acc[4][4];

  load_rows(x, n, h, r0, X, h);
  // pre = x @ W1 + b1; h = gelu(pre)
  for (int c0 = 0; c0 < k; c0 += 128) {
    tile_gemm<4, false, float>(X, h, h, w1, k, c0, k, slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = c0 + tx + 32 * j;
        if (c >= k) continue;
        const float pre = acc[i][j] + b1[c];
        const float hv = gelu_erf(pre);
        P[r * k + c] = pre;
        Hs[r * k + c] = hv;
        if (r < nv) h_out[(size_t)(r0 + r) * k + c] = hv;
      }
  }
  // z = x + h @ W2 + b2
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, float>(Hs, k, k, w2, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c >= h) continue;
        float* z = &X[(ty * 4 + i) * h + c];
        *z = (*z + acc[i][j]) + b2[c];
      }
  }
  __syncthreads();
  row_stats<ROWS>(X, h, h, eps, mean, inv);
  __syncthreads();
  for (int e = threadIdx.x; e < ROWS * h; e += NT) {
    const int r = e / h;
    X[e] = (X[e] - mean[r]) * inv[r];  // xhat
  }
  __syncthreads();
  // dls = sum g * xhat, dlb = sum g
  for (int c = threadIdx.x; c < h; c += NT) {
    float sgx = 0.f, sg = 0.f;
    for (int r = 0; r < nv; ++r) {
      const float gv = to_f(g[(size_t)(r0 + r) * h + c]);
      sgx += gv * X[r * h + c];
      sg += gv;
    }
    pt[k + h + c] = sgx;
    pt[k + 2 * h + c] = sg;
  }
  __syncthreads();
  // LN backward, one warp per row: dz = inv (gx - mean(gx) - xhat
  // mean(gx xhat)), gx = g ls; rows past n have g = 0, so dz = 0
  for (int r = warp; r < ROWS; r += NT / 32) {
    float* z = X + r * h;
    const T* gr = g + (size_t)(r0 + r) * h;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float gx = (r < nv ? to_f(gr[c]) : 0.f) * ls[c];
      s1 += gx;
      s2 += gx * z[c];
    }
    const float m1 = warp_sum(s1) / h, m2 = warp_sum(s2) / h;
    for (int c = lane; c < h; c += 32) {
      const float gx = (r < nv ? to_f(gr[c]) : 0.f) * ls[c];
      const float dz = inv[r] * (gx - m1 - z[c] * m2);
      z[c] = dz;
      if (r < nv) dz_out[(size_t)(r0 + r) * h + c] = dz;
    }
  }
  __syncthreads();
  col_sums(X, h, h, nv, pt + k);  // db2
  // dh = dz @ W2^T; dpre = dh * gelu'(pre)
  for (int c0 = 0; c0 < k; c0 += 128) {
    tile_gemm<4, false, float, true>(X, h, h, w2, h, c0, k, slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = c0 + tx + 32 * j;
        if (c >= k) continue;
        const float dp = acc[i][j] * gelu_erf_grad(P[r * k + c]);
        Hs[r * k + c] = dp;
        if (r < nv) dpre_out[(size_t)(r0 + r) * k + c] = dp;
      }
  }
  __syncthreads();
  col_sums(Hs, k, k, nv, pt);  // db1
  if (dx == nullptr) return;
  // dx = dz + dpre @ W1^T
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, float, true>(Hs, k, k, w1, k, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = c0 + tx + 32 * j;
        if (r < nv && c < h)
          dx[(size_t)(r0 + r) * h + c] = from_f<T>(X[r * h + c] + acc[i][j]);
      }
  }
}

// ---------------------------------------------------------------------------
// K3 backward (replaces _pnmlp_bwd_kernel, fused_adapter.py:550), the
// fp32 instantiation (bf16 runs on the tensor cores, below): matmul
// operands in T, fp32 accumulation, the 4H hidden walked in 128-column
// chunks. Writes dx, um = round(LN(x)) [n, h], hm = round(gelu(pre))
// [n, k], dpm = round(dpre) [n, k] (dW1 = um^T dpm, dW2 = hm^T g), and per
// tile [db1 = sum dpre (k) | db2 = sum g (h) | dls = sum du xhat (h) |
// dlb = sum du (h)]. Its three [ROWS][h] tiles live in shared memory
// where they fit (h up to 519), else (rows_ws not null) in the block's
// slice of a global workspace, with only P, the slab and the row stats in
// shared memory: the same operations in the same order either way.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT)
    prenorm_mlp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                           const float* __restrict__ b1,
                           const T* __restrict__ w2,
                           const float* __restrict__ ls,
                           const float* __restrict__ lb,
                           const T* __restrict__ g, float eps,
                           T* __restrict__ dx, T* __restrict__ um_out,
                           T* __restrict__ hm_out, T* __restrict__ dpm_out,
                           float* __restrict__ part,
                           float* __restrict__ rows_ws, int n, int h,
                           int k) {
  extern __shared__ float smem[];
  float* U = rows_ws == nullptr  // [ROWS][h]: round(LN(x))
                 ? smem
                 : rows_ws + (size_t)blockIdx.x * 3 * ROWS * h;
  float* G = U + ROWS * h;       // [ROWS][h]: g
  float* DU = G + ROWS * h;      // [ROWS][h]: x, then the du accumulator
  float* P = rows_ws == nullptr  // [ROWS][128]: pre, dpre, round(dpre)
                 ? DU + ROWS * h
                 : smem;
  float* slab = P + ROWS * 128;  // SLAB_T
  float* mean = slab + SLAB_T;   // [ROWS]
  float* inv = mean + ROWS;      // [ROWS]
  const int r0 = blockIdx.x * ROWS, nv = min(ROWS, n - r0);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int lane = tx, warp = ty;
  float* pt = part + (size_t)blockIdx.x * (k + 3 * h);
  float acc[4][4];

  load_rows(x, n, h, r0, DU, h);
  load_rows(g, n, h, r0, G, h);
  __syncthreads();
  row_stats<ROWS>(DU, h, h, eps, mean, inv);
  __syncthreads();
  for (int e = threadIdx.x; e < ROWS * h; e += NT) {
    const int r = e / h, c = e % h;
    U[e] = round_to<T>((DU[e] - mean[r]) * inv[r] * ls[c] + lb[c]);
    DU[e] = 0.f;
  }
  __syncthreads();
  store_tile<T, ROWS>(U, h, h, nv, um_out, r0);
  for (int k0 = 0; k0 < k; k0 += 128) {
    const int kc = min(128, k - k0);  // columns of this chunk (0 past kc)
    // this chunk's pre = um @ W1[:, k0:k0+kc] + b1
    tile_gemm<4, false, T>(U, h, h, w1, k, k0, k, slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 32 * j;
        P[(ty * 4 + i) * 128 + c] = c < kc ? acc[i][j] + b1[k0 + c] : 0.f;
      }
    // dh = g @ W2[k0:k0+kc, :]^T; dpre = dh * gelu'(pre)
    tile_gemm<4, false, T, true>(G, h, h, w2 + (size_t)k0 * h, h, 0, kc,
                                 slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 32 * j;
        const float pre = P[r * 128 + c];
        const float dp = acc[i][j] * gelu_erf_grad(pre);
        P[r * 128 + c] = dp;
        if (r < nv && c < kc) {
          const size_t at = (size_t)(r0 + r) * k + k0 + c;
          hm_out[at] = from_f<T>(gelu_erf(pre));
          dpm_out[at] = from_f<T>(dp);
        }
      }
    __syncthreads();
    col_sums(P, 128, kc, nv, pt + k0);  // db1, before rounding
    __syncthreads();
    for (int e = threadIdx.x; e < ROWS * 128; e += NT)
      P[e] = round_to<T>(P[e]);
    // du += dpm @ W1[:, k0:k0+kc]^T
    for (int c0 = 0; c0 < h; c0 += 128) {
      tile_gemm<4, false, T, true>(P, 128, kc, w1 + k0, k, c0, h, slab,
                                   acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 32 * j;
          if (c < h) DU[(ty * 4 + i) * h + c] += acc[i][j];
        }
    }
  }
  __syncthreads();
  // db2 = sum g, dls = sum du xhat, dlb = sum du (xhat again from x)
  for (int c = threadIdx.x; c < h; c += NT) {
    float sg = 0.f, sdx = 0.f, sd = 0.f;
    for (int r = 0; r < nv; ++r) {
      const float xh =
          (to_f(x[(size_t)(r0 + r) * h + c]) - mean[r]) * inv[r];
      sg += G[r * h + c];
      sdx += DU[r * h + c] * xh;
      sd += DU[r * h + c];
    }
    pt[k + c] = sg;
    pt[k + h + c] = sdx;
    pt[k + 2 * h + c] = sd;
  }
  if (dx == nullptr) return;
  // LN backward, one warp per row; dx = g + dx_ln, cast once at the end
  for (int r = warp; r < nv; r += NT / 32) {
    const T* xr = x + (size_t)(r0 + r) * h;
    const float* du = DU + r * h;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float xh = (to_f(xr[c]) - mean[r]) * inv[r];
      const float d = du[c] * ls[c];
      s1 += d;
      s2 += d * xh;
    }
    const float m1 = warp_sum(s1) / h, m2 = warp_sum(s2) / h;
    for (int c = lane; c < h; c += 32) {
      const float xh = (to_f(xr[c]) - mean[r]) * inv[r];
      const float d = du[c] * ls[c];
      dx[(size_t)(r0 + r) * h + c] =
          from_f<T>(G[r * h + c] + inv[r] * (d - m1 - xh * m2));
    }
  }
}

// ---------------------------------------------------------------------------
// K2 backward (replaces _cab_bwd_kernel, fused_adapter.py:807), per head
// against k, v [Tk, H] with the forward's per-head softmax max; operands
// rounded to T where the TPU kernel rounds them; heads of any width h /
// heads. R-row tiles: 16 (the block keeps seven [16, H]-sized tiles), or
// 8 where 16 would not fit in shared memory (H past about 560). Writes
// dx, um, qm, om, dom, dqm, dtm [n, h] and pm, dsm [n, heads*tk] in T for
// dWo = om^T g, dv_h = pm_h^T dom_h, dk_h = dsm_h^T qm_h, dWq = um^T dqm
// and dWt = x^T dtm; per tile
// [dbo = sum g | dbq = sum dqp | dls = sum du xhat | dlb = sum du |
// dbt = sum dt], each h wide.
// ---------------------------------------------------------------------------
template <typename T, int R>
__global__ void __launch_bounds__(NT) cross_attn_block_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ wt,
    const float* __restrict__ bt, const float* __restrict__ ls,
    const float* __restrict__ lb, const T* __restrict__ wq,
    const float* __restrict__ bq, const T* __restrict__ kk,
    const T* __restrict__ v, const T* __restrict__ wo,
    const T* __restrict__ g, float eps, float scale, T* __restrict__ dx,
    T* __restrict__ um_out, T* __restrict__ qm_out, T* __restrict__ om_out,
    T* __restrict__ dom_out, T* __restrict__ pm_out, T* __restrict__ dsm_out,
    T* __restrict__ dqm_out, T* __restrict__ dtm_out,
    float* __restrict__ part, int n, int din, int h, int heads, int tk) {
  extern __shared__ float smem[];
  const int ldq = max(din, h);
  float* B1 = smem;               // [R][ldq]: x, then qm
  float* U = B1 + R * ldq;       // [R][h]: t, then xhat
  float* B2 = U + R * h;         // [R][h]: um, then g, then du
  float* B3 = B2 + R * h;        // [R][h]: dom, then dt / dtm
  float* B4 = B3 + R * h;        // [R][h]: dqp, then dqm
  float* S = B4 + R * h;         // [R][SMAX]: scores, probs, dsm
  float* DP = S + R * SMAX;      // [R][SMAX]: dprobs
  float* slab = DP + R * SMAX;   // SLAB_T
  float* mean = slab + SLAB_T;    // [R]
  float* inv = mean + R;         // [R]
  const int r0 = blockIdx.x * R, nv = min(R, n - r0);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int lane = tx, warp = ty;
  const int hd = h / heads, hsz = heads * tk;
  float* pt = part + (size_t)blockIdx.x * 5 * h;
  constexpr int RPW = R / 8;  // rows a warp
  float acc[RPW][4];
  float acc2[RPW][2];

  load_rows<T, R>(x, n, din, r0, B1, ldq);
  // t = x @ Wt + bt
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, T>(B1, ldq, din, wt, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c < h) U[(ty * RPW + i) * h + c] = acc[i][j] + bt[c];
      }
  }
  __syncthreads();
  row_stats<R>(U, h, h, eps, mean, inv);
  __syncthreads();
  for (int e = threadIdx.x; e < R * h; e += NT) {
    const int r = e / h, c = e % h;
    const float xh = (U[e] - mean[r]) * inv[r];
    U[e] = xh;
    B2[e] = round_to<T>(xh * ls[c] + lb[c]);  // um
  }
  __syncthreads();
  store_tile<T, R>(B2, h, h, nv, um_out, r0);
  // qm = round(um @ Wq + bq), over x (no longer read)
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, T>(B2, h, h, wq, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c < h)
          B1[(ty * RPW + i) * ldq + c] = round_to<T>(acc[i][j] + bq[c]);
      }
  }
  __syncthreads();
  store_tile<T, R>(B1, ldq, h, nv, qm_out, r0);
  load_rows<T, R>(g, n, h, r0, B2, h);
  // dom = round(g @ Wo^T)
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, T, true>(B2, h, h, wo, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c < h) B3[(ty * RPW + i) * h + c] = round_to<T>(acc[i][j]);
      }
  }
  __syncthreads();
  store_tile<T, R>(B3, h, h, nv, dom_out, r0);
  for (int hh = 0; hh < heads; ++hh) {
    const int ho = hh * hd;
    // scores = q_h . k_h^T * scale, -inf past tk
    for (int c0 = 0; c0 < SMAX; c0 += 128) {
      tile_gemm<4, false, T, true>(B1 + ho, ldq, hd, kk + ho, h, c0, tk,
                                   slab, acc);
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 32 * j;
          S[(ty * RPW + i) * SMAX + c] =
              (c < tk) ? acc[i][j] * scale : -INFINITY;
        }
    }
    __syncthreads();
    // per-head softmax in fp32, one warp per row (probs kept in fp32)
    for (int r = warp; r < R; r += NT / 32) {
      float* s = S + r * SMAX;
      float m = -INFINITY;
      for (int c = lane; c < tk; c += 32) m = fmaxf(m, s[c]);
      m = warp_max(m);
      float sum = 0.f;
      for (int c = lane; c < tk; c += 32) {
        const float e = expf(s[c] - m);
        s[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int c = lane; c < tk; c += 32) {
        s[c] = s[c] / sum;
        if (r < nv)
          pm_out[(size_t)(r0 + r) * hsz + hh * tk + c] = from_f<T>(s[c]);
      }
    }
    // o_h = round(probs) @ v_h -> om (dWo's operand), 64 columns at a time
    for (int c0 = 0; c0 < hd; c0 += 64) {
      tile_gemm<2, true, T>(S, SMAX, tk, v + ho, h, c0, hd, slab, acc2);
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = ty * RPW + i, c = c0 + tx + 32 * j;
          if (r < nv && c < hd)
            om_out[(size_t)(r0 + r) * h + ho + c] = from_f<T>(acc2[i][j]);
        }
    }
    // dprobs = dom_h @ v_h^T
    for (int c0 = 0; c0 < SMAX; c0 += 128) {
      tile_gemm<4, false, T, true>(B3 + ho, h, hd, v + ho, h, c0, tk, slab,
                                   acc);
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          DP[(ty * RPW + i) * SMAX + c0 + tx + 32 * j] = acc[i][j];
    }
    __syncthreads();
    // ds = probs (dprobs - <dprobs, probs>) * scale, rounded
    for (int r = warp; r < R; r += NT / 32) {
      float* s = S + r * SMAX;
      const float* dp = DP + r * SMAX;
      float in = 0.f;
      for (int c = lane; c < tk; c += 32) in += dp[c] * s[c];
      in = warp_sum(in);
      for (int c = lane; c < tk; c += 32) {
        s[c] = round_to<T>((s[c] * (dp[c] - in)) * scale);
        if (r < nv)
          dsm_out[(size_t)(r0 + r) * hsz + hh * tk + c] = from_f<T>(s[c]);
      }
    }
    // dqp_h = dsm @ k_h (fp32; dbq sums it before rounding)
    for (int c0 = 0; c0 < hd; c0 += 64) {
      tile_gemm<2, false, T>(S, SMAX, tk, kk + ho, h, c0, hd, slab, acc2);
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = c0 + tx + 32 * j;
          if (c < hd) B4[(ty * RPW + i) * h + ho + c] = acc2[i][j];
        }
    }
  }
  __syncthreads();
  col_sums(B2, h, h, nv, pt);      // dbo = sum g
  col_sums(B4, h, h, nv, pt + h);  // dbq = sum dqp
  __syncthreads();
  for (int e = threadIdx.x; e < R * h; e += NT) B4[e] = round_to<T>(B4[e]);
  __syncthreads();
  store_tile<T, R>(B4, h, h, nv, dqm_out, r0);
  // du = g + dqm @ Wq^T
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, T, true>(B4, h, h, wq, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        if (c < h) B2[(ty * RPW + i) * h + c] += acc[i][j];
      }
  }
  __syncthreads();
  // dls = sum du xhat, dlb = sum du
  for (int c = threadIdx.x; c < h; c += NT) {
    float sdx = 0.f, sd = 0.f;
    for (int r = 0; r < nv; ++r) {
      sdx += B2[r * h + c] * U[r * h + c];
      sd += B2[r * h + c];
    }
    pt[2 * h + c] = sdx;
    pt[3 * h + c] = sd;
  }
  // LN backward, one warp per row: dt (fp32) into B3
  for (int r = warp; r < R; r += NT / 32) {
    const float* du = B2 + r * h;
    const float* xh = U + r * h;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float d = du[c] * ls[c];
      s1 += d;
      s2 += d * xh[c];
    }
    const float m1 = warp_sum(s1) / h, m2 = warp_sum(s2) / h;
    for (int c = lane; c < h; c += 32)
      B3[r * h + c] = inv[r] * (du[c] * ls[c] - m1 - xh[c] * m2);
  }
  __syncthreads();
  col_sums(B3, h, h, nv, pt + 4 * h);  // dbt = sum dt
  __syncthreads();
  for (int e = threadIdx.x; e < R * h; e += NT) B3[e] = round_to<T>(B3[e]);
  __syncthreads();
  store_tile<T, R>(B3, h, h, nv, dtm_out, r0);
  if (dx == nullptr) return;
  // dx = dtm @ Wt^T
  for (int c0 = 0; c0 < din; c0 += 128) {
    tile_gemm<4, false, T, true>(B3, h, h, wt, h, c0, din, slab, acc);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * RPW + i, c = c0 + tx + 32 * j;
        if (r < nv && c < din)
          dx[(size_t)(r0 + r) * din + c] = from_f<T>(acc[i][j]);
      }
  }
}

// ---------------------------------------------------------------------------
// Weight gradients: out[z*so + a*ldo + b] = sum_{r < n} A[r*lda + z*sa + a]
// * B[r*ldb + z*sb + b] for a < P, b < Q, in fp32. One 64x64 output tile
// per block (16x16 threads, 4x4 each); 32 rows of A and B staged through
// shared memory per step. A few dozen output tiles cannot fill 132 SMs,
// so the rows are also split in `splits` consecutive chunks: block
// (x, y, s*Z + z) sums chunk s in row order into out + s*split_stride,
// and split_sum_kernel then adds the chunks' partials in chunk order. The
// result does not depend on the launch order of the blocks.
// ---------------------------------------------------------------------------
constexpr int WR = 32;

template <typename TA, typename TB>
__global__ void __launch_bounds__(NT)
    wgrad_kernel(const TA* __restrict__ A, int lda, int sa,
                 const TB* __restrict__ B, int ldb, int sb,
                 float* __restrict__ out, int ldo, int so, int n, int P,
                 int Q, int nz, int chunk, size_t split_stride) {
  __shared__ float As[WR][64];
  __shared__ float Bs[WR][64];
  const int z = blockIdx.z % nz, split = blockIdx.z / nz;
  const int a0 = blockIdx.y * 64, b0 = blockIdx.x * 64;
  const int rbeg = split * chunk, rend = min(n, rbeg + chunk);
  A += (size_t)z * sa;
  B += (size_t)z * sb;
  out += (size_t)z * so + split * split_stride;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int r0 = rbeg; r0 < rend; r0 += WR) {
    __syncthreads();
    for (int e = tid; e < WR * 64; e += NT) {
      const int rr = e / 64, c = e % 64, r = r0 + rr;
      As[rr][c] = (r < rend && a0 + c < P)
                      ? to_f(A[(size_t)r * lda + a0 + c]) : 0.f;
      Bs[rr][c] = (r < rend && b0 + c < Q)
                      ? to_f(B[(size_t)r * ldb + b0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < WR; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[rr][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = a0 + ty + 16 * i, b = b0 + tx + 16 * j;
      if (a < P && b < Q) out[(size_t)a * ldo + b] = acc[i][j];
    }
}

// out[e] = sum over s < splits of part[s*m + e], in split order.
__global__ void __launch_bounds__(NT)
    split_sum_kernel(const float* __restrict__ part, int splits, size_t m,
                     float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  if (e >= m) return;
  float s = 0.f;
  for (int t = 0; t < splits; ++t) s += part[(size_t)t * m + e];
  out[e] = s;
}

// out[c] = sum over t < tiles of part[t*v + c], in tile order.
__global__ void __launch_bounds__(NT)
    colsum_kernel(const float* __restrict__ part, int tiles, int v,
                  float* __restrict__ out) {
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c >= v) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += part[(size_t)t * v + c];
  out[c] = s;
}

// ===========================================================================
// bf16 on the tensor cores: K3 backward and the bf16 x bf16 weight gradients
// ===========================================================================
//
// At the train step's text shape (x, g [7392, 512], W1 [512, 2048]) K3's
// backward is 77.5 GFLOP, which fp32 FMAs cannot do in under 1.16 ms; on
// the tensor cores its bound is 0.08 ms. So for T = bf16 the row pass is
// split into products that fill the card, each a BlockGemm (mma.sync
// m16n8k16, ldmatrix, a 3-stage cp.async ring) over 128 x 128 output
// tiles with its elementwise work fused into the epilogue:
//
//   pnmlp_ln_fwd_kernel       um = round(LN(x)) and each row's mean, 1/std
//   pnmlp_bwd_hidden_kernel   per (128 rows, 128 hidden columns):
//                             pre = um W1[:, c] + b1 and dh = g W2[c, :]^T;
//                             writes hm = round(gelu(pre)), dpm =
//                             round(dh gelu'(pre)) and the tile's column
//                             sums of the unrounded dpre (db1)
//   pnmlp_bwd_du_kernel       du = dpm W1^T (depth 4H), fp32
//   pnmlp_bwd_ln_kernel       dx = g + LN backward of du (fp32, cast once)
//                             and per 32-row tile the column sums of g
//                             (db2), du xhat (dls) and du (dlb)
//
// then dW1 = um^T dpm and dW2 = hm^T g through wgrad_mma_kernel (the same
// ordered row chunks as wgrad_kernel) and the [tiles, V] partials through
// colsum_kernel, in order: no atomics, so the gradients repeat bit for
// bit. Every rounding point is the TPU kernel's (and the fp32 kernel's
// above): operands in bf16, fp32 accumulation, pre from the rounded um,
// du from the rounded dpm, db1 from the unrounded dpre; products of bf16
// values are exact in fp32, so only the summation order differs.

// 128 x 128 block tiles on 8 warps of 64 x 32, 64-deep stages, 3 stages
typedef vct::BlockGemm<128, 128, 64, 64, 32, false, true, 3> GemmNT;
typedef vct::BlockGemm<128, 128, 64, 64, 32, true, false, 3> GemmTN;
constexpr int TC = 128;      // rows and columns of a product's block tile
constexpr int LN_ROWS = 32;  // rows per block of the LN backward

// um = round(LN(x)) row by row, one warp a row (the forward's
// statistics: the mean, then the mean of squared deviations), and each
// row's mean and 1/std unless mean is null. x is bf16 (K3) or fp32 (K2's
// t = x Wt + bt).
template <typename TI>
__device__ __forceinline__ void ln_fwd_rows(const TI* __restrict__ x,
                                            const float* __restrict__ ls,
                                            const float* __restrict__ lb,
                                            float eps,
                                            vct::bf16* __restrict__ um,
                                            float* __restrict__ mean,
                                            float* __restrict__ inv, int n,
                                            int h) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (r >= n) return;
  const TI* xr = x + (size_t)r * h;
  float s = 0.f;
  for (int c = lane; c < h; c += 32) s += to_f(xr[c]);
  const float m = warp_sum(s) / h;
  float v = 0.f;
  for (int c = lane; c < h; c += 32) {
    const float d = to_f(xr[c]) - m;
    v += d * d;
  }
  const float iv = rsqrtf(warp_sum(v) / h + eps);
  for (int c = lane; c < h; c += 32)
    um[(size_t)r * h + c] =
        from_f<vct::bf16>((to_f(xr[c]) - m) * iv * ls[c] + lb[c]);
  if (lane == 0 && mean != nullptr) {
    mean[r] = m;
    inv[r] = iv;
  }
}

__global__ void __launch_bounds__(NT)
    pnmlp_ln_fwd_kernel(const vct::bf16* __restrict__ x,
                        const float* __restrict__ ls,
                        const float* __restrict__ lb, float eps,
                        vct::bf16* __restrict__ um, float* __restrict__ mean,
                        float* __restrict__ inv, int n, int h) {
  ln_fwd_rows(x, ls, lb, eps, um, mean, inv, n, h);
}

// The hidden product's block holds two groups of 8 warps on the same
// 128 x 128 tile, each with its own 32-deep slabs of a 3-stage ring: the
// first computes pre = um W1[:, c], the second dh = g W2[c, :]^T. 16
// warps an SM (at most 128 registers a thread) hide more latency than
// one group holding both accumulators (255 registers, 8 warps). The
// groups trade half their accumulators through shared memory, in the
// fragment order both share, and each runs the epilogue (one erff per
// element for GELU and its derivative) on half the rows.
typedef vct::BlockGemm<128, 128, 32, 64, 32, false, false, 3> HidNN;
typedef vct::BlockGemm<128, 128, 32, 64, 32, false, true, 3> HidNT;
constexpr int HID_GROUP = HidNN::THREADS;  // threads of one group
constexpr int HID_STAGE = HidNN::STAGE_ELEMS + HidNT::STAGE_ELEMS;
constexpr int HID_ACC = HidNN::MT * HidNN::NT * 4;  // accumulators a thread
constexpr size_t HID_SMEM =
    3 * HID_STAGE * sizeof(vct::bf16) + HID_ACC * HID_GROUP * sizeof(float);

__global__ void __launch_bounds__(2 * HID_GROUP, 1)
    pnmlp_bwd_hidden_kernel(const vct::bf16* __restrict__ um,
                            const vct::bf16* __restrict__ g,
                            const vct::bf16* __restrict__ w1,
                            const float* __restrict__ b1,
                            const vct::bf16* __restrict__ w2,
                            vct::bf16* __restrict__ hm_out,
                            vct::bf16* __restrict__ dpm_out,
                            float* __restrict__ part, int n, int h, int k) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ float red[4][TC];
  vct::bf16* sm = reinterpret_cast<vct::bf16*>(tc_smem);
  float* handoff = reinterpret_cast<float*>(sm + 3 * HID_STAGE);
  const int c0 = blockIdx.x * TC, r0 = blockIdx.y * TC;
  const bool dh_group = threadIdx.x >= HID_GROUP;
  const int tid = threadIdx.x - (dh_group ? HID_GROUP : 0);
  const int nk = (h + 31) / 32;
  auto load = [&](int j) {
    vct::bf16* st = sm + (j % 3) * HID_STAGE;
    if (dh_group)
      HidNT::load_stage(st + HidNN::STAGE_ELEMS, g, h, w2, h, r0, n, c0, k,
                        j * 32, h, tid);
    else
      HidNN::load_stage(st, um, h, w1, k, r0, n, c0, k, j * 32, h, tid);
  };
  HidNN::Acc acc;  // pre in the first group, dh in the second
  HidNN::zero(acc);
  for (int j = 0; j < 2; ++j) {
    if (j < nk) load(j);
    vct::cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    vct::cp_async_wait<1>();
    __syncthreads();  // slab i landed; slab i - 1 is free
    if (i + 2 < nk) load(i + 2);
    vct::cp_async_commit();
    const vct::bf16* st = sm + (i % 3) * HID_STAGE;
    if (dh_group)
      HidNT::compute_stage(st + HidNN::STAGE_ELEMS, acc, tid);
    else
      HidNN::compute_stage(st, acc, tid);
  }
  vct::cp_async_wait<0>();
  // each group runs the epilogue of half the tile's rows (m-tiles 0-1 of
  // its warp's 64 rows in the first group, 2-3 in the second) and hands
  // the other half of its accumulators to the other group
  float* mine_to_dh = handoff;                       // pre, m-tiles 2-3
  float* mine_to_pre = handoff + HID_ACC / 2 * HID_GROUP;  // dh, 0-1
  auto slot = [&](int i, int j, int e) {
    return (((i & 1) * HidNN::NT + j) * 4 + e) * HID_GROUP + tid;
  };
#pragma unroll
  for (int i = 0; i < HidNN::MT; ++i) {
    if ((i >= HidNN::MT / 2) == dh_group) continue;  // this group's half
#pragma unroll
    for (int j = 0; j < HidNN::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        (dh_group ? mine_to_pre : mine_to_dh)[slot(i, j, e)] = acc[i][j][e];
  }
  __syncthreads();
  const float* other = dh_group ? mine_to_dh : mine_to_pre;
  const int lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const int wm = HidNN::warp_m(tid), wn = HidNN::warp_n(tid);
  float cs[HidNN::NT][2];
#pragma unroll
  for (int j = 0; j < HidNN::NT; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < HidNN::MT; ++i) {
    if ((i >= HidNN::MT / 2) != dh_group) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + wm + i * 16 + gr + half * 8;
#pragma unroll
      for (int j = 0; j < HidNN::NT; ++j) {
        const int c = c0 + wn + j * 8 + 2 * tq;
        float hv[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int at = 2 * half + e;
          const float o = other[slot(i, j, at)];
          const float p = (dh_group ? o : acc[i][j][at]) + b1[c + e];
          float gp;
          gelu_and_grad(p, hv[e], gp);
          dv[e] = (dh_group ? acc[i][j][at] : o) * gp;
        }
        if (r < n && c < k) {
          const size_t at = (size_t)r * k + c;
          *reinterpret_cast<uint32_t*>(hm_out + at) =
              vct::pack_bf16(hv[0], hv[1]);
          *reinterpret_cast<uint32_t*>(dpm_out + at) =
              vct::pack_bf16(dv[0], dv[1]);
          cs[j][0] += dv[0];
          cs[j][1] += dv[1];
        }
      }
    }
  }
  // db1: the column sums of dpre (before rounding) over the tile's rows,
  // across the lanes of a column, then the block's four 32-row quarters
  // in row order
#pragma unroll
  for (int j = 0; j < HidNN::NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cs[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (gr == 0)
        red[wm / (16 * HidNN::MT) * 2 + dh_group][wn + j * 8 + 2 * tq + e] = v;
    }
  __syncthreads();
  if (threadIdx.x < TC && c0 + threadIdx.x < k) {
    const int c = threadIdx.x;
    part[(size_t)blockIdx.y * k + c0 + c] =
        ((red[0][c] + red[1][c]) + red[2][c]) + red[3][c];
  }
}

__global__ void __launch_bounds__(GemmNT::THREADS)
    pnmlp_bwd_du_kernel(const vct::bf16* __restrict__ dpm,
                        const vct::bf16* __restrict__ w1,
                        float* __restrict__ du, int n, int h, int k) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  vct::bf16* sm = reinterpret_cast<vct::bf16*>(tc_smem);
  const int c0 = blockIdx.x * TC, r0 = blockIdx.y * TC;
  GemmNT::Acc acc;
  GemmNT::zero(acc);
  GemmNT::run(acc, sm, dpm, k, w1, k, r0, n, c0, h, 0, k);  // dpm W1^T
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int wm = GemmNT::warp_m(threadIdx.x), wn = GemmNT::warp_n(threadIdx.x);
#pragma unroll
  for (int i = 0; i < GemmNT::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + wm + i * 16 + gr + half * 8;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < GemmNT::NT; ++j) {
        const int c = c0 + wn + j * 8 + 2 * tq;
        if (c < h)
          *reinterpret_cast<float2*>(du + (size_t)r * h + c) =
              make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
}

__global__ void __launch_bounds__(NT)
    pnmlp_bwd_ln_kernel(const vct::bf16* __restrict__ x,
                        const vct::bf16* __restrict__ g,
                        const float* __restrict__ du,
                        const float* __restrict__ mean,
                        const float* __restrict__ inv,
                        const float* __restrict__ ls,
                        vct::bf16* __restrict__ dx, float* __restrict__ part,
                        int n, int h) {
  const int r0 = blockIdx.x * LN_ROWS, nv = min(LN_ROWS, n - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (dx != nullptr) {
    // one warp per row; dx = g + inv (d - mean(d) - xhat mean(d xhat)),
    // d = du ls, cast once
    for (int r = r0 + warp; r < r0 + nv; r += NT / 32) {
      const vct::bf16* xr = x + (size_t)r * h;
      const float* dr = du + (size_t)r * h;
      const float mr = mean[r], ir = inv[r];
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < h; c += 32) {
        const float xh = (to_f(xr[c]) - mr) * ir, d = dr[c] * ls[c];
        s1 += d;
        s2 += d * xh;
      }
      const float m1 = warp_sum(s1) / h, m2 = warp_sum(s2) / h;
      for (int c = lane; c < h; c += 32) {
        const float xh = (to_f(xr[c]) - mr) * ir, d = dr[c] * ls[c];
        dx[(size_t)r * h + c] = from_f<vct::bf16>(
            to_f(g[(size_t)r * h + c]) + ir * (d - m1 - xh * m2));
      }
    }
  }
  // [db2 = sum g | dls = sum du xhat | dlb = sum du] over the tile's rows
  float* pt = part + (size_t)blockIdx.x * 3 * h;
  for (int c = threadIdx.x; c < h; c += NT) {
    float sg = 0.f, sdx = 0.f, sd = 0.f;
    for (int r = r0; r < r0 + nv; ++r) {
      const size_t at = (size_t)r * h + c;
      const float xh = (to_f(x[at]) - mean[r]) * inv[r], d = du[at];
      sg += to_f(g[at]);
      sdx += d * xh;
      sd += d;
    }
    pt[c] = sg;
    pt[h + c] = sdx;
    pt[2 * h + c] = sd;
  }
}

// out[z*so + a*ldo + b] = sum over the split's rows r of A[r*lda + z*sa +
// a] * B[r*ldb + z*sb + b], bf16 operands on the tensor cores: the same
// contract, grid and ordered row chunks as wgrad_kernel, over 128 x 128
// output tiles. Operands 16-byte aligned, their strides, offsets and
// widths multiples of 8 (K2 pads each head's keys to 8 for this).
__global__ void __launch_bounds__(GemmTN::THREADS)
    wgrad_mma_kernel(const vct::bf16* __restrict__ A, int lda, int sa,
                     const vct::bf16* __restrict__ B, int ldb, int sb,
                     float* __restrict__ out, int ldo, int so, int n, int P,
                     int Q, int nz, int chunk, size_t split_stride) {
  typedef GemmTN G;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  vct::bf16* sm = reinterpret_cast<vct::bf16*>(tc_smem);
  const int z = blockIdx.z % nz, split = blockIdx.z / nz;
  const int a0 = blockIdx.y * TC, b0 = blockIdx.x * TC;
  const int rbeg = split * chunk, rend = min(n, rbeg + chunk);
  A += (size_t)z * sa;
  B += (size_t)z * sb;
  out += (size_t)z * so + split * split_stride;
  typename G::Acc acc;
  G::zero(acc);
  G::run(acc, sm, A, lda, B, ldb, a0, P, b0, Q, rbeg, rend);
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int wm = G::warp_m(threadIdx.x), wn = G::warp_n(threadIdx.x);
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int a = a0 + wm + i * 16 + gr + half * 8;
      if (a >= P) continue;
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = b0 + wn + j * 8 + 2 * tq + e;
          if (b < Q) out[(size_t)a * ldo + b] = acc[i][j][2 * half + e];
        }
    }
}

// ===========================================================================
// bf16 on the tensor cores: K3 forward, K2 backward and K2 forward
// ===========================================================================
//
// The same shape as K3's backward above: the row pass becomes products
// that fill the card, each a BlockGemm with its elementwise work in the
// epilogue (gemm_tile below hands each pair of output columns to an
// epilogue functor), plus row kernels for the LayerNorms and, for K2, one
// attention pass. Every rounding point stays where the TPU kernels and
// the fp32 kernels above put it; products of bf16 values are exact in
// fp32, so only the order of the fp32 sums differs.
//
// K3 forward (replaces _pnmlp_fwd_kernel, fused_adapter.py:532): 31 GFLOP
// at the train step's text shape (x [7392, 512], hidden 2048), which fp32
// FMAs cannot do in under 0.46 ms; the tensor cores' bound is 0.031 ms.
//
//   pnmlp_fwd_ln_kernel       um = round(LN(x))
//   pnmlp_fwd_hidden_kernel   hm = round(gelu(um W1 + b1)) [n, 4h] in bf16,
//                             128 x 128 tiles
//   pnmlp_fwd_out_kernel      y = round(x + b2 + hm W2), 128 x 64 tiles
//                             (twice the blocks of 128 x 128: 464 at the
//                             train step, 8 for one served request)
//
// The hidden goes through device memory (15 MB each way at the train
// step, about 0.01 ms): keeping it on chip would take 128 x 4h fp32
// accumulators a block.
//
// K2 backward (replaces _cab_bwd_kernel, fused_adapter.py:807): 40 GFLOP
// at the train step's text shape (H = 512, 8 heads of 64, Tk = 197):
//
//   cab_bwd_t_kernel       t = x Wt + bt (fp32)
//   cab_bwd_ln_fwd_kernel  um = round(LN(t)), each row's mean and 1/std
//   cab_bwd_q_kernel       qm = round(um Wq + bq)
//   cab_bwd_dom_kernel     dom = round(g Wo^T)
//   cab_bwd_attn_kernel    one block per (128 rows, head), below
//   cab_bwd_du_kernel      du = g + dqm Wq^T (fp32)
//   cab_bwd_ln_kernel      dtm = round(dt), dt the LN backward of du; per
//                          32-row tile the column sums of g (dbo), du
//                          xhat (dls), du (dlb) and the unrounded dt (dbt)
//   cab_bwd_dx_kernel      dx = dtm Wt^T (when asked)
//
// then dWo = om^T g, dv_h = pm_h^T dom_h, dk_h = dsm_h^T qm_h, dWq = um^T
// dqm and dWt = x^T dtm through wgrad_mma_kernel and the partials through
// colsum_kernel, in order: no atomics, the gradients repeat bit for bit.
// pm and dsm keep each head's keys padded to a multiple of 8 (197 ->
// 200, zeros past Tk), so the per-head weight gradients read 16-byte
// rows.
//
// The attention pass holds the head's K and V (Tk rows, zero-filled to a
// multiple of 16; 64 KB at Tk = 256) and the tile's q and dom rows in
// shared memory; each warp takes 16 rows and walks the keys in groups of
// 16, three times: (1) the scores, for each row's max and sum of
// exponentials; (2) p (fp32), pm = round(p), o = round(p) v (-> om),
// dp = dom_h v_h^T and <dp, p>; (3) p and dp again, ds = round(p (dp -
// <dp, p>) scale) (-> dsm) and dqp = ds k_h, whose column sums over the
// tile (dbq, before rounding) go to a [tiles, H] partial and whose
// rounding is dqm. The [128, Tk] scores never leave registers: recomputing
// them costs 7 products of 16 x 64 x Tk a warp where 4 would do (10
// GFLOP at the train step, about 0.07 ms), far below what storing them
// would cost. Keys past Tk score -inf before the max (ex2(-inf) = 0);
// groups wholly past Tk are not walked.
//
// K2 forward (replaces _cab_fwd_kernel, fused_adapter.py:796): 14.6 GFLOP
// at the train step's text shape, which the first, CUDA-core kernel ran
// in 1.56 ms (fp32 FMAs on bf16-rounded operands, one 32-row block for
// the whole block); the tensor cores' bound is 0.015 ms. The same passes
// as the backward's recompute:
//
//   cab_fwd_t_kernel      t = x Wt + bt (fp32)
//   cab_fwd_ln_kernel     um = round(LN(t)), each row's mean and 1/std
//   cab_fwd_q_kernel      qm = round(um Wq + bq)
//   cab_fwd_attn_kernel   per (128 rows, head): passes 1 and 2 of the
//                         backward's attention pass (the same device
//                         functions: head_stats, head_probs, head_pv), om
//                         = round(round(p) v)
//   cab_fwd_out_kernel    y = round(u + (om Wo + bo)), u = LN(t) in fp32
//                         recomputed from t and the row's statistics
//
// 128 x 64 output tiles give a served request (77 rows, H = 512) 8 blocks
// a product and 8 attention blocks, where the CUDA-core kernel ran 3.

// 128 x 64 block tiles on 8 warps of 32 x 32, 64-deep stages, 3 stages
template <bool B_T>
using Gemm64 = vct::BlockGemm<128, 64, 64, 32, 32, false, B_T, 3>;

// One block's tile of A B (blockIdx.x the column tile, blockIdx.y the row
// tile; rows of A past m_end and columns of B past n_end read as 0),
// handed to epi(r, c, v0, v1) for each pair of columns (c, c + 1) of a
// row r < m_end with c < n_end (n_end even).
template <class G, class Epi>
__device__ __forceinline__ void gemm_tile(const Epi& epi,
                                          const vct::bf16* A, long long lda,
                                          const vct::bf16* B, long long ldb,
                                          int m_end, int n_end, int depth) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int c0 = blockIdx.x * G::TILE_N, r0 = blockIdx.y * G::TILE_M;
  typename G::Acc acc;
  G::zero(acc);
  G::run(acc, reinterpret_cast<vct::bf16*>(tc_smem), A, lda, B, ldb, r0,
         m_end, c0, n_end, 0, depth);
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int wm = G::warp_m(threadIdx.x), wn = G::warp_n(threadIdx.x);
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + wm + i * 16 + gr + half * 8;
      if (r >= m_end) continue;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int c = c0 + wn + j * 8 + 2 * tq;
        if (c < n_end)
          epi(r, c, acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
}

__device__ __forceinline__ void store_pair(vct::bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = vct::pack_bf16(a, b);
}

// out = round(v + bias) in bf16 (no bias when null)
struct RoundEpi {
  vct::bf16* out;
  const float* bias;
  int ld;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    if (bias != nullptr) {
      v0 += bias[c];
      v1 += bias[c + 1];
    }
    store_pair(out + (size_t)r * ld + c, v0, v1);
  }
};

// out = v + bias in fp32
struct BiasF32Epi {
  float* out;
  const float* bias;
  int ld;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    *reinterpret_cast<float2*>(out + (size_t)r * ld + c) =
        make_float2(v0 + bias[c], v1 + bias[c + 1]);
  }
};

// out = g + v in fp32 (g bf16)
struct AddGEpi {
  float* out;
  const vct::bf16* g;
  int ld;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    const size_t at = (size_t)r * ld + c;
    *reinterpret_cast<float2*>(out + at) =
        make_float2(to_f(g[at]) + v0, to_f(g[at + 1]) + v1);
  }
};

// hm = round(gelu(v + b1))
struct GeluEpi {
  vct::bf16* hm;
  const float* b1;
  int ld;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    store_pair(hm + (size_t)r * ld + c, gelu_erf(v0 + b1[c]),
               gelu_erf(v1 + b1[c + 1]));
  }
};

// y = round((x + b2) + v)
struct ResidEpi {
  vct::bf16* y;
  const vct::bf16* x;
  const float* b2;
  int ld;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    const size_t at = (size_t)r * ld + c;
    store_pair(y + at, (to_f(x[at]) + b2[c]) + v0,
               (to_f(x[at + 1]) + b2[c + 1]) + v1);
  }
};

// --- K3 forward ----------------------------------------------------------

__global__ void __launch_bounds__(NT)
    pnmlp_fwd_ln_kernel(const vct::bf16* __restrict__ x,
                        const float* __restrict__ ls,
                        const float* __restrict__ lb, float eps,
                        vct::bf16* __restrict__ um, int n, int h) {
  ln_fwd_rows(x, ls, lb, eps, um, nullptr, nullptr, n, h);
}

__global__ void __launch_bounds__(HidNN::THREADS, 2)
    pnmlp_fwd_hidden_kernel(const vct::bf16* __restrict__ um,
                            const vct::bf16* __restrict__ w1,
                            const float* __restrict__ b1,
                            vct::bf16* __restrict__ hm, int n, int h,
                            int k) {
  gemm_tile<HidNN>(GeluEpi{hm, b1, k}, um, h, w1, k, n, k, h);
}

__global__ void __launch_bounds__(Gemm64<false>::THREADS, 2)
    pnmlp_fwd_out_kernel(const vct::bf16* __restrict__ hm,
                         const vct::bf16* __restrict__ w2,
                         const vct::bf16* __restrict__ x,
                         const float* __restrict__ b2,
                         vct::bf16* __restrict__ y, int n, int h, int k) {
  gemm_tile<Gemm64<false>>(ResidEpi{y, x, b2, h}, hm, k, w2, h, n, h, k);
}

// --- K2 backward ---------------------------------------------------------

__global__ void __launch_bounds__(Gemm64<false>::THREADS, 2)
    cab_bwd_t_kernel(const vct::bf16* __restrict__ x,
                     const vct::bf16* __restrict__ wt,
                     const float* __restrict__ bt, float* __restrict__ t,
                     int n, int din, int h) {
  gemm_tile<Gemm64<false>>(BiasF32Epi{t, bt, h}, x, din, wt, h, n, h, din);
}

__global__ void __launch_bounds__(NT)
    cab_bwd_ln_fwd_kernel(const float* __restrict__ t,
                          const float* __restrict__ ls,
                          const float* __restrict__ lb, float eps,
                          vct::bf16* __restrict__ um,
                          float* __restrict__ mean, float* __restrict__ inv,
                          int n, int h) {
  ln_fwd_rows(t, ls, lb, eps, um, mean, inv, n, h);
}

__global__ void __launch_bounds__(Gemm64<false>::THREADS, 2)
    cab_bwd_q_kernel(const vct::bf16* __restrict__ um,
                     const vct::bf16* __restrict__ wq,
                     const float* __restrict__ bq,
                     vct::bf16* __restrict__ qm, int n, int h) {
  gemm_tile<Gemm64<false>>(RoundEpi{qm, bq, h}, um, h, wq, h, n, h, h);
}

__global__ void __launch_bounds__(Gemm64<true>::THREADS, 2)
    cab_bwd_dom_kernel(const vct::bf16* __restrict__ g,
                       const vct::bf16* __restrict__ wo,
                       vct::bf16* __restrict__ dom, int n, int h) {
  gemm_tile<Gemm64<true>>(RoundEpi{dom, nullptr, h}, g, h, wo, h, n, h, h);
}

__global__ void __launch_bounds__(Gemm64<true>::THREADS, 2)
    cab_bwd_du_kernel(const vct::bf16* __restrict__ dqm,
                      const vct::bf16* __restrict__ wq,
                      const vct::bf16* __restrict__ g,
                      float* __restrict__ du, int n, int h) {
  gemm_tile<Gemm64<true>>(AddGEpi{du, g, h}, dqm, h, wq, h, n, h, h);
}

__global__ void __launch_bounds__(Gemm64<true>::THREADS, 2)
    cab_bwd_dx_kernel(const vct::bf16* __restrict__ dtm,
                      const vct::bf16* __restrict__ wt,
                      vct::bf16* __restrict__ dx, int n, int din, int h) {
  gemm_tile<Gemm64<true>>(RoundEpi{dx, nullptr, din}, dtm, h, wt, h, n, din,
                          h);
}

constexpr int AT_ROWS = 128;      // rows of an attention block: 8 warps

// K2's head widths on the tensor cores: a head of hd columns (a multiple
// of 8) runs in the kernel of the least HD >= hd, zero-filled past hd.
constexpr int HD_MAX = 128;

// Shared memory of an attention block: K and V of the head (Tk rows
// zero-filled to a multiple of 16) and `tiles` 128-row tiles of bf16
// (the backward's q and dom, the forward's q), plus `red` floats.
size_t cab_attn_smem(int tk, int HD, int tiles, int red) {
  const size_t tk16 = (size_t)(tk + 15) / 16 * 16;
  return sizeof(vct::bf16) * (2 * tk16 + tiles * AT_ROWS) * (HD + 8) +
         sizeof(float) * red;
}

// --- one head's attention for a warp's 16 rows, shared by K2's forward
// and backward attention passes, so that both compute p, round(p) and o
// = round(p) v identically. qf: the rows' q as A fragments; Ks, Vs: the
// head's keys and values in shared memory (row stride ld); keys past tk
// score -inf (ex2(-inf) = 0).

// s0, s1 = the scores of keys kb .. kb + 7 and kb + 8 .. kb + 15, times
// scale, -inf past tk
template <int HD>
__device__ __forceinline__ void head_scores(const uint32_t (&qf)[HD / 16][4],
                                            const vct::bf16* Ks, int ld,
                                            int kb, int tk, float scale,
                                            int lane, float (&s0)[4],
                                            float (&s1)[4]) {
  const int tq = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) s0[e] = s1[e] = 0.f;
  vct::mma_rows_t16<HD>(s0, s1, qf, Ks, ld, kb, lane);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = kb + 2 * tq + (e & 1);
    s0[e] = c < tk ? s0[e] * scale : -INFINITY;
    s1[e] = c + 8 < tk ? s1[e] * scale : -INFINITY;
  }
}

// Each row's softmax statistics over every key, online (pass 1): -max
// log2(e) (ml) and 1 / sum of exponentials (inv), for the thread's rows g
// (lo) and g + 8 (hi).
struct RowStats {
  float ml_lo, ml_hi, inv_lo, inv_hi;
};

template <int HD>
__device__ __forceinline__ RowStats head_stats(
    const uint32_t (&qf)[HD / 16][4], const vct::bf16* Ks, int ld, int tk,
    float scale, int lane) {
  using vct::ex2;
  using vct::L2E;
  using vct::quad_max;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  for (int kb = 0; kb < tk; kb += 16) {
    float s0[4], s1[4];
    head_scores<HD>(qf, Ks, ld, kb, tk, scale, lane, s0, s1);
    // every group holds a key below tk, so the new max is finite
    const float mn_lo = fmaxf(
        m_lo, quad_max(fmaxf(fmaxf(s0[0], s0[1]), fmaxf(s1[0], s1[1]))));
    const float mn_hi = fmaxf(
        m_hi, quad_max(fmaxf(fmaxf(s0[2], s0[3]), fmaxf(s1[2], s1[3]))));
    const float c_lo = -mn_lo * L2E, c_hi = -mn_hi * L2E;
    const float e_lo =
        (ex2(fmaf(s0[0], L2E, c_lo)) + ex2(fmaf(s0[1], L2E, c_lo))) +
        (ex2(fmaf(s1[0], L2E, c_lo)) + ex2(fmaf(s1[1], L2E, c_lo)));
    const float e_hi =
        (ex2(fmaf(s0[2], L2E, c_hi)) + ex2(fmaf(s0[3], L2E, c_hi))) +
        (ex2(fmaf(s1[2], L2E, c_hi)) + ex2(fmaf(s1[3], L2E, c_hi)));
    l_lo = (m_lo == -INFINITY ? 0.f : l_lo * ex2((m_lo - mn_lo) * L2E)) +
           e_lo;
    l_hi = (m_hi == -INFINITY ? 0.f : l_hi * ex2((m_hi - mn_hi) * L2E)) +
           e_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
  }
  return {-m_lo * L2E, -m_hi * L2E, 1.f / vct::quad_sum(l_lo),
          1.f / vct::quad_sum(l_hi)};
}

// p = exp(s - max) / sum in fp32 for keys kb .. kb + 15 (0 past tk)
template <int HD>
__device__ __forceinline__ void head_probs(const uint32_t (&qf)[HD / 16][4],
                                           const vct::bf16* Ks, int ld,
                                           int kb, int tk, float scale,
                                           const RowStats& st, int lane,
                                           float (&p0)[4], float (&p1)[4]) {
  using vct::ex2;
  using vct::L2E;
  head_scores<HD>(qf, Ks, ld, kb, tk, scale, lane, p0, p1);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float ml = e < 2 ? st.ml_lo : st.ml_hi;
    const float iv = e < 2 ? st.inv_lo : st.inv_hi;
    p0[e] = ex2(fmaf(p0[e], L2E, ml)) * iv;
    p1[e] = ex2(fmaf(p1[e], L2E, ml)) * iv;
  }
}

// o (m16n8 tiles over HD columns) += round(p) v over keys kb .. kb + 15
template <int HD>
__device__ __forceinline__ void head_pv(float (&o)[HD / 8][4],
                                        const float (&p0)[4],
                                        const float (&p1)[4],
                                        const vct::bf16* Vs, int ld, int kb,
                                        int lane) {
  uint32_t a[4];
  vct::pack_a(a, p0, p1);
  vct::mma_rows16<HD>(o, a, Vs, ld, kb, lane);
}

// o's first hd columns, rounded, into rows r_lo, r_hi (< n) of out
// (row stride h) from column c0
template <int HD>
__device__ __forceinline__ void store_head(const float (&o)[HD / 8][4],
                                           vct::bf16* out, int h, int c0,
                                           int hd, int r_lo, int r_hi, int n,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = c0 + j * 8 + 2 * (lane & 3);
    if (j * 8 >= hd) break;
    if (r_lo < n) store_pair(out + (size_t)r_lo * h + c, o[j][0], o[j][1]);
    if (r_hi < n) store_pair(out + (size_t)r_hi * h + c, o[j][2], o[j][3]);
  }
}

// The head's K and V (columns c0 .. c0 + hd of rows < tk, zero-filled to
// tk16 rows and HD columns) into Ks, Vs by cp.async (not committed).
template <int HD>
__device__ __forceinline__ void load_head_kv(vct::bf16* Ks, vct::bf16* Vs,
                                             const vct::bf16* k,
                                             const vct::bf16* v, int h,
                                             int c0, int hd, int tk,
                                             int tk16) {
  constexpr int AT_LD = HD + 8;
  for (int e = threadIdx.x; e < tk16 * (HD / 8); e += NT) {
    const int r = e / (HD / 8), c = (e % (HD / 8)) * 8;
    const bool ok = r < tk && c < hd;
    const size_t at = (size_t)r * h + c0 + c;
    vct::cp_async16(Ks + r * AT_LD + c, ok ? k + at : k, ok);
    vct::cp_async16(Vs + r * AT_LD + c, ok ? v + at : v, ok);
  }
}

// One block per (128-row tile, head), 8 warps of 16 rows; see the section
// comment. Heads of hd <= HD columns (hd a multiple of 8; the tiles' columns
// past hd read as 0, which changes no score, and are not written). qm, dom,
// om, dqm [n, h]; k, v [tk, h]; pm, dsm [n, heads, tkp] (keys past tk
// written as 0, tkp = tk rounded up to 8); part [tiles, h] (dbq).
template <int HD>
__global__ void __launch_bounds__(NT, HD <= 64 ? 2 : 1)
    cab_bwd_attn_kernel(const vct::bf16* __restrict__ qm,
                        const vct::bf16* __restrict__ dom,
                        const vct::bf16* __restrict__ k,
                        const vct::bf16* __restrict__ v, float scale,
                        vct::bf16* __restrict__ om, vct::bf16* __restrict__ pm,
                        vct::bf16* __restrict__ dsm,
                        vct::bf16* __restrict__ dqm, float* __restrict__ part,
                        int n, int h, int hd, int tk, int tkp) {
  constexpr int AT_LD = HD + 8;  // shared row of a bf16 head tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tk16 = (tk + 15) & ~15;
  vct::bf16* Ks = reinterpret_cast<vct::bf16*>(tc_smem);  // [tk16][AT_LD]
  vct::bf16* Vs = Ks + tk16 * AT_LD;                      // [tk16][AT_LD]
  vct::bf16* Qs = Vs + tk16 * AT_LD;                      // [128][AT_LD]
  vct::bf16* Ds = Qs + AT_ROWS * AT_LD;                   // [128][AT_LD]
  float* red = reinterpret_cast<float*>(Ds + AT_ROWS * AT_LD);  // [8][HD]
  const int r0 = blockIdx.x * AT_ROWS, head = blockIdx.y, c0 = head * hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r_lo = r0 + warp * 16 + g, r_hi = r_lo + 8;  // this thread's rows
  const bool active = r0 + warp * 16 < n;
  const size_t prow = (size_t)gridDim.y * tkp;  // row stride of pm, dsm

  load_head_kv<HD>(Ks, Vs, k, v, h, c0, hd, tk, tk16);
  vct::load_tile<AT_ROWS, HD, AT_LD, NT>(Qs, qm, h, r0, n, c0, c0 + hd,
                                         threadIdx.x);
  vct::load_tile<AT_ROWS, HD, AT_LD, NT>(Ds, dom, h, r0, n, c0, c0 + hd,
                                         threadIdx.x);
  vct::cp_async_commit();
  vct::cp_async_wait<0>();
  __syncthreads();

  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  if (active) {
    uint32_t qf[HD / 16][4], df[HD / 16][4];
    vct::load_a_rows<HD>(qf, Qs, AT_LD, warp * 16, lane);
    vct::load_a_rows<HD>(df, Ds, AT_LD, warp * 16, lane);
    const int groups = tk16 / 16;
    // pass 1: each row's max and sum of exponentials, online
    const RowStats st = head_stats<HD>(qf, Ks, AT_LD, tk, scale, lane);
    // dp = dom_h v_h^T
    auto dprobs = [&](int kb, float (&d0)[4], float (&d1)[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d0[e] = d1[e] = 0.f;
      vct::mma_rows_t16<HD>(d0, d1, df, Vs, AT_LD, kb, lane);
    };
    // keys kb .. kb + 15 of the thread's rows, rounded, into this head's
    // slot of pm or dsm (keys below tkp)
    auto store_keys = [&](vct::bf16* out, int kb, const float (&s0)[4],
                          const float (&s1)[4]) {
      vct::bf16* base = out + (size_t)head * tkp;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float* s = jj ? s1 : s0;
        const int c = kb + jj * 8 + 2 * tq;
        if (c >= tkp) continue;
        if (r_lo < n) store_pair(base + r_lo * prow + c, s[0], s[1]);
        if (r_hi < n) store_pair(base + r_hi * prow + c, s[2], s[3]);
      }
    };
    // pass 2: pm, o = round(p) v, <dp, p>
    float o[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    float dpp_lo = 0.f, dpp_hi = 0.f;
    for (int kg = 0; kg < groups; ++kg) {
      const int kb = kg * 16;
      float p0[4], p1[4], d0[4], d1[4];
      head_probs<HD>(qf, Ks, AT_LD, kb, tk, scale, st, lane, p0, p1);
      dprobs(kb, d0, d1);
      dpp_lo += (d0[0] * p0[0] + d0[1] * p0[1]) +
                (d1[0] * p1[0] + d1[1] * p1[1]);
      dpp_hi += (d0[2] * p0[2] + d0[3] * p0[3]) +
                (d1[2] * p1[2] + d1[3] * p1[3]);
      head_pv<HD>(o, p0, p1, Vs, AT_LD, kb, lane);
      store_keys(pm, kb, p0, p1);
    }
    dpp_lo = vct::quad_sum(dpp_lo);
    dpp_hi = vct::quad_sum(dpp_hi);
    store_head<HD>(o, om, h, c0, hd, r_lo, r_hi, n, lane);
    // pass 3: ds = round(p (dp - <dp, p>) scale) -> dsm, dqp = ds k
    for (int kg = 0; kg < groups; ++kg) {
      const int kb = kg * 16;
      float p0[4], p1[4], d0[4], d1[4];
      head_probs<HD>(qf, Ks, AT_LD, kb, tk, scale, st, lane, p0, p1);
      dprobs(kb, d0, d1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float in = e < 2 ? dpp_lo : dpp_hi;
        p0[e] = (p0[e] * (d0[e] - in)) * scale;
        p1[e] = (p1[e] * (d1[e] - in)) * scale;
      }
      uint32_t a[4];
      vct::pack_a(a, p0, p1);
      vct::mma_rows16<HD>(dq, a, Ks, AT_LD, kb, lane);
      store_keys(dsm, kb, p0, p1);
    }
    store_head<HD>(dq, dqm, h, c0, hd, r_lo, r_hi, n, lane);
  }
  // dbq: the column sums of the unrounded dqp over the tile's rows, over
  // the lanes of a column, then the warps in order
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = (r_lo < n ? dq[j][e] : 0.f) + (r_hi < n ? dq[j][2 + e] : 0.f);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) red[warp * HD + j * 8 + 2 * tq + e] = s;
    }
  __syncthreads();
  if (threadIdx.x < hd) {
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += red[w * HD + threadIdx.x];
    part[(size_t)blockIdx.x * h + c0 + threadIdx.x] = s;
  }
}

// --- K2 forward ----------------------------------------------------------

__global__ void __launch_bounds__(Gemm64<false>::THREADS, 2)
    cab_fwd_t_kernel(const vct::bf16* __restrict__ x,
                     const vct::bf16* __restrict__ wt,
                     const float* __restrict__ bt, float* __restrict__ t,
                     int n, int din, int h) {
  gemm_tile<Gemm64<false>>(BiasF32Epi{t, bt, h}, x, din, wt, h, n, h, din);
}

__global__ void __launch_bounds__(NT)
    cab_fwd_ln_kernel(const float* __restrict__ t,
                      const float* __restrict__ ls,
                      const float* __restrict__ lb, float eps,
                      vct::bf16* __restrict__ um, float* __restrict__ mean,
                      float* __restrict__ inv, int n, int h) {
  ln_fwd_rows(t, ls, lb, eps, um, mean, inv, n, h);
}

__global__ void __launch_bounds__(Gemm64<false>::THREADS, 2)
    cab_fwd_q_kernel(const vct::bf16* __restrict__ um,
                     const vct::bf16* __restrict__ wq,
                     const float* __restrict__ bq,
                     vct::bf16* __restrict__ qm, int n, int h) {
  gemm_tile<Gemm64<false>>(RoundEpi{qm, bq, h}, um, h, wq, h, n, h, h);
}

// One block per (128-row tile, head): pass 1 and the o of pass 2 of
// cab_bwd_attn_kernel (the same device functions), om = round(o).
template <int HD>
__global__ void __launch_bounds__(NT, HD <= 64 ? 2 : 1)
    cab_fwd_attn_kernel(const vct::bf16* __restrict__ qm,
                        const vct::bf16* __restrict__ k,
                        const vct::bf16* __restrict__ v, float scale,
                        vct::bf16* __restrict__ om, int n, int h, int hd,
                        int tk) {
  constexpr int AT_LD = HD + 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tk16 = (tk + 15) & ~15;
  vct::bf16* Ks = reinterpret_cast<vct::bf16*>(tc_smem);  // [tk16][AT_LD]
  vct::bf16* Vs = Ks + tk16 * AT_LD;                      // [tk16][AT_LD]
  vct::bf16* Qs = Vs + tk16 * AT_LD;                      // [128][AT_LD]
  const int r0 = blockIdx.x * AT_ROWS, c0 = blockIdx.y * hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r_lo = r0 + warp * 16 + (lane >> 2), r_hi = r_lo + 8;

  load_head_kv<HD>(Ks, Vs, k, v, h, c0, hd, tk, tk16);
  vct::load_tile<AT_ROWS, HD, AT_LD, NT>(Qs, qm, h, r0, n, c0, c0 + hd,
                                         threadIdx.x);
  vct::cp_async_commit();
  vct::cp_async_wait<0>();
  __syncthreads();
  if (r0 + warp * 16 >= n) return;
  uint32_t qf[HD / 16][4];
  vct::load_a_rows<HD>(qf, Qs, AT_LD, warp * 16, lane);
  const RowStats st = head_stats<HD>(qf, Ks, AT_LD, tk, scale, lane);
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int kb = 0; kb < tk; kb += 16) {
    float p0[4], p1[4];
    head_probs<HD>(qf, Ks, AT_LD, kb, tk, scale, st, lane, p0, p1);
    head_pv<HD>(o, p0, p1, Vs, AT_LD, kb, lane);
  }
  store_head<HD>(o, om, h, c0, hd, r_lo, r_hi, n, lane);
}

// y = round(u + (v + bo)) with u = LN(t) in fp32, recomputed from t and
// the row's mean and 1/std as ln_fwd_rows computes it (the reference adds
// the fp32 LN output, not its rounding)
struct LnResidEpi {
  vct::bf16* y;
  const float *t, *mean, *inv, *ls, *lb, *bo;
  int ld;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    const size_t at = (size_t)r * ld + c;
    const float m = mean[r], iv = inv[r];
    const float u0 = (t[at] - m) * iv * ls[c] + lb[c];
    const float u1 = (t[at + 1] - m) * iv * ls[c + 1] + lb[c + 1];
    store_pair(y + at, u0 + (v0 + bo[c]), u1 + (v1 + bo[c + 1]));
  }
};

__global__ void __launch_bounds__(Gemm64<false>::THREADS, 2)
    cab_fwd_out_kernel(const vct::bf16* __restrict__ om,
                       const vct::bf16* __restrict__ wo,
                       const float* __restrict__ t,
                       const float* __restrict__ mean,
                       const float* __restrict__ inv,
                       const float* __restrict__ ls,
                       const float* __restrict__ lb,
                       const float* __restrict__ bo, vct::bf16* __restrict__ y,
                       int n, int h) {
  gemm_tile<Gemm64<false>>(LnResidEpi{y, t, mean, inv, ls, lb, bo, h}, om, h,
                           wo, h, n, h, h);
}

// dt = LN backward of du (d = du ls: dt = inv (d - mean(d) - xhat
// mean(d xhat)), xhat from t and the row's statistics), dtm = round(dt),
// one warp a row; then per 32-row tile [dbo = sum g | dls = sum du xhat |
// dlb = sum du | dbt = sum dt] (dt recomputed from the rows' two means).
__global__ void __launch_bounds__(NT)
    cab_bwd_ln_kernel(const float* __restrict__ t,
                      const float* __restrict__ du,
                      const float* __restrict__ mean,
                      const float* __restrict__ inv,
                      const float* __restrict__ ls,
                      const vct::bf16* __restrict__ g,
                      vct::bf16* __restrict__ dtm, float* __restrict__ part,
                      int n, int h) {
  __shared__ float m1s[LN_ROWS], m2s[LN_ROWS];
  const int r0 = blockIdx.x * LN_ROWS, nv = min(LN_ROWS, n - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < nv; i += NT / 32) {
    const int r = r0 + i;
    const float* tr = t + (size_t)r * h;
    const float* dr = du + (size_t)r * h;
    const float mr = mean[r], ir = inv[r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float xh = (tr[c] - mr) * ir, d = dr[c] * ls[c];
      s1 += d;
      s2 += d * xh;
    }
    const float m1 = warp_sum(s1) / h, m2 = warp_sum(s2) / h;
    for (int c = lane; c < h; c += 32) {
      const float xh = (tr[c] - mr) * ir, d = dr[c] * ls[c];
      dtm[(size_t)r * h + c] = from_f<vct::bf16>(ir * (d - m1 - xh * m2));
    }
    if (lane == 0) {
      m1s[i] = m1;
      m2s[i] = m2;
    }
  }
  __syncthreads();
  float* pt = part + (size_t)blockIdx.x * 4 * h;
  for (int c = threadIdx.x; c < h; c += NT) {
    float sg = 0.f, sdx = 0.f, sd = 0.f, sdt = 0.f;
    for (int i = 0; i < nv; ++i) {
      const int r = r0 + i;
      const size_t at = (size_t)r * h + c;
      const float ir = inv[r];
      const float xh = (t[at] - mean[r]) * ir, d = du[at];
      sg += to_f(g[at]);
      sdx += d * xh;
      sd += d;
      sdt += ir * (d * ls[c] - m1s[i] - xh * m2s[i]);
    }
    pt[c] = sg;
    pt[h + c] = sdx;
    pt[2 * h + c] = sd;
    pt[3 * h + c] = sdt;
  }
}

// ===========================================================================
// K6: feature adapter blend (pipelines T and V)
// ===========================================================================
//
// Replaces _feat_fwd_kernel (fused_adapter.py:109) and _feat_bwd_kernel
// (:127): y = l2norm(r * (relu(x@W1 + b1) * mask)@W2 + b2 + (1 - r) * x)
// over [n, d] rows, all math in fp32 (weights fp32, x widened), y in T.
// The norm is rsqrt(sum z^2) with no eps, as the TPU kernel's.
//
// Dropout is the TPU kernel's counter hash (_dropout_mask, :87-106),
// reproduced bit for bit: the TPU grid runs 256-row tiles, so the hash
// takes the row within its tile and keys the tile into the seed
// (seed + tile * 1000003), all in wrapping uint32. threshold 0 means no
// dropout (a keep probability above 0 gives a threshold of at least 1).
//
// Both directions run as one launch of thread-block clusters. A call does
// 0.1-6 MFLOP, so the tensor cores would not help; what set the first
// versions' time (0.065 ms a forward call, 0.29 a backward one, on the
// H100) was a block per row, each reading both weights from L2 through
// chains of dependent loads, and the launches around it. A cluster of 8
// blocks takes a group of rows; each block owns an eighth of d (x's, g's,
// z's and y's columns, W1's rows, W2's columns), so each weight element
// is read by one SM per group (its slices copied into shared memory first
// where they fit beside the rows, every copy in flight at once), and it
// adds the cluster's partial products and row sums through distributed
// shared memory in rank order (cluster_sum). The forward half is one
// device function, feat_cluster_forward, that both kernels run, so the
// forward's y and the backward's recompute agree bit for bit.
//
// Forward: feature_adapter_fwd_cluster_kernel writes y = z / |z| over the
// block's slice. It has no reduction across rows, so its groups are as
// small as fills the card (feat_fwd_rows: 8 rows a group at pipeline T's
// 7-35 rows, five clusters at 35).
//
// Backward: feature_adapter_bwd_cluster_kernel (groups of up to 64 rows:
// its weight gradients sum over a group's rows). The weight gradients
// come out of the same launch, each block summing its slice over the
// group's rows in row order; past one group the groups' partials go
// through colsum_kernel, in group order. No atomics: the results repeat
// bit for bit. At pipeline T's 7-35 rows the loops are latency-bound, so
// a block has 512 threads (16 warps, 4 a scheduler) and the weight
// slices are copied with one 4-byte cp.async an element, all in flight
// together.
//
// Every width runs: where a block's row buffers do not fit its shared
// memory even at FRT rows (ceil(d / 8) + k past some 3,370), they live in
// a global workspace the wrapper allocates, and the cluster's rank-order
// sums read the other blocks' partials from it past L1 (FeatBlock::sum)
// instead of through distributed shared memory: the same additions, so
// the same bits, and the forward's y still equals the backward's
// recompute.

constexpr unsigned FEAT_TILE = 256;  // the TPU kernel's ROW_TILE

__device__ __forceinline__ float feat_dropout(int row, int col,
                                              unsigned seed,
                                              unsigned threshold,
                                              float scale) {
  const unsigned r = (unsigned)row % FEAT_TILE;
  const unsigned key = seed + ((unsigned)row / FEAT_TILE) * 1000003u;
  unsigned h = (r * 0x9E3779B1u) ^ ((unsigned)col * 0x85EBCA77u) ^
               (key * 0xC2B2AE3Du);
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  h ^= h >> 15;
  return h < threshold ? scale : 0.f;
}

// --- K6: one launch of 8-block thread-block clusters --------------------

constexpr int FEAT_CLUSTER = 8;  // blocks a cluster: each owns 1/8 of d
constexpr int FRT = 8;           // rows of a thread's register tile
constexpr int FEAT_RMAX = 64;    // rows a group, at most
constexpr int FNT = 512;         // threads a block: 16 warps

// store(e, load(e)) for e < count over the block's threads, eight loads
// in flight a thread before their stores: every load is issued (an e past
// count loads element count - 1; load clamps its addresses and zero-fills
// by a select), since a load behind a branch waits for the one before.
template <class Load, class Store>
__device__ __forceinline__ void stage(int count, const Load& load,
                                      const Store& store) {
  constexpr int B = 8;
  for (int e0 = threadIdx.x; e0 < count; e0 += B * FNT) {
    float v[B];
#pragma unroll
    for (int b = 0; b < B; ++b) v[b] = load(min(e0 + b * FNT, count - 1));
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (e0 + b * FNT < count) store(e0 + b * FNT, v[b]);
  }
}

// acc[i] = the sum over t in [t0, t1) of R[(r0 + i) * ldr + t] w[t * wt]
// for i < FRT, 4 steps of the depth at a time, R read 16 bytes at a time
// (R's rows finite and 0 from depth up to a multiple of 4, so w's last row
// stands in for the rows past depth and every load is issued).
__device__ __forceinline__ void range_dot(const float* R, int ldr, int r0,
                                          const float* w, int wt, int t0,
                                          int t1, int depth,
                                          float (&acc)[FRT]) {
#pragma unroll
  for (int i = 0; i < FRT; ++i) acc[i] = 0.f;
  for (int t = t0; t < t1; t += 4) {
    float wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wv[q] = w[min(t + q, depth - 1) * wt];
#pragma unroll
    for (int i = 0; i < FRT; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(R + (r0 + i) * ldr + t);
      acc[i] = fmaf(v.x, wv[0], acc[i]);
      acc[i] = fmaf(v.y, wv[1], acc[i]);
      acc[i] = fmaf(v.z, wv[2], acc[i]);
      acc[i] = fmaf(v.w, wv[3], acc[i]);
    }
  }
}

// The products of the cluster kernels, out(r, col) = sum over t < depth
// of R[r * ldr + t] W[col * wc + t * wt] for the rows of nrb tiles of FRT
// and col < ncol, handed to epi(r, col, out) (every row of the tiles; R as
// range_dot takes it). The depth is cut into S ranges (4-aligned, in
// order), S = FNT / ncol, at most 8, at least 1, and a sum is its ranges'
// sums added in range order. S comes from the columns alone, never the
// group's rows, so a product's sums take one order at every group size,
// and the forward kernel and the backward's recompute give the same bits.
// Where the columns, tiles and ranges fit the block's threads (few rows,
// as in the forward on pipeline T) a thread takes one of each and the
// ranges' partials go through part ([S][nrb FRT][ncol], at most FNT FRT
// floats); else a thread takes a column and a tile and sums its ranges in
// turn, each from zero, into the total (the same additions, no barrier).
template <class Epi>
__device__ __forceinline__ void rows_product(const float* R, int ldr,
                                             int nrb, int depth,
                                             const float* W, int ncol,
                                             int wc, int wt, float* part,
                                             const Epi& epi) {
  const int S = max(1, min(8, FNT / max(ncol, 1)));
  const int span = ((depth + S - 1) / S + 3) & ~3;
  const int tiles = ncol * nrb;
  float acc[FRT];
  if (S > 1 && tiles * S <= FNT) {
    const int u = threadIdx.x;
    if (u < tiles * S) {  // int offsets: d k < 2^31
      const int col = u % ncol, r0 = (u / ncol) % nrb * FRT, sr = u / tiles;
      range_dot(R, ldr, r0, W + col * wc, wt, sr * span,
                min(depth, sr * span + span), depth, acc);
#pragma unroll
      for (int i = 0; i < FRT; ++i)
        part[(sr * nrb * FRT + r0 + i) * ncol + col] = acc[i];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nrb * FRT * ncol; e += FNT) {
      float v = part[e];
      for (int sr = 1; sr < S; ++sr) v += part[sr * nrb * FRT * ncol + e];
      epi(e / ncol, e % ncol, v);
    }
    return;
  }
  for (int u = threadIdx.x; u < tiles; u += FNT) {
    const int col = u % ncol, r0 = u / ncol * FRT;
    const float* w = W + col * wc;
    float tot[FRT];
#pragma unroll
    for (int i = 0; i < FRT; ++i) acc[i] = 0.f;
    int sr = 0, stop = min(depth, span);  // the running range, its end
    for (int t = 0; t < depth; t += 4) {
      float wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[q] = w[min(t + q, depth - 1) * wt];
#pragma unroll
      for (int i = 0; i < FRT; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(R + (r0 + i) * ldr + t);
        acc[i] = fmaf(v.x, wv[0], acc[i]);
        acc[i] = fmaf(v.y, wv[1], acc[i]);
        acc[i] = fmaf(v.z, wv[2], acc[i]);
        acc[i] = fmaf(v.w, wv[3], acc[i]);
      }
      if (t + 4 >= stop) {  // the range ends: into the total, from zero
#pragma unroll
        for (int i = 0; i < FRT; ++i) {
          tot[i] = sr ? tot[i] + acc[i] : acc[i];
          acc[i] = 0.f;
        }
        ++sr;
        stop = min(depth, stop + span);
      }
    }
    for (; sr < S; ++sr)  // the ranges past the depth: zeros, as above
#pragma unroll
      for (int i = 0; i < FRT; ++i) tot[i] = sr ? tot[i] + 0.f : 0.f;
#pragma unroll
    for (int i = 0; i < FRT; ++i) epi(r0 + i, col, tot[i]);
  }
}

// Floats of one group's gradients [dW1 (d k) | db1 (k) | dW2 (k d) | db2 (d)].
inline size_t feat_grads(int d, int k) {
  return 2 * (size_t)d * k + k + d;
}

// Shared memory of a cluster block: for groups of `rows` rows the x and
// z / dz slices [rows][dsp], the partial product and h / dh [rows][kp]
// and the row partials and statistics [rows][2] each; the products'
// depth-range partials [FNT FRT]; with `resident` weights also W1's rows
// [ds][k | 1] and W2's columns [k][ds | 1] of the slice (odd row strides:
// a warp reading a column of either, one row a lane, hits 32 banks).
// Where even FRT rows' buffers do not fit (ceil(d / 8) + k past some
// 3,370: d past 26,900 or k past 3,370), they live in a global workspace
// instead, feat_buffers floats a block (feat_rows).
inline size_t feat_buffers(int rows, int d, int k) {
  const int ds = (d + FEAT_CLUSTER - 1) / FEAT_CLUSTER;
  const int dsp = (ds + 3) & ~3, kp = (k + 3) & ~3;
  return (size_t)rows * (2 * dsp + 2 * kp + 4) + (size_t)FNT * FRT;
}

inline size_t feat_smem(int rows, int d, int k, bool resident) {
  const int ds = (d + FEAT_CLUSTER - 1) / FEAT_CLUSTER;
  return sizeof(float) *
         (feat_buffers(rows, d, k) +
          (resident ? (size_t)ds * (k | 1) + (size_t)k * (ds | 1) : 0));
}

// A cluster block's share of K6: block rank q of cluster grp (blockIdx.x
// / 8) owns columns [q ds, q ds + ds) of d (ds = ceil(d / 8); the last
// ones may own fewer, or none) for the group's rows [grp * rows, ...)
// (rows: a multiple of FRT), and lays out its buffers as feat_smem says:
// in its shared memory fsm, or, with GLOBAL, in a global workspace at
// gbuf + blockIdx.x * bstride, where every rank's copy lies bstride
// floats from the next (a template parameter, so the shared-memory
// kernels carry no trace of the other route). The weight slices: W1(c,
// j) = W1s[c * ld1 + j] and W2(j, c) = W2s[j * ld2 + c] for c < dsz, j <
// k, in shared memory once feat_cluster_forward has copied them there
// (resident), else in place.
template <bool GLOBAL>
struct FeatBlock {
  int rank, ds, dsp, kp, c0, dsz, row0, nr, nrb, ld1, ld2;
  size_t rs;  // floats between two ranks' buffers (GLOBAL)
  float *X, *Z, *A, *H, *RS, *ST, *P;
  const float *W1s, *W2s;
  __device__ FeatBlock(float* fsm, float* gbuf, size_t bstride, int rank,
                       int grp, int rows, int n, int d, int k,
                       const float* w1, const float* w2)
      : rank(rank), rs(bstride) {
    if (GLOBAL) fsm = gbuf + (size_t)blockIdx.x * bstride;
    ds = (d + FEAT_CLUSTER - 1) / FEAT_CLUSTER;
    dsp = (ds + 3) & ~3;
    kp = (k + 3) & ~3;
    c0 = rank * ds;
    dsz = max(0, min(ds, d - c0));
    row0 = grp * rows;
    nr = min(rows, n - row0);
    nrb = (nr + FRT - 1) / FRT;  // register tiles of rows
    X = fsm;                 // [rows][dsp] x's slice
    Z = X + rows * dsp;      // [rows][dsp] z's slice (the backward: then dz)
    A = Z + rows * dsp;      // [rows][kp] the block's partial product
    H = A + rows * kp;       // [rows][kp] h (the backward: then dh)
    RS = H + rows * kp;      // [rows][2] partial sums of z^2 (and g z)
    ST = RS + 2 * rows;      // [rows][2] 1 / |z| (and <g, y>)
    P = ST + 2 * rows;       // [FNT FRT] the products' range partials
    W1s = w1 + (size_t)c0 * k;
    W2s = w2 + c0;
    ld1 = k;
    ld2 = d;
  }

  // The sum over the cluster's ranks, in rank order, of the float at
  // offset `at` of each rank's copy of this block's buffer buf: through
  // distributed shared memory (vct::cluster_sum), or from the global
  // workspace past L1 (the other blocks wrote it before a cluster.sync(),
  // whose release and acquire order the writes before these reads). The
  // same additions either way.
  __device__ __forceinline__ float sum(
      const cooperative_groups::cluster_group& cluster, float* buf,
      int at) const {
    if constexpr (!GLOBAL) {
      return vct::cluster_sum<FEAT_CLUSTER>(cluster, buf, at);
    } else {
      const float* p = buf - (size_t)rank * rs + at;
      float s = __ldcg(p);
#pragma unroll
      for (int q = 1; q < FEAT_CLUSTER; ++q) s += __ldcg(p + (size_t)q * rs);
      return s;
    }
  }
};

// K6's forward for a cluster block's share (both kernels run it, so they
// round alike): copies the weight slices when resident and x's slice;
// A = x_slice W1[slice, :]; h = relu(the ranks' partials in rank order +
// b1) * mask over the group's rows (0 past them and past k; the mask keyed
// by the global row); z's slice = r (h W2[:, slice] + b2) + (1 - r) x; and
// per row ST[2 r] = 1 / |z| from the ranks' sums of z^2 in rank order,
// rsqrt with no eps as the TPU kernel's. With WITH_G also ST[2 r + 1] =
// <g, y>, from the sums of g z taken beside them. Every block calls it,
// whatever its share (a block with no columns, a group with fewer rows
// than its tiles): it holds two cluster.sync() that all must reach. The
// caller keeps the cluster together (cluster.sync()) before a block may
// leave: the others read its A and RS.
template <typename T, bool WITH_G, bool GLOBAL>
__device__ __forceinline__ void feat_cluster_forward(
    const cooperative_groups::cluster_group& cluster, FeatBlock<GLOBAL>& b,
    const T* __restrict__ x, const float* __restrict__ b1,
    const float* __restrict__ b2, float r, unsigned seed, unsigned threshold,
    float scale, const T* __restrict__ g, int rows, int resident, int d,
    int k) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float *X = b.X, *Z = b.Z, *A = b.A, *H = b.H, *RS = b.RS, *ST = b.ST;
  const int dsp = b.dsp, kp = b.kp, ds = b.ds, dsz = b.dsz, c0 = b.c0;
  const int row0 = b.row0, nr = b.nr, nrb = b.nrb;
  if (resident) {  // every copy in flight at once (cp.async, 4 bytes); a
                   // warp a row of either slice, no division
    float* s1 = b.P + FNT * FRT;
    float* s2 = s1 + ds * (k | 1);
    const float *w1s = b.W1s, *w2s = b.W2s;
    for (int c = warp; c < dsz; c += FNT / 32)
      for (int j = lane; j < k; j += 32)
        vct::cp_async4(s1 + c * (k | 1) + j, w1s + (size_t)c * k + j);
    for (int j = warp; j < k; j += FNT / 32)
      for (int c = lane; c < dsz; c += 32)
        vct::cp_async4(s2 + j * (ds | 1) + c, w2s + (size_t)j * d + c);
    vct::cp_async_commit();
    b.W1s = s1;
    b.W2s = s2;
    b.ld1 = k | 1;
    b.ld2 = ds | 1;
  }
  // x's slice; rows past the group and padding columns 0 (the loads
  // clamped into x, then selected)
  const int n_last = row0 + nr - 1;
  stage(rows * dsp,
        [=](int e) {
          const int rr = e / dsp, c = e % dsp;
          const float v = to_f(x[(size_t)min(row0 + rr, n_last) * d +
                                 min(c0 + c, d - 1)]);
          return rr < nr && c < dsz ? v : 0.f;
        },
        [=](int e, float v) {
          X[e] = v;
          Z[e] = 0.f;
        });
  vct::cp_async_wait<0>();
  __syncthreads();
  // 1. A = x_slice W1[slice, :]
  rows_product(X, dsp, nrb, dsz, b.W1s, k, 1, b.ld1, b.P,
               [=](int rr, int j, float v) { A[rr * kp + j] = v; });
  cluster.sync();
  // pre = the ranks' partials in rank order + b1; h = relu(pre) * mask
  // (0 past the group's rows and k)
  for (int e = tid; e < nrb * FRT * kp; e += FNT) {
    const int rr = e / kp, j = e % kp;
    float v = 0.f;
    if (rr < nr && j < k) {
      v = fmaxf(b.sum(cluster, A, e) + b1[j], 0.f);
      if (threshold) v *= feat_dropout(row0 + rr, j, seed, threshold, scale);
    }
    H[e] = v;
  }
  __syncthreads();
  // 2. z = r (h W2[:, slice] + b2) + (1 - r) x
  rows_product(H, kp, nrb, k, b.W2s, dsz, 1, b.ld2, b.P,
               [=](int rr, int c, float v) {
                 const int at = rr * dsp + c;
                 Z[at] = r * (v + b2[c0 + c]) + (1.f - r) * X[at];
               });
  __syncthreads();
  // the slice's sums of z^2 (and g z), one warp a row
  for (int rr = warp; rr < nr; rr += FNT / 32) {
    float ss = 0.f, gz = 0.f;
    for (int c = lane; c < dsz; c += 32) {
      const float zv = Z[rr * dsp + c];
      ss = fmaf(zv, zv, ss);
      if (WITH_G)
        gz = fmaf(to_f(g[(size_t)(row0 + rr) * d + c0 + c]), zv, gz);
    }
    ss = warp_sum(ss);
    if (WITH_G) gz = warp_sum(gz);
    if (lane == 0) {
      RS[2 * rr] = ss;
      RS[2 * rr + 1] = gz;
    }
  }
  cluster.sync();
  if (tid < nr) {  // the row's sums over d, in rank order
    const float inv = rsqrtf(b.sum(cluster, RS, 2 * tid));
    ST[2 * tid] = inv;
    if (WITH_G) ST[2 * tid + 1] = b.sum(cluster, RS, 2 * tid + 1) * inv;
  }
  __syncthreads();
}

// K6's forward for the rows [grp * rows, ...) of cluster grp: y = z / |z|
// over the block's slice (the share and layout of FeatBlock).
template <typename T, bool GLOBAL>
__global__ void __cluster_dims__(FEAT_CLUSTER, 1, 1) __launch_bounds__(FNT)
    feature_adapter_fwd_cluster_kernel(
        const T* __restrict__ x, const float* __restrict__ w1,
        const float* __restrict__ b1, const float* __restrict__ w2,
        const float* __restrict__ b2, float r, unsigned seed,
        unsigned threshold, float scale, T* __restrict__ y, float* gbuf,
        size_t bstride, int rows, int resident, int n, int d, int k) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float fsm[];
  FeatBlock<GLOBAL> b(fsm, gbuf, bstride, (int)cluster.block_rank(),
                      blockIdx.x / FEAT_CLUSTER, rows, n, d, k, w1, w2);
  feat_cluster_forward<T, false>(cluster, b, x, b1, b2, r, seed, threshold,
                                 scale, (const T*)nullptr, rows, resident, d,
                                 k);
  for (int e = threadIdx.x; e < b.nr * b.dsz; e += FNT) {
    const int rr = e / b.dsz, c = e % b.dsz;
    y[(size_t)(b.row0 + rr) * d + b.c0 + c] =
        from_f<T>(b.Z[rr * b.dsp + c] * b.ST[2 * rr]);
  }
  cluster.sync();  // no block leaves while the cluster may read its RS
}

// K6's gradients for the rows [grp * rows, ...) of cluster grp, written
// to grads + grp * gstride (the gradients themselves with one group, a
// group's partials with more); dx when not null (the share and layout of
// FeatBlock).
template <typename T, bool GLOBAL>
__global__ void __cluster_dims__(FEAT_CLUSTER, 1, 1) __launch_bounds__(FNT)
    feature_adapter_bwd_cluster_kernel(
        const T* __restrict__ x, const float* __restrict__ w1,
        const float* __restrict__ b1, const float* __restrict__ w2,
        const float* __restrict__ b2, float r, unsigned seed,
        unsigned threshold, float scale, const T* __restrict__ g,
        T* __restrict__ dx, float* __restrict__ grads, size_t gstride,
        float* gbuf, size_t bstride, int rows, int resident, int n, int d,
        int k) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float fsm[];
  const int rank = (int)cluster.block_rank(), grp = blockIdx.x / FEAT_CLUSTER;
  FeatBlock<GLOBAL> b(fsm, gbuf, bstride, rank, grp, rows, n, d, k, w1,
                      w2);
  feat_cluster_forward<T, true>(cluster, b, x, b1, b2, r, seed, threshold,
                                scale, g, rows, resident, d, k);
  const int dsp = b.dsp, kp = b.kp, c0 = b.c0, dsz = b.dsz;
  const int row0 = b.row0, nr = b.nr, nrb = b.nrb;
  float *X = b.X, *Z = b.Z, *A = b.A, *H = b.H, *ST = b.ST;
  const float *W1s = b.W1s, *W2s = b.W2s;
  const int ld1 = b.ld1, ld2 = b.ld2;
  float* gout = grads + (size_t)grp * gstride;
  const int tid = threadIdx.x;
  // dz = (g - y <g, y>) / |z| over z
  for (int e = tid; e < nr * dsz; e += FNT) {
    const int rr = e / dsz, c = e % dsz;
    const float inv = ST[2 * rr], gy = ST[2 * rr + 1];
    const float zv = Z[rr * dsp + c];
    Z[rr * dsp + c] =
        (to_f(g[(size_t)(row0 + rr) * d + c0 + c]) - (zv * inv) * gy) * inv;
  }
  __syncthreads();
  // 3. A = da_slice W2[:, slice]^T = r (dz_slice W2[:, slice]^T)
  rows_product(Z, dsp, nrb, dsz, W2s, k, ld2, 1, b.P,
               [=](int rr, int j, float v) { A[rr * kp + j] = r * v; });
  // dW2[:, slice] = h^T da = r (h^T dz) (a thread: row j, 4 columns),
  // db2[slice] = r (the sum of dz), over the group's rows in order
  const int dq = (dsz + 3) / 4;
  float* dw2 = gout + (size_t)d * k + k + c0;
  for (int u = tid; u < k * dq; u += FNT) {
    const int j = u / dq, c = (u % dq) * 4;
    float acc[4] = {};
    for (int rr = 0; rr < nr; ++rr) {
      const float hv = H[rr * kp + j];
      const float4 zv = *reinterpret_cast<const float4*>(Z + rr * dsp + c);
      acc[0] = fmaf(hv, zv.x, acc[0]);
      acc[1] = fmaf(hv, zv.y, acc[1]);
      acc[2] = fmaf(hv, zv.z, acc[2]);
      acc[3] = fmaf(hv, zv.w, acc[3]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c + q < dsz) dw2[(size_t)j * d + c + q] = r * acc[q];
  }
  for (int c = tid; c < dsz; c += FNT) {
    float s = 0.f;
    for (int rr = 0; rr < nr; ++rr) s += Z[rr * dsp + c];
    gout[2 * (size_t)d * k + k + c0 + c] = r * s;
  }
  cluster.sync();
  // dh = (the ranks' partials in rank order) * mask where pre > 0, over h
  // (h > 0 exactly where pre > 0 and the mask keeps the element)
  for (int e = tid; e < nr * k; e += FNT) {
    const int at = (e / k) * kp + e % k;
    float s = b.sum(cluster, A, at);
    if (threshold) s *= feat_dropout(row0 + e / k, e % k, seed, threshold,
                                     scale);
    H[at] = H[at] > 0.f ? s : 0.f;
  }
  __syncthreads();
  // dW1[slice, :] = x_slice^T dh (a thread: row c, 4 columns); db1 = the
  // sum of dh, by rank 0
  const int kq = kp / 4;
  for (int u = tid; u < dsz * kq; u += FNT) {
    const int c = u / kq, j = (u % kq) * 4;
    float acc[4] = {};
    for (int rr = 0; rr < nr; ++rr) {
      const float xv = X[rr * dsp + c];
      const float4 hv = *reinterpret_cast<const float4*>(H + rr * kp + j);
      acc[0] = fmaf(xv, hv.x, acc[0]);
      acc[1] = fmaf(xv, hv.y, acc[1]);
      acc[2] = fmaf(xv, hv.z, acc[2]);
      acc[3] = fmaf(xv, hv.w, acc[3]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (j + q < k) gout[(size_t)(c0 + c) * k + j + q] = acc[q];
  }
  if (rank == 0)
    for (int j = tid; j < k; j += FNT) {
      float s = 0.f;
      for (int rr = 0; rr < nr; ++rr) s += H[rr * kp + j];
      gout[(size_t)d * k + j] = s;
    }
  // 4. dx = (1 - r) dz + dh W1[slice, :]^T
  if (dx != nullptr)
    rows_product(H, kp, nrb, k, W1s, dsz, ld1, 1, b.P,
                 [=](int rr, int c, float v) {
                   if (rr < nr)
                     dx[(size_t)(row0 + rr) * d + c0 + c] =
                         from_f<T>((1.f - r) * Z[rr * dsp + c] + v);
                 });
  cluster.sync();  // no block leaves while the cluster may read its A
}

// ===========================================================================
// K1 (forward and backward) and fp32 weight gradients on the TF32 tensor
// cores
// ===========================================================================
//
// K1's function is fp32 (the TPU kernel widens x, W1, W2 and g to fp32),
// so its products cannot round their operands to bf16, nor to TF32 in one
// pass (2^-11 relative a product). They run as error-compensated TF32
// products (vct::Tf32Gemm): each fp32 operand element is split into a
// TF32 big part and a TF32 small remainder and the products accumulate
// small b + big s + big b in fp32, about 2^-22 relative a product against
// fp32's 2^-24. A bf16 x (the FAST policy) is exact in TF32, so x W1 and
// x^T dpre take two passes, the other products three. At the train
// step's vision shape ([18912, 768], hidden 256, no dx) that is 97 GFLOP
// of TF32 products (0.20 ms at 495 TFLOP/s) where fp32 FMAs would take
// 0.56 ms at best. The row pass becomes products over 128 x 64 tiles with
// fused epilogues, a LayerNorm pass and ordered weight gradients:
//
//   seqbwd_pre_kernel    pre = x W1 + b1; writes h = gelu(pre) and
//                        gelu'(pre) [n, k], fp32
//   seqbwd_z_kernel      z = (x + h W2) + b2 [n, h], fp32
//   seqbwd_ln_kernel     per 32-row tile: each row's statistics (one warp
//                        a row), then dz = LN backward of g ls, written
//                        over z, and the tile's column sums of dz (db2),
//                        g xhat (dls) and g (dlb)
//   seqbwd_dpre_kernel   dpre = (dz W2^T) gelu'(pre) [n, k] and the
//                        128-row tile's column sums of dpre (db1)
//   seqbwd_dx_kernel     dx = dz + dpre W1^T (when asked), cast once
//
// then dW1 = x^T dpre and dW2 = h^T dz through wgrad_tf32_kernel (ordered
// row chunks, as wgrad_kernel) and the partials through colsum_kernel, in
// order: no atomics, so the gradients repeat bit for bit. The fp32
// intermediates (h, gelu'(pre), dpre, z / dz) go through device memory:
// about 0.3 GB at the vision shape, 0.1 ms of HBM. Widths: h a multiple
// of 8 and k of 4 (every row copies in 16-byte chunks); the wrapper sends
// other widths to seq_adapter_bwd_kernel above. The fp32 weight gradients
// of K2, K3 and K6 take wgrad_tf32_kernel as well where their operands
// copy in 16-byte chunks (vct_wgrad_tf32).
//
// K1's forward (replaces _seq_fwd_kernel, fused_adapter.py:310) takes the
// same passes at the same widths, three launches behind
// vct_seq_adapter_fwd:
//
//   seqfwd_pre_kernel    h = gelu(x W1 + b1) [n, k], fp32
//   seqfwd_z_kernel      z = (x + h W2) + b2 [n, h], fp32 (the body of
//                        seqbwd_z_kernel under its own name, so a profile
//                        files it under the forward)
//   seqfwd_ln_kernel     y = LN(z), one warp a row (the mean, then the
//                        mean of squared deviations), rounded once to x's
//                        type
//
// At the train step's vision shape ([18912, 768], hidden 256, bf16 x) its
// products are 37 GFLOP of TF32 passes (0.075 ms at 495 TFLOP/s) where
// the first, CUDA-core kernel's fp32 FMAs needed 0.22 ms at the least
// and took 1.4; h and z go through device memory (87 MB with the LN
// pass's reads and writes, 0.026 ms of HBM). A served request (77 or 197
// rows) gives the passes 4-24 blocks.

// 128 x 64 block tiles on 8 warps of 32 x 32, 32-deep stages, 3 stages
template <typename TA, bool A_T, bool B_T>
using Tf32G = vct::Tf32Gemm<128, 64, 32, 32, 32, A_T, B_T, 3, TA, float>;
constexpr int LNB_ROWS = 32;  // rows a block of K1's LN backward

// One block's tile of A B (blockIdx.x the column tile, blockIdx.y the row
// tile), handed to epi(r, c, v0, v1) for each pair of columns (c, c + 1)
// of a row r < m_end with c < n_end (n_end even).
template <class G, class Epi, typename TA>
__device__ __forceinline__ void tf32_tile(const Epi& epi, const TA* A,
                                          long long lda, const float* B,
                                          long long ldb, int m_end,
                                          int n_end, int depth) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int c0 = blockIdx.x * G::TILE_N, r0 = blockIdx.y * G::TILE_M;
  typename G::Acc acc;
  G::zero(acc);
  G::run(acc, tc_smem, A, lda, B, ldb, r0, m_end, c0, n_end, 0, depth);
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int wm = G::warp_m(threadIdx.x), wn = G::warp_n(threadIdx.x);
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + wm + i * 16 + gr + half * 8;
      if (r >= m_end) continue;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int c = c0 + wn + j * 8 + 2 * tq;
        if (c < n_end)
          epi(r, c, acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
}

// h = gelu(v + b1), gp = gelu'(v + b1), fp32
struct PreEpi {
  float* hh;
  float* gp;
  const float* b1;
  int ld;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    float h0, h1, d0, d1;
    gelu_and_grad(v0 + b1[c], h0, d0);
    gelu_and_grad(v1 + b1[c + 1], h1, d1);
    const size_t at = (size_t)r * ld + c;
    *reinterpret_cast<float2*>(hh + at) = make_float2(h0, h1);
    *reinterpret_cast<float2*>(gp + at) = make_float2(d0, d1);
  }
};

// z = (x + v) + b2, fp32
template <typename TX>
struct ZEpi {
  float* z;
  const TX* x;
  const float* b2;
  int ld;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    const size_t at = (size_t)r * ld + c;
    *reinterpret_cast<float2*>(z + at) =
        make_float2((to_f(x[at]) + v0) + b2[c],
                    (to_f(x[at + 1]) + v1) + b2[c + 1]);
  }
};

// dx = dz + v, cast to TX
template <typename TX>
struct DxEpi {
  TX* dx;
  const float* dz;
  int ld;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    const size_t at = (size_t)r * ld + c;
    dx[at] = from_f<TX>(dz[at] + v0);
    dx[at + 1] = from_f<TX>(dz[at + 1] + v1);
  }
};

template <typename TX>
__global__ void __launch_bounds__(Tf32G<TX, false, false>::THREADS, 2)
    seqbwd_pre_kernel(const TX* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, float* __restrict__ hh,
                      float* __restrict__ gp, int n, int h, int k) {
  tf32_tile<Tf32G<TX, false, false>>(PreEpi{hh, gp, b1, k}, x, h, w1, k, n,
                                     k, h);
}

// z = (x + h W2) + b2, one block's 128 x 64 tile
template <typename TX>
__device__ __forceinline__ void seq_z_tile(const float* hh, const float* w2,
                                           const TX* x, const float* b2,
                                           float* z, int n, int h, int k) {
  tf32_tile<Tf32G<float, false, false>>(ZEpi<TX>{z, x, b2, h}, hh, k, w2, h,
                                        n, h, k);
}

template <typename TX>
__global__ void __launch_bounds__(Tf32G<float, false, false>::THREADS, 2)
    seqbwd_z_kernel(const float* __restrict__ hh,
                    const float* __restrict__ w2, const TX* __restrict__ x,
                    const float* __restrict__ b2, float* __restrict__ z,
                    int n, int h, int k) {
  seq_z_tile(hh, w2, x, b2, z, n, h, k);
}

// zd: z in, dz out. Per 32-row tile: one warp a row for the row's mean,
// 1/std (the forward's statistics: the mean, then the mean of squared
// deviations), m1 = mean(g ls) and m2 = mean(g ls xhat); then one thread a
// column over the tile's rows: dz = inv (g ls - m1 - xhat m2) and the
// column sums [db2 = sum dz | dls = sum g xhat | dlb = sum g] -> part.
template <typename TX>
__global__ void __launch_bounds__(NT)
    seqbwd_ln_kernel(float* __restrict__ zd, const TX* __restrict__ g,
                     const float* __restrict__ ls, float eps,
                     float* __restrict__ part, int n, int h) {
  __shared__ float stat[LNB_ROWS][4];  // mean, 1/std, m1, m2
  const int r0 = blockIdx.x * LNB_ROWS, nv = min(LNB_ROWS, n - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < nv; rr += NT / 32) {
    const float* z = zd + (size_t)(r0 + rr) * h;
    const TX* gr = g + (size_t)(r0 + rr) * h;
    float s = 0.f;
    for (int c = lane; c < h; c += 32) s += z[c];
    const float mean = warp_sum(s) / h;
    float v = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float d = z[c] - mean;
      v += d * d;
    }
    const float inv = rsqrtf(warp_sum(v) / h + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float gx = to_f(gr[c]) * ls[c];
      s1 += gx;
      s2 += gx * ((z[c] - mean) * inv);
    }
    const float m1 = warp_sum(s1) / h, m2 = warp_sum(s2) / h;
    if (lane == 0) {
      stat[rr][0] = mean;
      stat[rr][1] = inv;
      stat[rr][2] = m1;
      stat[rr][3] = m2;
    }
  }
  __syncthreads();
  float* pt = part + (size_t)blockIdx.x * 3 * h;
  for (int c = threadIdx.x; c < h; c += NT) {
    const float lsc = ls[c];
    float sdz = 0.f, sgx = 0.f, sg = 0.f;
#pragma unroll 8
    for (int rr = 0; rr < nv; ++rr) {
      const size_t at = (size_t)(r0 + rr) * h + c;
      const float gv = to_f(g[at]);
      const float xh = (zd[at] - stat[rr][0]) * stat[rr][1];
      const float dz =
          stat[rr][1] * (gv * lsc - stat[rr][2] - xh * stat[rr][3]);
      zd[at] = dz;
      sdz += dz;
      sgx += gv * xh;
      sg += gv;
    }
    pt[c] = sdz;
    pt[h + c] = sgx;
    pt[2 * h + c] = sg;
  }
}

// dpre = (dz W2^T) gelu'(pre) [n, k] and the 128-row tile's column sums
// of dpre -> part [row tiles, k]: across the lanes of a column, then the
// four 32-row warp rows of the block in row order.
__global__ void __launch_bounds__(Tf32G<float, false, true>::THREADS, 2)
    seqbwd_dpre_kernel(const float* __restrict__ dz,
                       const float* __restrict__ w2,
                       const float* __restrict__ gp,
                       float* __restrict__ dpre, float* __restrict__ part,
                       int n, int h, int k) {
  typedef Tf32G<float, false, true> G;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ float red[G::TILE_M / 32][G::TILE_N];
  const int c0 = blockIdx.x * G::TILE_N, r0 = blockIdx.y * G::TILE_M;
  typename G::Acc acc;
  G::zero(acc);
  G::run(acc, tc_smem, dz, h, w2, h, r0, n, c0, k, 0, h);  // dz W2^T
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int wm = G::warp_m(threadIdx.x), wn = G::warp_n(threadIdx.x);
  float cs[G::NT][2];
#pragma unroll
  for (int j = 0; j < G::NT; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + wm + i * 16 + gr + half * 8;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int c = c0 + wn + j * 8 + 2 * tq;
        if (c >= k) continue;
        const size_t at = (size_t)r * k + c;
        const float2 d = *reinterpret_cast<const float2*>(gp + at);
        const float p0 = acc[i][j][2 * half] * d.x;
        const float p1 = acc[i][j][2 * half + 1] * d.y;
        *reinterpret_cast<float2*>(dpre + at) = make_float2(p0, p1);
        cs[j][0] += p0;
        cs[j][1] += p1;
      }
    }
#pragma unroll
  for (int j = 0; j < G::NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cs[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (gr == 0) red[wm / 32][wn + j * 8 + 2 * tq + e] = v;
    }
  __syncthreads();
  if (threadIdx.x < G::TILE_N && c0 + threadIdx.x < k) {
    float v = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < G::TILE_M / 32; ++w) v += red[w][threadIdx.x];
    part[(size_t)blockIdx.y * k + c0 + threadIdx.x] = v;
  }
}

template <typename TX>
__global__ void __launch_bounds__(Tf32G<float, false, true>::THREADS, 2)
    seqbwd_dx_kernel(const float* __restrict__ dpre,
                     const float* __restrict__ w1,
                     const float* __restrict__ dz, TX* __restrict__ dx,
                     int n, int h, int k) {
  tf32_tile<Tf32G<float, false, true>>(DxEpi<TX>{dx, dz, h}, dpre, k, w1, k,
                                       n, h, k);  // dpre W1^T
}

// h = gelu(v + b1), fp32: the forward's pre pass, which needs no gelu'
struct HEpi {
  float* hh;
  const float* b1;
  int ld;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    *reinterpret_cast<float2*>(hh + (size_t)r * ld + c) =
        make_float2(gelu_erf(v0 + b1[c]), gelu_erf(v1 + b1[c + 1]));
  }
};

template <typename TX>
__global__ void __launch_bounds__(Tf32G<TX, false, false>::THREADS, 2)
    seqfwd_pre_kernel(const TX* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ b1, float* __restrict__ hh,
                      int n, int h, int k) {
  tf32_tile<Tf32G<TX, false, false>>(HEpi{hh, b1, k}, x, h, w1, k, n, k, h);
}

template <typename TX>
__global__ void __launch_bounds__(Tf32G<float, false, false>::THREADS, 2)
    seqfwd_z_kernel(const float* __restrict__ hh,
                    const float* __restrict__ w2, const TX* __restrict__ x,
                    const float* __restrict__ b2, float* __restrict__ z,
                    int n, int h, int k) {
  seq_z_tile(hh, w2, x, b2, z, n, h, k);
}

// y = LN(z) rounded once to TX, one warp a row, 16-byte loads (h a
// multiple of 4; z, ls and lb 16-byte aligned)
template <typename TX>
__global__ void __launch_bounds__(NT)
    seqfwd_ln_kernel(const float* __restrict__ z,
                     const float* __restrict__ ls,
                     const float* __restrict__ lb, float eps,
                     TX* __restrict__ y, int n, int h) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (r >= n) return;
  const float4* zr = reinterpret_cast<const float4*>(z + (size_t)r * h);
  const float4* ls4 = reinterpret_cast<const float4*>(ls);
  const float4* lb4 = reinterpret_cast<const float4*>(lb);
  const int h4 = h / 4;
  float s = 0.f;
  for (int c = lane; c < h4; c += 32) {
    const float4 v = zr[c];
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = warp_sum(s) / h;
  float q = 0.f;
  for (int c = lane; c < h4; c += 32) {
    const float4 v = zr[c];
    const float a = v.x - mean, b = v.y - mean, e = v.z - mean,
                f = v.w - mean;
    q += (a * a + b * b) + (e * e + f * f);
  }
  const float inv = rsqrtf(warp_sum(q) / h + eps);
  TX* yr = y + (size_t)r * h;
  for (int c = lane; c < h4; c += 32) {
    const float4 v = zr[c], sc = ls4[c], sh = lb4[c];
    yr[4 * c] = from_f<TX>((v.x - mean) * inv * sc.x + sh.x);
    yr[4 * c + 1] = from_f<TX>((v.y - mean) * inv * sc.y + sh.y);
    yr[4 * c + 2] = from_f<TX>((v.z - mean) * inv * sc.z + sh.z);
    yr[4 * c + 3] = from_f<TX>((v.w - mean) * inv * sc.w + sh.w);
  }
}

// out[z*so + a*ldo + b] = sum over the split's rows r of A[r*lda + z*sa +
// a] * B[r*ldb + z*sb + b], fp32 B and fp32 or bf16 A, error-compensated
// on the TF32 tensor cores: wgrad_kernel's contract, grid and ordered row
// chunks over 128 x 64 output tiles. Operands 16-byte aligned, their
// strides, offsets and widths multiples of a 16-byte chunk.
template <typename TA>
__global__ void __launch_bounds__(Tf32G<TA, true, false>::THREADS, 2)
    wgrad_tf32_kernel(const TA* __restrict__ A, int lda, int sa,
                      const float* __restrict__ B, int ldb, int sb,
                      float* __restrict__ out, int ldo, int so, int n, int P,
                      int Q, int nz, int chunk, size_t split_stride) {
  typedef Tf32G<TA, true, false> G;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int z = blockIdx.z % nz, split = blockIdx.z / nz;
  const int a0 = blockIdx.y * G::TILE_M, b0 = blockIdx.x * G::TILE_N;
  const int rbeg = split * chunk, rend = min(n, rbeg + chunk);
  A += (size_t)z * sa;
  B += (size_t)z * sb;
  out += (size_t)z * so + split * split_stride;
  typename G::Acc acc;
  G::zero(acc);
  G::run(acc, tc_smem, A, lda, B, ldb, a0, P, b0, Q, rbeg, rend);
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int wm = G::warp_m(threadIdx.x), wn = G::warp_n(threadIdx.x);
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int a = a0 + wm + i * 16 + gr + half * 8;
      if (a >= P) continue;
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = b0 + wn + j * 8 + 2 * tq + e;
          if (b < Q) out[(size_t)a * ldo + b] = acc[i][j][2 * half + e];
        }
    }
}

// Dynamic shared memory above 48 KB must be allowed per kernel.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline dim3 grid_for(int n) { return dim3((n + ROWS - 1) / ROWS); }

// K2's forward takes 32-row tiles where they fit in a Hopper block's 227
// KB of shared memory, else 16-row tiles.
constexpr size_t SMEM_MAX = 227 * 1024;
size_t cab_fwd_smem(int rows, int din, int h) {
  const size_t ldq = din > h ? din : h;
  return sizeof(float) * ((size_t)rows * (ldq + h + SMAX) + KC * 128);
}
template <typename T, int R>
int cab_fwd_launch(const void* x, const void* wt, const void* bt,
                          const void* ls, const void* lb, const void* wq,
                          const void* bq, const void* kt, const void* v,
                          const void* wo, const void* bo, float eps,
                          float scale, void* y, int n, int din, int h,
                          int heads, int tk, size_t smem, cudaStream_t st) {
  auto kern = cross_attn_block_fwd_kernel<T, R>;
  int err;
  if ((err = allow_smem(kern, smem))) return err;
  kern<<<(n + R - 1) / R, NT, smem, st>>>(
      (const T*)x, (const T*)wt, (const float*)bt, (const float*)ls,
      (const float*)lb, (const T*)wq, (const float*)bq, (const T*)kt,
      (const T*)v, (const T*)wo, (const float*)bo, eps, scale, (T*)y, n, din,
      h, heads, tk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vct_wgrad_tf32(int a_bf16, const void* a, int lda, int sa,
                              const void* b, int ldb, int sb, void* out,
                              int ldo, int so, int n, int p, int q, int z,
                              int splits, void* work, size_t out_numel,
                              void* stream);
extern "C" int vct_colsum(const void* part, int tiles, int v, void* out,
                          void* stream);

namespace {

// Row chunks of a weight gradient on the tensor cores with `tiles` output
// tiles (128 x 128 or, TF32, 128 x 64; two blocks fit an SM): at most one
// wave of the card,
// no chunk under 256 rows, at most 16 (as _tc_splits in
// ops/fused_adapter.py, which the other callers of vct_wgrad use).
constexpr int SMS = 132;  // H100 SXM streaming multiprocessors
static int tc_splits(int n, int tiles) {
  int s = 2 * SMS / tiles;
  if (s > n / 256) s = n / 256;
  if (s > 16) s = 16;
  return s > 1 ? s : 1;
}

// K1 backward on the TF32 tensor cores: the row chunks of its two weight
// gradients (dW1 [h, k] and dW2 [k, h], 128 x 64 tiles).
void seqbwd_splits(int n, int h, int k, int* s1, int* s2) {
  *s1 = tc_splits(n, ((k + 63) / 64) * ((h + 127) / 128));
  *s2 = tc_splits(n, ((h + 63) / 64) * ((k + 127) / 128));
}

template <typename TX>
int seqbwd_launch(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, const void* ls,
                         const void* g, float eps, void* dx, void* dw1,
                         void* dw2, void* vec, void* ws, int n, int h, int k,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rt = (n + 127) / 128, lt = (n + LNB_ROWS - 1) / LNB_ROWS;
  float* hh = (float*)ws;
  float* gp = hh + (size_t)n * k;
  float* dpre = gp + (size_t)n * k;
  float* zd = dpre + (size_t)n * k;
  float* part_dpre = zd + (size_t)n * h;
  float* part_ln = part_dpre + (size_t)rt * k;
  float* work = part_ln + (size_t)lt * 3 * h;
  const float *fw1 = (const float*)w1, *fw2 = (const float*)w2;
  const TX* tx = (const TX*)x;
  int err;
  typedef Tf32G<TX, false, false> GP;
  typedef Tf32G<float, false, false> GZ;
  typedef Tf32G<float, false, true> GT;
  if ((err = allow_smem(seqbwd_pre_kernel<TX>, GP::SMEM_BYTES))) return err;
  seqbwd_pre_kernel<TX><<<dim3((k + 63) / 64, rt), GP::THREADS,
                          GP::SMEM_BYTES, st>>>(tx, fw1, (const float*)b1, hh,
                                                gp, n, h, k);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = allow_smem(seqbwd_z_kernel<TX>, GZ::SMEM_BYTES))) return err;
  seqbwd_z_kernel<TX><<<dim3((h + 63) / 64, rt), GZ::THREADS, GZ::SMEM_BYTES,
                        st>>>(hh, fw2, tx, (const float*)b2, zd, n, h, k);
  if ((err = (int)cudaGetLastError())) return err;
  seqbwd_ln_kernel<TX><<<lt, NT, 0, st>>>(zd, (const TX*)g, (const float*)ls,
                                          eps, part_ln, n, h);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = allow_smem(seqbwd_dpre_kernel, GT::SMEM_BYTES))) return err;
  seqbwd_dpre_kernel<<<dim3((k + 63) / 64, rt), GT::THREADS, GT::SMEM_BYTES,
                       st>>>(zd, fw2, gp, dpre, part_dpre, n, h, k);
  if ((err = (int)cudaGetLastError())) return err;
  if (dx != nullptr) {
    if ((err = allow_smem(seqbwd_dx_kernel<TX>, GT::SMEM_BYTES))) return err;
    seqbwd_dx_kernel<TX><<<dim3((h + 63) / 64, rt), GT::THREADS,
                           GT::SMEM_BYTES, st>>>(dpre, fw1, zd, (TX*)dx, n, h,
                                                 k);
    if ((err = (int)cudaGetLastError())) return err;
  }
  int s1, s2;
  seqbwd_splits(n, h, k, &s1, &s2);
  const int abf = sizeof(TX) == 2;
  // dW1 = x^T dpre, dW2 = h^T dz (one work buffer: the stream orders them)
  if ((err = vct_wgrad_tf32(abf, x, h, 0, dpre, k, 0, dw1, k, 0, n, h, k, 1,
                            s1, work, (size_t)h * k, stream)))
    return err;
  if ((err = vct_wgrad_tf32(0, hh, k, 0, zd, h, 0, dw2, h, 0, n, k, h, 1, s2,
                            work, (size_t)h * k, stream)))
    return err;
  if ((err = vct_colsum(part_dpre, rt, k, vec, stream))) return err;
  return vct_colsum(part_ln, lt, 3 * h, (float*)vec + k, stream);
}

// The widths K1 runs on the TF32 tensor cores, forward and backward:
// every row of x, W1, W2, h and z copies in 16-byte chunks.
bool seq_tc(int h, int k) { return h % 8 == 0 && k % 4 == 0; }

// The widths K3 runs on the bf16 tensor cores, forward and backward: every
// row of x, W1, W2, um, hm and dpm copies in 16-byte chunks. At the others
// (and in fp32) it runs its CUDA-core kernels, prenorm_mlp_fwd_kernel and
// prenorm_mlp_bwd_kernel, which compute the same function (ops.
// fused_adapter.prenorm_mlp_tensor_cores is this gate in Python).
bool pnmlp_tc(int h, int k) { return h % 8 == 0 && k % 8 == 0; }

// K1 forward on the TF32 tensor cores: ws holds h [n, k] and z [n, h].
template <typename TX>
int seqfwd_launch(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* ls,
                  const void* lb, float eps, void* y, void* ws, int n, int h,
                  int k, cudaStream_t st) {
  float* hh = (float*)ws;
  float* z = hh + (size_t)n * k;
  const int rt = (n + 127) / 128;
  typedef Tf32G<TX, false, false> GP;
  typedef Tf32G<float, false, false> GZ;
  int err;
  if ((err = allow_smem(seqfwd_pre_kernel<TX>, GP::SMEM_BYTES))) return err;
  seqfwd_pre_kernel<TX><<<dim3((k + 63) / 64, rt), GP::THREADS,
                          GP::SMEM_BYTES, st>>>(
      (const TX*)x, (const float*)w1, (const float*)b1, hh, n, h, k);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = allow_smem(seqfwd_z_kernel<TX>, GZ::SMEM_BYTES))) return err;
  seqfwd_z_kernel<TX><<<dim3((h + 63) / 64, rt), GZ::THREADS, GZ::SMEM_BYTES,
                        st>>>(hh, (const float*)w2, (const TX*)x,
                              (const float*)b2, z, n, h, k);
  if ((err = (int)cudaGetLastError())) return err;
  seqfwd_ln_kernel<TX><<<(n + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
      z, (const float*)ls, (const float*)lb, eps, (TX*)y, n, h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t vct_prenorm_mlp_smem(int h);
extern "C" size_t vct_prenorm_mlp_bwd_smem(int h);
extern "C" size_t vct_prenorm_mlp_bwd_ws(int n, int h);

namespace {

// The CUDA-core kernel: fp32, and bf16 at the widths pnmlp_tc refuses
// (bf16 on its gate takes vct_prenorm_mlp_fwd_bf16).
template <typename T>
int pnmlp_fwd_launch(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, const void* ls,
                     const void* lb, float eps, void* y, int n, int h, int k,
                     cudaStream_t st) {
  const size_t smem = vct_prenorm_mlp_smem(h);
  auto kern = prenorm_mlp_fwd_kernel<T>;
  int err;
  if ((err = allow_smem(kern, smem))) return err;
  kern<<<grid_for(n), NT, smem, st>>>(
      (const T*)x, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (const float*)ls, (const float*)lb, eps, (T*)y, n, h,
      k);
  return (int)cudaGetLastError();
}

// The CUDA-core row pass: fp32, and bf16 at the widths pnmlp_tc refuses
// (bf16 on its gate takes vct_prenorm_mlp_bwd_bf16).
template <typename T>
int pnmlp_bwd_launch(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* ls, const void* lb,
                     const void* g, float eps, void* dx, void* um_out,
                     void* hm_out, void* dpm_out, void* part, void* ws,
                     int n, int h, int k, cudaStream_t st) {
  const size_t smem = vct_prenorm_mlp_bwd_smem(h);
  if (vct_prenorm_mlp_bwd_ws(n, h) && ws == nullptr)
    return (int)cudaErrorInvalidValue;
  auto kern = prenorm_mlp_bwd_kernel<T>;
  int err;
  if ((err = allow_smem(kern, smem))) return err;
  kern<<<grid_for(n), NT, smem, st>>>(
      (const T*)x, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)ls, (const float*)lb, (const T*)g, eps, (T*)dx,
      (T*)um_out, (T*)hm_out, (T*)dpm_out, (float*)part,
      vct_prenorm_mlp_bwd_ws(n, h) ? (float*)ws : nullptr, n, h, k);
  return (int)cudaGetLastError();
}
// K2 backward's CUDA-core row pass at R = rows rows a block (R2 or R2 / 2).
template <typename T>
int cab_bwd_launch(const void* x, const void* wt, const void* bt,
                   const void* ls, const void* lb, const void* wq,
                   const void* bq, const void* k, const void* v,
                   const void* wo, const void* g, float eps, float scale,
                   void* dx, void* um_out, void* qm_out, void* om_out,
                   void* dom_out, void* pm_out, void* dsm_out, void* dqm_out,
                   void* dtm_out, void* part, int n, int din, int h,
                   int heads, int tk, int rows, size_t smem,
                   cudaStream_t st) {
  auto kern = rows == R2 ? cross_attn_block_bwd_kernel<T, R2>
                         : cross_attn_block_bwd_kernel<T, R2 / 2>;
  int err;
  if ((err = allow_smem(kern, smem))) return err;
  kern<<<dim3((n + rows - 1) / rows), NT, smem, st>>>(
      (const T*)x, (const T*)wt, (const float*)bt, (const float*)ls,
      (const float*)lb, (const T*)wq, (const float*)bq, (const T*)k,
      (const T*)v, (const T*)wo, (const T*)g, eps, scale, (T*)dx,
      (T*)um_out, (T*)qm_out, (T*)om_out, (T*)dom_out, (T*)pm_out,
      (T*)dsm_out, (T*)dqm_out, (T*)dtm_out, (float*)part, n, din, h, heads,
      tk);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" {

// Shared memory each entry point asks for, in bytes (the wrapper names it
// when a launch is refused).
size_t vct_seq_adapter_smem(int h, int k) {
  return sizeof(float) * ((size_t)ROWS * h + (size_t)ROWS * k + KC * 128);
}
size_t vct_prenorm_mlp_smem(int h) {
  return sizeof(float) * (2 * (size_t)ROWS * h + ROWS * 128 + KC * 128);
}
size_t vct_cross_attn_block_smem(int din, int h) {
  const size_t s = cab_fwd_smem(ROWS, din, h);
  return s <= SMEM_MAX ? s : cab_fwd_smem(ROWS / 2, din, h);
}

// Bytes of scratch vct_seq_adapter_fwd needs: h [n, k] and z [n, h] in
// fp32 on the TF32 tensor cores, none on the CUDA cores.
size_t vct_seq_adapter_fwd_ws(int n, int h, int k) {
  return seq_tc(h, k) ? sizeof(float) * (size_t)n * (h + k) : 0;
}

// K1 forward: the TF32 tensor-core passes at the widths seq_tc takes
// (every pointer 16-byte aligned; ws: vct_seq_adapter_fwd_ws bytes), the
// CUDA-core seq_adapter_fwd_kernel at the others (ws unused).
int vct_seq_adapter_fwd(int bf16, const void* x, const void* w1,
                        const void* b1, const void* w2, const void* b2,
                        const void* ls, const void* lb, float eps, void* y,
                        void* ws, int n, int h, int k, void* stream) {
  const size_t smem = vct_seq_adapter_smem(h, k);
  cudaStream_t st = (cudaStream_t)stream;
  if (seq_tc(h, k))
    return bf16 ? seqfwd_launch<vct::bf16>(x, w1, b1, w2, b2, ls, lb, eps, y,
                                           ws, n, h, k, st)
                : seqfwd_launch<float>(x, w1, b1, w2, b2, ls, lb, eps, y, ws,
                                       n, h, k, st);
  const float *fw1 = (const float*)w1, *fb1 = (const float*)b1,
              *fw2 = (const float*)w2, *fb2 = (const float*)b2,
              *fls = (const float*)ls, *flb = (const float*)lb;
  int err;
  if (bf16) {
    auto kern = seq_adapter_fwd_kernel<__nv_bfloat16>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<grid_for(n), NT, smem, st>>>((const __nv_bfloat16*)x, fw1, fb1,
                                        fw2, fb2, fls, flb, eps,
                                        (__nv_bfloat16*)y, n, h, k);
  } else {
    auto kern = seq_adapter_fwd_kernel<float>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<grid_for(n), NT, smem, st>>>((const float*)x, fw1, fb1, fw2, fb2,
                                        fls, flb, eps, (float*)y, n, h, k);
  }
  return (int)cudaGetLastError();
}

// K3 forward on the CUDA cores (pnmlp_fwd_launch).
int vct_prenorm_mlp_fwd(int bf16, const void* x, const void* w1,
                        const void* b1, const void* w2, const void* b2,
                        const void* ls, const void* lb, float eps, void* y,
                        int n, int h, int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16 && pnmlp_tc(h, k)) return (int)cudaErrorInvalidValue;
  return bf16 ? pnmlp_fwd_launch<__nv_bfloat16>(x, w1, b1, w2, b2, ls, lb,
                                                eps, y, n, h, k, st)
              : pnmlp_fwd_launch<float>(x, w1, b1, w2, b2, ls, lb, eps, y, n,
                                        h, k, st);
}

size_t vct_seq_adapter_bwd_smem(int h, int k) {
  return sizeof(float) *
         ((size_t)ROWS * h + 2 * (size_t)ROWS * k + SLAB_T + 2 * ROWS);
}
// K3 backward's CUDA-core row pass: its three [ROWS][h] tiles in shared
// memory where the block's total fits SMEM_MAX, else in a global
// workspace of vct_prenorm_mlp_bwd_ws bytes (0 where they fit).
static size_t pnmlp_bwd_rest(void) {
  return sizeof(float) * (ROWS * 128 + SLAB_T + 2 * ROWS);
}
static size_t pnmlp_bwd_tiles(int h) {
  return sizeof(float) * 3 * (size_t)ROWS * h;
}
size_t vct_prenorm_mlp_bwd_smem(int h) {
  const size_t all = pnmlp_bwd_tiles(h) + pnmlp_bwd_rest();
  return all <= SMEM_MAX ? all : pnmlp_bwd_rest();
}
size_t vct_prenorm_mlp_bwd_ws(int n, int h) {
  return pnmlp_bwd_tiles(h) + pnmlp_bwd_rest() <= SMEM_MAX
             ? 0
             : (size_t)grid_for(n).x * pnmlp_bwd_tiles(h);
}
static size_t cab_bwd_smem(int rows, int din, int h) {
  const size_t ldq = din > h ? din : h;
  return sizeof(float) * (rows * (ldq + 4 * (size_t)h + 2 * SMAX + 2) +
                          SLAB_T);
}
// Rows a block of K2's fp32 backward takes: 16 where they fit, else 8.
int vct_cross_attn_block_bwd_rows(int din, int h) {
  return cab_bwd_smem(R2, din, h) <= SMEM_MAX ? R2 : R2 / 2;
}
size_t vct_cross_attn_block_bwd_smem(int din, int h) {
  return cab_bwd_smem(vct_cross_attn_block_bwd_rows(din, h), din, h);
}

int vct_seq_adapter_bwd(int bf16, const void* x, const void* w1,
                        const void* b1, const void* w2, const void* b2,
                        const void* ls, const void* g, float eps, void* dx,
                        void* h_out, void* dpre_out, void* dz_out,
                        void* part, int n, int h, int k, void* stream) {
  const size_t smem = vct_seq_adapter_bwd_smem(h, k);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid = grid_for(n);
  const float *fw1 = (const float*)w1, *fb1 = (const float*)b1,
              *fw2 = (const float*)w2, *fb2 = (const float*)b2,
              *fls = (const float*)ls;
  float *fh = (float*)h_out, *fdp = (float*)dpre_out, *fdz = (float*)dz_out,
        *fpt = (float*)part;
  int err;
  if (bf16) {
    typedef __nv_bfloat16 T;
    auto kern = seq_adapter_bwd_kernel<T>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<grid, NT, smem, st>>>((const T*)x, fw1, fb1, fw2, fb2, fls,
                                 (const T*)g, eps, (T*)dx, fh, fdp, fdz, fpt,
                                 n, h, k);
  } else {
    typedef float T;
    auto kern = seq_adapter_bwd_kernel<T>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<grid, NT, smem, st>>>((const T*)x, fw1, fb1, fw2, fb2, fls,
                                 (const T*)g, eps, (T*)dx, fh, fdp, fdz, fpt,
                                 n, h, k);
  }
  return (int)cudaGetLastError();
}

// K3 backward's CUDA-core row pass (pnmlp_bwd_launch).
int vct_prenorm_mlp_bwd(int bf16, const void* x, const void* w1,
                        const void* b1, const void* w2, const void* ls,
                        const void* lb, const void* g, float eps, void* dx,
                        void* um_out, void* hm_out, void* dpm_out,
                        void* part, void* ws, int n, int h, int k,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16 && pnmlp_tc(h, k)) return (int)cudaErrorInvalidValue;
  return bf16 ? pnmlp_bwd_launch<__nv_bfloat16>(
                    x, w1, b1, w2, ls, lb, g, eps, dx, um_out, hm_out,
                    dpm_out, part, ws, n, h, k, st)
              : pnmlp_bwd_launch<float>(x, w1, b1, w2, ls, lb, g, eps, dx,
                                        um_out, hm_out, dpm_out, part, ws, n,
                                        h, k, st);
}

// K2 backward's CUDA-core row pass: fp32, and bf16 at head widths its
// tensor-core passes do not take (cab_tc_ok; bf16 on the gate takes
// vct_cross_attn_block_bwd_bf16). Every intermediate out in T.
int vct_cross_attn_block_bwd(int bf16, const void* x, const void* wt,
                             const void* bt, const void* ls, const void* lb,
                             const void* wq, const void* bq, const void* k,
                             const void* v, const void* wo, const void* g,
                             float eps, float scale, void* dx, void* um_out,
                             void* qm_out, void* om_out, void* dom_out,
                             void* pm_out, void* dsm_out, void* dqm_out,
                             void* dtm_out, void* part, int n, int din,
                             int h, int heads, int tk, void* stream) {
  const size_t smem = vct_cross_attn_block_bwd_smem(din, h);
  const int rows = vct_cross_attn_block_bwd_rows(din, h);
  auto launch = bf16 ? cab_bwd_launch<__nv_bfloat16> : cab_bwd_launch<float>;
  return launch(x, wt, bt, ls, lb, wq, bq, k, v, wo, g, eps, scale, dx,
                um_out, qm_out, om_out, dom_out, pm_out, dsm_out, dqm_out,
                dtm_out, part, n, din, h, heads, tk, rows, smem,
                (cudaStream_t)stream);
}

// A and B each float (0) or bf16 (1); bf16 A with fp32 B is K1's x^T dpre.
// bf16 x bf16 runs on the tensor cores over 128 x 128 output tiles (grid
// ceil(q / 128) x ceil(p / 128) x z * splits) where every row copies in
// 16-byte chunks (a and b 16-byte aligned; lda, ldb, sa, sb, p and q
// multiples of 8; ops/fused_adapter.py _bf16_tc_route makes the same
// choice), the rest on the CUDA cores over 64 x 64 tiles.
// With splits > 1, `work` holds splits * out_numel floats of partials
// (out_numel: the floats of out the products cover) and split_sum_kernel
// writes out; with splits == 1 the blocks write out directly.
int vct_wgrad(int a_bf16, int b_bf16, const void* a, int lda, int sa,
              const void* b, int ldb, int sb, void* out, int ldo, int so,
              int n, int p, int q, int z, int splits, void* work,
              size_t out_numel, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((q + 63) / 64, (p + 63) / 64, z * splits);
  const int chunk = (n + splits - 1) / splits;
  float* o = splits > 1 ? (float*)work : (float*)out;
  const size_t stride = splits > 1 ? out_numel : 0;
  typedef __nv_bfloat16 H;
  const bool vec = (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
                   lda % 8 == 0 && ldb % 8 == 0 && sa % 8 == 0 &&
                   sb % 8 == 0 && p % 8 == 0 && q % 8 == 0;
  if (!a_bf16 && !b_bf16)
    wgrad_kernel<float, float><<<grid, NT, 0, st>>>(
        (const float*)a, lda, sa, (const float*)b, ldb, sb, o, ldo, so, n, p,
        q, z, chunk, stride);
  else if (a_bf16 && !b_bf16)
    wgrad_kernel<H, float><<<grid, NT, 0, st>>>(
        (const H*)a, lda, sa, (const float*)b, ldb, sb, o, ldo, so, n, p, q,
        z, chunk, stride);
  else if (a_bf16 && b_bf16 && !vec)
    wgrad_kernel<H, H><<<grid, NT, 0, st>>>(
        (const H*)a, lda, sa, (const H*)b, ldb, sb, o, ldo, so, n, p, q, z,
        chunk, stride);
  else if (a_bf16 && b_bf16) {
    // the tensor cores, over 128 x 128 tiles, in 16-byte copies
    const dim3 tgrid((q + TC - 1) / TC, (p + TC - 1) / TC, z * splits);
    int err;
    if ((err = allow_smem(wgrad_mma_kernel, GemmTN::SMEM_BYTES))) return err;
    wgrad_mma_kernel<<<tgrid, GemmTN::THREADS, GemmTN::SMEM_BYTES, st>>>(
        (const H*)a, lda, sa, (const H*)b, ldb, sb, o, ldo, so, n, p, q, z,
        chunk, stride);
  } else
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  split_sum_kernel<<<(unsigned)((out_numel + NT - 1) / NT), NT, 0, st>>>(
      (const float*)work, splits, out_numel, (float*)out);
  return (int)cudaGetLastError();
}

int vct_colsum(const void* part, int tiles, int v, void* out, void* stream) {
  colsum_kernel<<<(v + NT - 1) / NT, NT, 0, (cudaStream_t)stream>>>(
      (const float*)part, tiles, v, (float*)out);
  return (int)cudaGetLastError();
}

// fp32 weight gradients on the TF32 tensor cores, error-compensated:
// vct_wgrad's contract for an fp32 B and an fp32 (a_bf16 = 0) or bf16 A
// over 128 x 64 output tiles (grid ceil(q / 64) x ceil(p / 128) x z *
// splits). a and b 16-byte aligned, lda, sa and p multiples of 4 (fp32 A)
// or 8 (bf16 A), ldb, sb and q multiples of 4, else
// cudaErrorMisalignedAddress.
int vct_wgrad_tf32(int a_bf16, const void* a, int lda, int sa,
                   const void* b, int ldb, int sb, void* out, int ldo, int so,
                   int n, int p, int q, int z, int splits, void* work,
                   size_t out_numel, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ea = a_bf16 ? 8 : 4;
  const bool vec = (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
                   lda % ea == 0 && sa % ea == 0 && p % ea == 0 &&
                   ldb % 4 == 0 && sb % 4 == 0 && q % 4 == 0;
  if (!vec) return (int)cudaErrorMisalignedAddress;
  const dim3 grid((q + 63) / 64, (p + 127) / 128, z * splits);
  const int chunk = (n + splits - 1) / splits;
  float* o = splits > 1 ? (float*)work : (float*)out;
  const size_t stride = splits > 1 ? out_numel : 0;
  int err;
  if (a_bf16) {
    typedef Tf32G<vct::bf16, true, false> G;
    if ((err = allow_smem(wgrad_tf32_kernel<vct::bf16>, G::SMEM_BYTES)))
      return err;
    wgrad_tf32_kernel<vct::bf16><<<grid, G::THREADS, G::SMEM_BYTES, st>>>(
        (const vct::bf16*)a, lda, sa, (const float*)b, ldb, sb, o, ldo, so,
        n, p, q, z, chunk, stride);
  } else {
    typedef Tf32G<float, true, false> G;
    if ((err = allow_smem(wgrad_tf32_kernel<float>, G::SMEM_BYTES)))
      return err;
    wgrad_tf32_kernel<float><<<grid, G::THREADS, G::SMEM_BYTES, st>>>(
        (const float*)a, lda, sa, (const float*)b, ldb, sb, o, ldo, so, n, p,
        q, z, chunk, stride);
  }
  if ((err = (int)cudaGetLastError()) || splits == 1) return err;
  split_sum_kernel<<<(unsigned)((out_numel + NT - 1) / NT), NT, 0, st>>>(
      (const float*)work, splits, out_numel, (float*)out);
  return (int)cudaGetLastError();
}

// Bytes of scratch vct_seq_adapter_bwd_tf32 needs: h, gelu'(pre), dpre
// [n, k] and z / dz [n, h] in fp32, the column-sum partials of dpre
// (128-row tiles, k) and of the LN pass (32-row tiles, 3h), and the
// weight gradients' row-chunk partials.
size_t vct_seq_adapter_bwd_tf32_ws(int n, int h, int k) {
  int s1, s2;
  seqbwd_splits(n, h, k, &s1, &s2);
  const int s = s1 > s2 ? s1 : s2;
  return sizeof(float) *
         (3 * (size_t)n * k + (size_t)n * h + (size_t)((n + 127) / 128) * k +
          (size_t)((n + LNB_ROWS - 1) / LNB_ROWS) * 3 * h +
          (s > 1 ? (size_t)s * h * k : 0));
}

// K1 backward on the TF32 tensor cores (h a multiple of 8, k of 4; every
// pointer 16-byte aligned), all its launches in one call: writes dx
// (unless null), dw1 [h, k], dw2 [k, h] and vec [db1 (k) | db2 | dls |
// dlb (h each)]; ws: vct_seq_adapter_bwd_tf32_ws bytes of scratch.
int vct_seq_adapter_bwd_tf32(int bf16, const void* x, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             const void* ls, const void* g, float eps,
                             void* dx, void* dw1, void* dw2, void* vec,
                             void* ws, int n, int h, int k, void* stream) {
  if (!seq_tc(h, k) || n < 1) return (int)cudaErrorInvalidValue;
  return bf16 ? seqbwd_launch<vct::bf16>(x, w1, b1, w2, b2, ls, g, eps, dx,
                                         dw1, dw2, vec, ws, n, h, k, stream)
              : seqbwd_launch<float>(x, w1, b1, w2, b2, ls, g, eps, dx, dw1,
                                     dw2, vec, ws, n, h, k, stream);
}

// K3 backward in bf16 on the tensor cores (h, k multiples of 8; every
// pointer 16-byte aligned), all its launches in one call: writes dx
// (unless null), dw1 [h, k], dw2 [k, h] and vec [db1 (k) | db2 | dls |
// dlb (h each)]. act: bf16 scratch of n (h + 2k) (um, hm, dpm); scratch:
// fp32 of n h (du) + 2n (mean, 1/std) + ceil(n / 128) k (db1 partials) +
// ceil(n / 32) 3h (LN partials) + splits h k (weight-gradient chunks);
// splits: the row chunks of both weight gradients.
int vct_prenorm_mlp_bwd_bf16(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* ls, const void* lb,
                             const void* g, float eps, void* dx, void* dw1,
                             void* dw2, void* vec, void* act, void* scratch,
                             int splits, int n, int h, int k, void* stream) {
  typedef vct::bf16 T;
  if (!pnmlp_tc(h, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int row_tiles = (n + TC - 1) / TC;
  const int ln_tiles = (n + LN_ROWS - 1) / LN_ROWS;
  T* um = (T*)act;
  T* hm = um + (size_t)n * h;
  T* dpm = hm + (size_t)n * k;
  float* du = (float*)scratch;
  float* mean = du + (size_t)n * h;
  float* inv = mean + n;
  float* part_hidden = inv + n;
  float* part_ln = part_hidden + (size_t)row_tiles * k;
  float* work = part_ln + (size_t)ln_tiles * 3 * h;
  int err;
  pnmlp_ln_fwd_kernel<<<(n + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
      (const T*)x, (const float*)ls, (const float*)lb, eps, um, mean, inv, n,
      h);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = allow_smem(pnmlp_bwd_hidden_kernel, HID_SMEM))) return err;
  pnmlp_bwd_hidden_kernel<<<dim3((k + TC - 1) / TC, row_tiles),
                            2 * HID_GROUP, HID_SMEM, st>>>(
      um, (const T*)g, (const T*)w1, (const float*)b1, (const T*)w2, hm, dpm,
      part_hidden, n, h, k);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = allow_smem(pnmlp_bwd_du_kernel, GemmNT::SMEM_BYTES))) return err;
  pnmlp_bwd_du_kernel<<<dim3((h + TC - 1) / TC, row_tiles), GemmNT::THREADS,
                        GemmNT::SMEM_BYTES, st>>>(dpm, (const T*)w1, du, n, h,
                                                  k);
  if ((err = (int)cudaGetLastError())) return err;
  pnmlp_bwd_ln_kernel<<<ln_tiles, NT, 0, st>>>(
      (const T*)x, (const T*)g, du, mean, inv, (const float*)ls, (T*)dx,
      part_ln, n, h);
  if ((err = (int)cudaGetLastError())) return err;
  // dW1 = um^T dpm, dW2 = hm^T g (one work buffer: the stream orders them)
  if ((err = vct_wgrad(1, 1, um, h, 0, dpm, k, 0, dw1, k, 0, n, h, k, 1,
                       splits, work, (size_t)h * k, stream)))
    return err;
  if ((err = vct_wgrad(1, 1, hm, k, 0, g, h, 0, dw2, h, 0, n, k, h, 1,
                       splits, work, (size_t)h * k, stream)))
    return err;
  if ((err = vct_colsum(part_hidden, row_tiles, k, vec, stream))) return err;
  return vct_colsum(part_ln, ln_tiles, 3 * h, (float*)vec + k, stream);
}

// K3 forward in bf16 on the tensor cores (h, k multiples of 8; every
// pointer 16-byte aligned): y [n, h]; ws: vct_prenorm_mlp_fwd_bf16_ws
// bytes of scratch (um [n, h] and hm [n, k] in bf16).
size_t vct_prenorm_mlp_fwd_bf16_ws(int n, int h, int k) {
  return sizeof(vct::bf16) * (size_t)n * (h + k);
}

int vct_prenorm_mlp_fwd_bf16(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* ls,
                             const void* lb, float eps, void* y, void* ws,
                             int n, int h, int k, void* stream) {
  typedef vct::bf16 T;
  if (!pnmlp_tc(h, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int row_tiles = (n + TC - 1) / TC;
  T* um = (T*)ws;
  T* hm = um + (size_t)n * h;
  int err;
  pnmlp_fwd_ln_kernel<<<(n + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
      (const T*)x, (const float*)ls, (const float*)lb, eps, um, n, h);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = allow_smem(pnmlp_fwd_hidden_kernel, HidNN::SMEM_BYTES)))
    return err;
  pnmlp_fwd_hidden_kernel<<<dim3((k + TC - 1) / TC, row_tiles),
                            HidNN::THREADS, HidNN::SMEM_BYTES, st>>>(
      um, (const T*)w1, (const float*)b1, hm, n, h, k);
  if ((err = (int)cudaGetLastError())) return err;
  typedef Gemm64<false> G;
  if ((err = allow_smem(pnmlp_fwd_out_kernel, G::SMEM_BYTES))) return err;
  pnmlp_fwd_out_kernel<<<dim3((h + G::TILE_N - 1) / G::TILE_N, row_tiles),
                         G::THREADS, G::SMEM_BYTES, st>>>(
      hm, (const T*)w2, (const T*)x, (const float*)b2, (T*)y, n, h, k);
  return (int)cudaGetLastError();
}

// K2 in bf16 on the tensor cores, forward and backward: its shape gate
// (heads of a multiple of 8 columns, at most HD_MAX; din a multiple of 8,
// which the wrapper pads to; 0 < tk <= SMAX), then the scratch, all
// decided here from the shapes.
static bool cab_tc_ok(int din, int h, int heads, int tk) {
  const int hd = heads > 0 ? h / heads : 0;
  return heads > 0 && hd * heads == h && hd % 8 == 0 && hd <= HD_MAX &&
         din % 8 == 0 && tk > 0 && tk <= SMAX;
}

// K2 forward's scratch, in 16-byte-aligned pieces: fp32 t [n, h], bf16
// um [n, h] (then om, which the attention pass writes over it), bf16 qm
// [n, h], fp32 mean, inv [n].
struct CabFwdWs {
  float *t, *mean, *inv;
  vct::bf16 *um, *qm;
};

static size_t cab_fwd_ws(unsigned char* base, int n, int h, CabFwdWs* w) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    void* p = (void*)((uintptr_t)base + off);
    off += (bytes + 15) / 16 * 16;
    return p;
  };
  const size_t nh = (size_t)n * h;
  w->t = (float*)take(sizeof(float) * nh);
  w->um = (vct::bf16*)take(sizeof(vct::bf16) * nh);
  w->qm = (vct::bf16*)take(sizeof(vct::bf16) * nh);
  w->mean = (float*)take(sizeof(float) * n);
  w->inv = (float*)take(sizeof(float) * n);
  return off;
}

// Bytes of scratch K2's forward takes: the tensor-core passes' in bf16
// where cab_tc_ok holds, else 0 (the CUDA-core kernel needs none).
size_t vct_cross_attn_block_fwd_ws(int bf16, int n, int din, int h,
                                   int heads, int tk) {
  if (!bf16 || !cab_tc_ok(din, h, heads, tk)) return 0;
  CabFwdWs w;
  return cab_fwd_ws(nullptr, n, h, &w);
}

// K2 forward in bf16 on the tensor cores: the five passes (t = x Wt + bt
// in fp32; the LN, um = round(u) and each row's mean and 1/std; qm =
// round(um Wq + bq); om = round(softmax(q k^T scale) v) per (128-row
// tile, head); y = round(u + (om Wo + bo)) with the fp32 u).
static int cab_fwd_bf16(const void* x, const void* wt, const void* bt,
                        const void* ls, const void* lb, const void* wq,
                        const void* bq, const void* k, const void* v,
                        const void* wo, const void* bo, float eps,
                        float scale, void* y, void* ws, int n, int din, int h,
                        int heads, int tk, cudaStream_t st) {
  typedef vct::bf16 T;
  typedef Gemm64<false> G;
  const int hd = h / heads, row_tiles = (n + TC - 1) / TC;
  CabFwdWs w;
  cab_fwd_ws((unsigned char*)ws, n, h, &w);
  const dim3 hgrid((h + G::TILE_N - 1) / G::TILE_N, row_tiles);
  const float *fls = (const float*)ls, *flb = (const float*)lb;
  int err;
#define VCT_CHECK() \
  if ((err = (int)cudaGetLastError())) return err
  if ((err = allow_smem(cab_fwd_t_kernel, G::SMEM_BYTES))) return err;
  cab_fwd_t_kernel<<<hgrid, G::THREADS, G::SMEM_BYTES, st>>>(
      (const T*)x, (const T*)wt, (const float*)bt, w.t, n, din, h);
  VCT_CHECK();
  cab_fwd_ln_kernel<<<(n + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
      w.t, fls, flb, eps, w.um, w.mean, w.inv, n, h);
  VCT_CHECK();
  if ((err = allow_smem(cab_fwd_q_kernel, G::SMEM_BYTES))) return err;
  cab_fwd_q_kernel<<<hgrid, G::THREADS, G::SMEM_BYTES, st>>>(
      w.um, (const T*)wq, (const float*)bq, w.qm, n, h);
  VCT_CHECK();
  T* om = w.um;  // um is not read again
  const dim3 agrid(row_tiles, heads);
  if (hd <= 64) {
    const size_t asmem = cab_attn_smem(tk, 64, 1, 0);
    if ((err = allow_smem(cab_fwd_attn_kernel<64>, asmem))) return err;
    cab_fwd_attn_kernel<64><<<agrid, NT, asmem, st>>>(
        w.qm, (const T*)k, (const T*)v, scale, om, n, h, hd, tk);
  } else {
    const size_t asmem = cab_attn_smem(tk, HD_MAX, 1, 0);
    if ((err = allow_smem(cab_fwd_attn_kernel<HD_MAX>, asmem))) return err;
    cab_fwd_attn_kernel<HD_MAX><<<agrid, NT, asmem, st>>>(
        w.qm, (const T*)k, (const T*)v, scale, om, n, h, hd, tk);
  }
  VCT_CHECK();
  if ((err = allow_smem(cab_fwd_out_kernel, G::SMEM_BYTES))) return err;
  cab_fwd_out_kernel<<<hgrid, G::THREADS, G::SMEM_BYTES, st>>>(
      om, (const T*)wo, w.t, w.mean, w.inv, fls, flb, (const float*)bo,
      (T*)y, n, h);
#undef VCT_CHECK
  return (int)cudaGetLastError();
}

// K2 forward, one entry for both routes: in bf16 where cab_tc_ok holds,
// the tensor-core passes (k [tk, h]; x, wt, k, v, wq, wo 16-byte aligned;
// ws: vct_cross_attn_block_fwd_ws bytes); otherwise, and in fp32, the
// CUDA-core kernel in 32- or 16-row tiles (kt = k^T [h, tk]). n >= 1.
int vct_cross_attn_block_fwd(int bf16, const void* x, const void* wt,
                             const void* bt, const void* ls, const void* lb,
                             const void* wq, const void* bq, const void* k,
                             const void* kt, const void* v, const void* wo,
                             const void* bo, float eps, float scale, void* y,
                             void* ws, int n, int din, int h, int heads,
                             int tk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16 && cab_tc_ok(din, h, heads, tk)) {
    if (ws == nullptr || k == nullptr) return (int)cudaErrorInvalidValue;
    return cab_fwd_bf16(x, wt, bt, ls, lb, wq, bq, k, v, wo, bo, eps, scale,
                        y, ws, n, din, h, heads, tk, st);
  }
  if (kt == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = vct_cross_attn_block_smem(din, h);
  const bool r32 = smem == cab_fwd_smem(ROWS, din, h);
  typedef __nv_bfloat16 B;
  auto launch = bf16 ? (r32 ? cab_fwd_launch<B, ROWS>
                            : cab_fwd_launch<B, ROWS / 2>)
                     : (r32 ? cab_fwd_launch<float, ROWS>
                            : cab_fwd_launch<float, ROWS / 2>);
  return launch(x, wt, bt, ls, lb, wq, bq, kt, v, wo, bo, eps, scale, y, n,
                din, h, heads, tk, smem, st);
}

// K2 backward's five weight gradients (dWo, dv, dk, dWq, dWt) as (p, q,
// z): output p x q, z times; and their row chunks.
struct CabGrads {
  int p[5], q[5], z[5], splits[5];
  size_t work;  // floats of row-chunk partials (the largest product)
  CabGrads(int n, int din, int h, int heads, int tkp) {
    const int hd = h / heads;
    const int pqz[5][3] = {{h, h, 1}, {tkp, hd, heads}, {tkp, hd, heads},
                           {h, h, 1}, {din, h, 1}};
    work = 0;
    for (int i = 0; i < 5; ++i) {
      p[i] = pqz[i][0];
      q[i] = pqz[i][1];
      z[i] = pqz[i][2];
      splits[i] = tc_splits(n, (p[i] + TC - 1) / TC * ((q[i] + TC - 1) / TC) *
                                   z[i]);
      const size_t w = (size_t)splits[i] * p[i] * q[i] * z[i];
      if (splits[i] > 1 && w > work) work = w;
    }
  }
};

// K2 backward's bf16 scratch, carved from one buffer in 16-byte-aligned
// pieces: bf16 um, qm, dom, om, dqm, dtm [n, h] and pm, dsm [n, heads,
// tkp]; fp32 t, du [n, h], mean, inv [n], the LN partials [ceil(n / 32),
// 4h], the dbq partials [ceil(n / 128), h] and the weight gradients' row
// chunks.
struct CabWs {
  vct::bf16 *um, *qm, *dom, *om, *dqm, *dtm, *pm, *dsm;
  float *t, *du, *mean, *inv, *part_ln, *part_q, *work;
};

static size_t cab_ws(unsigned char* base, int n, int h, int heads, int tkp,
                     size_t work, CabWs* w) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    void* p = (void*)((uintptr_t)base + off);
    off += (bytes + 15) / 16 * 16;
    return p;
  };
  const size_t nh = (size_t)n * h, np = (size_t)n * heads * tkp;
  const size_t ln_tiles = ((size_t)n + LN_ROWS - 1) / LN_ROWS;
  const size_t row_tiles = ((size_t)n + TC - 1) / TC;
  vct::bf16** bf[] = {&w->um, &w->qm, &w->dom, &w->om, &w->dqm, &w->dtm};
  for (vct::bf16** p : bf) *p = (vct::bf16*)take(sizeof(vct::bf16) * nh);
  w->pm = (vct::bf16*)take(sizeof(vct::bf16) * np);
  w->dsm = (vct::bf16*)take(sizeof(vct::bf16) * np);
  w->t = (float*)take(sizeof(float) * nh);
  w->du = (float*)take(sizeof(float) * nh);
  w->mean = (float*)take(sizeof(float) * n);
  w->inv = (float*)take(sizeof(float) * n);
  w->part_ln = (float*)take(sizeof(float) * ln_tiles * 4 * h);
  w->part_q = (float*)take(sizeof(float) * row_tiles * h);
  w->work = (float*)take(sizeof(float) * work);
  return off;
}

// Bytes of scratch vct_cross_attn_block_bwd_bf16 takes; 0 for shapes it
// does not take.
size_t vct_cross_attn_block_bwd_bf16_ws(int n, int din, int h, int heads,
                                        int tk) {
  if (!cab_tc_ok(din, h, heads, tk)) return 0;
  const int tkp = (tk + 7) / 8 * 8;
  CabWs w;
  return cab_ws(nullptr, n, h, heads, tkp,
                CabGrads(n, din, h, heads, tkp).work, &w);
}

// K2 backward in bf16 on the tensor cores (heads of hd = h / heads
// columns, hd a multiple of 8 up to HD_MAX; din a multiple of 8; 0 < tk <=
// 256; every pointer 16-byte aligned), all its launches in one call:
// writes dx [n, din] (unless null) and into `grads` (fp32) dWt [din, h],
// dWq [h, h], dWo [h, h], dk [tkp, h], dv [tkp, h] (rows past tk zero) and
// [dbo | dls | dlb | dbt | dbq] (h each). ws:
// vct_cross_attn_block_bwd_bf16_ws bytes.
int vct_cross_attn_block_bwd_bf16(
    const void* x, const void* wt, const void* bt, const void* ls,
    const void* lb, const void* wq, const void* bq, const void* k,
    const void* v, const void* wo, const void* g, float eps, float scale,
    void* dx, void* grads, void* ws, int n, int din, int h, int heads,
    int tk, void* stream) {
  typedef vct::bf16 T;
  if (!cab_tc_ok(din, h, heads, tk)) return (int)cudaErrorInvalidValue;
  const int hd = h / heads, tkp = (tk + 7) / 8 * 8;
  cudaStream_t st = (cudaStream_t)stream;
  const CabGrads wg(n, din, h, heads, tkp);
  CabWs w;
  cab_ws((unsigned char*)ws, n, h, heads, tkp, wg.work, &w);
  float* dwt = (float*)grads;
  float* dwq = dwt + (size_t)din * h;
  float* dwo = dwq + (size_t)h * h;
  float* dk = dwo + (size_t)h * h;
  float* dv = dk + (size_t)tkp * h;
  float* vec = dv + (size_t)tkp * h;
  const T *tx = (const T*)x, *tg = (const T*)g;
  const int row_tiles = (n + TC - 1) / TC;
  const int ln_tiles = (n + LN_ROWS - 1) / LN_ROWS;
  typedef Gemm64<false> GN;
  typedef Gemm64<true> GT;
  const dim3 hgrid((h + GN::TILE_N - 1) / GN::TILE_N, row_tiles);
  int err;
#define VCT_CHECK() \
  if ((err = (int)cudaGetLastError())) return err
  if ((err = allow_smem(cab_bwd_t_kernel, GN::SMEM_BYTES))) return err;
  cab_bwd_t_kernel<<<hgrid, GN::THREADS, GN::SMEM_BYTES, st>>>(
      tx, (const T*)wt, (const float*)bt, w.t, n, din, h);
  VCT_CHECK();
  cab_bwd_ln_fwd_kernel<<<(n + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
      w.t, (const float*)ls, (const float*)lb, eps, w.um, w.mean, w.inv, n,
      h);
  VCT_CHECK();
  if ((err = allow_smem(cab_bwd_q_kernel, GN::SMEM_BYTES))) return err;
  cab_bwd_q_kernel<<<hgrid, GN::THREADS, GN::SMEM_BYTES, st>>>(
      w.um, (const T*)wq, (const float*)bq, w.qm, n, h);
  VCT_CHECK();
  if ((err = allow_smem(cab_bwd_dom_kernel, GT::SMEM_BYTES))) return err;
  cab_bwd_dom_kernel<<<hgrid, GT::THREADS, GT::SMEM_BYTES, st>>>(
      tg, (const T*)wo, w.dom, n, h);
  VCT_CHECK();
  const dim3 agrid(row_tiles, heads);
  if (hd <= 64) {
    const size_t asmem = cab_attn_smem(tk, 64, 2, (NT / 32) * 64);
    if ((err = allow_smem(cab_bwd_attn_kernel<64>, asmem))) return err;
    cab_bwd_attn_kernel<64><<<agrid, NT, asmem, st>>>(
        w.qm, w.dom, (const T*)k, (const T*)v, scale, w.om, w.pm, w.dsm,
        w.dqm, w.part_q, n, h, hd, tk, tkp);
  } else {
    const size_t asmem =
        cab_attn_smem(tk, HD_MAX, 2, (NT / 32) * HD_MAX);
    if ((err = allow_smem(cab_bwd_attn_kernel<HD_MAX>, asmem))) return err;
    cab_bwd_attn_kernel<HD_MAX><<<agrid, NT, asmem, st>>>(
        w.qm, w.dom, (const T*)k, (const T*)v, scale, w.om, w.pm, w.dsm,
        w.dqm, w.part_q, n, h, hd, tk, tkp);
  }
  VCT_CHECK();
  if ((err = allow_smem(cab_bwd_du_kernel, GT::SMEM_BYTES))) return err;
  cab_bwd_du_kernel<<<hgrid, GT::THREADS, GT::SMEM_BYTES, st>>>(
      w.dqm, (const T*)wq, tg, w.du, n, h);
  VCT_CHECK();
  cab_bwd_ln_kernel<<<ln_tiles, NT, 0, st>>>(w.t, w.du, w.mean, w.inv,
                                             (const float*)ls, tg, w.dtm,
                                             w.part_ln, n, h);
  VCT_CHECK();
  if (dx != nullptr) {
    if ((err = allow_smem(cab_bwd_dx_kernel, GT::SMEM_BYTES))) return err;
    cab_bwd_dx_kernel<<<dim3((din + GT::TILE_N - 1) / GT::TILE_N, row_tiles),
                        GT::THREADS, GT::SMEM_BYTES, st>>>(
        w.dtm, (const T*)wt, (T*)dx, n, din, h);
    VCT_CHECK();
  }
#undef VCT_CHECK
  // dWo = om^T g; per head dv_h = pm_h^T dom_h, dk_h = dsm_h^T qm_h; dWq =
  // um^T dqm; dWt = x^T dtm (one work buffer: the stream orders them)
  const int pp = heads * tkp;
  const T* as[5] = {w.om, w.pm, w.dsm, w.um, tx};
  const T* bs[5] = {tg, w.dom, w.qm, w.dqm, w.dtm};
  float* outs[5] = {dwo, dv, dk, dwq, dwt};
  const int ldas[5] = {h, pp, pp, h, din}, sas[5] = {0, tkp, tkp, 0, 0};
  const int sbs[5] = {0, hd, hd, 0, 0};
  for (int i = 0; i < 5; ++i)
    if ((err = vct_wgrad(1, 1, as[i], ldas[i], sas[i], bs[i], h, sbs[i],
                         outs[i], h, sbs[i], n, wg.p[i], wg.q[i], wg.z[i],
                         wg.splits[i], w.work,
                         (size_t)wg.p[i] * wg.q[i] * wg.z[i], stream)))
      return err;
  if ((err = vct_colsum(w.part_ln, ln_tiles, 4 * h, vec, stream))) return err;
  return vct_colsum(w.part_q, row_tiles, h, vec + 4 * (size_t)h, stream);
}

// Rows a group of K6's cluster kernels takes (a multiple of FRT, at most
// FEAT_RMAX) from `want` rows, whether each block keeps its weight slices
// in shared memory, and where its buffers live: it keeps the weights
// where they fit beside those rows, else it takes the most rows whose
// buffers fit without them; where even FRT rows' buffers do not fit
// (*global), they go to a global workspace of feat_buffers(rows, d, k)
// floats a block, and the group keeps `want` rows (capped).
static int feat_rows(int want, int d, int k, bool* resident, bool* global) {
  int rows = (want + FRT - 1) / FRT * FRT;
  if (rows > FEAT_RMAX) rows = FEAT_RMAX;
  *resident = feat_smem(rows, d, k, true) <= SMEM_MAX;
  *global = feat_smem(FRT, d, k, false) > SMEM_MAX;
  if (*global) {
    *resident = false;
    return rows;
  }
  while (!*resident && rows > FRT && feat_smem(rows, d, k, false) > SMEM_MAX)
    rows -= FRT;
  return rows;
}

// The backward's groups: up to FEAT_RMAX rows, since it sums its weight
// gradients over a group's rows in the launch and over the groups in one
// more launch.
static int feat_bwd_rows(int n, int d, int k, bool* resident, bool* global) {
  return feat_rows(n, d, k, resident, global);
}

// The forward's groups: it sums nothing across rows, so a group takes the
// fewest rows that keep the clusters within one wave of the card
// (FEAT_WAVE clusters of 8 blocks, 128 of its 132 SMs): FRT rows a group
// up to 128 rows (pipeline T's 7-35 rows: one to five clusters, every
// cluster's rows one register tile), more rows a group past that.
constexpr int FEAT_WAVE = 16;
static int feat_fwd_rows(int n, int d, int k, bool* resident, bool* global) {
  const int tiles = (n + FRT - 1) / FRT;
  return feat_rows(FRT * ((tiles + FEAT_WAVE - 1) / FEAT_WAVE), d, k,
                   resident, global);
}

// Floats of a cluster launch's global buffers (feat_rows), 0 in shared
// memory.
static size_t feat_global_floats(int n, int rows, bool global, int d,
                                 int k) {
  const size_t groups = (n + rows - 1) / rows;
  return global ? groups * FEAT_CLUSTER * feat_buffers(rows, d, k) : 0;
}

// Bytes of scratch vct_feature_adapter_fwd needs: the blocks' buffers
// where they do not fit shared memory, none where they do.
size_t vct_feature_adapter_fwd_ws(int n, int d, int k) {
  bool resident, global;
  const int rows = feat_fwd_rows(n, d, k, &resident, &global);
  return sizeof(float) * feat_global_floats(n, rows, global, d, k);
}

}  // extern "C"

namespace {

// One launch of K6's forward (see vct_feature_adapter_fwd).
template <typename T, bool GLOBAL>
int feat_fwd_launch(const void* x, const float* w1, const float* b1,
                    const float* w2, const float* b2, float r, unsigned seed,
                    unsigned threshold, float scale, void* y, float* gbuf,
                    size_t bstride, int groups, size_t smem, int rows,
                    bool resident, int n, int d, int k, cudaStream_t st) {
  int err;
  if ((err = vct::cluster_ready<feature_adapter_fwd_cluster_kernel<T, GLOBAL>,
                                FEAT_CLUSTER, FNT>(SMEM_MAX)))
    return err;
  feature_adapter_fwd_cluster_kernel<T, GLOBAL>
      <<<groups * FEAT_CLUSTER, FNT, smem, st>>>(
          (const T*)x, w1, b1, w2, b2, r, seed, threshold, scale, (T*)y,
          gbuf, bstride, rows, (int)resident, n, d, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K6 forward: y [n, d] in T, one launch of 8-block clusters, a cluster
// per group of feat_fwd_rows rows; ws: vct_feature_adapter_fwd_ws bytes
// (null when that is 0).
int vct_feature_adapter_fwd(int bf16, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            float r, unsigned seed, unsigned threshold,
                            float scale, void* y, void* ws, int n, int d,
                            int k, void* stream) {
  typedef __nv_bfloat16 H;
  bool resident, global;
  const int rows = feat_fwd_rows(n, d, k, &resident, &global);
  const int groups = (n + rows - 1) / rows;
  const size_t smem = global ? 0 : feat_smem(rows, d, k, resident);
  const size_t bstride = global ? feat_buffers(rows, d, k) : 0;
  auto launch = bf16 ? (global ? feat_fwd_launch<H, true>
                               : feat_fwd_launch<H, false>)
                     : (global ? feat_fwd_launch<float, true>
                               : feat_fwd_launch<float, false>);
  return launch(x, (const float*)w1, (const float*)b1, (const float*)w2,
                (const float*)b2, r, seed, threshold, scale, y, (float*)ws,
                bstride, groups, smem, rows, resident, n, d, k,
                (cudaStream_t)stream);
}

}  // extern "C"

// Floats of the backward's workspace before the blocks' buffers: the
// groups' partial gradients past one group (none within one), rounded up
// to a multiple of 4 so that the buffers after them stay 16-byte aligned
// for the float4 loads of X, Z and H.
static size_t feat_bwd_partials(int groups, int d, int k) {
  return groups > 1 ? (groups * feat_grads(d, k) + 3) & ~(size_t)3 : 0;
}

extern "C" {

// Bytes of scratch vct_feature_adapter_bwd needs: the groups' partial
// gradients (feat_bwd_partials), then the blocks' buffers where they do
// not fit shared memory.
size_t vct_feature_adapter_bwd_ws(int n, int d, int k) {
  bool resident, global;
  const int rows = feat_bwd_rows(n, d, k, &resident, &global);
  const int groups = (n + rows - 1) / rows;
  return sizeof(float) * (feat_bwd_partials(groups, d, k) +
                          feat_global_floats(n, rows, global, d, k));
}

}  // extern "C"

namespace {

// One launch of K6's backward kernel (see vct_feature_adapter_bwd).
template <typename T, bool GLOBAL>
int feat_bwd_launch(const void* x, const float* w1, const float* b1,
                    const float* w2, const float* b2, float r, unsigned seed,
                    unsigned threshold, float scale, const void* g, void* dx,
                    float* dst, size_t v, float* gbuf, size_t bstride,
                    int groups, size_t smem, int rows, bool resident, int n,
                    int d, int k, cudaStream_t st) {
  int err;
  if ((err = vct::cluster_ready<feature_adapter_bwd_cluster_kernel<T, GLOBAL>,
                                FEAT_CLUSTER, FNT>(SMEM_MAX)))
    return err;
  feature_adapter_bwd_cluster_kernel<T, GLOBAL>
      <<<groups * FEAT_CLUSTER, FNT, smem, st>>>(
          (const T*)x, w1, b1, w2, b2, r, seed, threshold, scale,
          (const T*)g, (T*)dx, dst, v, gbuf, bstride, rows, (int)resident, n,
          d, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K6 backward: writes dx (unless null) and grads [dW1 (d k) | db1 (k) |
// dW2 (k d) | db2 (d)], every element; one launch of 8-block clusters, and
// past one group of rows one colsum launch over ws
// (vct_feature_adapter_bwd_ws bytes, null when that is 0).
int vct_feature_adapter_bwd(int bf16, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            float r, unsigned seed, unsigned threshold,
                            float scale, const void* g, void* dx,
                            void* grads, void* ws, int n, int d, int k,
                            void* stream) {
  typedef __nv_bfloat16 H;
  bool resident, global;
  const int rows = feat_bwd_rows(n, d, k, &resident, &global);
  const int groups = (n + rows - 1) / rows;
  const size_t smem = global ? 0 : feat_smem(rows, d, k, resident);
  const size_t v = feat_grads(d, k);
  const size_t bstride = global ? feat_buffers(rows, d, k) : 0;
  const size_t partials = feat_bwd_partials(groups, d, k);
  float* dst = groups > 1 ? (float*)ws : (float*)grads;
  auto launch = bf16 ? (global ? feat_bwd_launch<H, true>
                               : feat_bwd_launch<H, false>)
                     : (global ? feat_bwd_launch<float, true>
                               : feat_bwd_launch<float, false>);
  int err = launch(x, (const float*)w1, (const float*)b1, (const float*)w2,
                   (const float*)b2, r, seed, threshold, scale, g, dx, dst, v,
                   global ? (float*)ws + partials : nullptr, bstride, groups,
                   smem, rows, resident, n, d, k, (cudaStream_t)stream);
  if (err || groups == 1) return err;
  return vct_colsum(ws, groups, (int)v, grads, stream);
}

}  // extern "C"
