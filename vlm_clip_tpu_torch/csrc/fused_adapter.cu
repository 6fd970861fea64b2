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
// last row tile is masked, not padded. What bounds these kernels on the
// H100: they are compute-bound in fp32 FMA (about 14-31 GFLOP per call at
// the B=96 shapes against 67 TFLOP/s of fp32 FMA) and move little memory
// (weights stay in the 50 MB L2, each row is read and written once), so
// the next step is wgmma on bf16 operands, which this layout leaves open.
//
// K3's backward in bf16 and the bf16 x bf16 weight gradients (K2, K3) are
// redesigned for the tensor cores (section "bf16 on the tensor cores"
// below): at the train step's shape fp32 FMAs bound the first version at
// 1.16 ms or more a call, the tensor cores at 0.08 ms, so the row pass is
// split into mma.sync products over 128 x 128 tiles that fill the card,
// with the GELU, its derivative, the roundings and the column sums fused
// into their epilogues. The fp32 instantiations keep the CUDA-core
// kernels: the tensor cores would round fp32 operands to TF32.
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
#include <math.h>
#include <stdint.h>

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

// U = LN(Z) row by row (one warp per row), rounded to TR. U may alias Z.
// Statistics in fp32: mean, then the mean of squared deviations.
template <typename TR>
__device__ void ln_rows(const float* Z, float* U, int h,
                        const float* __restrict__ ls,
                        const float* __restrict__ lb, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < ROWS; r += NT / 32) {
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

// fp32 tile -> y rows [r0, min(r0 + ROWS, n)) in T.
template <typename T>
__device__ void store_rows(const float* Y, int h, T* __restrict__ y, int r0,
                           int n) {
  for (int e = threadIdx.x; e < ROWS * h; e += NT) {
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
        G[(ty * 4 + i) * k + c] = gelu_erf(acc[i][j] + b1[c]);
      }
  }
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, float>(G, k, k, w2, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
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
    tile_gemm<4, false, T>(U, h, h, w1, k, k0, k, slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 32 * j;
        G[(ty * 4 + i) * 128 + c] =
            round_to<T>(gelu_erf(acc[i][j] + b1[k0 + c]));
      }
    for (int c0 = 0; c0 < h; c0 += 128) {
      tile_gemm<4, false, T>(G, 128, 128, w2 + (size_t)k0 * h, h, c0, h,
                             slab, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          X[(ty * 4 + i) * h + c0 + tx + 32 * j] += acc[i][j];
    }
  }
  __syncthreads();
  store_rows(X, h, y, r0, n);
}

// ---------------------------------------------------------------------------
// K2: cross-modal attention block against a batch-shared K/V
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT)
    cross_attn_block_fwd_kernel(
        const T* __restrict__ x, const T* __restrict__ wt,
        const float* __restrict__ bt, const float* __restrict__ ls,
        const float* __restrict__ lb, const T* __restrict__ wq,
        const float* __restrict__ bq, const T* __restrict__ kt,
        const T* __restrict__ v, const T* __restrict__ wo,
        const float* __restrict__ bo, float eps, float scale,
        T* __restrict__ y, int n, int din, int h, int tk) {
  extern __shared__ float smem[];
  const int ldq = max(din, h);
  float* Q = smem;               // [ROWS][ldq]: x, then q (rounded), then
                                 // the attention output o (rounded), head
                                 // by head in place of q
  float* U = Q + ROWS * ldq;     // [ROWS][h]: t, then u = LN(t) in fp32
  float* S = U + ROWS * h;       // [ROWS][SMAX]: scores, then probs
  float* slab = S + ROWS * SMAX;  // [KC][128]
  const int r0 = blockIdx.x * ROWS;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int lane = tx, warp = ty;
  float acc[4][4];
  float acc2[4][2];

  load_rows(x, n, din, r0, Q, ldq);
  // t = x @ Wt + bt
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, T>(Q, ldq, din, wt, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        U[(ty * 4 + i) * h + c] = acc[i][j] + bt[c];
      }
  }
  __syncthreads();
  ln_rows<float>(U, U, h, ls, lb, eps);
  // q = round(u) @ Wq + bq, kept rounded: it is the scores' operand
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, true, T>(U, h, h, wq, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        Q[(ty * 4 + i) * ldq + c] = round_to<T>(acc[i][j] + bq[c]);
      }
  }
  const int heads = h / 64;
  for (int hd = 0; hd < heads; ++hd) {
    // scores = q_h . k^T * scale over the shared rows, -inf past tk
    for (int c0 = 0; c0 < SMAX; c0 += 128) {
      tile_gemm<4, false, T>(Q + hd * 64, ldq, 64, kt + (size_t)hd * 64 * tk,
                             tk, c0, tk, slab, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 32 * j;
          S[(ty * 4 + i) * SMAX + c] =
              (c < tk) ? acc[i][j] * scale : -INFINITY;
        }
    }
    __syncthreads();
    // per-head softmax in fp32, one warp per row; probs rounded to T
    for (int r = warp; r < ROWS; r += NT / 32) {
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
    // o_h = probs @ v_h, written over q_h (no longer read)
    tile_gemm<2, false, T>(S, SMAX, tk, v + hd * 64, h, 0, 64, slab, acc2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        Q[(ty * 4 + i) * ldq + hd * 64 + tx + 32 * j] =
            round_to<T>(acc2[i][j]);
  }
  // y = u + (o @ Wo + bo)
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, T>(Q, ldq, h, wo, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        float* u = &U[(ty * 4 + i) * h + c];
        *u = *u + (acc[i][j] + bo[c]);
      }
  }
  __syncthreads();
  store_rows(U, h, y, r0, n);
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
constexpr int R2 = 16;                  // rows per block in K2's backward

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
        float* z = &X[(ty * 4 + i) * h + c0 + tx + 32 * j];
        *z = (*z + acc[i][j]) + b2[c0 + tx + 32 * j];
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
        if (r < nv)
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
// dlb = sum du (h)].
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
                           float* __restrict__ part, int n, int h, int k) {
  extern __shared__ float smem[];
  float* U = smem;               // [ROWS][h]: round(LN(x))
  float* G = U + ROWS * h;       // [ROWS][h]: g
  float* DU = G + ROWS * h;      // [ROWS][h]: x, then the du accumulator
  float* P = DU + ROWS * h;      // [ROWS][128]: pre, dpre, round(dpre)
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
    // this chunk's pre = um @ W1[:, k0:k0+128] + b1
    tile_gemm<4, false, T>(U, h, h, w1, k, k0, k, slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 32 * j;
        P[(ty * 4 + i) * 128 + c] = acc[i][j] + b1[k0 + c];
      }
    // dh = g @ W2[k0:k0+128, :]^T; dpre = dh * gelu'(pre)
    tile_gemm<4, false, T, true>(G, h, h, w2 + (size_t)k0 * h, h, 0, 128,
                                 slab, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 32 * j;
        const float pre = P[r * 128 + c];
        const float dp = acc[i][j] * gelu_erf_grad(pre);
        P[r * 128 + c] = dp;
        if (r < nv) {
          const size_t at = (size_t)(r0 + r) * k + k0 + c;
          hm_out[at] = from_f<T>(gelu_erf(pre));
          dpm_out[at] = from_f<T>(dp);
        }
      }
    __syncthreads();
    col_sums(P, 128, 128, nv, pt + k0);  // db1, before rounding
    __syncthreads();
    for (int e = threadIdx.x; e < ROWS * 128; e += NT)
      P[e] = round_to<T>(P[e]);
    // du += dpm @ W1[:, k0:k0+128]^T
    for (int c0 = 0; c0 < h; c0 += 128) {
      tile_gemm<4, false, T, true>(P, 128, 128, w1 + k0, k, c0, h, slab,
                                   acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          DU[(ty * 4 + i) * h + c0 + tx + 32 * j] += acc[i][j];
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
// rounded to T where the TPU kernel rounds them. 16-row tiles (the block
// keeps seven [16, H]-sized tiles). Writes dx, um, qm, om, dom, dqm, dtm
// [n, h] and pm, dsm [n, heads*tk] in T for dWo = om^T g, dv_h = pm_h^T
// dom_h, dk_h = dsm_h^T qm_h, dWq = um^T dqm and dWt = x^T dtm; per tile
// [dbo = sum g | dbq = sum dqp | dls = sum du xhat | dlb = sum du |
// dbt = sum dt], each h wide.
// ---------------------------------------------------------------------------
template <typename T>
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
    float* __restrict__ part, int n, int din, int h, int tk) {
  extern __shared__ float smem[];
  const int ldq = max(din, h);
  float* B1 = smem;               // [R2][ldq]: x, then qm
  float* U = B1 + R2 * ldq;       // [R2][h]: t, then xhat
  float* B2 = U + R2 * h;         // [R2][h]: um, then g, then du
  float* B3 = B2 + R2 * h;        // [R2][h]: dom, then dt / dtm
  float* B4 = B3 + R2 * h;        // [R2][h]: dqp, then dqm
  float* S = B4 + R2 * h;         // [R2][SMAX]: scores, probs, dsm
  float* DP = S + R2 * SMAX;      // [R2][SMAX]: dprobs
  float* slab = DP + R2 * SMAX;   // SLAB_T
  float* mean = slab + SLAB_T;    // [R2]
  float* inv = mean + R2;         // [R2]
  const int r0 = blockIdx.x * R2, nv = min(R2, n - r0);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int lane = tx, warp = ty;
  const int heads = h / 64, hsz = heads * tk;
  float* pt = part + (size_t)blockIdx.x * 5 * h;
  float acc[2][4];
  float acc2[2][2];

  load_rows<T, R2>(x, n, din, r0, B1, ldq);
  // t = x @ Wt + bt
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, T>(B1, ldq, din, wt, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        U[(ty * 2 + i) * h + c] = acc[i][j] + bt[c];
      }
  }
  __syncthreads();
  row_stats<R2>(U, h, h, eps, mean, inv);
  __syncthreads();
  for (int e = threadIdx.x; e < R2 * h; e += NT) {
    const int r = e / h, c = e % h;
    const float xh = (U[e] - mean[r]) * inv[r];
    U[e] = xh;
    B2[e] = round_to<T>(xh * ls[c] + lb[c]);  // um
  }
  __syncthreads();
  store_tile<T, R2>(B2, h, h, nv, um_out, r0);
  // qm = round(um @ Wq + bq), over x (no longer read)
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, T>(B2, h, h, wq, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 32 * j;
        B1[(ty * 2 + i) * ldq + c] = round_to<T>(acc[i][j] + bq[c]);
      }
  }
  __syncthreads();
  store_tile<T, R2>(B1, ldq, h, nv, qm_out, r0);
  load_rows<T, R2>(g, n, h, r0, B2, h);
  // dom = round(g @ Wo^T)
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, T, true>(B2, h, h, wo, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        B3[(ty * 2 + i) * h + c0 + tx + 32 * j] = round_to<T>(acc[i][j]);
  }
  __syncthreads();
  store_tile<T, R2>(B3, h, h, nv, dom_out, r0);
  for (int hd = 0; hd < heads; ++hd) {
    const int ho = hd * 64;
    // scores = q_h . k_h^T * scale, -inf past tk
    for (int c0 = 0; c0 < SMAX; c0 += 128) {
      tile_gemm<4, false, T, true>(B1 + ho, ldq, 64, kk + ho, h, c0, tk,
                                   slab, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 32 * j;
          S[(ty * 2 + i) * SMAX + c] =
              (c < tk) ? acc[i][j] * scale : -INFINITY;
        }
    }
    __syncthreads();
    // per-head softmax in fp32, one warp per row (probs kept in fp32)
    for (int r = warp; r < R2; r += NT / 32) {
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
          pm_out[(size_t)(r0 + r) * hsz + hd * tk + c] = from_f<T>(s[c]);
      }
    }
    // o_h = round(probs) @ v_h -> om (dWo's operand)
    tile_gemm<2, true, T>(S, SMAX, tk, v + ho, h, 0, 64, slab, acc2);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty * 2 + i;
        if (r < nv)
          om_out[(size_t)(r0 + r) * h + ho + tx + 32 * j] =
              from_f<T>(acc2[i][j]);
      }
    // dprobs = dom_h @ v_h^T
    for (int c0 = 0; c0 < SMAX; c0 += 128) {
      tile_gemm<4, false, T, true>(B3 + ho, h, 64, v + ho, h, c0, tk, slab,
                                   acc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          DP[(ty * 2 + i) * SMAX + c0 + tx + 32 * j] = acc[i][j];
    }
    __syncthreads();
    // ds = probs (dprobs - <dprobs, probs>) * scale, rounded
    for (int r = warp; r < R2; r += NT / 32) {
      float* s = S + r * SMAX;
      const float* dp = DP + r * SMAX;
      float in = 0.f;
      for (int c = lane; c < tk; c += 32) in += dp[c] * s[c];
      in = warp_sum(in);
      for (int c = lane; c < tk; c += 32) {
        s[c] = round_to<T>((s[c] * (dp[c] - in)) * scale);
        if (r < nv)
          dsm_out[(size_t)(r0 + r) * hsz + hd * tk + c] = from_f<T>(s[c]);
      }
    }
    // dqp_h = dsm @ k_h (fp32; dbq sums it before rounding)
    tile_gemm<2, false, T>(S, SMAX, tk, kk + ho, h, 0, 64, slab, acc2);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        B4[(ty * 2 + i) * h + ho + tx + 32 * j] = acc2[i][j];
  }
  __syncthreads();
  col_sums(B2, h, h, nv, pt);      // dbo = sum g
  col_sums(B4, h, h, nv, pt + h);  // dbq = sum dqp
  __syncthreads();
  for (int e = threadIdx.x; e < R2 * h; e += NT) B4[e] = round_to<T>(B4[e]);
  __syncthreads();
  store_tile<T, R2>(B4, h, h, nv, dqm_out, r0);
  // du = g + dqm @ Wq^T
  for (int c0 = 0; c0 < h; c0 += 128) {
    tile_gemm<4, false, T, true>(B4, h, h, wq, h, c0, h, slab, acc);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        B2[(ty * 2 + i) * h + c0 + tx + 32 * j] += acc[i][j];
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
  for (int r = warp; r < R2; r += NT / 32) {
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
  for (int e = threadIdx.x; e < R2 * h; e += NT) B3[e] = round_to<T>(B3[e]);
  __syncthreads();
  store_tile<T, R2>(B3, h, h, nv, dtm_out, r0);
  if (dx == nullptr) return;
  // dx = dtm @ Wt^T
  for (int c0 = 0; c0 < din; c0 += 128) {
    tile_gemm<4, false, T, true>(B3, h, h, wt, h, c0, din, slab, acc);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 2 + i, c = c0 + tx + 32 * j;
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
typedef vct::BlockGemm<128, 128, 64, 64, 32, false, true, true, 3> GemmNT;
template <bool VEC>
using GemmTN = vct::BlockGemm<128, 128, 64, 64, 32, true, false, VEC, 3>;
constexpr int TC = 128;      // rows and columns of a product's block tile
constexpr int LN_ROWS = 32;  // rows per block of the LN backward

__global__ void __launch_bounds__(NT)
    pnmlp_ln_fwd_kernel(const vct::bf16* __restrict__ x,
                        const float* __restrict__ ls,
                        const float* __restrict__ lb, float eps,
                        vct::bf16* __restrict__ um, float* __restrict__ mean,
                        float* __restrict__ inv, int n, int h) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (r >= n) return;
  const vct::bf16* xr = x + (size_t)r * h;
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
  if (lane == 0) {
    mean[r] = m;
    inv[r] = iv;
  }
}

// The hidden product's block holds two groups of 8 warps on the same
// 128 x 128 tile, each with its own 32-deep slabs of a 3-stage ring: the
// first computes pre = um W1[:, c], the second dh = g W2[c, :]^T. 16
// warps an SM (at most 128 registers a thread) hide more latency than
// one group holding both accumulators (255 registers, 8 warps). The
// groups trade half their accumulators through shared memory, in the
// fragment order both share, and each runs the epilogue (one erff per
// element for GELU and its derivative) on half the rows.
typedef vct::BlockGemm<128, 128, 32, 64, 32, false, false, true, 3> HidNN;
typedef vct::BlockGemm<128, 128, 32, 64, 32, false, true, true, 3> HidNT;
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
  const int nk = h / 32;
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
        if (r < n) {
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
  if (threadIdx.x < TC) {
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
      for (int j = 0; j < GemmNT::NT; ++j)
        *reinterpret_cast<float2*>(du + (size_t)r * h + c0 + wn + j * 8 +
                                   2 * tq) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
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
// output tiles. VEC: 16-byte copies (aligned operands, widths multiples
// of 8); else element copies (K2's per-head slices of width Tk).
template <bool VEC>
__global__ void __launch_bounds__(GemmTN<VEC>::THREADS)
    wgrad_mma_kernel(const vct::bf16* __restrict__ A, int lda, int sa,
                     const vct::bf16* __restrict__ B, int ldb, int sb,
                     float* __restrict__ out, int ldo, int so, int n, int P,
                     int Q, int nz, int chunk, size_t split_stride) {
  typedef GemmTN<VEC> G;
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
// Design (first, simple version): pipeline T sees few rows (32 image
// features, 7 class means, 35 descriptions; d = 768, k = 64), so one block
// of 256 threads takes one row and keeps it in shared memory. W1 and W2
// (196 KB each at d = 768, k = 64) stay in global memory, where the L2
// keeps them for every block; each product reads them coalesced: x@W1 by
// 32 columns of W1 per warp over an eighth of its rows, h@W2 by one
// column per thread, da@W2^T and dh@W1^T by one row of the weight per
// warp. What bounds it on the H100: at these row counts, the latency of
// reading the weights from L2 and of the block reductions, not the 0.1-2
// MFLOP a row. The backward writes dx and each row's h, dh and da; the
// weight gradients (x^T dh, h^T da) and bias sums then run through
// wgrad_kernel and colsum_kernel, in row order, with no atomics.

constexpr unsigned FEAT_TILE = 256;  // the TPU kernel's ROW_TILE
constexpr int NW = NT / 32;          // warps per block

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

// The sum of v over the block, added in the same order on every call.
// red: NW floats of shared memory.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red is free: every thread has read the last sum
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < NW; ++w) s += red[w];
  return s;
}

// One row of K6's forward in shared memory: X [d] holds x (fp32); fills
// P [k] = x@W1 + b1, H [k] = relu(P) * mask and Z [d] = r a + (1 - r) x
// with a = H@W2 + b2, and returns 1 / |z|. part: NT floats.
__device__ float feat_row_forward(const float* X, int row, int d, int k,
                                  const float* __restrict__ w1,
                                  const float* __restrict__ b1,
                                  const float* __restrict__ w2,
                                  const float* __restrict__ b2, float r,
                                  unsigned seed, unsigned threshold,
                                  float scale, float* P, float* H, float* Z,
                                  float* part, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // pre = x@W1 + b1: warp w sums its eighth of the rows of W1 for 32
  // columns at a time (lane = column), then the eight partial sums are
  // added in warp order
  const int per = (d + NW - 1) / NW;
  const int c0 = warp * per, c1 = min(d, c0 + per);
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    float s = 0.f;
    if (j < k)
      for (int c = c0; c < c1; ++c) s = fmaf(X[c], w1[(size_t)c * k + j], s);
    part[warp * 32 + lane] = s;
    __syncthreads();
    if (warp == 0 && j < k) {
      float t = 0.f;
      for (int w = 0; w < NW; ++w) t += part[w * 32 + lane];
      const float pre = t + b1[j];
      float h = fmaxf(pre, 0.f);
      if (threshold) h *= feat_dropout(row, j, seed, threshold, scale);
      P[j] = pre;
      H[j] = h;
    }
    __syncthreads();
  }
  // z = r (h@W2 + b2) + (1 - r) x, one column per thread
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += NT) {
    float a = 0.f;
    for (int j = 0; j < k; ++j) a = fmaf(H[j], w2[(size_t)j * d + c], a);
    const float z = r * (a + b2[c]) + (1.f - r) * X[c];
    Z[c] = z;
    ss += z * z;
  }
  return rsqrtf(block_sum(ss, red));
}

template <typename T>
__global__ void __launch_bounds__(NT)
    feature_adapter_fwd_kernel(const T* __restrict__ x,
                               const float* __restrict__ w1,
                               const float* __restrict__ b1,
                               const float* __restrict__ w2,
                               const float* __restrict__ b2, float r,
                               unsigned seed, unsigned threshold, float scale,
                               T* __restrict__ y, int n, int d, int k) {
  extern __shared__ float smem[];
  float* X = smem;       // [d]
  float* Z = X + d;      // [d]
  float* P = Z + d;      // [k]
  float* H = P + k;      // [k]
  float* DH = H + k;     // [k] (unused here; the backward's)
  float* part = DH + k;  // [NT]
  float* red = part + NT;  // [NW]
  const int row = blockIdx.x;
  const T* xr = x + (size_t)row * d;
  for (int c = threadIdx.x; c < d; c += NT) X[c] = to_f(xr[c]);
  __syncthreads();
  const float inv = feat_row_forward(X, row, d, k, w1, b1, w2, b2, r, seed,
                                     threshold, scale, P, H, Z, part, red);
  // each thread reads back only the Z it wrote
  for (int c = threadIdx.x; c < d; c += NT)
    y[(size_t)row * d + c] = from_f<T>(Z[c] * inv);
}

// K6 backward row pass: recomputes the forward, then dz = (g - y<g, y>)
// inv, da = r dz, dh = (da@W2^T) * mask where pre > 0, dx = (1 - r) dz +
// dh@W1^T. Writes dx (when asked) and the rows' h [n, k], dh [n, k] and
// da [n, d] in fp32 for dW1 = x^T dh, dW2 = h^T da, db1 = sum dh, db2 =
// sum da.
template <typename T>
__global__ void __launch_bounds__(NT)
    feature_adapter_bwd_kernel(const T* __restrict__ x,
                               const float* __restrict__ w1,
                               const float* __restrict__ b1,
                               const float* __restrict__ w2,
                               const float* __restrict__ b2, float r,
                               unsigned seed, unsigned threshold, float scale,
                               const T* __restrict__ g, T* __restrict__ dx,
                               float* __restrict__ h_out,
                               float* __restrict__ dh_out,
                               float* __restrict__ da_out, int n, int d,
                               int k) {
  extern __shared__ float smem[];
  float* X = smem;       // [d]
  float* Z = X + d;      // [d]: z, then dz
  float* P = Z + d;      // [k]: pre
  float* H = P + k;      // [k]: h
  float* DH = H + k;     // [k]: dh
  float* part = DH + k;  // [NT]
  float* red = part + NT;  // [NW]
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xr = x + (size_t)row * d;
  const T* gr = g + (size_t)row * d;
  for (int c = threadIdx.x; c < d; c += NT) X[c] = to_f(xr[c]);
  __syncthreads();
  const float inv = feat_row_forward(X, row, d, k, w1, b1, w2, b2, r, seed,
                                     threshold, scale, P, H, Z, part, red);
  for (int j = threadIdx.x; j < k; j += NT) h_out[(size_t)row * k + j] = H[j];
  // <g, y>
  float gy = 0.f;
  for (int c = threadIdx.x; c < d; c += NT) gy += to_f(gr[c]) * (Z[c] * inv);
  gy = block_sum(gy, red);
  for (int c = threadIdx.x; c < d; c += NT) {
    const float dz = (to_f(gr[c]) - (Z[c] * inv) * gy) * inv;
    Z[c] = dz;
    da_out[(size_t)row * d + c] = r * dz;
  }
  __syncthreads();
  // dh = da@W2^T (one row of W2 per warp, lanes along it), then the
  // dropout mask and relu'
  for (int j = warp; j < k; j += NW) {
    const float* w = w2 + (size_t)j * d;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s = fmaf(r * Z[c], w[c], s);
    s = warp_sum(s);
    if (lane == 0) {
      if (threshold) s *= feat_dropout(row, j, seed, threshold, scale);
      const float dh = P[j] > 0.f ? s : 0.f;
      DH[j] = dh;
      dh_out[(size_t)row * k + j] = dh;
    }
  }
  if (dx == nullptr) return;
  __syncthreads();
  // dx = (1 - r) dz + dh@W1^T (one row of W1 per warp)
  for (int c = warp; c < d; c += NW) {
    const float* w = w1 + (size_t)c * k;
    float s = 0.f;
    for (int j = lane; j < k; j += 32) s = fmaf(DH[j], w[j], s);
    s = warp_sum(s);
    if (lane == 0) dx[(size_t)row * d + c] = from_f<T>((1.f - r) * Z[c] + s);
  }
}

// Dynamic shared memory above 48 KB must be allowed per kernel.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline dim3 grid_for(int n) { return dim3((n + ROWS - 1) / ROWS); }

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
  const size_t ldq = din > h ? din : h;
  return sizeof(float) *
         (ROWS * ldq + (size_t)ROWS * h + ROWS * SMAX + KC * 128);
}

int vct_seq_adapter_fwd(int bf16, const void* x, const void* w1,
                        const void* b1, const void* w2, const void* b2,
                        const void* ls, const void* lb, float eps, void* y,
                        int n, int h, int k, void* stream) {
  const size_t smem = vct_seq_adapter_smem(h, k);
  cudaStream_t st = (cudaStream_t)stream;
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

int vct_prenorm_mlp_fwd(int bf16, const void* x, const void* w1,
                        const void* b1, const void* w2, const void* b2,
                        const void* ls, const void* lb, float eps, void* y,
                        int n, int h, int k, void* stream) {
  const size_t smem = vct_prenorm_mlp_smem(h);
  cudaStream_t st = (cudaStream_t)stream;
  const float *fb1 = (const float*)b1, *fb2 = (const float*)b2,
              *fls = (const float*)ls, *flb = (const float*)lb;
  int err;
  if (bf16) {
    typedef __nv_bfloat16 T;
    auto kern = prenorm_mlp_fwd_kernel<T>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<grid_for(n), NT, smem, st>>>((const T*)x, (const T*)w1, fb1,
                                        (const T*)w2, fb2, fls, flb, eps,
                                        (T*)y, n, h, k);
  } else {
    typedef float T;
    auto kern = prenorm_mlp_fwd_kernel<T>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<grid_for(n), NT, smem, st>>>((const T*)x, (const T*)w1, fb1,
                                        (const T*)w2, fb2, fls, flb, eps,
                                        (T*)y, n, h, k);
  }
  return (int)cudaGetLastError();
}

int vct_cross_attn_block_fwd(int bf16, const void* x, const void* wt,
                             const void* bt, const void* ls, const void* lb,
                             const void* wq, const void* bq, const void* kt,
                             const void* v, const void* wo, const void* bo,
                             float eps, float scale, void* y, int n, int din,
                             int h, int tk, void* stream) {
  const size_t smem = vct_cross_attn_block_smem(din, h);
  cudaStream_t st = (cudaStream_t)stream;
  const float *fbt = (const float*)bt, *fls = (const float*)ls,
              *flb = (const float*)lb, *fbq = (const float*)bq,
              *fbo = (const float*)bo;
  int err;
  if (bf16) {
    typedef __nv_bfloat16 T;
    auto kern = cross_attn_block_fwd_kernel<T>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<grid_for(n), NT, smem, st>>>(
        (const T*)x, (const T*)wt, fbt, fls, flb, (const T*)wq, fbq,
        (const T*)kt, (const T*)v, (const T*)wo, fbo, eps, scale, (T*)y, n,
        din, h, tk);
  } else {
    typedef float T;
    auto kern = cross_attn_block_fwd_kernel<T>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<grid_for(n), NT, smem, st>>>(
        (const T*)x, (const T*)wt, fbt, fls, flb, (const T*)wq, fbq,
        (const T*)kt, (const T*)v, (const T*)wo, fbo, eps, scale, (T*)y, n,
        din, h, tk);
  }
  return (int)cudaGetLastError();
}

size_t vct_seq_adapter_bwd_smem(int h, int k) {
  return sizeof(float) *
         ((size_t)ROWS * h + 2 * (size_t)ROWS * k + SLAB_T + 2 * ROWS);
}
size_t vct_prenorm_mlp_bwd_smem(int h) {
  return sizeof(float) *
         (3 * (size_t)ROWS * h + ROWS * 128 + SLAB_T + 2 * ROWS);
}
size_t vct_cross_attn_block_bwd_smem(int din, int h) {
  const size_t ldq = din > h ? din : h;
  return sizeof(float) * (R2 * ldq + 4 * (size_t)R2 * h + 2 * R2 * SMAX +
                          SLAB_T + 2 * R2);
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

// fp32 only (the CUDA-core row pass); bf16 takes vct_prenorm_mlp_bwd_bf16.
int vct_prenorm_mlp_bwd(int bf16, const void* x, const void* w1,
                        const void* b1, const void* w2, const void* ls,
                        const void* lb, const void* g, float eps, void* dx,
                        void* um_out, void* hm_out, void* dpm_out,
                        void* part, int n, int h, int k, void* stream) {
  if (bf16) return (int)cudaErrorInvalidValue;
  const size_t smem = vct_prenorm_mlp_bwd_smem(h);
  typedef float T;
  auto kern = prenorm_mlp_bwd_kernel<T>;
  int err;
  if ((err = allow_smem(kern, smem))) return err;
  kern<<<grid_for(n), NT, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)ls, (const float*)lb, (const T*)g, eps, (T*)dx,
      (T*)um_out, (T*)hm_out, (T*)dpm_out, (float*)part, n, h, k);
  return (int)cudaGetLastError();
}

int vct_cross_attn_block_bwd(int bf16, const void* x, const void* wt,
                             const void* bt, const void* ls, const void* lb,
                             const void* wq, const void* bq, const void* k,
                             const void* v, const void* wo, const void* g,
                             float eps, float scale, void* dx, void* um_out,
                             void* qm_out, void* om_out, void* dom_out,
                             void* pm_out, void* dsm_out, void* dqm_out,
                             void* dtm_out, void* part, int n, int din,
                             int h, int tk, void* stream) {
  const size_t smem = vct_cross_attn_block_bwd_smem(din, h);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + R2 - 1) / R2);
  const float *fbt = (const float*)bt, *fls = (const float*)ls,
              *flb = (const float*)lb, *fbq = (const float*)bq;
  int err;
  if (bf16) {
    typedef __nv_bfloat16 T;
    auto kern = cross_attn_block_bwd_kernel<T>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<grid, NT, smem, st>>>(
        (const T*)x, (const T*)wt, fbt, fls, flb, (const T*)wq, fbq,
        (const T*)k, (const T*)v, (const T*)wo, (const T*)g, eps, scale,
        (T*)dx, (T*)um_out, (T*)qm_out, (T*)om_out, (T*)dom_out, (T*)pm_out,
        (T*)dsm_out, (T*)dqm_out, (T*)dtm_out, (float*)part, n, din, h, tk);
  } else {
    typedef float T;
    auto kern = cross_attn_block_bwd_kernel<T>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<grid, NT, smem, st>>>(
        (const T*)x, (const T*)wt, fbt, fls, flb, (const T*)wq, fbq,
        (const T*)k, (const T*)v, (const T*)wo, (const T*)g, eps, scale,
        (T*)dx, (T*)um_out, (T*)qm_out, (T*)om_out, (T*)dom_out, (T*)pm_out,
        (T*)dsm_out, (T*)dqm_out, (T*)dtm_out, (float*)part, n, din, h, tk);
  }
  return (int)cudaGetLastError();
}

// A and B each float (0) or bf16 (1); bf16 A with fp32 B is K1's x^T dpre.
// bf16 x bf16 runs on the tensor cores over 128 x 128 output tiles (grid
// ceil(q / 128) x ceil(p / 128) x z * splits), the rest on the CUDA cores
// over 64 x 64 tiles.
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
  if (!a_bf16 && !b_bf16)
    wgrad_kernel<float, float><<<grid, NT, 0, st>>>(
        (const float*)a, lda, sa, (const float*)b, ldb, sb, o, ldo, so, n, p,
        q, z, chunk, stride);
  else if (a_bf16 && !b_bf16)
    wgrad_kernel<H, float><<<grid, NT, 0, st>>>(
        (const H*)a, lda, sa, (const float*)b, ldb, sb, o, ldo, so, n, p, q,
        z, chunk, stride);
  else if (a_bf16 && b_bf16) {
    // the tensor cores, over 128 x 128 tiles
    const dim3 tgrid((q + TC - 1) / TC, (p + TC - 1) / TC, z * splits);
    const bool vec = (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
                     lda % 8 == 0 && ldb % 8 == 0 && sa % 8 == 0 &&
                     sb % 8 == 0 && p % 8 == 0 && q % 8 == 0;
    auto kern = vec ? wgrad_mma_kernel<true> : wgrad_mma_kernel<false>;
    const size_t smem = vec ? GemmTN<true>::SMEM_BYTES
                            : GemmTN<false>::SMEM_BYTES;
    int err;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<tgrid, GemmTN<true>::THREADS, smem, st>>>(
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

// K3 backward in bf16 on the tensor cores (h, k multiples of 128; every
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
  if (h % TC || k % TC) return (int)cudaErrorInvalidValue;
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
  pnmlp_bwd_hidden_kernel<<<dim3(k / TC, row_tiles), 2 * HID_GROUP,
                            HID_SMEM, st>>>(
      um, (const T*)g, (const T*)w1, (const float*)b1, (const T*)w2, hm, dpm,
      part_hidden, n, h, k);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = allow_smem(pnmlp_bwd_du_kernel, GemmNT::SMEM_BYTES))) return err;
  pnmlp_bwd_du_kernel<<<dim3(h / TC, row_tiles), GemmNT::THREADS,
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
  if ((err = vct_wgrad(1, 1, hm, k, 0, g, h, 0, dw2, h, 0, n, k, h, 1, splits,
                       work, (size_t)h * k, stream)))
    return err;
  if ((err = vct_colsum(part_hidden, row_tiles, k, vec, stream))) return err;
  return vct_colsum(part_ln, ln_tiles, 3 * h, (float*)vec + k, stream);
}

// K6, forward and backward: one block per row.
size_t vct_feature_adapter_smem(int d, int k) {
  return sizeof(float) * (2 * (size_t)d + 3 * (size_t)k + NT + NW);
}

int vct_feature_adapter_fwd(int bf16, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            float r, unsigned seed, unsigned threshold,
                            float scale, void* y, int n, int d, int k,
                            void* stream) {
  const size_t smem = vct_feature_adapter_smem(d, k);
  cudaStream_t st = (cudaStream_t)stream;
  const float *fw1 = (const float*)w1, *fb1 = (const float*)b1,
              *fw2 = (const float*)w2, *fb2 = (const float*)b2;
  int err;
  if (bf16) {
    typedef __nv_bfloat16 T;
    auto kern = feature_adapter_fwd_kernel<T>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<n, NT, smem, st>>>((const T*)x, fw1, fb1, fw2, fb2, r, seed,
                              threshold, scale, (T*)y, n, d, k);
  } else {
    typedef float T;
    auto kern = feature_adapter_fwd_kernel<T>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<n, NT, smem, st>>>((const T*)x, fw1, fb1, fw2, fb2, r, seed,
                              threshold, scale, (T*)y, n, d, k);
  }
  return (int)cudaGetLastError();
}

int vct_feature_adapter_bwd(int bf16, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            float r, unsigned seed, unsigned threshold,
                            float scale, const void* g, void* dx,
                            void* h_out, void* dh_out, void* da_out, int n,
                            int d, int k, void* stream) {
  const size_t smem = vct_feature_adapter_smem(d, k);
  cudaStream_t st = (cudaStream_t)stream;
  const float *fw1 = (const float*)w1, *fb1 = (const float*)b1,
              *fw2 = (const float*)w2, *fb2 = (const float*)b2;
  float *fh = (float*)h_out, *fdh = (float*)dh_out, *fda = (float*)da_out;
  int err;
  if (bf16) {
    typedef __nv_bfloat16 T;
    auto kern = feature_adapter_bwd_kernel<T>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<n, NT, smem, st>>>((const T*)x, fw1, fb1, fw2, fb2, r, seed,
                              threshold, scale, (const T*)g, (T*)dx, fh, fdh,
                              fda, n, d, k);
  } else {
    typedef float T;
    auto kern = feature_adapter_bwd_kernel<T>;
    if ((err = allow_smem(kern, smem))) return err;
    kern<<<n, NT, smem, st>>>((const T*)x, fw1, fb1, fw2, fb2, r, seed,
                              threshold, scale, (const T*)g, (T*)dx, fh, fdh,
                              fda, n, d, k);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
