// Hand-written Hopper (sm_90a) kernels for the CLIP towers' short-sequence
// attention (K5).
//
// Port of vlm_clip_tpu/ops/attention.py: fused_attention (:100), Pallas
// kernels _attn_kernel_nomask (:59) and _attn_kernel_mask (:63):
//
//   o = softmax(q k^T * scale + mask) v   over [B, h, T, d] q, k, v
//
// for head widths d of 64 (every CLIP preset), 128 and 256, each its own
// instantiation, and past 256 a multiple of 64 streamed in column chunks
// (attention_wide_kernel); the wrapper zero-pads a head to the next of
// these widths (zero columns add nothing to a score and give zero
// outputs).
//
// with the TPU kernel's rounding points: the scores are fp32 sums of
// products of T values (bf16 products are exact in fp32), times scale,
// plus the fp32 mask; the softmax is fp32; p is rounded to T after it is
// normalized; p v accumulates in fp32; o is written in T. The mask is
// none, [T, T] (batch stride 0) or [B, 1, T, T] (a batch-broadcast mask
// comes in expanded, batch stride 0).
//
// q, k, v and o are read and written through their batch, head and row
// strides (Strides; a head's d columns are contiguous), so the [B, h, T,
// d] views of [B, T, h d] projections need no transposed copy and o can be
// written where the out-projection reads it.
//
// The TPU kernel holds a whole head's [T, T] scores in VMEM; at T = 257
// that is 264 KB of fp32, more than the 227 KB of shared memory a Hopper
// block may use. So each block takes (batch, head, a tile of 64 query
// rows) and streams K (and V) in chunks of 64 keys, in two passes over the
// keys: the first takes each row's max and sum of exponentials, the
// second recomputes the scores and multiplies p = exp(s - max) / sum,
// rounded to T, into V. One pass with an online softmax would round p
// before it is normalized, which the TPU kernel does not.
//
// bf16 (attention_mma_kernel). What bounds it on the H100: the bytes of
// q, k, v and o (about 0.025 ms at ViT-L/14's shapes) against some 20
// GFLOP of products and 100 M exponentials: both products (q k^T twice,
// p v once) run on the tensor cores (mma.sync m16n8k16, bf16 operands,
// fp32 accumulation), fed by ldmatrix from bf16 tiles that cp.async
// double-buffers, so the second q k^T costs little; each exponential is
// one FFMA and one ex2 on the special-function unit. A block takes 128
// query rows on 8 warps of 16, so each K/V chunk read from L2 serves 128
// rows, and two blocks fill an SM (16 warps, at most 128 registers a
// thread; 64-row blocks measured no faster). A warp whose rows all lie
// past T skips its work, and so does a group of 16 keys wholly past T (at
// T = 257 the last chunk holds one key). What still bounds it: two passes
// do 1.5 times the products and twice the exponentials of a one-pass
// online softmax. A thread keeps its rows' max and sum in registers
// (quad shuffles reduce a score fragment's row) and p goes from the score
// accumulators straight into the A fragments of p v, rounded to bf16,
// with no trip through shared memory. The ragged last key chunk and the
// rows past T are masked (zero-filled tiles, -inf scores), not padded in
// memory.
//
// fp32 (attention_fwd_kernel, the first version). The tensor cores take
// fp32 only as TF32, which would round operands the TPU kernel keeps, so
// fp32 stays on the CUDA cores: one block of 256 threads per (batch, head,
// 64 query rows), q, k and v in fp32 tiles, each thread a 4 x 4 tile of
// the scores and a 4 x d/16 tile of the output, fp32 FMAs (q k^T computed
// twice). It also takes bf16 heads of 129-256 columns (D = 256), which
// the tensor-core kernel's registers do not hold: the bf16 operands are
// widened as they are loaded (their products are exact in fp32), p is
// rounded to bf16 after it is normalized and o once at the end, the
// rounding points of the tensor-core kernel and of the TPU kernel. At D =
// 256 a block takes 4 (64 257 + 64 257 + 64 256 + 64 65 + 128) = 214,272
// bytes of shared memory, under the 232,448 a Hopper block may use; D =
// 512 would take 410,880, so heads past 256 columns take the column-chunk
// kernel below, whose tiles are those of D = 256.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"

namespace {

// Head widths D: 64 (every CLIP preset), 128 and 256; the wrapper
// zero-pads a narrower head to the next of them, which changes no score.
constexpr int QT = 64;     // query rows per block
constexpr int KC = 64;     // keys per chunk
constexpr int NT = 256;    // threads per block
constexpr int SLS = KC + 1;  // padded row of the fp32 score tile

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

// Element strides of a [b, heads, t, d] operand: batch, head and row (a
// row's d columns are contiguous).
struct Strides {
  long long b, h, r;

  __device__ __forceinline__ size_t head(int bi, int hi) const {
    return (size_t)bi * b + (size_t)hi * h;
  }
};

// Strides of q, k, v and o, in that order.
struct AttnStrides {
  Strides q, k, v, o;
};

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

// rows [r0, r0 + 64) of a [T, D] head (row stride ld) -> fp32 tile (row
// stride ldt); rows past t are 0.
template <int D, typename T>
__device__ void load_tile(const T* __restrict__ src, long long ld, int t,
                          int r0, float* tile, int ldt) {
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, c = e % D;
    tile[r * ldt + c] = (r0 + r < t) ? to_f(src[(size_t)(r0 + r) * ld + c])
                                     : 0.f;
  }
}

// s[i][j] += q[row_i] . k[col_j] over the first n columns of the tiles
// Qs and Ks (row stride LD), in column order, for the thread's rows row_i
// = ty + 16 i and columns col_j = tx + 16 j of the tiles.
template <int LD>
__device__ __forceinline__ void scores_add(const float* Qs, const float* Ks,
                                           int n, float (&s)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 8
  for (int dd = 0; dd < n; ++dd) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + dd];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * LD + dd];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

__device__ __forceinline__ void scores_zero(float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
}

// s[i][j] = s[i][j] * scale + mask(row_i, col_j) for the thread's rows
// row_i = q0 + ty + 16 i and columns col_j = k0 + tx + 16 j; -inf past
// the last key (and 0 mask past the last query row).
__device__ __forceinline__ void scores_finish(const float* __restrict__ mask,
                                              int t, int q0, int k0,
                                              float scale, float (&s)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx + 16 * j;
      float v = s[i][j] * scale;
      if (mask != nullptr && r < t && c < t) v += mask[(size_t)r * t + c];
      s[i][j] = c < t ? v : -INFINITY;
    }
  }
}

// s[i][j] = (q[row_i] . k[col_j]) * scale + mask(row_i, col_j) over the
// whole head (D columns), as scores_finish says.
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks,
                                       const float* __restrict__ mask,
                                       int t, int q0, int k0, float scale,
                                       float (&s)[4][4]) {
  scores_zero(s);
  scores_add<D + 1>(Qs, Ks, D, s);
  scores_finish(mask, t, q0, k0, scale, s);
}

// Pass 1's running statistics of a block's 64 query rows over the key
// chunks: warp w owns rows 8w .. 8w + 7, each lane two keys of a chunk.
struct RowStats {
  float m[8], l[8];  // row max; row sum of exp(s - max)

  __device__ __forceinline__ RowStats() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
  }

  // Takes in a key chunk's scores s through Ss (free: every thread is
  // past a barrier since it was last read); ends with Ss still to read.
  __device__ __forceinline__ void add(float* Ss, const float (&s)[4][4]) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[(ty + 16 * i) * SLS + tx + 16 * j] = s[i][j];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* sr = Ss + (warp * 8 + i) * SLS;
      const float a = sr[lane], c = sr[lane + 32];
      const float mn = fmaxf(m[i], warp_max(fmaxf(a, c)));
      float e = 0.f;
      if (mn != -INFINITY) e = expf(a - mn) + expf(c - mn);
      e = warp_sum(e);
      l[i] = (m[i] == -INFINITY ? 0.f : l[i] * expf(m[i] - mn)) + e;
      m[i] = mn;
    }
  }

  // the rows' max and sum to M and L [QT]
  __device__ __forceinline__ void store(float* M, float* L) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        M[warp * 8 + i] = m[i];
        L[warp * 8 + i] = l[i];
      }
    }
  }
};

// Pass 2's p = exp(s - max) / sum of the thread's scores s, rounded to T
// after it is normalized (the TPU kernel's rounding point), into Ss.
template <typename T>
__device__ __forceinline__ void p_store(float* Ss, const float* M,
                                        const float* L,
                                        const float (&s)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float m = M[r], l = L[r];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Ss[r * SLS + tx + 16 * j] = to_f(from_f<T>(expf(s[i][j] - m) / l));
  }
}

// o[i][j] += sum over the chunk's kn keys c of p(row_i, c) v(c, col_j),
// in key order, for the thread's rows ty + 16 i and its first oj of the
// columns tx + 16 j of the V tile Vs (row stride ldv).
template <int OJ>
__device__ __forceinline__ void pv_add(const float* Ss, const float* Vs,
                                       int ldv, int kn, int oj,
                                       float (&o)[4][OJ]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int c = 0; c < kn; ++c) {
    float p[4], w[OJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * SLS + c];
#pragma unroll
    for (int j = 0; j < OJ; ++j)
      w[j] = j < oj ? Vs[c * ldv + tx + 16 * j] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < OJ; ++j) o[i][j] = fmaf(p[i], w[j], o[i][j]);
  }
}

// The thread's first oj output columns c0 + tx + 16 j of its rows q0 +
// ty + 16 i below t, in T, into the head oh (row stride ld).
template <typename T, int OJ>
__device__ __forceinline__ void out_store(T* oh, long long ld, int c0,
                                          int q0, int t, int oj,
                                          const float (&o)[4][OJ]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < t)
#pragma unroll
      for (int j = 0; j < OJ; ++j)
        if (j < oj) oh[(size_t)r * ld + c0 + tx + 16 * j] = from_f<T>(o[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ mask, long long mask_bstride,
                         float scale, T* __restrict__ out, AttnStrides strides,
                         int t) {
  constexpr int LD = D + 1;  // padded row of the q / k tiles
  constexpr int OJ = D / 16;  // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;           // [QT][LD]
  float* Ks = Qs + QT * LD;   // [KC][LD]
  float* Vs = Ks + KC * LD;   // [KC][D]
  float* Ss = Vs + KC * D;    // [QT][SLS]: scores, then p rounded to T
  float* M = Ss + QT * SLS;   // [QT]: row max
  float* L = M + QT;          // [QT]: row sum of exp(s - max)
  const int q0 = blockIdx.x * QT, hd = blockIdx.y, b = blockIdx.z;
  const T* qh = q + strides.q.head(b, hd);
  const T* kh = k + strides.k.head(b, hd);
  const T* vh = v + strides.v.head(b, hd);
  const float* mb = mask == nullptr ? nullptr : mask + b * mask_bstride;
  float s[4][4];

  load_tile<D>(qh, strides.q.r, t, q0, Qs, LD);
  // pass 1: running max and sum per row
  RowStats st;
  for (int k0 = 0; k0 < t; k0 += KC) {
    __syncthreads();  // Ks and Ss are free
    load_tile<D>(kh, strides.k.r, t, k0, Ks, LD);
    __syncthreads();
    scores<D>(Qs, Ks, mb, t, q0, k0, scale, s);
    st.add(Ss, s);
  }
  st.store(M, L);
  // pass 2: o = round(p) v, p = exp(s - max) / sum
  float o[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) o[i][j] = 0.f;
  for (int k0 = 0; k0 < t; k0 += KC) {
    __syncthreads();  // Ks, Vs, Ss free; M, L written
    load_tile<D>(kh, strides.k.r, t, k0, Ks, LD);
    load_tile<D>(vh, strides.v.r, t, k0, Vs, D);
    __syncthreads();
    scores<D>(Qs, Ks, mb, t, q0, k0, scale, s);
    p_store<T>(Ss, M, L, s);
    __syncthreads();
    pv_add<OJ>(Ss, Vs, D, min(KC, t - k0), OJ, o);
  }
  out_store<T, OJ>(out + strides.o.head(b, hd), strides.o.r, 0, q0, t, OJ,
                   o);
}

// ---------------------------------------------------------------------------
// Heads wider than 256 columns, streamed in column chunks
// ---------------------------------------------------------------------------
//
// attention_wide_kernel takes heads of d > 256 columns (d a multiple of
// 64: the wrapper zero-pads), for which attention_fwd_kernel's whole-head
// tiles would not fit a block's shared memory (D = 512: 410,880 bytes).
// The block, its threads' tiles and its two passes are
// attention_fwd_kernel's, through the same device functions (RowStats,
// p_store, pv_add, out_store); what changes is that q, k and v are
// streamed in column chunks of at most WC = 256 into tiles of that width
// (214,272 bytes, as at D = 256):
//   - a key chunk's scores are the sums of q . k over the column chunks,
//     taken in column order in each thread's registers (the same order
//     as the whole-head kernel's), then scaled and masked;
//   - pass 1 keeps each row's max and sum of exp(s - max) over the key
//     chunks;
//   - pass 2 writes the output one column chunk at a time: for each, it
//     recomputes every key chunk's scores (the same bits as pass 1), takes
//     p = exp(s - max) / sum rounded to T, and adds p v over the chunk's
//     columns of v.
// So p is rounded after it is normalized, as in the TPU kernel (no online
// softmax), at the price of recomputing the scores once an output chunk
// (twice at d = 512). No CLIP preset has such heads; this route is for
// completeness, not speed.

constexpr int WC = 256;  // columns of a chunk

// rows [r0, r0 + 64) and columns [c0, c0 + cw) of a [t, d] head (row
// stride ld) -> fp32 tile (row stride ldt); rows past t are 0.
template <typename T>
__device__ void load_chunk(const T* __restrict__ src, long long ld, int t,
                           int r0, int c0, int cw, float* tile, int ldt) {
  for (int e = threadIdx.x; e < 64 * cw; e += NT) {
    const int r = e / cw, c = e % cw;
    tile[r * ldt + c] =
        (r0 + r < t) ? to_f(src[(size_t)(r0 + r) * ld + c0 + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
    attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ mask,
                          long long mask_bstride, float scale,
                          T* __restrict__ out, AttnStrides strides, int t,
                          int d) {
  constexpr int LD = WC + 1;   // padded row of the q / k chunk tiles
  constexpr int OJ = WC / 16;  // output columns a thread, at most
  extern __shared__ float smem[];
  float* Qs = smem;           // [QT][LD] a column chunk of q
  float* Ks = Qs + QT * LD;   // [KC][LD] a column chunk of k
  float* Vs = Ks + KC * LD;   // [KC][WC] a column chunk of v
  float* Ss = Vs + KC * WC;   // [QT][SLS]: scores, then p rounded to T
  float* M = Ss + QT * SLS;   // [QT]: row max
  float* L = M + QT;          // [QT]: row sum of exp(s - max)
  const int q0 = blockIdx.x * QT, hd = blockIdx.y, b = blockIdx.z;
  const T* qh = q + strides.q.head(b, hd);
  const T* kh = k + strides.k.head(b, hd);
  const T* vh = v + strides.v.head(b, hd);
  const float* mb = mask == nullptr ? nullptr : mask + b * mask_bstride;
  float s[4][4];

  // the scores of the key chunk at k0: q . k summed over the column
  // chunks in order, then scaled and masked (starts with a barrier: the
  // tiles and Ss are free once every thread is past it)
  auto chunk_scores = [&](int k0) {
    scores_zero(s);
    for (int c0 = 0; c0 < d; c0 += WC) {
      const int cw = min(WC, d - c0);
      __syncthreads();
      load_chunk(qh, strides.q.r, t, q0, c0, cw, Qs, LD);
      load_chunk(kh, strides.k.r, t, k0, c0, cw, Ks, LD);
      __syncthreads();
      scores_add<LD>(Qs, Ks, cw, s);
    }
    scores_finish(mb, t, q0, k0, scale, s);
  };

  // pass 1: running max and sum per row
  RowStats st;
  for (int k0 = 0; k0 < t; k0 += KC) {
    chunk_scores(k0);
    st.add(Ss, s);
  }
  st.store(M, L);
  // pass 2, one output column chunk at a time: o = round(p) v over the
  // chunk's columns, p = exp(s - max) / sum
  for (int c0 = 0; c0 < d; c0 += WC) {
    const int cw = min(WC, d - c0), oj = cw / 16;
    float o[4][OJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < OJ; ++j) o[i][j] = 0.f;
    for (int k0 = 0; k0 < t; k0 += KC) {
      chunk_scores(k0);  // its barriers also order M, L and Vs
      p_store<T>(Ss, M, L, s);
      load_chunk(vh, strides.v.r, t, k0, c0, cw, Vs, WC);
      __syncthreads();
      pv_add<OJ>(Ss, Vs, WC, min(KC, t - k0), oj, o);
    }
    out_store<T, OJ>(out + strides.o.head(b, hd), strides.o.r, c0, q0, t, oj,
                     o);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 8;        // per block, 16 query rows each
constexpr int MQ = 16 * MMA_WARPS;  // query rows per block
constexpr int MT_N = 32 * MMA_WARPS;
// blocks an SM: at D = 64, 16 warps at <= 128 registers; at D = 128 the
// output fragments alone take 64 registers, so one block of 8 warps
template <int D>
constexpr int mma_blocks() { return D <= 64 ? 16 / MMA_WARPS : 1; }

// rows [r0, r0 + R) of a [t, D] bf16 head (row stride ld, 16-byte
// aligned rows) -> tile (row stride D + 8; rows past t zeroed)
template <int R, int D>
__device__ __forceinline__ void load_head_rows(vct::bf16* tile,
                                               const vct::bf16* src,
                                               long long ld, int t,
                                               int r0) {
  constexpr int SLD = D + 8;
#pragma unroll
  for (int i = 0; i < R * (D / 8) / MT_N; ++i) {
    const int e = threadIdx.x + i * MT_N;
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    const bool ok = r0 + r < t;
    vct::cp_async16(tile + r * SLD + c,
                    ok ? src + (size_t)(r0 + r) * ld + c : src, ok);
  }
}

using vct::ex2;
using vct::L2E;
using vct::quad_max;
using vct::quad_sum;

// Steps 0 .. nc-1 are pass 1 over the key chunks (K only), steps nc ..
// 2nc-1 pass 2 (K and V); step s + 1's chunks load while step s computes.
// A warp whose 16 rows all lie past t only loads and waits; key pairs
// (16 keys) wholly past t are skipped.
template <int D>
__global__ void __launch_bounds__(MT_N, mma_blocks<D>())
    attention_mma_kernel(const vct::bf16* __restrict__ q,
                         const vct::bf16* __restrict__ k,
                         const vct::bf16* __restrict__ v,
                         const float* __restrict__ mask,
                         long long mask_bstride, float scale,
                         vct::bf16* __restrict__ out, AttnStrides strides,
                         int t) {
  using vct::bf16;
  constexpr int SLD = D + 8;  // shared row of a bf16 q / k / v tile
  extern __shared__ __align__(16) unsigned char attn_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(attn_smem);  // [MQ][SLD]
  bf16* Ks = Qs + MQ * SLD;                       // [2][KC][SLD]
  bf16* Vs = Ks + 2 * KC * SLD;                   // [2][KC][SLD]
  const int q0 = blockIdx.x * MQ, hd = blockIdx.y, b = blockIdx.z;
  const bf16* qh = q + strides.q.head(b, hd);
  const bf16* kh = k + strides.k.head(b, hd);
  const bf16* vh = v + strides.v.head(b, hd);
  const float* mb = mask == nullptr ? nullptr : mask + b * mask_bstride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;  // this thread's rows
  const bool active = q0 + warp * 16 < t;
  const int nc = (t + KC - 1) / KC, steps = 2 * nc;

  auto issue = [&](int s) {
    const int c = s < nc ? s : s - nc;
    load_head_rows<KC, D>(Ks + (s & 1) * KC * SLD, kh, strides.k.r, t,
                          c * KC);
    if (s >= nc)
      load_head_rows<KC, D>(Vs + (s & 1) * KC * SLD, vh, strides.v.r, t,
                            c * KC);
  };
  load_head_rows<MQ, D>(Qs, qh, strides.q.r, t, q0);
  issue(0);
  vct::cp_async_commit();

  uint32_t qf[D / 16][4];  // the warp's 16 q rows as A fragments
  float m_lo = -INFINITY, m_hi = -INFINITY;  // row max (quad-uniform)
  float l_lo = 0.f, l_hi = 0.f;  // this thread's share of the row sum
  float ml_lo = 0.f, ml_hi = 0.f, inv_lo = 0.f, inv_hi = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1);
    vct::cp_async_commit();
    vct::cp_async_wait<1>();
    __syncthreads();  // step s's chunks (and q) landed
    if (active) {
      if (s == 0) vct::load_a_rows<D>(qf, Qs, SLD, warp * 16, lane);
      const bool pass2 = s >= nc;
      const int k0 = (pass2 ? s - nc : s) * KC;
      const bf16* Kb = Ks + (s & 1) * KC * SLD;
      // scores of the warp's 16 rows against the chunk's 64 keys
      float sc[KC / 8][4];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int j = 0; j < KC / 8; j += 2) {
        if (k0 + j * 8 >= t) continue;
        vct::mma_rows_t16<D>(sc[j], sc[j + 1], qf, Kb, SLD, j * 8, lane);
      }
      // times scale, plus the mask (fp32); -inf past the last key
      if (mb == nullptr && k0 + KC <= t) {
#pragma unroll
        for (int j = 0; j < KC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] *= scale;
      } else {
#pragma unroll
        for (int j = 0; j < KC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e < 2 ? r_lo : r_hi;
            const int c = k0 + j * 8 + 2 * tq + (e & 1);
            float x = sc[j][e] * scale;
            if (mb != nullptr && r < t && c < t) x += mb[(size_t)r * t + c];
            sc[j][e] = c < t ? x : -INFINITY;
          }
      }
      if (!pass2) {
        float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
          mx_lo = fmaxf(mx_lo, fmaxf(sc[j][0], sc[j][1]));
          mx_hi = fmaxf(mx_hi, fmaxf(sc[j][2], sc[j][3]));
        }
        const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
        const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
        // a chunk with nothing but -inf so far leaves the sums at 0
        float e_lo = 0.f, e_hi = 0.f;
        if (mn_lo != -INFINITY) {
          const float c_lo = -mn_lo * L2E;
#pragma unroll
          for (int j = 0; j < KC / 8; ++j)
            if (k0 + j * 8 < t)
              e_lo += ex2(fmaf(sc[j][0], L2E, c_lo)) +
                      ex2(fmaf(sc[j][1], L2E, c_lo));
        }
        if (mn_hi != -INFINITY) {
          const float c_hi = -mn_hi * L2E;
#pragma unroll
          for (int j = 0; j < KC / 8; ++j)
            if (k0 + j * 8 < t)
              e_hi += ex2(fmaf(sc[j][2], L2E, c_hi)) +
                      ex2(fmaf(sc[j][3], L2E, c_hi));
        }
        l_lo = (m_lo == -INFINITY ? 0.f : l_lo * ex2((m_lo - mn_lo) * L2E)) +
               e_lo;
        l_hi = (m_hi == -INFINITY ? 0.f : l_hi * ex2((m_hi - mn_hi) * L2E)) +
               e_hi;
        m_lo = mn_lo;
        m_hi = mn_hi;
        if (s == nc - 1) {
          inv_lo = 1.f / quad_sum(l_lo);
          inv_hi = 1.f / quad_sum(l_hi);
          ml_lo = -m_lo * L2E;
          ml_hi = -m_hi * L2E;
        }
      } else {
        // p = exp(s - max) / sum, rounded to bf16 into the A fragments of
        // p v: keys 16kk .. 16kk + 15 are score tiles 2kk and 2kk + 1
        const bf16* Vb = Vs + (s & 1) * KC * SLD;
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          if (k0 + kk * 16 >= t) continue;
          float p0[4], p1[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ml = e < 2 ? ml_lo : ml_hi;
            const float inv = e < 2 ? inv_lo : inv_hi;
            p0[e] = ex2(fmaf(sc[2 * kk][e], L2E, ml)) * inv;
            p1[e] = ex2(fmaf(sc[2 * kk + 1][e], L2E, ml)) * inv;
          }
          uint32_t a[4];
          vct::pack_a(a, p0, p1);
          vct::mma_rows16<D>(o, a, Vb, SLD, kk * 16, lane);
        }
      }
    }
    __syncthreads();  // buffer s & 1 is free for step s + 2
  }
  if (!active) return;
  bf16* oh = out + strides.o.head(b, hd);
  const long long ldo = strides.o.r;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * tq;
    if (r_lo < t)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r_lo * ldo + c) =
          vct::pack_bf16(o[j][0], o[j][1]);
    if (r_hi < t)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r_hi * ldo + c) =
          vct::pack_bf16(o[j][2], o[j][3]);
  }
}

// bf16 heads up to 128 columns take the tensor-core kernel; fp32, and
// bf16 at D = 256, the CUDA-core kernel.
template <int D>
size_t attention_smem(int bf16) {
  if (bf16 && D <= 128) return sizeof(vct::bf16) * (MQ + 4 * KC) * (D + 8);
  return sizeof(float) *
         (QT * (D + 1) + KC * (D + 1) + KC * D + QT * SLS + 2 * QT);
}

template <typename T, int D>
int attention_cuda_cores(const void* q, const void* k, const void* v,
                         const float* m, long long mask_bstride, float scale,
                         void* out, const AttnStrides& strides, int b,
                         int heads, int t, size_t smem, cudaStream_t st) {
  const dim3 grid((t + QT - 1) / QT, heads, b);
  auto kern = attention_fwd_kernel<T, D>;
  int err;
  if ((err = (int)cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return err;
  kern<<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v, m,
                               mask_bstride, scale, (T*)out, strides, t);
  return (int)cudaGetLastError();
}

template <int D>
int attention_launch(int bf16, const void* q, const void* k, const void* v,
                     const float* m, long long mask_bstride, float scale,
                     void* out, const AttnStrides& strides, int b, int heads,
                     int t, cudaStream_t st) {
  const size_t smem = attention_smem<D>(bf16);
  if constexpr (D <= 128) {
    if (bf16) {
      typedef vct::bf16 T;
      const dim3 grid((t + MQ - 1) / MQ, heads, b);
      auto kern = attention_mma_kernel<D>;
      int err;
      if ((err = (int)cudaFuncSetAttribute(
               kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
        return err;
      kern<<<grid, MT_N, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                     m, mask_bstride, scale, (T*)out,
                                     strides, t);
      return (int)cudaGetLastError();
    }
  } else if (bf16) {
    return attention_cuda_cores<vct::bf16, D>(q, k, v, m, mask_bstride,
                                              scale, out, strides, b, heads,
                                              t, smem, st);
  }
  return attention_cuda_cores<float, D>(q, k, v, m, mask_bstride, scale, out,
                                        strides, b, heads, t, smem, st);
}

// The column-chunk route for heads wider than 256 (d a multiple of 64):
// its tiles are those of the fp32 kernel at D = 256.
template <typename T>
int attention_wide(const void* q, const void* k, const void* v,
                   const float* m, long long mask_bstride, float scale,
                   void* out, const AttnStrides& strides, int b, int heads,
                   int t, int d, cudaStream_t st) {
  const size_t smem = attention_smem<WC>(0);
  const dim3 grid((t + QT - 1) / QT, heads, b);
  auto kern = attention_wide_kernel<T>;
  int err;
  if ((err = (int)cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return err;
  kern<<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v, m,
                               mask_bstride, scale, (T*)out, strides, t, d);
  return (int)cudaGetLastError();
}

// Whether the tensor-core kernel can take an operand: its 16-byte copies
// need every row to start on a 16-byte boundary (in, 16-byte aligned),
// its 4-byte output stores an even element offset (out).
bool mma_aligned(const void* p, const Strides& s, bool in) {
  const long long e = in ? 8 : 2;  // bf16 elements
  return (size_t)p % (2 * e) == 0 && s.b % e == 0 && s.h % e == 0 &&
         s.r % e == 0;
}

}  // namespace

extern "C" {

// Shared memory a block of the bf16 or the fp32 kernel takes at head width
// d (64, 128, 256, or a multiple of 64 past 256), in bytes.
size_t vct_attention_smem(int bf16, int d) {
  return d <= 64    ? attention_smem<64>(bf16)
         : d <= 128 ? attention_smem<128>(bf16)
         : d <= 256 ? attention_smem<256>(bf16)
                    : attention_smem<WC>(0);
}

// q, k, v, out: [b, heads, t, d] in T (bf16 when bf16 != 0, else fp32),
// each row's d columns contiguous, at the element strides st[3 i .. 3 i +
// 2] (batch, head, row) of operand i in the order q, k, v, out; on the
// tensor-core route (bf16, d <= 128) every q, k, v row 16-byte aligned and
// out's rows 4-byte aligned, else cudaErrorMisalignedAddress. d 64, 128,
// 256, or a multiple of 64 past 256 (the column-chunk route); mask: fp32
// [t, t] rows at mask + batch * mask_bstride, or null.
int vct_attention_fwd(int bf16, const void* q, const void* k, const void* v,
                      const long long* st, const void* mask,
                      long long mask_bstride, float scale, void* out, int b,
                      int heads, int t, int d, void* stream) {
  const AttnStrides strides{{st[0], st[1], st[2]},
                            {st[3], st[4], st[5]},
                            {st[6], st[7], st[8]},
                            {st[9], st[10], st[11]}};
  const float* m = (const float*)mask;
  const cudaStream_t cs = (cudaStream_t)stream;
  if (d > 256) {
    if (d % 64) return (int)cudaErrorInvalidValue;
    return bf16 ? attention_wide<vct::bf16>(q, k, v, m, mask_bstride, scale,
                                            out, strides, b, heads, t, d, cs)
                : attention_wide<float>(q, k, v, m, mask_bstride, scale, out,
                                        strides, b, heads, t, d, cs);
  }
  if (d != 64 && d != 128 && d != 256) return (int)cudaErrorInvalidValue;
  if (bf16 && d <= 128 &&
      !(mma_aligned(q, strides.q, true) && mma_aligned(k, strides.k, true) &&
        mma_aligned(v, strides.v, true) && mma_aligned(out, strides.o, false)))
    return (int)cudaErrorMisalignedAddress;
  auto launch = d == 64    ? attention_launch<64>
                : d == 128 ? attention_launch<128>
                           : attention_launch<256>;
  return launch(bf16, q, k, v, m, mask_bstride, scale, out, strides, b, heads,
                t, cs);
}

}  // extern "C"
