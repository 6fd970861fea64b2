// Hand-written Hopper (sm_90a) kernel for the CLIP towers' short-sequence
// attention (K5).
//
// Port of vlm_clip_tpu/ops/attention.py: fused_attention (:100), Pallas
// kernels _attn_kernel_nomask (:59) and _attn_kernel_mask (:63):
//
//   o = softmax(q k^T * scale + mask) v   over [B, h, T, 64] q, k, v
//
// with the TPU kernel's rounding points: the scores are fp32 sums of
// products of T values (bf16 products are exact in fp32), times scale,
// plus the fp32 mask; the softmax is fp32; p is rounded to T after it is
// normalized; p v accumulates in fp32; o is written in T. The mask is
// none, [T, T] (batch stride 0) or [B, 1, T, T] (a batch-broadcast mask
// comes in expanded, batch stride 0).
//
// Design (first, simple version). The TPU kernel holds a whole head's
// [T, T] scores in VMEM; at T = 257 that is 264 KB of fp32, more than the
// 227 KB of shared memory a Hopper block may use. So one block of 256
// threads takes (batch, head, a tile of 64 query rows) and streams K and
// V through shared memory in chunks of 64 keys, in two passes over the
// keys: the first keeps each row's running max and sum of exponentials
// (rescaled when the max grows), the second recomputes the scores, forms
// p = exp(s - max) / sum, rounds it to T and multiplies it into V. Each
// thread owns a 4 x 4 tile of the 64 x 64 scores and of the 64 x 64
// output, and the products are fp32 FMAs on the CUDA cores. What bounds
// it on the H100: fp32 FMAs and shared-memory reads (q k^T is computed
// twice); the tensor cores (wgmma on bf16 operands) are the next step.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;      // head width (every CLIP preset)
constexpr int QT = 64;     // query rows per block
constexpr int KC = 64;     // keys per chunk
constexpr int NT = 256;    // threads per block
constexpr int LD = D + 1;  // padded row of the q / k / score tiles

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

// rows [r0, r0 + 64) of a [T, 64] head -> fp32 tile (ld = ldt); rows past
// t are 0.
template <typename T>
__device__ void load_tile(const T* __restrict__ src, int t, int r0,
                          float* tile, int ldt) {
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, c = e % D;
    tile[r * ldt + c] = (r0 + r < t) ? to_f(src[(size_t)(r0 + r) * D + c])
                                     : 0.f;
  }
}

// s[i][j] = (q[row_i] . k[col_j]) * scale + mask(row_i, col_j) for the
// thread's rows row_i = q0 + ty + 16 i and columns col_j = k0 + tx + 16 j;
// -inf past the last key (and 0 mask past the last query row).
__device__ __forceinline__ void scores(const float* Qs, const float* Ks,
                                       const float* __restrict__ mask,
                                       int t, int q0, int k0, float scale,
                                       float (&s)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int dd = 0; dd < D; ++dd) {
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

template <typename T>
__global__ void __launch_bounds__(NT)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ mask, long long mask_bstride,
                         float scale, T* __restrict__ out, int heads, int t) {
  extern __shared__ float smem[];
  float* Qs = smem;           // [QT][LD]
  float* Ks = Qs + QT * LD;   // [KC][LD]
  float* Vs = Ks + KC * LD;   // [KC][D]
  float* Ss = Vs + KC * D;    // [QT][LD]: scores, then p rounded to T
  float* M = Ss + QT * LD;    // [QT]: row max
  float* L = M + QT;          // [QT]: row sum of exp(s - max)
  const int q0 = blockIdx.x * QT, hd = blockIdx.y, b = blockIdx.z;
  const size_t head = ((size_t)b * heads + hd) * t * D;
  const T *qh = q + head, *kh = k + head, *vh = v + head;
  const float* mb = mask == nullptr ? nullptr : mask + b * mask_bstride;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s[4][4];

  load_tile(qh, t, q0, Qs, LD);
  // pass 1: running max and sum per row; warp w owns rows 8w .. 8w + 7
  float m_run[8], l_run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  for (int k0 = 0; k0 < t; k0 += KC) {
    __syncthreads();  // Ks and Ss are free
    load_tile(kh, t, k0, Ks, LD);
    __syncthreads();
    scores(Qs, Ks, mb, t, q0, k0, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ss[(ty + 16 * i) * LD + tx + 16 * j] = s[i][j];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* sr = Ss + (warp * 8 + i) * LD;
      const float a = sr[lane], c = sr[lane + 32];
      const float mn = fmaxf(m_run[i], warp_max(fmaxf(a, c)));
      float e = 0.f;
      if (mn != -INFINITY) e = expf(a - mn) + expf(c - mn);
      e = warp_sum(e);
      l_run[i] = (m_run[i] == -INFINITY ? 0.f : l_run[i] * expf(m_run[i] - mn)) + e;
      m_run[i] = mn;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      M[warp * 8 + i] = m_run[i];
      L[warp * 8 + i] = l_run[i];
    }
  }
  // pass 2: o = round(p) v, p = exp(s - max) / sum
  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  for (int k0 = 0; k0 < t; k0 += KC) {
    __syncthreads();  // Ks, Vs, Ss free; M, L written
    load_tile(kh, t, k0, Ks, LD);
    load_tile(vh, t, k0, Vs, D);
    __syncthreads();
    scores(Qs, Ks, mb, t, q0, k0, scale, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float m = M[r], l = L[r];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[r * LD + tx + 16 * j] = to_f(from_f<T>(expf(s[i][j] - m) / l));
    }
    __syncthreads();
    const int kn = min(KC, t - k0);
    for (int c = 0; c < kn; ++c) {
      float p[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(p[i], w[j], o[i][j]);
    }
  }
  T* oh = out + head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < t)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        oh[(size_t)r * D + tx + 16 * j] = from_f<T>(o[i][j]);
  }
}

}  // namespace

extern "C" {

size_t vct_attention_smem() {
  return sizeof(float) * (2 * QT * LD + KC * LD + KC * D + 2 * QT);
}

// q, k, v, out: [b, heads, t, 64] contiguous in T (bf16 when bf16 != 0,
// else fp32); mask: fp32 [t, t] rows at mask + batch * mask_bstride, or
// null.
int vct_attention_fwd(int bf16, const void* q, const void* k, const void* v,
                      const void* mask, long long mask_bstride, float scale,
                      void* out, int b, int heads, int t, void* stream) {
  const size_t smem = vct_attention_smem();
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((t + QT - 1) / QT, heads, b);
  const float* m = (const float*)mask;
  int err;
  if (bf16) {
    typedef __nv_bfloat16 T;
    auto kern = attention_fwd_kernel<T>;
    if ((err = (int)cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return err;
    kern<<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v, m,
                                 mask_bstride, scale, (T*)out, heads, t);
  } else {
    typedef float T;
    auto kern = attention_fwd_kernel<T>;
    if ((err = (int)cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return err;
    kern<<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v, m,
                                 mask_bstride, scale, (T*)out, heads, t);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
