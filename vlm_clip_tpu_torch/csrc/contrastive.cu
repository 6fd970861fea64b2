// Hand-written Hopper (sm_90a) kernels for the pipeline-M contrastive head.
//
// Port of the Pallas TPU kernels in vlm_clip_tpu/ops/contrastive.py:
//
//   contrastive_fwd  <- _fwd_kernel (contrastive.py:52)
//       tn, mn = rows of txt, img over their L2 norms;
//       Z = exp(logit_scale) * tn @ mn^T;
//       loss = (mean_i(lse_row(Z)_i - Z_ii) + mean_j(lse_col(Z)_j - Z_jj))/2
//   contrastive_bwd  <- _bwd_kernel (contrastive.py:68)
//       dZ = g ((softmax_rows(Z) - I) + (softmax_cols(Z) - I)) / 2B;
//       d_txt = l2norm_bwd(s dZ @ mn), d_img = l2norm_bwd(s dZ^T @ tn),
//       d_logit_scale = sum(dZ * Z)
//
// All math in fp32 on the inputs widened to fp32. The TPU kernel holds the
// whole batch in one block and falls back to XLA above B = 1024. Here the
// [B, B] logits live in device memory and every pass is its own small
// kernel, so any B is covered and nothing falls back. Every sum is taken in
// a fixed order (no atomics), so the results do not vary between runs.
//
// What bounds them on the H100: at the pipeline-M batch (B = 96, D = 512)
// the work is tiny (about 19 MFLOP forward, 57 MFLOP backward, under 1 MB
// moved), so each call is bound by its launches (4 forward, 8 backward)
// and by the few blocks a 96x96 problem fills; the logits products use a
// 16x16-tiled fp32 SIMT product. Folding the passes into one persistent
// kernel is the next step.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream and returns the first cudaGetLastError() that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int TS = 16;   // product tile

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

// Block-wide sum of one value per thread, in a fixed order.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// Rows 0..b-1 of t and rows 0..b-1 of m, one warp per row:
// nrm[row] = x / ||x||, inv[row] = 1 / ||x|| (rows of m after those of t).
template <typename T>
__global__ void __launch_bounds__(NT)
    norm_kernel(const T* __restrict__ t, const T* __restrict__ m,
                float* __restrict__ nrm, float* __restrict__ inv, int b,
                int d) {
  const int row = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= 2 * b) return;
  const T* x = row < b ? t + (size_t)row * d : m + (size_t)(row - b) * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_f(x[c]);
    s += v * v;
  }
  const float iv = rsqrtf(warp_sum(s));
  for (int c = lane; c < d; c += 32)
    nrm[(size_t)row * d + c] = to_f(x[c]) * iv;
  if (lane == 0) inv[row] = iv;
}

// C[i*ldc + j] = exp(log_alpha[0]) * sum_k A[i*sai + k*sak] *
// B[k*sbk + j*sbj] for i < mm, j < nn: one 16x16 tile per block, 16-deep
// slabs of A and B through shared memory. The strides let one kernel do
// tn @ mn^T, dZ @ mn and dZ^T @ tn.
__global__ void __launch_bounds__(TS * TS)
    gemm_kernel(const float* __restrict__ a, int sai, int sak,
                const float* __restrict__ bm, int sbk, int sbj,
                float* __restrict__ c, int ldc, int mm, int nn, int kd,
                const float* __restrict__ log_alpha) {
  __shared__ float As[TS][TS + 1];
  __shared__ float Bs[TS][TS + 1];
  const int tx = threadIdx.x % TS, ty = threadIdx.x / TS;
  const int i = blockIdx.y * TS + ty, j = blockIdx.x * TS + tx;
  float acc = 0.f;
  for (int k0 = 0; k0 < kd; k0 += TS) {
    const int ai = blockIdx.y * TS + ty, ak = k0 + tx;
    As[ty][tx] = (ai < mm && ak < kd) ? a[(size_t)ai * sai + (size_t)ak * sak]
                                      : 0.f;
    const int bk = k0 + ty, bj = blockIdx.x * TS + tx;
    Bs[ty][tx] = (bk < kd && bj < nn)
                     ? bm[(size_t)bk * sbk + (size_t)bj * sbj]
                     : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TS; ++kk) acc = fmaf(As[ty][kk], Bs[kk][tx], acc);
    __syncthreads();
  }
  if (i < mm && j < nn) c[(size_t)i * ldc + j] = expf(log_alpha[0]) * acc;
}

// lse[r] for r < b: logsumexp of row r of z; lse[b + r]: of column r.
__global__ void __launch_bounds__(NT)
    lse_kernel(const float* __restrict__ z, float* __restrict__ lse, int b) {
  const int idx = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (idx >= 2 * b) return;
  const int r = idx < b ? idx : idx - b;
  // row r: z[r*b + j]; column r: z[j*b + r]
  const size_t base = idx < b ? (size_t)r * b : (size_t)r;
  const size_t step = idx < b ? 1 : (size_t)b;
  float mx = -INFINITY;
  for (int j = lane; j < b; j += 32) mx = fmaxf(mx, z[base + j * step]);
  mx = warp_max(mx);
  float s = 0.f;
  for (int j = lane; j < b; j += 32) s += expf(z[base + j * step] - mx);
  s = warp_sum(s);
  if (lane == 0) lse[idx] = mx + logf(s);
}

// loss[0] = (sum_i (lse_row_i - z_ii) / b + sum_i (lse_col_i - z_ii) / b)/2
__global__ void __launch_bounds__(NT)
    loss_kernel(const float* __restrict__ z, const float* __restrict__ lse,
                float* __restrict__ loss, int b) {
  __shared__ float red[NT];
  float st = 0.f, si = 0.f;
  for (int i = threadIdx.x; i < b; i += NT) {
    const float zd = z[(size_t)i * b + i];
    st += lse[i] - zd;
    si += lse[b + i] - zd;
  }
  st = block_sum(st, red);
  si = block_sum(si, red);
  if (threadIdx.x == 0) loss[0] = 0.5f * (st / b + si / b);
}

// dz = g ((softmax_rows - I) + (softmax_cols - I)) / 2b, elementwise.
__global__ void __launch_bounds__(NT)
    dz_kernel(const float* __restrict__ z, const float* __restrict__ lse,
              const float* __restrict__ g, float* __restrict__ dz, int b) {
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  if (e >= (size_t)b * b) return;
  const int i = (int)(e / b), j = (int)(e % b);
  const float eye = i == j ? 1.f : 0.f;
  const float pr = expf(z[e] - lse[i]);
  const float pc = expf(z[e] - lse[b + j]);
  dz[e] = g[0] * ((pr - eye) + (pc - eye)) / (2.f * b);
}

// dls[0] = sum(dz * z), one block.
__global__ void __launch_bounds__(NT)
    dls_kernel(const float* __restrict__ dz, const float* __restrict__ z,
               float* __restrict__ dls, int b) {
  __shared__ float red[NT];
  float s = 0.f;
  for (size_t e = threadIdx.x; e < (size_t)b * b; e += NT) s += dz[e] * z[e];
  s = block_sum(s, red);
  if (threadIdx.x == 0) dls[0] = s;
}

// L2-norm backward per row (rows of t, then of m), one warp per row:
// dx = (dn - n <dn, n>) * inv.
template <typename T>
__global__ void __launch_bounds__(NT)
    norm_bwd_kernel(const float* __restrict__ dn,
                    const float* __restrict__ nrm,
                    const float* __restrict__ inv, T* __restrict__ dt,
                    T* __restrict__ dm, int b, int d) {
  const int row = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= 2 * b) return;
  const float* g = dn + (size_t)row * d;
  const float* n = nrm + (size_t)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += g[c] * n[c];
  s = warp_sum(s);
  T* out = row < b ? dt + (size_t)row * d : dm + (size_t)(row - b) * d;
  for (int c = lane; c < d; c += 32)
    out[c] = from_f<T>((g[c] - n[c] * s) * inv[row]);
}

// Workspace layout (floats): nrm [2b, d] | inv [2b] | z [b, b] | lse [2b] |
// dz [b, b] | dn [2b, d]. The forward uses the first four.
struct Work {
  float *nrm, *inv, *z, *lse, *dz, *dn;
  Work(float* w, int b, int d) {
    nrm = w;
    inv = nrm + 2 * (size_t)b * d;
    z = inv + 2 * b;
    lse = z + (size_t)b * b;
    dz = lse + 2 * b;
    dn = dz + (size_t)b * b;
  }
};

inline dim3 warp_rows(int rows) {
  return dim3((rows + NT / 32 - 1) / (NT / 32));
}

// norm, logits, lse: the forward's passes, shared with the backward's
// recompute. Returns the first launch error.
template <typename T>
int forward_passes(const T* t, const T* m, const float* log_scale,
                   const Work& w, int b, int d, cudaStream_t st) {
  int err;
  norm_kernel<T><<<warp_rows(2 * b), NT, 0, st>>>(t, m, w.nrm, w.inv, b, d);
  if ((err = (int)cudaGetLastError())) return err;
  const dim3 g((b + TS - 1) / TS, (b + TS - 1) / TS);
  // Z = s tn @ mn^T: A = tn [b, d], B(k, j) = mn[j, k]
  gemm_kernel<<<g, TS * TS, 0, st>>>(w.nrm, d, 1, w.nrm + (size_t)b * d, 1,
                                     d, w.z, b, b, b, d, log_scale);
  if ((err = (int)cudaGetLastError())) return err;
  lse_kernel<<<warp_rows(2 * b), NT, 0, st>>>(w.z, w.lse, b);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const T* t, const T* m, const float* log_scale, const float* g,
             float* work, T* dt, T* dm, float* dls, int b, int d,
             cudaStream_t st) {
  const Work w(work, b, d);
  int err;
  if ((err = forward_passes(t, m, log_scale, w, b, d, st))) return err;
  const size_t bb = (size_t)b * b;
  dz_kernel<<<(unsigned)((bb + NT - 1) / NT), NT, 0, st>>>(w.z, w.lse, g,
                                                           w.dz, b);
  if ((err = (int)cudaGetLastError())) return err;
  const dim3 gd((d + TS - 1) / TS, (b + TS - 1) / TS);
  // dtn = s dZ @ mn; dmn = s dZ^T @ tn
  gemm_kernel<<<gd, TS * TS, 0, st>>>(w.dz, b, 1, w.nrm + (size_t)b * d, d,
                                      1, w.dn, d, b, d, b, log_scale);
  if ((err = (int)cudaGetLastError())) return err;
  gemm_kernel<<<gd, TS * TS, 0, st>>>(w.dz, 1, b, w.nrm, d, 1,
                                      w.dn + (size_t)b * d, d, b, d, b,
                                      log_scale);
  if ((err = (int)cudaGetLastError())) return err;
  norm_bwd_kernel<T><<<warp_rows(2 * b), NT, 0, st>>>(w.dn, w.nrm, w.inv, dt,
                                                      dm, b, d);
  if ((err = (int)cudaGetLastError())) return err;
  dls_kernel<<<1, NT, 0, st>>>(w.dz, w.z, dls, b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace the backward needs (the forward needs fewer).
size_t vct_contrastive_work(int b, int d) {
  return 4 * (size_t)b * d + 4 * (size_t)b + 2 * (size_t)b * b;
}

int vct_contrastive_fwd(int bf16, const void* t, const void* m,
                        const void* log_scale, void* work, void* loss, int b,
                        int d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Work w((float*)work, b, d);
  const float* ls = (const float*)log_scale;
  int err = bf16 ? forward_passes((const __nv_bfloat16*)t,
                                  (const __nv_bfloat16*)m, ls, w, b, d, st)
                 : forward_passes((const float*)t, (const float*)m, ls, w, b,
                                  d, st);
  if (err) return err;
  loss_kernel<<<1, NT, 0, st>>>(w.z, w.lse, (float*)loss, b);
  return (int)cudaGetLastError();
}

int vct_contrastive_bwd(int bf16, const void* t, const void* m,
                        const void* log_scale, const void* g, void* work,
                        void* dt, void* dm, void* dls, int b, int d,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *ls = (const float*)log_scale, *gg = (const float*)g;
  if (bf16) {
    typedef __nv_bfloat16 T;
    return backward((const T*)t, (const T*)m, ls, gg, (float*)work, (T*)dt,
                    (T*)dm, (float*)dls, b, d, st);
  }
  return backward((const float*)t, (const float*)m, ls, gg, (float*)work,
                  (float*)dt, (float*)dm, (float*)dls, b, d, st);
}

}  // extern "C"
