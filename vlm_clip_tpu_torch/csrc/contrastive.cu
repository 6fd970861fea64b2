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
// whole batch in one block and falls back to XLA above B = 1024. Every sum
// here is taken in a fixed order (no atomics), so the results do not vary
// between runs.
//
// What bounds them on the H100: at the pipeline-M batch (B = 96, D = 512)
// the work is tiny (about 9 MFLOP forward, 28 MFLOP backward, under 1 MB
// moved), so a call is bound by its launches and by the few SMs a 96 x 96
// problem fills, not by the 0.00042 ms its bytes and operations would
// take. The backward is one launch of an 8-block thread-block cluster
// (contrastive_bwd_cluster_kernel, below) for every batch whose tiles fit
// its blocks' shared memory (D a multiple of 8; B <= 128 at D = 512,
// vct_contrastive_bwd_cluster_max): the logits never leave the chip, and
// the row norms, logits, LSE and sums of dZ Z are added across the
// cluster through distributed shared memory. Larger batches take the
// first version, which keeps the [B, B] logits in device memory and runs
// every pass as its own small kernel (eight launches, 16 x 16-tiled fp32
// SIMT products), so every batch is covered. The forward is one launch of
// the same cluster (contrastive_fwd_cluster_kernel) at the same batches,
// built from the backward's norm, logit and LSE steps, so its row and
// column LSEs are the backward's bits; past them, the first version's
// four launches.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream and returns the first cudaGetLastError() that is not 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"

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

// ---------------------------------------------------------------------------
// Backward as one launch of a thread-block cluster (every batch whose
// tiles fit: vct_contrastive_bwd_cluster_max)
// ---------------------------------------------------------------------------
//
// One cluster of CL blocks of CNT threads takes the whole batch. Block q
// owns a slice of the depth, columns [q ds, q ds + ds) of d (ds = ceil(d /
// CL) rounded up to 8; the last blocks may own fewer, or none), of both
// sides and every row, and rows [q R, q R + R) of Z and dZ (R = ceil(b /
// CL)). It loads its slices once (16 bytes a load, all at once) and keeps
// them in shared memory, so the chip streams each input once: what set
// the time of a row-block split, which streamed both whole inputs through
// each of the 8 SMs three times, was the rate at which an SM pulls from
// L2. Then, with sums across the cluster through distributed shared
// memory, every one in rank order (every block gets the same bits):
//   1. each row's sum of squares over the slice -> 1 / |row|, every row;
//      the slices normalized in place (tn, mn; k4_norm_slices);
//   2. the slice's partial logits tn mn^T (b x b); the block's rows of Z
//      = s (the partials' sum; k4_logit_rows); their LSE and their
//      partial column statistics (max, sum of exp; k4_row_stats), merged
//      into every column's LSE (k4_col_lse). Steps 1-2 are the forward's
//      too: K4's forward is to take these functions;
//   3. the block's rows of dZ (k4_dz) and its partial of sum(dZ Z), which
//      rank 0 adds; every row of dZ gathered from the cluster;
//   4. the slice of dtn = s dZ mn and dmn = s dZ^T tn, each
//      row's partial of <dn, n> over the slice, summed over the cluster,
//      and the norm backward, written for the slice.
// Z never leaves the chip and nothing is atomic: the results repeat bit
// for bit. At B = 96, D = 512 that is 28 MFLOP in products of 4 x 4
// register tiles on 8 SMs and one launch, where the multi-kernel route
// below takes eight.

namespace cg = cooperative_groups;
constexpr int CL = 8;     // blocks of the cluster
constexpr int CNT = 512;  // threads a block: 16 warps
constexpr size_t SMEM_MAX = 227 * 1024;

__host__ __device__ inline int k4_rows(int b) { return (b + CL - 1) / CL; }
// Columns of d a block owns, at most: ceil(d / CL) rounded up to 8.
__host__ __device__ inline int k4_ds(int d) {
  return ((d + CL - 1) / CL + 7) & ~7;
}
// Row stride of a slice: ds rounded up to 32, plus 4, so the lanes of a
// warp that read 16 bytes from consecutive rows hit distinct banks.
__host__ __device__ inline int k4_dsp(int d) {
  return (k4_ds(d) + 31) / 32 * 32 + 4;
}
// Rows of the tiles: b rounded up to 4 (zero rows past b).
__host__ __device__ inline int k4_bp(int b) { return (b + 3) & ~3; }
// Floats of the block's buffer that the cluster reads (PUB): each row's
// partial sums of squares (txt, img), partial <dn, n> (txt, img), the own
// rows' LSE, the partial of sum(dZ Z), and the own rows' column maxima and
// sums of exp.
__host__ __device__ inline int k4_pub(int b) {
  return (4 * b + k4_rows(b) + 1 + 2 * b + 3) & ~3;
}

// Floats of a cluster block's shared memory (the layout in
// contrastive_bwd_cluster_kernel).
inline size_t k4_smem_floats(int b, int d) {
  const size_t bp = k4_bp(b), R = k4_rows(b), dsp = k4_dsp(d);
  return (size_t)k4_pub(b) + 4 * (size_t)b + 4 * bp * dsp + bp * bp +
         2 * R * bp;
}

// The products, with 4 x 4 register tiles, depth k in order, handed to
// epi(r, c, v) for r < nr, c < nc (multiples of 4). Every operand is read
// 16 bytes at a time from shared memory, a thread's reads of b land on
// distinct banks across a warp, and its reads of a are shared by the
// warp's lanes of one row group.
//   k4_gemm_nt: out = A B^T, fa(r, k) and fb(c, k) four consecutive k; a
//     thread takes rows {ri + x NR} (x < 4, or 8 where 4 x 4 tiles would
//     outnumber the threads) and columns {ci + y NC} (y < 4).
//   k4_gemm_nn: out = A B, fa(r, k) four consecutive k, fb(k, c) four
//     consecutive c; rows {ri + x NR}, columns 4 ci + [0, 4).
//   k4_gemm_tn: out = A^T B, fa(k, r) four consecutive r, fb(k, c) four
//     consecutive c; rows 4 ri + [0, 4), columns 4 ci + [0, 4).
template <int TR, class FA, class FB, class Epi>
__device__ __forceinline__ void k4_gemm_nt_tile(int nr, int nc, int n,
                                                const FA& fa, const FB& fb,
                                                const Epi& epi) {
  const int NR = nr / TR, NC = nc / 4;
  for (int u = threadIdx.x; u < NR * NC; u += CNT) {
    const int ci = u % NC, ri = u / NC;
    float acc[TR][4] = {};
    for (int k = 0; k < n; k += 4) {
      float4 a[TR], bv[4];
#pragma unroll
      for (int x = 0; x < TR; ++x) a[x] = fa(ri + x * NR, k);
#pragma unroll
      for (int y = 0; y < 4; ++y) bv[y] = fb(ci + y * NC, k);
#pragma unroll
      for (int x = 0; x < TR; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          acc[x][y] = fmaf(a[x].x, bv[y].x, acc[x][y]);
          acc[x][y] = fmaf(a[x].y, bv[y].y, acc[x][y]);
          acc[x][y] = fmaf(a[x].z, bv[y].z, acc[x][y]);
          acc[x][y] = fmaf(a[x].w, bv[y].w, acc[x][y]);
        }
    }
#pragma unroll
    for (int x = 0; x < TR; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) epi(ri + x * NR, ci + y * NC, acc[x][y]);
  }
}

// Tiles of 8 x 4 where 4 x 4 ones would outnumber the threads (one round
// instead of a second that few threads run), where nr is a multiple of 8.
template <class FA, class FB, class Epi>
__device__ __forceinline__ void k4_gemm_nt(int nr, int nc, int n,
                                           const FA& fa, const FB& fb,
                                           const Epi& epi) {
  if ((nr / 4) * (nc / 4) > CNT && nr % 8 == 0)
    k4_gemm_nt_tile<8>(nr, nc, n, fa, fb, epi);
  else
    k4_gemm_nt_tile<4>(nr, nc, n, fa, fb, epi);
}

__device__ __forceinline__ float k4_at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <class FA, class FB, class Epi>
__device__ __forceinline__ void k4_gemm_nn(int nr, int nc, int n,
                                           const FA& fa, const FB& fb,
                                           const Epi& epi) {
  const int NR = nr / 4, NC = nc / 4;
  for (int u = threadIdx.x; u < NR * NC; u += CNT) {
    const int ci = u % NC, ri = u / NC;
    float acc[4][4] = {};
    for (int k = 0; k < n; k += 4) {
      float4 a[4], bv[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        a[x] = fa(ri + x * NR, k);
        bv[x] = fb(k + x, 4 * ci);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float av = k4_at(a[x], kk);
          acc[x][0] = fmaf(av, bv[kk].x, acc[x][0]);
          acc[x][1] = fmaf(av, bv[kk].y, acc[x][1]);
          acc[x][2] = fmaf(av, bv[kk].z, acc[x][2]);
          acc[x][3] = fmaf(av, bv[kk].w, acc[x][3]);
        }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) epi(ri + x * NR, 4 * ci + y, acc[x][y]);
  }
}

template <class FA, class FB, class Epi>
__device__ __forceinline__ void k4_gemm_tn(int nr, int nc, int n,
                                           const FA& fa, const FB& fb,
                                           const Epi& epi) {
  const int NR = nr / 4, NC = nc / 4;
  for (int u = threadIdx.x; u < NR * NC; u += CNT) {
    const int ci = u % NC, ri = u / NC;
    float acc[4][4] = {};
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float4 a = fa(k, 4 * ri), bv = fb(k, 4 * ci);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float av = k4_at(a, x);
        acc[x][0] = fmaf(av, bv.x, acc[x][0]);
        acc[x][1] = fmaf(av, bv.y, acc[x][1]);
        acc[x][2] = fmaf(av, bv.z, acc[x][2]);
        acc[x][3] = fmaf(av, bv.w, acc[x][3]);
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) epi(4 * ri + x, 4 * ci + y, acc[x][y]);
  }
}

// Four consecutive outputs of a row, rounded to T, in one store (8 or 16
// bytes; p 8- or 16-byte aligned).
__device__ __forceinline__ void k4_store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void k4_store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// logsumexp of v[0], v[stride], ... (n values), for the whole warp.
__device__ __forceinline__ float k4_lse(const float* v, int n, int stride) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
  for (int j = lane; j < n; j += 32) mx = fmaxf(mx, v[j * stride]);
  mx = warp_max(mx);
  float s = 0.f;
  for (int j = lane; j < n; j += 32) s += expf(v[j * stride] - mx);
  return mx + logf(warp_sum(s));
}

// The LSE of column j from the blocks' partials over their rows (maxima
// pm[q][j], sums of exp(z - max) ps[q][j]; an empty block -inf and 0),
// merged in rank order: every block gets the same bits.
__device__ __forceinline__ float k4_col_lse(
    const cg::cluster_group& cluster, float* pm, float* ps, int j) {
  float mx = -INFINITY;
#pragma unroll
  for (int q = 0; q < CL; ++q)
    mx = fmaxf(mx, cluster.map_shared_rank(pm, q)[j]);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < CL; ++q)
    s += cluster.map_shared_rank(ps, q)[j] *
         expf(cluster.map_shared_rank(pm, q)[j] - mx);
  return mx + logf(s);
}

// dZ(i, j) from Z(i, j) and the LSE of row i and of column j.
__device__ __forceinline__ float k4_dz(float z, float lse_row, float lse_col,
                                       bool diag, float g, int b) {
  const float eye = diag ? 1.f : 0.f;
  const float pr = expf(z - lse_row), pc = expf(z - lse_col);
  return g * ((pr - eye) + (pc - eye)) / (2.f * b);
}

// The sum over the cluster's blocks, in rank order, of the float at
// offset `at` of each block's copy of `buf`.
__device__ __forceinline__ float k4_sum(const cg::cluster_group& cluster,
                                        float* buf, int at) {
  return vct::cluster_sum<CL>(cluster, buf, at);
}

// Step 1 of the cluster kernel (the forward's to take too): the block's
// slices of t and m, every row, into TS and MS ([bp][dsp], zero past b;
// 16-byte loads, all issued before any is stored), each row's partial sum
// of squares over the slice into NS ([2b], read by the cluster), then INV
// = 1 / |row| from the cluster's partials in rank order (every block the
// same bits), and tn, mn in place. Every block calls it: it holds a
// cluster.sync().
template <typename T>
__device__ void k4_norm_slices(const cg::cluster_group& cluster,
                               const T* __restrict__ t,
                               const T* __restrict__ m, int b, int d, int c0,
                               int dsz, int bp, int dsp, float* TS, float* MS,
                               float* NS, float* INV) {
  const int tid = threadIdx.x;
  // 8 elements a unit; a block that owns no columns (dsz = 0, at d < 8 ds
  // as d = 24) has no units and loads nothing, and every load of the
  // others is clamped to the last unit (its row clamped below b)
  const int su = dsz / 8, units = 2 * bp * su;
  for (int base = 0; base < units; base += 4 * CNT) {
    uint4 raw[4][2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = min(base + k * CNT + tid, units - 1);
      const int side = e / (bp * su), i = min(e / su % bp, b - 1);
      const T* p = (side ? m : t) + (size_t)i * d + c0 + 8 * (e % su);
      const uint4* p4 = reinterpret_cast<const uint4*>(p);
      raw[k][0] = __ldg(p4);
      raw[k][1] = sizeof(T) == 4 ? __ldg(p4 + 1) : raw[k][0];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = base + k * CNT + tid;
      if (e >= units) continue;
      const int side = e / (bp * su), i = e / su % bp, c = 8 * (e % su);
      float f[8];
      if (sizeof(T) == 2) {
        const __nv_bfloat16* h =
            reinterpret_cast<const __nv_bfloat16*>(&raw[k][0]);
#pragma unroll
        for (int x = 0; x < 8; ++x) f[x] = __bfloat162float(h[x]);
      } else {
        const float* h = reinterpret_cast<const float*>(&raw[k][0]);
#pragma unroll
        for (int x = 0; x < 4; ++x) f[x] = h[x];
        h = reinterpret_cast<const float*>(&raw[k][1]);
#pragma unroll
        for (int x = 0; x < 4; ++x) f[4 + x] = h[x];
      }
      const float z = i < b ? 1.f : 0.f;  // rows past b: zeros
      float4* o = reinterpret_cast<float4*>((side ? MS : TS) + i * dsp + c);
      o[0] = make_float4(f[0] * z, f[1] * z, f[2] * z, f[3] * z);
      o[1] = make_float4(f[4] * z, f[5] * z, f[6] * z, f[7] * z);
    }
  }
  __syncthreads();
  for (int e = tid; e < 2 * b; e += CNT) {  // a thread a row
    const float* x = (e >= b ? MS : TS) + (e % b) * dsp;
    float ss = 0.f;
    for (int c = 0; c < dsz; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(x + c);
      ss = fmaf(v.x, v.x, ss);
      ss = fmaf(v.y, v.y, ss);
      ss = fmaf(v.z, v.z, ss);
      ss = fmaf(v.w, v.w, ss);
    }
    NS[e] = ss;
  }
  cluster.sync();
  for (int e = tid; e < 2 * b; e += CNT)
    INV[e] = rsqrtf(k4_sum(cluster, NS, e));
  __syncthreads();
  for (int e = tid; e < 2 * b * (dsz / 4); e += CNT) {
    const int row = e % (2 * b), c = 4 * (e / (2 * b));  // a float4 each
    float* x = (row >= b ? MS : TS) + (row % b) * dsp + c;
    const float iv = INV[row];
    float4 v = *reinterpret_cast<float4*>(x);
    v.x *= iv, v.y *= iv, v.z *= iv, v.w *= iv;
    *reinterpret_cast<float4*>(x) = v;
  }
  __syncthreads();
}

// Step 2: the slice's partial logits tn mn^T into ZP ([bp][bp], read by
// the cluster), then the block's nr rows of Z (r0 on) = s (the cluster's
// partials in rank order) into ZO ([nr][bp]; zero past b). Every block
// calls it: it holds a cluster.sync().
__device__ void k4_logit_rows(const cg::cluster_group& cluster,
                              const float* TS, const float* MS, float* ZP,
                              float* ZO, float s, int r0, int nr, int bp,
                              int dsz, int dsp) {
  k4_gemm_nt(bp, bp, dsz,
             [=](int r, int k) {
               return *reinterpret_cast<const float4*>(TS + r * dsp + k);
             },
             [=](int c, int k) {
               return *reinterpret_cast<const float4*>(MS + c * dsp + k);
             },
             [=](int r, int c, float v) { ZP[r * bp + c] = v; });
  cluster.sync();
  for (int e = threadIdx.x; e < nr * bp; e += CNT)
    ZO[e] = s * k4_sum(cluster, ZP, r0 * bp + e);
  __syncthreads();
}

// The block's rows' LSE (LR, one warp a row) and their partial statistics
// of every column (PM: the maximum, PS: the sum of exp(z - max); -inf and
// 0 without rows), for k4_col_lse to merge.
__device__ void k4_row_stats(const float* ZO, float* LR, float* PM,
                             float* PS, int nr, int b, int bp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < nr; i += CNT / 32) {
    const float l = k4_lse(ZO + i * bp, b, 1);
    if (lane == 0) LR[i] = l;
  }
  for (int j = threadIdx.x; j < b; j += CNT) {
    float mx = -INFINITY, se = 0.f;
    for (int i = 0; i < nr; ++i) mx = fmaxf(mx, ZO[i * bp + j]);
    for (int i = 0; i < nr; ++i) se += expf(ZO[i * bp + j] - mx);
    PM[j] = mx;
    PS[j] = se;
  }
}

// A cluster block's shared memory (k4_smem_floats floats; the forward
// uses all but DTS, DMS and DZO) and its share: rows [r0, r0 + nr) of Z,
// columns [c0, c0 + dsz) of d.
struct K4Block {
  int q, R, r0, nr, ds, c0, dsz, dsp, bp;
  float* PUB;   // [k4_pub] read by the cluster
  float* NS;    // [2b] each row's partial sum of squares
  float* NB;    // [2b] each row's partial <dn, n> (the forward: its two
                // partial loss sums)
  float* LR;    // [R] the own rows' LSE
  float* DL;    // [1] the own rows' partial of sum(dZ Z)
  float* PM;    // [b] the own rows' maximum, each column
  float* PS;    // [b] their sum of exp(z - max)
  float* INV;   // [2b] 1 / |row|, txt then img
  float* LSER;  // [b] every row's LSE
  float* LSEC;  // [b] every column's LSE
  float* TS;    // [bp][dsp] the slice of t, then of tn
  float* MS;    // [bp][dsp] the slice of m, then of mn
  float* DTS;   // [bp][dsp] the slice of dtn
  float* DMS;   // [bp][dsp] the slice of dmn
  float* ZP;    // [bp][bp] partial logits, then every dZ
  float* ZO;    // [R][bp] the own rows of Z
  float* DZO;   // [R][bp] the own rows of dZ, zero past b
  __device__ K4Block(float* csm, int rank, int b, int d) {
    q = rank;
    R = k4_rows(b);
    r0 = q * R;
    nr = max(0, min(R, b - r0));
    ds = k4_ds(d);
    c0 = q * ds;
    dsz = max(0, min(ds, d - c0));
    dsp = k4_dsp(d);
    bp = k4_bp(b);
    PUB = csm;
    NS = PUB;
    NB = NS + 2 * b;
    LR = NB + 2 * b;
    DL = LR + R;
    PM = DL + 1;
    PS = PM + b;
    INV = PUB + k4_pub(b);
    LSER = INV + 2 * b;
    LSEC = LSER + b;
    TS = LSEC + b;
    MS = TS + bp * dsp;
    DTS = MS + bp * dsp;
    DMS = DTS + bp * dsp;
    ZP = DMS + bp * dsp;
    ZO = ZP + bp * bp;
    DZO = ZO + R * bp;
  }
};

// K4's forward as one launch of the backward's cluster: steps 1-2 of
// contrastive_bwd_cluster_kernel (the same device functions, so the same
// row and column LSEs, bit for bit, as the backward recomputes), then
// the loss. Each block takes its own rows i: the row term LSE_row(i) -
// Z_ii and the column term LSE_col(i) - Z_ii (column i's LSE merged from
// the blocks' partials in rank order, as the backward merges it), each
// summed in row order; rank 0 adds the blocks' sums in rank order and
// writes loss = (rows / b + columns / b) / 2. With lse not null, every
// row's and column's LSE too ([2b]: rows, then columns).
template <typename T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(CNT)
    contrastive_fwd_cluster_kernel(const T* __restrict__ t,
                                   const T* __restrict__ m,
                                   const float* __restrict__ log_scale,
                                   float* __restrict__ loss,
                                   float* __restrict__ lse, int b, int d) {
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float csm[];
  const K4Block kb(csm, (int)cluster.block_rank(), b, d);
  const int tid = threadIdx.x;
  const float s = expf(log_scale[0]);

  k4_norm_slices(cluster, t, m, b, d, kb.c0, kb.dsz, kb.bp, kb.dsp, kb.TS,
                 kb.MS, kb.NS, kb.INV);
  k4_logit_rows(cluster, kb.TS, kb.MS, kb.ZP, kb.ZO, s, kb.r0, kb.nr, kb.bp,
                kb.dsz, kb.dsp);
  k4_row_stats(kb.ZO, kb.LR, kb.PM, kb.PS, kb.nr, b, kb.bp);
  cluster.sync();
  for (int i = tid; i < kb.nr; i += CNT) {
    const int j = kb.r0 + i;
    kb.LSEC[j] = k4_col_lse(cluster, kb.PM, kb.PS, j);
    if (lse != nullptr) {
      lse[j] = kb.LR[i];
      lse[b + j] = kb.LSEC[j];
    }
  }
  __syncthreads();
  if (tid == 0) {
    float st = 0.f, si = 0.f;
    for (int i = 0; i < kb.nr; ++i) {
      const float zd = kb.ZO[i * kb.bp + kb.r0 + i];
      st += kb.LR[i] - zd;
      si += kb.LSEC[kb.r0 + i] - zd;
    }
    kb.NB[0] = st;
    kb.NB[1] = si;
  }
  cluster.sync();
  if (kb.q == 0 && tid == 0) {
    const float st = k4_sum(cluster, kb.NB, 0), si = k4_sum(cluster, kb.NB, 1);
    loss[0] = 0.5f * (st / b + si / b);
  }
  cluster.sync();  // no block leaves while the cluster may read its PUB
}

template <typename T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(CNT)
    contrastive_bwd_cluster_kernel(const T* __restrict__ t,
                                   const T* __restrict__ m,
                                   const float* __restrict__ log_scale,
                                   const float* __restrict__ gp,
                                   T* __restrict__ dt, T* __restrict__ dm,
                                   float* __restrict__ dls,
                                   float* __restrict__ lse, int b, int d) {
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float csm[];
  const K4Block kb(csm, (int)cluster.block_rank(), b, d);
  const int q = kb.q, R = kb.R, r0 = kb.r0, nr = kb.nr, c0 = kb.c0;
  const int dsz = kb.dsz, dsp = kb.dsp, bp = kb.bp;
  float *NS = kb.NS, *NB = kb.NB, *LR = kb.LR, *DL = kb.DL, *PM = kb.PM,
        *PS = kb.PS, *INV = kb.INV, *LSER = kb.LSER, *LSEC = kb.LSEC,
        *TS = kb.TS, *MS = kb.MS, *DTS = kb.DTS, *DMS = kb.DMS,
        *ZP = kb.ZP, *ZO = kb.ZO, *DZO = kb.DZO;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float s = expf(log_scale[0]), g = gp[0];

  // 1. the slices, normalized, and every row's inverse norm
  k4_norm_slices(cluster, t, m, b, d, c0, dsz, bp, dsp, TS, MS, NS, INV);
  // 2. the own rows of Z, their LSE and their partial column statistics
  k4_logit_rows(cluster, TS, MS, ZP, ZO, s, r0, nr, bp, dsz, dsp);
  k4_row_stats(ZO, LR, PM, PS, nr, b, bp);
  cluster.sync();
  // 3. every row's and column's LSE; the own rows of dZ and their partial
  // of sum(dZ Z) (one warp a row, then in row order)
  for (int i = tid; i < b; i += CNT) {
    LSER[i] = cluster.map_shared_rank(LR, i / R)[i % R];
    LSEC[i] = k4_col_lse(cluster, PM, PS, i);
  }
  __syncthreads();
  if (lse != nullptr && q == 0)  // LSEC follows LSER
    for (int i = tid; i < 2 * b; i += CNT) lse[i] = LSER[i];
  for (int e = tid; e < nr * bp; e += CNT) {
    const int i = e / bp, j = e % bp;
    DZO[e] = j < b ? k4_dz(ZO[e], LSER[r0 + i], LSEC[j], r0 + i == j, g, b)
                   : 0.f;
  }
  __syncthreads();
  for (int i = warp; i < nr; i += CNT / 32) {
    float p = 0.f;
    for (int j = lane; j < b; j += 32)
      p = fmaf(DZO[i * bp + j], ZO[i * bp + j], p);
    p = warp_sum(p);
    if (lane == 0) NB[i] = p;  // the row's partial (NB is free until 4.)
  }
  __syncthreads();
  if (tid == 0) {
    float p = 0.f;
    for (int i = 0; i < nr; ++i) p += NB[i];
    DL[0] = p;
  }
  cluster.sync();
  if (q == 0 && tid == 0) dls[0] = k4_sum(cluster, DL, 0);
  // every row of dZ from the cluster, over ZP (zero past b), 16 bytes a
  // load, eight loads in flight a thread
  {
    const int nq = bp / 4, items = bp * nq;
    for (int base = 0; base < items; base += 8 * CNT) {
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = min(base + k * CNT + tid, items - 1);
        const int i = min(e / nq, b - 1);
        v[k] = reinterpret_cast<const float4*>(cluster.map_shared_rank(
            DZO, i / R))[((i % R) * bp) / 4 + e % nq];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = base + k * CNT + tid;
        if (e < items) {
          const float z = e / nq < b ? 1.f : 0.f;
          reinterpret_cast<float4*>(ZP)[e] =
              make_float4(v[k].x * z, v[k].y * z, v[k].z * z, v[k].w * z);
        }
      }
    }
  }
  __syncthreads();
  // 4. the slices of dtn = s dZ mn and dmn = s dZ^T tn, each row's
  // partial <dn, n> over the slice, the cluster's sums in rank order, the
  // norm backward
  k4_gemm_nn(bp, dsz, bp,
             [=](int r, int k) {
               return *reinterpret_cast<const float4*>(ZP + r * bp + k);
             },
             [=](int k, int c) {
               return *reinterpret_cast<const float4*>(MS + k * dsp + c);
             },
             [=](int r, int c, float v) { DTS[r * dsp + c] = s * v; });
  k4_gemm_tn(bp, dsz, bp,
             [=](int k, int r) {
               return *reinterpret_cast<const float4*>(ZP + k * bp + r);
             },
             [=](int k, int c) {
               return *reinterpret_cast<const float4*>(TS + k * dsp + c);
             },
             [=](int r, int c, float v) { DMS[r * dsp + c] = s * v; });
  __syncthreads();
  for (int e = tid; e < 2 * b; e += CNT) {  // a thread a row
    const float* dn = (e >= b ? DMS : DTS) + (e % b) * dsp;
    const float* n = (e >= b ? MS : TS) + (e % b) * dsp;
    float p = 0.f;
    for (int c = 0; c < dsz; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(dn + c);
      const float4 v = *reinterpret_cast<const float4*>(n + c);
      p = fmaf(a.x, v.x, p);
      p = fmaf(a.y, v.y, p);
      p = fmaf(a.z, v.z, p);
      p = fmaf(a.w, v.w, p);
    }
    NB[e] = p;
  }
  cluster.sync();
  for (int e = tid; e < 2 * b; e += CNT)  // <dn, n> over d, over NS
    NS[e] = k4_sum(cluster, NB, e);       // (read by nobody since 1.)
  __syncthreads();
  for (int e = tid; e < 2 * b * (dsz / 4); e += CNT) {  // 4 outputs each
    const int row = e / (dsz / 4), c = 4 * (e % (dsz / 4));
    const int side = row >= b, i = row % b;
    const float sd = NS[row], iv = INV[row];
    const float4 a =
        *reinterpret_cast<const float4*>((side ? DMS : DTS) + i * dsp + c);
    const float4 v =
        *reinterpret_cast<const float4*>((side ? MS : TS) + i * dsp + c);
    k4_store4((side ? dm : dt) + (size_t)i * d + c0 + c,
              make_float4((a.x - v.x * sd) * iv, (a.y - v.y * sd) * iv,
                          (a.z - v.z * sd) * iv, (a.w - v.w * sd) * iv));
  }
  cluster.sync();  // no block leaves while the cluster may read its PUB
}

// The largest batch the cluster kernel takes at width d: d a multiple of
// 8 (the 16-byte loads; the wrapper passes 16-byte aligned rows) and its
// blocks' shared memory within SMEM_MAX; 0 where none fits.
inline int k4_cluster_max(int d) {
  if (d % 8) return 0;
  int b = 1024;
  while (b > 0 && sizeof(float) * k4_smem_floats(b, d) > SMEM_MAX) --b;
  return b;
}

template <typename T>
int forward_cluster(const T* t, const T* m, const float* log_scale,
                    float* loss, float* lse, int b, int d, cudaStream_t st) {
  int err;
  if ((err = vct::cluster_ready<contrastive_fwd_cluster_kernel<T>, CL, CNT>(
           SMEM_MAX)))
    return err;
  contrastive_fwd_cluster_kernel<T>
      <<<CL, CNT, sizeof(float) * k4_smem_floats(b, d), st>>>(
          t, m, log_scale, loss, lse, b, d);
  return (int)cudaGetLastError();
}

template <typename T>
int backward_cluster(const T* t, const T* m, const float* log_scale,
                     const float* g, T* dt, T* dm, float* dls, float* lse,
                     int b, int d, cudaStream_t st) {
  int err;
  if ((err = vct::cluster_ready<contrastive_bwd_cluster_kernel<T>, CL, CNT>(
           SMEM_MAX)))
    return err;
  contrastive_bwd_cluster_kernel<T>
      <<<CL, CNT, sizeof(float) * k4_smem_floats(b, d), st>>>(
          t, m, log_scale, g, dt, dm, dls, lse, b, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace the forward needs, and the backward past its
// cluster route.
size_t vct_contrastive_work(int b, int d) {
  return 4 * (size_t)b * d + 4 * (size_t)b + 2 * (size_t)b * b;
}

// K4 forward: one cluster launch for b <= vct_contrastive_bwd_cluster_max
// (work unused, may be null), else the four-kernel route over work
// (vct_contrastive_work floats).
int vct_contrastive_fwd(int bf16, const void* t, const void* m,
                        const void* log_scale, void* work, void* loss, int b,
                        int d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* ls = (const float*)log_scale;
  if (b <= k4_cluster_max(d)) {
    typedef __nv_bfloat16 H;
    return bf16 ? forward_cluster((const H*)t, (const H*)m, ls,
                                  (float*)loss, nullptr, b, d, st)
                : forward_cluster((const float*)t, (const float*)m, ls,
                                  (float*)loss, nullptr, b, d, st);
  }
  const Work w((float*)work, b, d);
  int err = bf16 ? forward_passes((const __nv_bfloat16*)t,
                                  (const __nv_bfloat16*)m, ls, w, b, d, st)
                 : forward_passes((const float*)t, (const float*)m, ls, w, b,
                                  d, st);
  if (err) return err;
  loss_kernel<<<1, NT, 0, st>>>(w.z, w.lse, (float*)loss, b);
  return (int)cudaGetLastError();
}

// The largest batch the backward takes in one cluster launch at width d
// (past it: the multi-kernel route and its workspace).
int vct_contrastive_bwd_cluster_max(int d) { return k4_cluster_max(d); }

// K4 backward: one cluster launch for b <= vct_contrastive_bwd_cluster_max
// (work unused, may be null), else the multi-kernel route over work
// (vct_contrastive_work floats).
int vct_contrastive_bwd(int bf16, const void* t, const void* m,
                        const void* log_scale, const void* g, void* work,
                        void* dt, void* dm, void* dls, int b, int d,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *ls = (const float*)log_scale, *gg = (const float*)g;
  if (b <= k4_cluster_max(d)) {
    typedef __nv_bfloat16 H;
    return bf16 ? backward_cluster((const H*)t, (const H*)m, ls, gg, (H*)dt,
                                   (H*)dm, (float*)dls, nullptr, b, d, st)
                : backward_cluster((const float*)t, (const float*)m, ls, gg,
                                   (float*)dt, (float*)dm, (float*)dls,
                                   nullptr, b, d, st);
  }
  if (bf16) {
    typedef __nv_bfloat16 T;
    return backward((const T*)t, (const T*)m, ls, gg, (float*)work, (T*)dt,
                    (T*)dm, (float*)dls, b, d, st);
  }
  return backward((const float*)t, (const float*)m, ls, gg, (float*)work,
                  (float*)dt, (float*)dm, (float*)dls, b, d, st);
}

// Every row's then every column's LSE of Z ([2b] in lse) as one of K4's
// cluster kernels computes it, for b <= vct_contrastive_bwd_cluster_max:
// the forward's (backward 0; out: the loss) or the backward's (backward
// 1, cotangent g; out: dls, beside dt and dm). A check that the two are
// the same bits; the training entries above write no LSE.
int vct_contrastive_cluster_lse(int bf16, int backward, const void* t,
                                const void* m, const void* log_scale,
                                const void* g, void* out, void* dt,
                                void* dm, void* lse, int b, int d,
                                void* stream) {
  if (b > k4_cluster_max(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *ls = (const float*)log_scale, *gg = (const float*)g;
  typedef __nv_bfloat16 H;
  if (!backward)
    return bf16 ? forward_cluster((const H*)t, (const H*)m, ls, (float*)out,
                                  (float*)lse, b, d, st)
                : forward_cluster((const float*)t, (const float*)m, ls,
                                  (float*)out, (float*)lse, b, d, st);
  return bf16 ? backward_cluster((const H*)t, (const H*)m, ls, gg, (H*)dt,
                                 (H*)dm, (float*)out, (float*)lse, b, d, st)
              : backward_cluster((const float*)t, (const float*)m, ls, gg,
                                 (float*)dt, (float*)dm, (float*)out,
                                 (float*)lse, b, d, st);
}

}  // extern "C"
