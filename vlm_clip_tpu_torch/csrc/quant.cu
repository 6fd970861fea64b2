// K7: int4 GEMV for Hopper (sm_90a) on the bf16 tensor cores, plain C
// interface for ctypes.
//
// Replaces vlm_clip_tpu/ops/quant.py `_qmm4_kernel` (:233, pallas_call
// :290):
//   out[m, n] = scale[n] * sum_k x[m, k] * (nib[k, n] - 8)
// over row-pair packed bytes (low nibble = input row 2r, high = 2r + 1),
// fp32 accumulation, fp32 out over the logical N columns. The weight is
// read once, in the layout quantize_weight writes ([K2 >= K/2, ldw],
// pre-padded), and never dequantized to memory.
//
// What bounds it on the H100 (3.35 TB/s): the 8h4 LM head (K = 2048,
// N = 151,936) moves 156 MB of nibbles, 0.047 ms; at M = 8 its 5.0 GFLOP
// take 0.005 ms on the bf16 tensor cores (989 TFLOP/s). The nibbles
// (-8..7) and bf16 x are exact in bf16, so a bf16 mma with fp32
// accumulation computes the reference's fp32 function up to summation
// order. Design:
//
// - Swapped product: the weight is the A operand (16 output columns x 16
//   k of an m16n8k16 tile), x^T the B operand (8 rows of x a tile), so
//   each A fragment is converted once and serves every n-tile of x.
// - A fragment register (row g, k 2t..2t + 1) = one packed byte pair:
//   byte q of packed rows t and t + 4 (prmt), low nibbles -> one bf16
//   pair, high nibbles -> the other (int4_pairs in mma.cuh). The k order
//   inside a 16-deep step is permuted to match (logical 2t + 1 <->
//   physical 2t + 8); the B registers take x in the same order.
// - Columns: a lane reads 8 adjacent columns of a packed row (one 8-byte
//   shared load); byte q of its first word is column 8g + q of tile q's
//   row g, its second word columns 8g + 4 + q (row g + 8). The store
//   inverts the map.
// - Bytes in flight: each warp streams its own ring of DEPTH 16-deep steps
//   (8 packed rows x 64 columns, 512 bytes, and the step's x rows) with
//   cp.async, synchronised by __syncwarp alone. x goes through L1, where
//   the other warps on the SM find it: past L1, every warp's copy of x
//   comes from L2, and the kernel's time grows with M.
// - A block is one 64-column tile; its 4 warps take consecutive quarters
//   of the depth and add their accumulators in warp order through shared
//   memory. Where the tiles cannot fill the card (narrow N), the depth is
//   also cut into ordered slices whose partial sums a second kernel adds
//   in slice order: no atomics, so results repeat bit for bit.
// - fp32 x: a pre-pass splits each value into three bf16 terms h =
//   bf16(x), m = bf16(x - h), l = bf16(x - h - m), which sum to x exactly
//   (above the subnormals, below bf16's largest finite value); each
//   term's product with an exact nibble is exact, so only the summation
//   order differs. The same pre-pass pads a bf16 x whose rows cannot be
//   copied in 16-byte chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using vct::bf16;

constexpr int WARPS = 4;           // warps a block: quarters of the depth
constexpr int THREADS = WARPS * 32;
constexpr int TILE_N = 64;         // columns a block
constexpr int DEPTH = 8;           // ring stages a warp, one 16-deep step each
constexpr int W_LD = 96;           // bytes a packed row in the ring (64 + 32)
constexpr int W_STAGE = 8 * W_LD;  // 8 packed rows = 16 k
constexpr int X_LD = 48;           // bytes an x row of a step (32 + 16)

// Shared memory of one instantiation: NTL n-tiles of 8 x rows, TERMS bf16
// terms of x. A stage's rows keep the banks distinct: W_LD (24 words) puts
// the rows t and t + 4 that a half-warp reads 8 banks apart, X_LD (12
// words) the 8 rows of an n-tile.
template <int NTL, int TERMS>
struct Shape {
  static constexpr int XROWS = 8 * NTL;
  static constexpr int STAGE = W_STAGE + TERMS * XROWS * X_LD;
  static constexpr int RING = DEPTH * STAGE;  // a warp's
  static constexpr int ACC = 4 * NTL * 4;     // accumulators a lane
  static constexpr int RED = (WARPS - 1) * ACC * 32 * 4;
  static constexpr int SMEM = WARPS * RING > RED ? WARPS * RING : RED;
};

// xs: TERMS bf16 terms of x, term stride xterm elements, rows of ldx (a
// multiple of 8, zero past K); packed [k2rows, ldw] (ldw a multiple of
// 16); out [M, N] = scale * sum, or partial [splits, M, N] unscaled.
template <int NTL, int TERMS>
__global__ void __launch_bounds__(THREADS)
    qmm4_mma_kernel(const bf16* __restrict__ xs, int ldx, long long xterm,
                    int M, const uint8_t* __restrict__ packed, int k2rows,
                    int ldw, const float* __restrict__ scale,
                    float* __restrict__ partial, float* __restrict__ out,
                    int N, int steps, int steps_per_split) {
  typedef Shape<NTL, TERMS> S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * TILE_N;
  const int s0 = blockIdx.y * steps_per_split;
  const int s1 = min(steps, s0 + steps_per_split);
  const int per = (max(s1 - s0, 0) + WARPS - 1) / WARPS;
  const int wb = min(s1, s0 + warp * per), we = min(s1, wb + per);
  const int ns = max(we - wb, 0);
  unsigned char* ring = smem + warp * S::RING;

  auto load = [&](int i) {  // step wb + i into slot i % DEPTH
    unsigned char* st = ring + (i % DEPTH) * S::STAGE;
    const int s = wb + i;
    const int pr = 8 * s + (lane >> 2), c = col0 + 16 * (lane & 3);
    const bool ok = pr < k2rows && c < ldw;
    vct::cp_async16(st + (lane >> 2) * W_LD + 16 * (lane & 3),
                    ok ? packed + (size_t)pr * ldw + c : packed, ok);
    unsigned char* xst = st + W_STAGE;
    for (int e = lane; e < TERMS * S::XROWS * 2; e += 32) {
      const int row = e >> 1, term = row / S::XROWS, m = row % S::XROWS;
      const int k = 16 * s + 8 * (e & 1);
      const bool okx = m < M && k < ldx;
      // through L1: the warps of an SM that take the same depth quarter
      // read the same x rows in the same order
      vct::cp_async16_ca(xst + row * X_LD + 16 * (e & 1),
                         okx ? xs + term * xterm + (size_t)m * ldx + k : xs,
                         okx);
    }
  };

  float acc[4][NTL][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < DEPTH - 1; ++i) {
    if (i < ns) load(i);
    vct::cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    vct::cp_async_wait<DEPTH - 2>();
    __syncwarp();  // step i landed for every lane; slot i - 1 is free
    if (i + DEPTH - 1 < ns) load(i + DEPTH - 1);
    vct::cp_async_commit();
    const unsigned char* st = ring + (i % DEPTH) * S::STAGE;
    // packed rows t and t + 4, columns 8g .. 8g + 7 of the tile
    const uint2 w = *reinterpret_cast<const uint2*>(st + t * W_LD + 8 * g);
    const uint2 w4 =
        *reinterpret_cast<const uint2*>(st + (t + 4) * W_LD + 8 * g);
    // B: x row 8j + g at k (2t, 2t + 8) and (2t + 1, 2t + 9)
    uint32_t b[TERMS][NTL][2];
    const unsigned char* xst = st + W_STAGE;
#pragma unroll
    for (int term = 0; term < TERMS; ++term)
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const uint32_t* xr = reinterpret_cast<const uint32_t*>(
            xst + (term * S::XROWS + 8 * j + g) * X_LD);
        const uint32_t lo = xr[t], hi = xr[t + 4];
        b[term][j][0] = __byte_perm(lo, hi, 0x5410);
        b[term][j][1] = __byte_perm(lo, hi, 0x7632);
      }
    uint32_t a[4][4];
    vct::int4_pairs<0>(w.x, w4.x, a[0][0], a[0][2]);
    vct::int4_pairs<0>(w.y, w4.y, a[0][1], a[0][3]);
    vct::int4_pairs<1>(w.x, w4.x, a[1][0], a[1][2]);
    vct::int4_pairs<1>(w.y, w4.y, a[1][1], a[1][3]);
    vct::int4_pairs<2>(w.x, w4.x, a[2][0], a[2][2]);
    vct::int4_pairs<2>(w.y, w4.y, a[2][1], a[2][3]);
    vct::int4_pairs<3>(w.x, w4.x, a[3][0], a[3][2]);
    vct::int4_pairs<3>(w.y, w4.y, a[3][1], a[3][3]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int term = 0; term < TERMS; ++term)
          vct::mma_bf16(acc[q][j], a[q], b[term][j][0], b[term][j][1]);
  }
  vct::cp_async_wait<0>();
  __syncthreads();  // every ring is drained: its memory takes the sums

  // the warps' sums in warp order
  float* red = reinterpret_cast<float*>(smem);
  if (warp > 0) {
    int r = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e, ++r)
          red[((warp - 1) * S::ACC + r) * 32 + lane] = acc[q][j][e];
  }
  __syncthreads();
  if (warp > 0) return;
  for (int w2 = 0; w2 < WARPS - 1; ++w2) {
    int r = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e, ++r)
          acc[q][j][e] += red[(w2 * S::ACC + r) * 32 + lane];
  }
  // tile q's row g is column 8g + q, its row g + 8 column 8g + 4 + q;
  // the accumulator's columns 2t, 2t + 1 are x rows 8j + 2t, 8j + 2t + 1
#pragma unroll
  for (int j = 0; j < NTL; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * j + 2 * t + e;
      if (m >= M) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = col0 + 8 * g + 4 * half + q;
          if (n >= N) continue;
          const float v = acc[q][j][2 * half + e];
          if (partial != nullptr)
            partial[((size_t)blockIdx.y * M + m) * N + n] = v;
          else
            out[(size_t)m * N + n] = v * scale[n];
        }
    }
}

// x [M, K] (fp32 or bf16) -> TERMS bf16 terms [TERMS][M][ldx], zero past
// K: h = bf16(x), m = bf16(x - h), l = bf16(x - h - m).
template <typename Tx>
__global__ void qmm4_split_x_kernel(const Tx* __restrict__ x, int M, int K,
                                    int ldx, int terms,
                                    bf16* __restrict__ xs) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * ldx;
  if (i >= total) return;
  const int m = (int)(i / ldx), k = (int)(i % ldx);
  float v = k < K ? vct::elem_f(x[(size_t)m * K + k]) : 0.f;
  for (int term = 0; term < terms; ++term) {
    const bf16 r = __float2bfloat16_rn(v);
    xs[term * total + i] = r;
    v -= __bfloat162float(r);
  }
}

// out[m, n] = scale[n] * sum over the slices in order
__global__ void qmm4_reduce_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ scale,
                                   float* __restrict__ out, int M, int N,
                                   int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t MN = (size_t)M * N;
  if (i >= MN) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[p * MN + i];
  out[i] = s * scale[i % N];
}

template <int NTL, int TERMS>
cudaError_t launch(const bf16* xs, int ldx, long long xterm, int M,
                   const uint8_t* packed, int k2rows, int ldw,
                   const float* scale, float* partial, float* out, int N,
                   int steps, int splits, cudaStream_t st) {
  typedef Shape<NTL, TERMS> S;
  auto kern = qmm4_mma_kernel<NTL, TERMS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return err;
  const int sps = (steps + splits - 1) / splits;
  dim3 grid((N + TILE_N - 1) / TILE_N, splits);
  kern<<<grid, THREADS, S::SMEM, st>>>(xs, ldx, xterm, M, packed, k2rows,
                                       ldw, scale,
                                       splits > 1 ? partial : nullptr, out,
                                       N, steps, sps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t MN = (size_t)M * N;
  qmm4_reduce_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      partial, scale, out, M, N, splits);
  return cudaGetLastError();
}

template <int TERMS>
cudaError_t dispatch(const bf16* xs, int ldx, long long xterm, int M,
                     const uint8_t* packed, int k2rows, int ldw,
                     const float* scale, float* partial, float* out, int N,
                     int steps, int splits, cudaStream_t st) {
#define QMM4_CASE(NTL)                                                     \
  if (M <= 8 * NTL)                                                        \
    return launch<NTL, TERMS>(xs, ldx, xterm, M, packed, k2rows, ldw,      \
                              scale, partial, out, N, steps, splits, st);
  QMM4_CASE(1)
  QMM4_CASE(2)
  QMM4_CASE(4)
#undef QMM4_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x [M, K] (fp32 or bf16, contiguous; K even); packed [k2rows >= K/2,
// ldw] uint8 (ldw a multiple of 16, 16-byte aligned); scale [>= N] fp32;
// xs: bf16 scratch of [1 (bf16) or 3 (fp32) terms][M][K rounded up to
// 8], unused when direct (a bf16 x with K a multiple of 8, 16-byte
// aligned, read in place); partial [splits, M, N] fp32
// scratch when splits > 1; out [M, N] fp32. Returns the cudaError_t of
// the launches.
extern "C" int vct_qmm4(int is_bf16, int direct, const void* x, void* xs,
                        const void* packed, const void* scale, void* partial,
                        void* out, int M, int K, int k2rows, int N, int ldw,
                        int splits, void* stream) {
  if (M < 1 || M > 32 || K < 2 || K % 2 || N < 1 || ldw % 16 ||
      splits < 1 || 2 * k2rows < K || (is_bf16 && direct && K % 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = (K + 15) / 16;
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (is_bf16 && direct)
    return (int)dispatch<1>(static_cast<const bf16*>(x), K, 0, M, pk, k2rows,
                            ldw, sc, part, o, N, steps, splits, st);
  const int ldx = (K + 7) / 8 * 8;
  const int terms = is_bf16 ? 1 : 3;
  const size_t total = (size_t)M * ldx;
  bf16* t = static_cast<bf16*>(xs);
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (is_bf16)
    qmm4_split_x_kernel<bf16><<<blocks, 256, 0, st>>>(
        static_cast<const bf16*>(x), M, K, ldx, 1, t);
  else
    qmm4_split_x_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(x), M, K, ldx, 3, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)(terms == 1
                   ? dispatch<1>(t, ldx, (long long)total, M, pk, k2rows, ldw,
                                 sc, part, o, N, steps, splits, st)
                   : dispatch<3>(t, ldx, (long long)total, M, pk, k2rows, ldw,
                                 sc, part, o, N, steps, splits, st));
}
