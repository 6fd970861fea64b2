// K7: int4 GEMV for Hopper (sm_90a) on the bf16 tensor cores, and the
// int8-weight GEMM of the decode linears (qmm8_mma_kernel, below); plain
// C interface for ctypes.
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

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


// ---------------------------------------------------------------------------
// The int8-weight GEMM of the decode linears (qmm8_mma_kernel)
// ---------------------------------------------------------------------------
//
// Replaces no Pallas kernel: the reference leaves its int8 matmul to XLA,
// which fuses the dequantize `qw * scale` into the dot's operand
// (vlm_clip_tpu/ops/quant.py:225-230), so no fp weight reaches memory.
// This kernel computes the same function in one pass over the weight:
//   y[m, n] = cast(sum_k bf16(x[m, k]) * bf16(q[k, n] * s[n]) + bias[n])
// fp32 products and sums, the fp32 bias added to the fp32 sum, one cast
// to the output's type. The operand bf16(q * s) is formed per element in
// registers: the int8 value in fp32 (exact), times its column's fp32
// scale (one fp32 rounding, as dequantize_weight), rounded to bf16
// (nearest even, as .to(bfloat16)): the reference's operand bit for bit.
//
// What bounds it on the H100: bytes. At M = 32 an int8 weight byte
// carries 64 FLOP against the card's ridge of about 295 (989 TFLOP/s over
// 3.35 TB/s); the 8h4 text linears stream 77.07 MB of int8 a layer, 2.775
// GB (0.83 ms) a decode forward. Design:
// - The weight is the A operand of mma.sync m16n8k16 (16 output columns
//   x 16 k), x^T the B operand (8 rows of x): each converted A fragment
//   serves every 8-row n-tile of x.
// - A block takes 128 columns and a depth slice. Its 8 warps share a
//   ring of up to 8 stages (about 100 KB: two blocks an SM), each 64 int8
//   rows x 128 columns (8 KB) and the x rows at that depth. A bf16 x with
//   N % 16 == 0 (every 8h4 text linear) fills a stage with two boxes of
//   the tensor memory accelerator (TMA), issued by one thread and
//   counted in on an mbarrier, zero past K, N and M: it holds about 2.6
//   TB/s where 16-byte cp.async copies from every thread held 2.2 (x's
//   copies compete with the weight's for the SM's outstanding requests).
//   An fp32 x takes the cp.async copies, a ragged N byte loads.
// - A warp takes 16 QT of the columns and a share of each stage's four
//   16-deep steps (QT = 4, or 2 past 32 rows of x, so that a lane holds
//   at most 64 accumulators). A lane reads 2 QT adjacent bytes of each of
//   the k rows 2t, 2t + 1, 2t + 8, 2t + 9 of a step, which are its A
//   fragments' k: byte q of its segment is row g of column tile q, byte
//   QT + q its row g + 8. The TMA's 128-byte swizzle (16-byte chunk c of
//   row r at c ^ (r & 7)) and the copies' 16-byte row padding both keep
//   the rows a load instruction reads on distinct banks.
// - The conversion without I2F: prmt puts the byte (xor 0x80: b + 128)
//   under the exponent of 2^23, an fp32 subtraction of 2^23 + 128 leaves
//   b exactly; one fp32 multiply by the scale; cvt.rn.bf16x2.f32 packs
//   two.
// - Narrow N (2,048 and 2,560 columns: 16 and 20 tiles) cannot fill 132
//   SMs by columns: the depth is cut into up to 6 slices, the blocks of a
//   tile form a thread-block cluster, and each block sums whole rows of
//   the tile over the cluster's partial tiles in rank order through
//   distributed shared memory: one launch, no workspace, a result that
//   repeats bit for bit (a decode graph replays it as it is). Larger
//   clusters cost more in scheduling and merge than they bring.
// - The epilogue adds the fp32 bias, casts once to bf16 or fp32, stages
//   the rows in shared memory and writes them in 16-byte stores.
// - fp32 x: as K7, three exact bf16 terms of x times the exact int8
//   values, and the scale applied to the fp32 sum (the reference rounds
//   q * s to fp32 before its fp32 product: the two differ at fp32's
//   rounding, not at bf16's).
// - Measured (H100 80GB HBM3, 700 W): the 144 calls of an 8h4 decode
//   forward take 2.40 ms at M = 32 and 1.90 ms at M = 1 against the 0.83
//   ms bound. What is left: each call's launch gap and first stage (about
//   2.5 us), the cluster merge (about 2 us), and gateup's 172 tiles on 132
//   SMs (40 SMs take two).
namespace q8 {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BN = 128;              // columns a block
constexpr int BK = 64;               // depth a stage: four 16-deep steps
constexpr int W_LD = BN + 16;        // bytes a stage's weight row
constexpr int W_STAGE = BK * W_LD;
constexpr int SMEM_MAX = 110 * 1024;  // a block's ring: two blocks an SM
constexpr int MAX_SPLITS = 8;       // blocks of a cluster (portable)
constexpr float MAGIC = 8388736.f;   // 2^23 + 128
// how a stage reaches shared memory: the tensor memory accelerator (two
// boxes a stage, 128-byte swizzled rows; bf16 x, N % 16 == 0), 16-byte
// cp.async copies (fp32 x, N % 16 == 0), or bytes (rows of any N)
enum Load { TMA, CP16, BYTES };

template <int NTL, bool XF32, Load LOAD>
struct Shape {
  static constexpr int XR = 8 * NTL;  // x rows a stage holds
  // a stage's weight rows: dense 128-byte rows for the TMA (its swizzle
  // spreads the banks), else rows of W_LD with 16 bytes of padding
  static constexpr int W_PITCH = LOAD == TMA ? BN : W_LD;
  static constexpr int W_BYTES = BK * W_PITCH;
  // bytes an x row of a stage: TMA's dense swizzled rows; else bf16 rows
  // 4 banks apart (ldmatrix), fp32 rows 8 (a half-warp's 8-byte loads)
  static constexpr int X_LD = LOAD == TMA ? 2 * BK : XF32 ? 4 * BK + 32
                                                         : 2 * BK + 16;
  static constexpr int STAGE = W_BYTES + XR * X_LD;
  static constexpr int STAGES = SMEM_MAX / STAGE < 8 ? SMEM_MAX / STAGE : 8;
};

// a block's shared memory: the ring, or the epilogue's warp tiles and
// staged output where they take more, and the TMA's 1024-byte alignment
template <int QT, int NTL, bool XF32, Load LOAD>
constexpr int smem_bytes() {
  typedef Shape<NTL, XF32, LOAD> S;
  constexpr int WN = BN / (16 * QT), WK = WARPS / WN;
  constexpr int EPI = WK * WN * QT * NTL * 32 * 16 + S::XR * (BN * 4 + 16);
  constexpr int RING = S::STAGES * S::STAGE;
  return (RING > EPI ? RING : EPI) + (LOAD == TMA ? 1024 : 0);
}

struct alignas(64) Args {
  CUtensorMap wmap;    // TMA: the weight [K, N] int8 in boxes of BK x BN
  CUtensorMap xmap;    // TMA: x [M, K] bf16 in boxes of XR x BK
  const void* x;       // [M, ldx] bf16 or fp32: 16-byte aligned rows,
                       // zero in [K, ldx)
  const int8_t* q;     // [K, N]
  const float* scale;  // [N]
  const float* bias;   // [N] or null
  void* out;           // [M, N] bf16 or fp32
  int ldx, M, K, N;
  int kps;             // depth a slice, a multiple of BK
  int out_f32;
};

// x's values (lo, hi) as three bf16 pairs whose sum is exact
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& h,
                                       uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(lo, hi);
  const float rlo = lo - __low2float(h2), rhi = hi - __high2float(h2);
  const __nv_bfloat162 m2 = __floats2bfloat162_rn(rlo, rhi);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(rlo - __low2float(m2),
                                                  rhi - __high2float(m2));
  h = *reinterpret_cast<const uint32_t*>(&h2);
  m = *reinterpret_cast<const uint32_t*>(&m2);
  l = *reinterpret_cast<const uint32_t*>(&l2);
}

// mbarrier and TMA primitives (a stage's arrival: one expect_tx and the
// bytes of its boxes)
__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                   vct::smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          vct::smem_u32(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n W: mbarrier.try_wait.parity.shared::cta.b64 p, "
      "[%0], %1;\n @!p bra W;\n}" ::"r"(vct::smem_u32(b)),
      "r"(parity)
      : "memory");
}

// box (c0 inner, c1 outer) of the tensor map into shared memory at dst
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c0, int c1, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
          vct::smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(vct::smem_u32(b))
      : "memory");
}

// byte pos of w (stored as b + 128) -> b in fp32, exactly: prmt under the
// exponent bits held in `magic` (0x4B000000 in a register, so that the
// selector, a constant once the loops unroll, takes prmt's immediate),
// then one subtraction
__device__ __forceinline__ float byte_value(uint32_t w, uint32_t magic,
                                            int pos) {
  return __uint_as_float(__byte_perm(w, magic, 0x7540 | pos)) - MAGIC;
}

template <int QT, int NTL, bool XF32, Load LOAD>
__global__ void __launch_bounds__(THREADS, 2)
    qmm8_mma_kernel(const __grid_constant__ Args a) {
  typedef Shape<NTL, XF32, LOAD> S;
  constexpr int WN = BN / (16 * QT);  // warps across the block's columns
  constexpr int WK = WARPS / WN;      // warps across a stage's four steps
  constexpr int SEG = 2 * QT;         // bytes a lane reads of a row
  constexpr int TERMS = XF32 ? 3 : 1;
  constexpr int XES = XF32 ? 4 : 2;   // bytes an x value
  constexpr int CPR = BK * XES / 16;  // 16-byte chunks an x row of a stage
  constexpr int XCH = S::XR * CPR;    // x chunks a stage
  constexpr int CPRW = BN / 16;       // 16-byte chunks a weight row
  constexpr int WROWS = THREADS / CPRW;  // weight rows a round of copies
  constexpr int FRAG = WN * QT * NTL * 32;  // float4 fragments of a tile
  constexpr int WP = S::W_PITCH;
  static_assert(WK <= 4 && (4 % WK) == 0, "each warp takes whole steps");
  static_assert(LOAD != TMA || !XF32, "the TMA path takes a bf16 x");
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[8];  // TMA: a stage's arrival
  unsigned char* smem =
      LOAD == TMA
          ? smem_raw + ((1024 - (vct::smem_u32(smem_raw) & 1023)) & 1023)
          : smem_raw;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % WN, wk = warp / WN;
  const int col0 = blockIdx.x * BN;
  const int splits = gridDim.y;
  const int kb = blockIdx.y * a.kps, ke = min(a.K, kb + a.kps);
  const int nk = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  const int wcol = wn * 16 * QT + SEG * g;  // the lane's segment in the tile
  // the exponent bits as a register (a.M < 2^30: the or adds nothing)
  const uint32_t magic = 0x4B000000u | ((uint32_t)a.M >> 30);

  if (LOAD == TMA) {
    if (tid == 0) {
      for (int s = 0; s < S::STAGES; ++s) mbar_init(&full[s]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  // the scales of the lane's columns (a bf16 x: in the operand)
  float sc[SEG];
#pragma unroll
  for (int c = 0; c < SEG; ++c)
    sc[c] = !XF32 && col0 + wcol + c < a.N ? __ldg(a.scale + col0 + wcol + c)
                                           : 0.f;

  // the copies without the TMA, set up once: weight chunk i of a stage is
  // row wr + WROWS i, bytes wc.. wc + 15 of the tile; x chunk tid + i
  // THREADS is row m, values at xk[i]..; each source advances a stage at
  // a time, and a copy is live while its depth is inside the slice
  const int wr = tid / CPRW, wc = (tid % CPRW) * 16;
  const bool wcol_ok = col0 + wc < a.N;
  const int8_t* wsrc = a.q + (size_t)(kb + wr) * a.N + col0 + wc;
  const size_t wstage = (size_t)BK * a.N, wround = (size_t)WROWS * a.N;
  const int wdst = wr * WP + wc;
  constexpr int XPT = (XCH + THREADS - 1) / THREADS;  // x copies a thread
  const unsigned char* xsrc[XPT];
  int xdst[XPT], xk[XPT];
  bool xon[XPT];
#pragma unroll
  for (int i = 0; i < XPT; ++i) {
    const int e = tid + i * THREADS, m = e / CPR, c = e % CPR;
    xk[i] = c * (16 / XES);
    xon[i] = e < XCH && m < a.M;
    xdst[i] = m * S::X_LD + c * 16;
    xsrc[i] = static_cast<const unsigned char*>(a.x) +
              ((size_t)min(m, a.M - 1) * a.ldx + kb + xk[i]) * XES;
  }
  const int span = ke - kb;  // the slice's depth

  // stage s of the slice into st: the TMA (thread 0 alone: one expect_tx,
  // a weight box and an x box, zero past K, N and M), or every thread's
  // copies (one commit group a stage)
  auto load = [&](int s, unsigned char* st, uint64_t* bar) {
    if constexpr (LOAD == TMA) {
      mbar_expect(bar, S::STAGE);
      tma_box(st, &a.wmap, col0, kb + s * BK, bar);
      tma_box(st + S::W_BYTES, &a.xmap, kb + s * BK, 0, bar);
    } else {
      const int d0 = s * BK;
#pragma unroll
      for (int i = 0; i < BK / WROWS; ++i) {
        const bool ok = wcol_ok && d0 + wr + i * WROWS < span;
        if (LOAD == CP16) {
          vct::cp_async16(st + wdst + i * WROWS * WP,
                          ok ? wsrc + i * wround : a.q, ok);
        } else {  // rows not 16-byte aligned (N % 16): byte by byte
          uint32_t w[4] = {0u, 0u, 0u, 0u};
          if (ok)
            for (int b = 0; b < 16 && col0 + wc + b < a.N; ++b)
              w[b >> 2] |= (uint32_t)(uint8_t)__ldg(wsrc + i * wround + b)
                           << (8 * (b & 3));
          *reinterpret_cast<uint4*>(st + wdst + i * WROWS * WP) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      wsrc += wstage;
      unsigned char* xst = st + S::W_BYTES;
#pragma unroll
      for (int i = 0; i < XPT; ++i) {
        if (XCH % THREADS == 0 || tid + i * THREADS < XCH) {
          const bool ok = xon[i] && d0 + xk[i] < span;
          vct::cp_async16(xst + xdst[i], ok ? xsrc[i] : a.x, ok);
        }
        xsrc[i] += BK * XES;
      }
    }
  };

  float acc[QT][NTL][4];
#pragma unroll
  for (int q = 0; q < QT; ++q)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.f;

  if (LOAD == TMA) {
    if (tid == 0)
      for (int s = 0; s < S::STAGES - 1 && s < nk; ++s)
        load(s, smem + s * S::STAGE, &full[s]);
  } else {
#pragma unroll
    for (int s = 0; s < S::STAGES - 1; ++s) {
      if (s < nk) load(s, smem + s * S::STAGE, nullptr);
      vct::cp_async_commit();
    }
  }
  // the lane's offsets in a stage: its weight rows (2t and 2t + 1 of its
  // first step, its segment; the TMA's rows swizzle 16-byte chunk c of
  // row r to c ^ (r & 7), and r & 7 is 2t or 2t + 1) and, for a bf16 x,
  // its ldmatrix row and chunk (swizzled: row & 7 is lane & 7)
  const int w_off = (16 * wk + 2 * t) * WP;
  const int swz0 = LOAD == TMA ? (((wcol >> 4) ^ (2 * t)) << 4) + (wcol & 15)
                               : wcol;
  const int swz1 =
      LOAD == TMA ? (((wcol >> 4) ^ (2 * t + 1)) << 4) + (wcol & 15) : wcol;
  const int x_row = 8 * ((lane >> 4) & 1) + (lane & 7);
  const int x_chunk = 2 * wk + ((lane >> 3) & 1);
  int slot = 0, fill = S::STAGES - 1;
  for (int i = 0; i < nk; ++i) {
    if (LOAD == TMA) {
      mbar_wait(&full[slot], (i / S::STAGES) & 1);
      __syncthreads();  // stage i landed; the slot of stage i - 1 is free
      if (tid == 0 && i + S::STAGES - 1 < nk) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        load(i + S::STAGES - 1, smem + fill * S::STAGE, &full[fill]);
      }
    } else {
      vct::cp_async_wait<S::STAGES - 2>();
      __syncthreads();  // stage i landed; the slot of stage i - 1 is free
      if (i + S::STAGES - 1 < nk)
        load(i + S::STAGES - 1, smem + fill * S::STAGE, nullptr);
      vct::cp_async_commit();
    }
    fill = fill + 1 == S::STAGES ? 0 : fill + 1;
    const unsigned char* st = smem + slot * S::STAGE;
    slot = slot + 1 == S::STAGES ? 0 : slot + 1;
    const unsigned char* xst = st + S::W_BYTES;
#pragma unroll
    for (int u = 0; u < 4 / WK; ++u) {
      // step wk + u WK: rows 16 (wk + u WK) + 2t, + 1, + 8, + 9 of the
      // lane's segment, each byte b as b + 128 (xor 0x80)
      const unsigned char* wrow = st + w_off + 16 * u * WK * WP;
      uint32_t w[4][SEG / 4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const unsigned char* src =
            wrow + ((r & 1) + 8 * (r >> 1)) * WP + ((r & 1) ? swz1 : swz0);
        if constexpr (SEG == 8) {
          const uint2 v = *reinterpret_cast<const uint2*>(src);
          w[r][0] = v.x, w[r][1] = v.y;
        } else {
          w[r][0] = *reinterpret_cast<const uint32_t*>(src);
        }
#pragma unroll
        for (int c = 0; c < SEG / 4; ++c) w[r][c] ^= 0x80808080u;
      }
      // B: x rows 8j + g at k (kk + 2t, + 1) and (kk + 2t + 8, + 9)
      uint32_t b[TERMS][NTL][2];
      if constexpr (!XF32) {
        const int ch = x_chunk + 2 * u * WK;  // 16-byte chunk of the row
        const unsigned char* xl =
            LOAD == TMA ? xst + x_row * S::X_LD + ((ch ^ (lane & 7)) << 4)
                        : xst + x_row * S::X_LD + 16 * ch;
        if constexpr (NTL == 1) {
          uint32_t r2[2];
          vct::ldsm_x2(r2, xl);
          b[0][0][0] = r2[0], b[0][0][1] = r2[1];
        } else {
#pragma unroll
          for (int j = 0; j < NTL; j += 2) {
            uint32_t r4[4];
            vct::ldsm_x4(r4, xl + 8 * j * S::X_LD);
            b[0][j][0] = r4[0], b[0][j][1] = r4[1];
            b[0][j + 1][0] = r4[2], b[0][j + 1][1] = r4[3];
          }
        }
      } else {
        const int kk = 16 * (wk + u * WK);
#pragma unroll
        for (int j = 0; j < NTL; ++j) {
          const float* xr = reinterpret_cast<const float*>(
                                xst + (8 * j + g) * S::X_LD) + kk + 2 * t;
          const float2 lo = *reinterpret_cast<const float2*>(xr);
          const float2 hi = *reinterpret_cast<const float2*>(xr + 8);
          split3(lo.x, lo.y, b[0][j][0], b[1 % TERMS][j][0],
                 b[2 % TERMS][j][0]);
          split3(hi.x, hi.y, b[0][j][1], b[1 % TERMS][j][1],
                 b[2 % TERMS][j][1]);
        }
      }
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        // v[r][h]: row r's weight in column tile q's row g (h = 0) and
        // g + 8 (h = 1): segment bytes q and QT + q
        float v[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          v[r][0] = byte_value(w[r][q >> 2], magic, q & 3);
          v[r][1] = byte_value(w[r][(QT + q) >> 2], magic, (QT + q) & 3);
          if (!XF32) v[r][0] *= sc[q], v[r][1] *= sc[QT + q];
        }
        uint32_t af[4];
        af[0] = vct::pack_bf16(v[0][0], v[1][0]);
        af[1] = vct::pack_bf16(v[0][1], v[1][1]);
        af[2] = vct::pack_bf16(v[2][0], v[3][0]);
        af[3] = vct::pack_bf16(v[2][1], v[3][1]);
#pragma unroll
        for (int j = 0; j < NTL; ++j)
#pragma unroll
          for (int term = 0; term < TERMS; ++term)
            vct::mma_bf16(acc[q][j], af, b[term][j][0], b[term][j][1]);
      }
    }
  }
  if (LOAD != TMA) vct::cp_async_wait<0>();
  __syncthreads();  // the ring is drained: its memory takes the sums

  // every warp's accumulators as float4 fragments into its slice of red
  // [WK][WN][QT][NTL][32 lanes] (conflict-free), then the slices added in
  // warp order into slice 0, every thread a share of the fragments
  float4* red = reinterpret_cast<float4*>(smem);
#pragma unroll
  for (int q = 0; q < QT; ++q)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
      red[((wk * WN + wn) * QT * NTL + q * NTL + j) * 32 + lane] =
          make_float4(acc[q][j][0], acc[q][j][1], acc[q][j][2], acc[q][j][3]);
  __syncthreads();
  if constexpr (WK > 1)
    for (int f = tid; f < FRAG; f += THREADS) {
      float4 sum = red[f];
#pragma unroll
      for (int w2 = 1; w2 < WK; ++w2) {
        const float4 v = red[w2 * FRAG + f];
        sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
      }
      red[f] = sum;
    }
  const cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1)
    cluster.sync();  // every block's tile is in its slice 0
  else if (WK > 1)
    __syncthreads();
  // this block's rows of the output: row pairs (j, t), x rows 8j + 2t and
  // + 1, split across the cluster's ranks. Fragment ((wn QT + q) NTL + j)
  // 32 + 4g + t holds them at columns wn 16 QT + 2 QT g + q (x, y) and
  // + QT (z, w). Each is summed over the ranks in order (every rank's load
  // in flight together), scaled (an fp32 x), biased and cast into a
  // staging tile, whose rows then go out in 16-byte stores.
  constexpr int PAIRS = 4 * NTL, PER_PAIR = WN * QT * 8;
  const int rank = splits > 1 ? (int)cluster.block_rank() : 0;
  const int p0 = rank * PAIRS / splits, p1 = (rank + 1) * PAIRS / splits;
  const int es = a.out_f32 ? 4 : 2;
  constexpr int OST_LD = BN * 4 + 16;  // bytes a staging row
  unsigned char* ost = smem + WK * FRAG * 16;  // [XR][OST_LD]
  for (int e = tid; e < (p1 - p0) * PER_PAIR; e += THREADS) {
    const int pr = p0 + e / PER_PAIR, k = e % PER_PAIR;
    const int fj = pr >> 2, ft = pr & 3, fg = k & 7, fq = (k >> 3) % QT;
    const int fw = (k >> 3) / QT;
    const int m0 = 8 * fj + 2 * ft;
    if (m0 >= a.M) continue;
    const int f = ((fw * QT + fq) * NTL + fj) * 32 + 4 * fg + ft;
    float4 sum = red[f];
    if (splits > 1) {
      float4 v[MAX_SPLITS];
#pragma unroll
      for (int p = 0; p < MAX_SPLITS; ++p)
        if (p < splits) v[p] = cluster.map_shared_rank(red, p)[f];
      sum = v[0];
#pragma unroll
      for (int p = 1; p < MAX_SPLITS; ++p)
        if (p < splits)
          sum.x += v[p].x, sum.y += v[p].y, sum.z += v[p].z, sum.w += v[p].w;
    }
    const int ca = fw * 16 * QT + 2 * QT * fg + fq;
    const float r[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = m0 + (c & 1), col = ca + (c >> 1) * QT, n = col0 + col;
      if (m >= a.M || n >= a.N) continue;
      float y = r[c];
      if (XF32) y *= a.scale[n];
      if (a.bias != nullptr) y += a.bias[n];
      if (a.out_f32)
        reinterpret_cast<float*>(ost + m * OST_LD)[col] = y;
      else
        reinterpret_cast<bf16*>(ost + m * OST_LD)[col] = __float2bfloat16_rn(y);
    }
  }
  // the cluster may leave our tile now; the last barrier waits at exit
  if (splits > 1)
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  __syncthreads();
  // this block's rows [2 p0, 2 p1) of x, its staged columns to the output
  const int r0 = 2 * p0, r1 = min(2 * p1, a.M);
  const int ncols = min(BN, a.N - col0);
  const bool vec_out = (a.N * es) % 16 == 0;  // rows start 16-byte aligned
  const int vrow = ncols * es / 16;          // 16-byte pieces a row
  if (vec_out) {
    for (int e = tid; e < (r1 - r0) * vrow; e += THREADS) {
      const int m = r0 + e / vrow, c = e % vrow;
      *reinterpret_cast<uint4*>(static_cast<unsigned char*>(a.out) +
                                ((size_t)m * a.N + col0) * es + 16 * c) =
          *reinterpret_cast<const uint4*>(ost + m * OST_LD + 16 * c);
    }
  } else {
    for (int e = tid; e < (r1 - r0) * ncols; e += THREADS) {
      const int m = r0 + e / ncols, c = e % ncols;
      unsigned char* dst = static_cast<unsigned char*>(a.out) +
                           ((size_t)m * a.N + col0 + c) * es;
      if (a.out_f32)
        *reinterpret_cast<float*>(dst) =
            reinterpret_cast<const float*>(ost + m * OST_LD)[c];
      else
        *reinterpret_cast<bf16*>(dst) =
            reinterpret_cast<const bf16*>(ost + m * OST_LD)[c];
    }
  }
  if (splits > 1)  // no block leaves while others may read its tile
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <int QT, int NTL, bool XF32, Load LOAD>
cudaError_t launch(const Args& a, int splits, cudaStream_t st) {
  constexpr int SMEM = smem_bytes<QT, NTL, XF32, LOAD>();
  auto kern = qmm8_mma_kernel<QT, NTL, XF32, LOAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BN - 1) / BN, splits);
  if (splits == 1) {
    kern<<<grid, THREADS, SMEM, st>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool XF32, Load LOAD>
cudaError_t dispatch(const Args& a, int splits, cudaStream_t st) {
  if (a.M <= 8) return launch<4, 1, XF32, LOAD>(a, splits, st);
  if (a.M <= 16) return launch<4, 2, XF32, LOAD>(a, splits, st);
  if (a.M <= 32) return launch<4, 4, XF32, LOAD>(a, splits, st);
  return launch<2, 8, XF32, LOAD>(a, splits, st);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found once through the runtime
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a row-major [rows, cols] matrix of elements of `bytes` bytes (row pitch
// `pitch` bytes, a multiple of 16) in boxes of box_rows x box_cols, the
// box's 128-byte rows swizzled; zero past the matrix
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                       const void* base, int rows, int cols, size_t pitch,
                       int box_rows, int box_cols) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

}  // namespace q8

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

// The int8-weight GEMM: x [M <= 64, ldx] (bf16, or fp32 when x_f32; rows
// 16-byte aligned, ldx a multiple of 8 or 4 values, zero in [K, ldx)); q
// [K, N] int8 (rows 16-byte aligned when vec); scale [N] fp32; bias [N]
// fp32 or null; out [M, N] fp32 when out_f32, else bf16; the depth cut
// into splits <= 8 slices, a thread-block cluster of that many blocks a
// column tile. Returns the cudaError_t of the launch.
extern "C" int vct_qmm8(int x_f32, const void* x, int ldx, const void* q,
                        const void* scale, const void* bias, void* out,
                        int out_f32, int M, int K, int N, int vec, int splits,
                        void* stream) {
  if (M < 1 || M > 64 || K < 1 || N < 1 || splits < 1 ||
      splits > q8::MAX_SPLITS || ldx < K || ldx % (x_f32 ? 4 : 8) ||
      (vec && N % 16))
    return (int)cudaErrorInvalidValue;
  q8::Args a = {};
  a.x = x;
  a.q = static_cast<const int8_t*>(q);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.ldx = ldx, a.M = M, a.K = K, a.N = N, a.out_f32 = out_f32;
  const int stages = (K + q8::BK - 1) / q8::BK;
  a.kps = (stages + splits - 1) / splits * q8::BK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return (int)(vec ? q8::dispatch<true, q8::CP16>(a, splits, st)
                     : q8::dispatch<true, q8::BYTES>(a, splits, st));
  if (!vec) return (int)q8::dispatch<false, q8::BYTES>(a, splits, st);
  // the TMA: the weight in boxes of a stage's rows and columns, x in
  // boxes of the instantiation's rows (past M: zero)
  const int xr = M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64;
  cudaError_t err = q8::tensor_map(&a.wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, q,
                                   K, N, (size_t)N, q8::BK, q8::BN);
  if (err == cudaSuccess)
    err = q8::tensor_map(&a.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K,
                         (size_t)ldx * 2, xr, q8::BK);
  if (err != cudaSuccess) return (int)err;
  return (int)q8::dispatch<false, q8::TMA>(a, splits, st);
}
