// Tensor-core building blocks for the port's Hopper (sm_90a) kernels,
// shared by csrc/attention.cu, csrc/fused_adapter.cu, csrc/quant.cu and
// csrc/decode_attention.cu.
//
// - ldmatrix (plain and .trans) from bf16 tiles in shared memory;
// - quad reductions over an accumulator row, ex2 on the SFU;
// - a warp's 16-row fragment products against a tile of keys (scores
//   q k^T, p v), shared by K5 and K2's backward;
// - mma.sync.m16n8k16 with bf16 operands and fp32 accumulators;
// - cp.async 16-byte copies (zero-filled past a tile's ragged edge),
//   past L1 or through it; every operand is 16-byte aligned, its row
//   stride and widths multiples of 8; 4-byte copies through L1;
// - load_tile: a bf16 tile of a row-major matrix into shared memory;
// - BlockGemm: one block's [BM, BN] fp32 tile of A B over a depth range,
//   through a STAGES-deep cp.async ring, with either operand read in
//   either layout (the transposed one through ldmatrix.trans);
// - mma.sync.m16n8k8 with TF32 operands, the split of an fp32 value into
//   a TF32 "big" part and a TF32 "small" remainder (cvt.rna's rounding),
//   and Tf32Gemm: BlockGemm's contract for fp32 (or bf16) operands whose
//   products are error-compensated (big b + big s + small b, about 2^-22
//   relative a product where one TF32 pass gives 2^-11);
// - the int4 nibble -> bf16 conversion of K7 (csrc/quant.cu).
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): an fp32
// accumulator holds (row g, columns 2t, 2t + 1) in [0], [1] and row g + 8
// in [2], [3]; an A fragment is four bf16 pairs: (g, k 2t..2t+1),
// (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); a B fragment two:
// (k 2t..2t+1, column g) and (k 2t + 8.., g). The lower-indexed element of
// a pair sits in the low 16 bits.
//
// Fragment layout of m16n8k8 with TF32 operands (32-bit registers, the
// fp32 bit pattern of which the low 13 mantissa bits are ignored): A is
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k t, column g) and
// (k t + 4, g); the accumulator as for m16n8k16.
//
// Shared-memory tiles keep rows of C + 8 bf16 (C a multiple of 16): the 8
// rows one ldmatrix phase reads then start 4 banks apart (conflict-free),
// and every row starts on a 16-byte boundary, as cp.async needs.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vct {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and register j receives matrix j.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// Two 8x8 b16 matrices; lanes 0-15 give the row addresses (lane i: row
// i % 8 of matrix i / 8), register j receives matrix j.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b over one m16n8k16 tile: bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, bypassing L1; writes 16 zero bytes instead
// when !pred (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The same through L1 (.ca): for small data that many warps of an SM read.
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src,
                                              bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared through L1: for copies into padded layouts
// whose rows do not start on 16-byte boundaries.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Reductions over the four lanes of a quad (lane & ~3 alike): the lanes
// that hold one row of an m16n8 accumulator fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr float L2E = 1.4426950408889634f;  // log2(e)

// 2^x on the special-function unit; exp(s - m) = ex2(s log2e - m log2e),
// and ex2(-inf) = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16, lo in the low 16 bits.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A warp's A fragments of 16 rows [row0, row0 + 16) of a bf16 tile s
// (row stride ld) over a depth of KD: a[kk] covers columns 16kk .. 16kk +
// 15.
template <int KD>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[KD / 16][4],
                                            const bf16* s, int ld, int row0,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk)
    ldsm_x4(a[kk], s + (row0 + (lane & 15)) * ld + kk * 16 + (lane >> 4) * 8);
}

// s0, s1 (m16n8 tiles: columns k0 .. k0 + 7 and k0 + 8 .. k0 + 15) +=
// the warp's 16 rows, as A fragments a over a depth of KD, times rows k0
// .. k0 + 15 of a row-major bf16 tile Bs (row stride ld) transposed:
// B(k, n) = Bs[(k0 + n) * ld + k]. With q's rows in a and K's rows in Bs
// these are the scores of 16 keys.
template <int KD>
__device__ __forceinline__ void mma_rows_t16(float (&s0)[4], float (&s1)[4],
                                             const uint32_t (&a)[KD / 16][4],
                                             const bf16* Bs, int ld, int k0,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    uint32_t r[4];
    ldsm_x4(r, Bs + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + kk * 16 +
                   ((lane >> 3) & 1) * 8);
    mma_bf16(s0, a[kk], r[0], r[1]);
    mma_bf16(s1, a[kk], r[2], r[3]);
  }
}

// acc[j] (m16n8 tiles over N columns) += a, the warp's 16 rows over 16
// keys k0 .. k0 + 15 as one A fragment, times rows k0 .. k0 + 15 of a
// row-major bf16 tile Bs (row stride ld): B(k, n) = Bs[(k0 + k) * ld + n].
// With p in a and V's rows in Bs this is p v over 16 keys.
template <int N>
__device__ __forceinline__ void mma_rows16(float (&acc)[N / 8][4],
                                           const uint32_t (&a)[4],
                                           const bf16* Bs, int ld, int k0,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; j += 2) {
    uint32_t r[4];
    ldsm_x4_t(r, Bs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + j * 8 +
                     (lane >> 4) * 8);
    mma_bf16(acc[j], a, r[0], r[1]);
    mma_bf16(acc[j + 1], a, r[2], r[3]);
  }
}

// The A fragment (16 rows x 16 keys) of two m16n8 fp32 tiles s0 (keys
// 0-7) and s1 (keys 8-15), each value rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&s0)[4],
                                       const float (&s1)[4]) {
  a[0] = pack_bf16(s0[0], s0[1]);
  a[1] = pack_bf16(s0[2], s0[3]);
  a[2] = pack_bf16(s1[0], s1[1]);
  a[3] = pack_bf16(s1[2], s1[3]);
}

// Rows [r0, r0 + R) and columns [c0, c0 + C) of a row-major bf16 matrix
// (row stride ld elements) -> dst (row stride LDS), by NT threads of
// which this is thread tid, in 16-byte chunks with cp.async (src 16-byte
// aligned; ld, c0 and c_end multiples of 8); a chunk at row >= r_end or
// column >= c_end is zero-filled.
template <int R, int C, int LDS, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ld, int r0, int r_end,
                                          int c0, int c_end, int tid) {
  constexpr int CPR = C / 8, N = R * CPR;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (N % NT != 0 && e >= N) break;
    const int r = e / CPR, c = (e % CPR) * 8;
    const bool ok = r0 + r < r_end && c0 + c < c_end;
    cp_async16(dst + r * LDS + c,
               ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
  }
}

// One block's [BM, BN] tile of C = A B, A [M, K], B [K, N] in bf16, fp32
// accumulators. Warps tile the block WM x WN each, (BM / WM) x (BN / WN)
// of them. A_T: A is stored transposed, element (m, k) at A[k * lda + m]
// (else A[m * lda + k]); B_T: B is stored transposed, (k, n) at
// B[n * ldb + k] (else B[k * ldb + n]). Each stage holds a BK-deep slab
// of both operands in their stored layout; the operand whose stored rows
// run along the depth is read with ldmatrix.trans. The helpers take the
// thread's index among the THREADS that share the tile (threadIdx.x in
// run), so that one block may hold two such groups of warps.
template <int BM, int BN, int BK, int WM, int WN, bool A_T, bool B_T,
          int STAGES>
struct BlockGemm {
  static constexpr int TILE_M = BM, TILE_N = BN;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = (BM / WM) * WARPS_N * 32;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int A_ROWS = A_T ? BK : BM, A_COLS = A_T ? BM : BK;
  static constexpr int B_ROWS = B_T ? BN : BK, B_COLS = B_T ? BK : BN;
  static constexpr int A_LD = A_COLS + 8, B_LD = B_COLS + 8;
  static constexpr int STAGE_ELEMS = A_ROWS * A_LD + B_ROWS * B_LD;
  static constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 2;
  static_assert(BK % 16 == 0 && WN % 16 == 0 && WM % 16 == 0, "tile");

  typedef float Acc[MT][NT][4];

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // The warp's first row and column within the block tile.
  __device__ static int warp_m(int tid) { return (tid / 32) / WARPS_N * WM; }
  __device__ static int warp_n(int tid) { return (tid / 32) % WARPS_N * WN; }

  __device__ static void load_stage(bf16* s, const bf16* A, long long lda,
                                    const bf16* B, long long ldb, int m0,
                                    int m_end, int n0, int n_end, int k,
                                    int k_end, int tid) {
    bf16* sa = s;
    bf16* sb = s + A_ROWS * A_LD;
    if (A_T)
      load_tile<BK, BM, A_LD, THREADS>(sa, A, lda, k, k_end, m0, m_end,
                                            tid);
    else
      load_tile<BM, BK, A_LD, THREADS>(sa, A, lda, m0, m_end, k, k_end,
                                            tid);
    if (B_T)
      load_tile<BN, BK, B_LD, THREADS>(sb, B, ldb, n0, n_end, k, k_end,
                                            tid);
    else
      load_tile<BK, BN, B_LD, THREADS>(sb, B, ldb, k, k_end, n0, n_end,
                                            tid);
  }

  __device__ static void compute_stage(const bf16* s, Acc& acc, int tid) {
    const bf16* sa = s;
    const bf16* sb = s + A_ROWS * A_LD;
    const int lane = tid & 31, wm = warp_m(tid), wn = warp_n(tid);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m = wm + i * 16;
        if (A_T)
          ldsm_x4_t(a[i], sa + (kk + (lane & 7) + (lane >> 4) * 8) * A_LD +
                              m + ((lane >> 3) & 1) * 8);
        else
          ldsm_x4(a[i], sa + (m + (lane & 15)) * A_LD + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int n = wn + j * 8;
        uint32_t r[4];
        if (B_T)
          ldsm_x4(r, sb + (n + (lane & 7) + (lane >> 4) * 8) * B_LD + kk +
                         ((lane >> 3) & 1) * 8);
        else
          ldsm_x4_t(r, sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * B_LD +
                           n + (lane >> 4) * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  // acc += A[m0.., k_begin..k_end) B[k_begin..k_end), n0..) with rows of A
  // past m_end and columns of B past n_end read as 0. smem holds
  // SMEM_BYTES; it is free again when this returns.
  __device__ static void run(Acc& acc, bf16* smem, const bf16* A,
                             long long lda, const bf16* B, long long ldb,
                             int m0, int m_end, int n0, int n_end,
                             int k_begin, int k_end) {
    const int nk = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk)
        load_stage(smem + s * STAGE_ELEMS, A, lda, B, ldb, m0, m_end, n0,
                   n_end, k_begin + s * BK, k_end, threadIdx.x);
      cp_async_commit();
    }
    for (int i = 0; i < nk; ++i) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage i landed; stage i - 1 is free
      const int j = i + STAGES - 1;
      if (j < nk)
        load_stage(smem + (j % STAGES) * STAGE_ELEMS, A, lda, B, ldb, m0,
                   m_end, n0, n_end, k_begin + j * BK, k_end, threadIdx.x);
      cp_async_commit();
      compute_stage(smem + (i % STAGES) * STAGE_ELEMS, acc, threadIdx.x);
    }
    cp_async_wait<0>();
    __syncthreads();
  }
};

// ---------------------------------------------------------------------------
// TF32 on the tensor cores, error-compensated
// ---------------------------------------------------------------------------

// d += a b over one m16n8k8 tile: TF32 operands, fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to TF32 (10 mantissa bits; to nearest, ties away from zero),
// as an fp32 bit pattern: cvt.rna.tf32.f32's rounding for every finite
// v, done on the bits (half a TF32 ulp added to the magnitude, the 13 low
// bits cleared; a carry moves into the exponent as rounding up should).
// On the H100 this gave cvt.rna's results bit for bit, and K1's backward
// ran faster with it than with the cvt instruction.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = big + small to about 2^-22 of v: big = tf32(v), small = tf32(v - big)
// (v - big is exact in fp32).
__device__ __forceinline__ void tf32_split(float v, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// An operand element as the tensor cores' 32-bit TF32 register: an fp32
// value's bits (split by the caller), a bf16 value widened exactly.
__device__ __forceinline__ float elem_f(float v) { return v; }
__device__ __forceinline__ float elem_f(bf16 v) { return __bfloat162float(v); }

// Tiles of fp32 or bf16 in shared memory for Tf32Gemm: rows of C + PAD
// elements. An fp32 tile read with the fragment row g along its rows pads
// by 4 words (rows 4 banks apart: the 8 g x 4 t lanes hit 32 banks), one
// read with t along its rows by 8; bf16 rows pad by 8 (the lanes then
// read 16 distinct words, each shared by two lanes). Every row starts on
// a 16-byte boundary.
template <typename T, bool G_ROWS>
struct TileLd {
  static constexpr int PAD = sizeof(T) == 4 ? (G_ROWS ? 4 : 8) : 8;
};

// Rows [r0, r0 + R) and columns [c0, c0 + C) of a row-major fp32 or bf16
// matrix -> dst (row stride LDS), 16-byte cp.async chunks of 16 /
// sizeof(T) elements; a chunk at row >= r_end or column >= c_end is
// zero-filled (c_end, c0 and ld multiples of a chunk, src 16-byte
// aligned).
template <typename T, int R, int C, int LDS, int NT>
__device__ __forceinline__ void load_tile_t(T* dst, const T* src, long long ld,
                                            int r0, int r_end, int c0,
                                            int c_end, int tid) {
  constexpr int E = 16 / sizeof(T), CPR = C / E, N = R * CPR;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (N % NT != 0 && e >= N) break;
    const int r = e / CPR, c = (e % CPR) * E;
    const bool ok = r0 + r < r_end && c0 + c < c_end;
    cp_async16(dst + r * LDS + c,
               ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
  }
}

// BlockGemm's contract (one block's [BM, BN] fp32 tile of A B over a
// depth range, a STAGES-deep cp.async ring, A_T / B_T: the operand stored
// transposed) for operands of type TA, TB in {float, bf16}, on the TF32
// tensor cores, error-compensated: each fp32 operand element is split
// into big + small TF32 parts and the products accumulate small b + big s
// + big b (three passes of m16n8k8; two when one operand is bf16, which
// TF32 holds exactly and which then has no small part). About 2^-22
// relative error a product, against fp32's 2^-24; one TF32 pass would
// give 2^-11. Fragments come from 32-bit (fp32) or 16-bit (bf16) shared
// loads.
template <int BM, int BN, int BK, int WM, int WN, bool A_T, bool B_T,
          int STAGES, typename TA, typename TB>
struct Tf32Gemm {
  static constexpr int TILE_M = BM, TILE_N = BN;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = (BM / WM) * WARPS_N * 32;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int A_ROWS = A_T ? BK : BM, A_COLS = A_T ? BM : BK;
  static constexpr int B_ROWS = B_T ? BN : BK, B_COLS = B_T ? BK : BN;
  // the fragment row g runs along A's stored rows unless A_T, along B's
  // stored rows only if B_T
  static constexpr int A_LD = A_COLS + TileLd<TA, !A_T>::PAD;
  static constexpr int B_LD = B_COLS + TileLd<TB, B_T>::PAD;
  static constexpr int A_BYTES = A_ROWS * A_LD * (int)sizeof(TA);
  static constexpr int STAGE_BYTES = A_BYTES + B_ROWS * B_LD * (int)sizeof(TB);
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
  static constexpr bool SPLIT_A = sizeof(TA) == 4, SPLIT_B = sizeof(TB) == 4;
  static_assert(BK % 8 == 0 && WN % 8 == 0 && WM % 16 == 0, "tile");
  static_assert(A_BYTES % 16 == 0, "stage alignment");

  typedef float Acc[MT][NT][4];

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  __device__ static int warp_m(int tid) { return (tid / 32) / WARPS_N * WM; }
  __device__ static int warp_n(int tid) { return (tid / 32) % WARPS_N * WN; }

  __device__ static void load_stage(unsigned char* s, const TA* A,
                                    long long lda, const TB* B, long long ldb,
                                    int m0, int m_end, int n0, int n_end,
                                    int k, int k_end, int tid) {
    TA* sa = reinterpret_cast<TA*>(s);
    TB* sb = reinterpret_cast<TB*>(s + A_BYTES);
    if (A_T)
      load_tile_t<TA, BK, BM, A_LD, THREADS>(sa, A, lda, k, k_end, m0, m_end,
                                             tid);
    else
      load_tile_t<TA, BM, BK, A_LD, THREADS>(sa, A, lda, m0, m_end, k, k_end,
                                             tid);
    if (B_T)
      load_tile_t<TB, BN, BK, B_LD, THREADS>(sb, B, ldb, n0, n_end, k, k_end,
                                             tid);
    else
      load_tile_t<TB, BK, BN, B_LD, THREADS>(sb, B, ldb, k, k_end, n0, n_end,
                                             tid);
  }

  __device__ static float a_at(const TA* sa, int m, int k) {
    return elem_f(A_T ? sa[k * A_LD + m] : sa[m * A_LD + k]);
  }
  __device__ static float b_at(const TB* sb, int k, int n) {
    return elem_f(B_T ? sb[n * B_LD + k] : sb[k * B_LD + n]);
  }

  __device__ static void compute_stage(const unsigned char* s, Acc& acc,
                                       int tid) {
    const TA* sa = reinterpret_cast<const TA*>(s);
    const TB* sb = reinterpret_cast<const TB*>(s + A_BYTES);
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wm = warp_m(tid), wn = warp_n(tid);
    // one 8-deep step at a time: unrolled steps spill at the 128
    // registers of two 256-thread blocks an SM
#pragma unroll 1
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn + j * 8 + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = b_at(sb, kk + t + 4 * h, n);
          if (SPLIT_B)
            tf32_split(v, bb[j][h], bs[j][h]);
          else
            bb[j][h] = __float_as_uint(v);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m = wm + i * 16 + g;
        uint32_t ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = a_at(sa, m + 8 * (e & 1), kk + t + 4 * (e >> 1));
          if (SPLIT_A)
            tf32_split(v, ab[e], as[e]);
          else
            ab[e] = __float_as_uint(v);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // the passes of one 8-deep step into a fresh accumulator, added
          // to acc in fp32 (round to nearest): the tensor cores truncate
          // their sums, and a long chain of truncations would bias acc
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          if (SPLIT_A) mma_tf32(d, as, bb[j][0], bb[j][1]);
          if (SPLIT_B) mma_tf32(d, ab, bs[j][0], bs[j][1]);
          mma_tf32(d, ab, bb[j][0], bb[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
        }
      }
    }
  }

  // acc += A[m0.., k_begin..k_end) B[k_begin..k_end), n0..) with rows of A
  // past m_end and columns of B past n_end read as 0. smem holds
  // SMEM_BYTES; it is free again when this returns.
  __device__ static void run(Acc& acc, unsigned char* smem, const TA* A,
                             long long lda, const TB* B, long long ldb,
                             int m0, int m_end, int n0, int n_end,
                             int k_begin, int k_end) {
    const int nk = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk)
        load_stage(smem + s * STAGE_BYTES, A, lda, B, ldb, m0, m_end, n0,
                   n_end, k_begin + s * BK, k_end, threadIdx.x);
      cp_async_commit();
    }
    for (int i = 0; i < nk; ++i) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage i landed; stage i - 1 is free
      const int j = i + STAGES - 1;
      if (j < nk)
        load_stage(smem + (j % STAGES) * STAGE_BYTES, A, lda, B, ldb, m0,
                   m_end, n0, n_end, k_begin + j * BK, k_end, threadIdx.x);
      cp_async_commit();
      compute_stage(smem + (i % STAGES) * STAGE_BYTES, acc, threadIdx.x);
    }
    cp_async_wait<0>();
    __syncthreads();
  }
};

// ---------------------------------------------------------------------------
// int4 nibbles -> bf16 (K7)
// ---------------------------------------------------------------------------

// Byte q of two packed words w (packed row r) and w4 (row r + 4), each
// byte lo | hi << 4 with the stored nibbles v = w + 8 of input rows 2r
// (lo) and 2r + 1 (hi) of one column: lo_pair = (lo(w), lo(w4)) and
// hi_pair = (hi(w), hi(w4)) as bf16 pairs of the weights v - 8, lower
// element in the low 16 bits. OR-ing a nibble into 0x4300 (bf16 128.0,
// whose ulp is 1) gives 128 + v; subtracting 136 leaves v - 8, exactly.
template <int Q>
__device__ __forceinline__ void int4_pairs(uint32_t w, uint32_t w4,
                                           uint32_t& lo_pair,
                                           uint32_t& hi_pair) {
  const uint32_t b = __byte_perm(w, w4, Q | ((4 + Q) << 8));  // [w_q . w4_q .]
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t lo = (b & 0x000F000Fu) | 0x43004300u;
  uint32_t hi = ((b >> 4) & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 l = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&lo), off);
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&hi), off);
  lo_pair = *reinterpret_cast<uint32_t*>(&l);
  hi_pair = *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace vct
