// K8: GQA decode attention over a KV cache for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces vlm_clip_tpu/ops/decode_attention.py `_make_kernel` (:130,
// pallas_call :304). For batch row b and kv head g, the R = T * rep query
// rows (row r = t * rep + rr is head g * rep + rr at fresh position t)
// attend the cache columns col < depth[b] plus the T fresh columns with a
// causal triangle (fresh column t' <= t):
//   - cache columns stream in 64-column chunks with an online softmax:
//     scores in fp32 from operands rounded to q's type, k scales folded
//     into the scores for an int8 cache, masked columns -1e30 (finite),
//     masked probs zeroed before the v scales fold in, p rounded to q's
//     type against the running max before p v (fp32 sums);
//   - then the T fresh columns in fp32 throughout;
//   - out = acc / l, written in q's type.
//
// Bound on the H100: it reads the cache rows below each depth once (K and
// V, plus their scales for an int8 cache) and does 4 R d FLOP per column:
// bytes bound it (B=8, S=768, bf16, depth 307: 2.5 MB, 0.77 us). The
// first design ran one block per (row, kv head), 16 blocks on 132 SMs at
// B=8, each walking its columns in series. This one splits the columns
// across blocks, flash-decoding style: grid = B x kv x splits, the split
// count from S, B, kv and the card's SM count (never from the depths,
// which live on the device), about two blocks an SM. Each block:
//   - copies its columns below the row's depth into shared memory with
//     cp.async (bf16, or int8 widened exactly to bf16 there);
//   - in bf16, computes the scores S^T = K q^T and the product O^T = V^T
//     p^T with mma.sync m16n8k16, the query rows as the n8 side (at T = 1
//     a kv head's 8 query rows are one n8 tile), p going through shared
//     memory in bf16; in fp32 (fp32 q, fp32 or int8 cache) the same steps
//     on the CUDA cores;
//   - writes a partial (per row: acc [d], its running max m and sum l) to
//     a workspace; a split wholly at or past the depth writes l = 0 and
//     nothing else.
// The last block of each (b, g) to finish, found by an atomic ticket
// that it resets itself, merges the partials in split order (so results
// repeat bit for bit), adds the T fresh columns in fp32 and writes the
// output: one launch a call, as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float MNEG = -1e30f;
constexpr int MAX_SPLITS = 32;
constexpr int MAX_PW = 16;   // bf16: (channel tile, row tile) pairs a warp
constexpr int FMA_ACC = 64;  // fp32: (row, channel) outputs a thread
// dynamic shared memory a block may take: Hopper's 227 KB less the merge
// flag's static 16 bytes
constexpr int SMEM_MAX = 232448 - 16;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
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

struct Args {
  const void* q;       // [B, T, h, D] Tq, contiguous
  const void* k_old;   // [B, S, kv, D] Tc, rows contiguous, batch stride
  const void* v_old;
  const void* k_cur;   // [B, T, kv, D] Tq, contiguous
  const void* v_cur;
  const int* depths;   // [B]
  const float* k_scale;  // [B, S, kv] (int8 cache), batch stride
  const float* v_scale;
  void* out;           // [B, T, h, D] Tq
  float* part;         // [B * kv, splits, R, D]: the splits' acc
  float* stat;         // [B * kv, splits, 2, R]: their m and l
  int* tickets;        // [B * kv], 0 between calls
  long long cache_bstride;  // elements between batch rows of k/v_old
  long long scale_bstride;
  int B, T, h, kv, D, S;
  int CH;      // columns a chunk
  int splits;  // column splits a (b, g)
  int cps;     // columns a split (a multiple of CH)
  float scale;
};

// Shared-memory layout (byte offsets, 16-byte aligned). The chunk phase
// (K, V, the int8 staging, scores, p, scales) and the merge phase (the
// splits' weights and sums, fresh probs) share the first region; q, the
// T fresh K and V rows (q's type) and the row statistics follow. bf16:
// q, K, V as bf16 rows of D + 8 (ldmatrix, conflict-free), p bf16 [R8][CH
// + 8]; fp32: q [R8][D], K, V [CH][D + 1] in fp32, p in place of the
// scores.
struct Layout {
  int k, v, sk, sv, sc, ps, ksc, vsc, w, ls, pf, q, kc, vc, m, l, al, bytes;
};

__host__ __device__ inline int take(int& off, int bytes) {
  const int at = off;
  off += (bytes + 15) / 16 * 16;
  return at;
}

__host__ __device__ inline Layout layout(int R, int D, int T, int CH,
                                         int splits, bool mma, bool quant) {
  Layout L{};
  const int R8 = (R + 7) / 8 * 8;
  int off = 0;
  if (mma) {
    L.k = take(off, 2 * CH * (D + 8));
    L.v = take(off, 2 * CH * (D + 8));
    L.sk = quant ? take(off, CH * D) : 0;
    L.sv = quant ? take(off, CH * D) : 0;
    L.sc = take(off, 4 * R8 * CH);
    L.ps = take(off, 2 * R8 * (CH + 8));
  } else {
    L.k = take(off, 4 * CH * (D + 1));
    L.v = take(off, 4 * CH * (D + 1));
    L.sc = L.ps = take(off, 4 * R8 * CH);
  }
  L.ksc = take(off, 4 * CH);
  L.vsc = take(off, 4 * CH);
  int merge = 0;
  L.w = take(merge, 4 * splits * R8);
  L.ls = take(merge, 4 * splits * R8);
  L.pf = take(merge, 4 * R8 * T);
  off = off > merge ? off : merge;
  L.q = take(off, mma ? 2 * R8 * (D + 8) : 4 * R8 * D);
  L.kc = take(off, (mma ? 2 : 4) * T * D);
  L.vc = take(off, (mma ? 2 : 4) * T * D);
  L.m = take(off, 4 * R8);
  L.l = take(off, 4 * R8);
  L.al = take(off, 4 * R8);
  L.bytes = off;
  return L;
}

// The chunk's online-softmax update, one warp per query row r < R: the
// chunk max over its nv valid columns (the scores sc [R][CH], already
// scaled), m_new = max(m, chunk max), p = exp(s - m_new) (0 past nv), l =
// l alpha + sum p with alpha = exp(m - m_new), then p times the v scales
// (int8 cache) rounded to TP into ps (row stride ldp; may be sc itself).
template <typename TP>
__device__ __forceinline__ void chunk_softmax(const float* sc, TP* ps,
                                              int ldp, float* mrow,
                                              float* lrow, float* arow,
                                              const float* vsc, bool quant,
                                              int nv, int R, int CH) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += WARPS) {
    const float* s = sc + r * CH;
    float mx = MNEG;
    for (int c = lane; c < nv; c += 32) mx = fmaxf(mx, s[c]);
    mx = warp_max(mx);
    const float m_old = mrow[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int c = lane; c < CH; c += 32) {
      float p = c < nv ? expf(s[c] - m_new) : 0.f;
      sum += p;
      if (quant) p *= c < nv ? vsc[c] : 0.f;
      ps[r * ldp + c] = from_f<TP>(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      lrow[r] = lrow[r] * alpha + sum;
      mrow[r] = m_new;
      arow[r] = alpha;
    }
  }
}

// q's R rows of (b, g) (zero-filled to R8; bf16 rows of D + 8, fp32 of
// D) and the T fresh K and V rows, in q's type, into shared memory by
// cp.async (not committed).
template <typename Tq>
__device__ __forceinline__ void load_q_fresh(const Args& a, const Layout& L,
                                             unsigned char* sm, int b,
                                             int g) {
  constexpr int E = 16 / sizeof(Tq);  // elements per 16-byte copy
  const int rep = a.h / a.kv, R = a.T * rep, R8 = (R + 7) / 8 * 8;
  const int D = a.D, LDQ = sizeof(Tq) == 2 ? D + 8 : D;
  const Tq* q = static_cast<const Tq*>(a.q);
  const Tq* kc = static_cast<const Tq*>(a.k_cur);
  const Tq* vc = static_cast<const Tq*>(a.v_cur);
  Tq* qs = reinterpret_cast<Tq*>(sm + L.q);
  Tq* kcs = reinterpret_cast<Tq*>(sm + L.kc);
  Tq* vcs = reinterpret_cast<Tq*>(sm + L.vc);
  for (int i = threadIdx.x; i < R8 * (D / E); i += THREADS) {
    const int r = i / (D / E), e = (i % (D / E)) * E;
    const int t = r / rep, head = g * rep + r % rep;
    const bool ok = r < R;
    vct::cp_async16(qs + r * LDQ + e,
                    ok ? q + (((size_t)b * a.T + t) * a.h + head) * D + e : q,
                    ok);
  }
  for (int i = threadIdx.x; i < a.T * (D / E); i += THREADS) {
    const int t = i / (D / E), e = (i % (D / E)) * E;
    const size_t off = (((size_t)b * a.T + t) * a.kv + g) * D + e;
    vct::cp_async16(kcs + t * D + e, kc + off, true);
    vct::cp_async16(vcs + t * D + e, vc + off, true);
  }
}

// The k / v scales of the chunk's columns (0 past nv).
__device__ __forceinline__ void load_scales(const Args& a, int b, int g,
                                            int c0, int nv, float* ksc,
                                            float* vsc) {
  for (int c = threadIdx.x; c < a.CH; c += THREADS) {
    const size_t off = b * a.scale_bstride + (size_t)(c0 + c) * a.kv + g;
    ksc[c] = c < nv ? a.k_scale[off] : 0.f;
    vsc[c] = c < nv ? a.v_scale[off] : 0.f;
  }
}

// bf16 q: the split's columns [cs, ce) on the tensor cores; writes the
// partial acc [R][D] to part and [m | l] [2][R] to stat.
template <typename Tc>
__device__ __forceinline__ void mma_split(const Args& a, const Layout& L,
                                          unsigned char* sm, int b, int g,
                                          int cs, int ce, float* part,
                                          float* stat) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rep = a.h / a.kv, R = a.T * rep, R8 = (R + 7) / 8 * 8;
  const int D = a.D, CH = a.CH, LD = D + 8, LP = CH + 8;
  const bool quant = a.k_scale != nullptr;
  bf16* qs = reinterpret_cast<bf16*>(sm + L.q);
  bf16* ks = reinterpret_cast<bf16*>(sm + L.k);
  bf16* vs = reinterpret_cast<bf16*>(sm + L.v);
  float* sc = reinterpret_cast<float*>(sm + L.sc);
  bf16* ps = reinterpret_cast<bf16*>(sm + L.ps);
  float* ksc = reinterpret_cast<float*>(sm + L.ksc);
  float* vsc = reinterpret_cast<float*>(sm + L.vsc);
  float* mrow = reinterpret_cast<float*>(sm + L.m);
  float* lrow = reinterpret_cast<float*>(sm + L.l);
  float* arow = reinterpret_cast<float*>(sm + L.al);

  // p rows past R stay 0 (q is in shared memory, its copy in flight)
  for (int i = R * LP + tid; i < R8 * LP; i += THREADS)
    ps[i] = __float2bfloat16(0.f);
  for (int r = tid; r < R8; r += THREADS) {
    mrow[r] = MNEG;
    lrow[r] = 0.f;
    arow[r] = 0.f;
  }
  const int MT = D / 16, P = MT * (R8 / 8);  // p v: (channel, row) tiles
  float acc[MAX_PW][4];
#pragma unroll
  for (int i = 0; i < MAX_PW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const Tc* kb = static_cast<const Tc*>(a.k_old) + b * a.cache_bstride;
  const Tc* vb = static_cast<const Tc*>(a.v_old) + b * a.cache_bstride;
  for (int c0 = cs; c0 < ce; c0 += CH) {
    const int nv = min(CH, ce - c0);
    // the chunk's K and V rows below ce (zero-filled past it)
    if constexpr (sizeof(Tc) == 2) {
      for (int i = tid; i < CH * (D / 8); i += THREADS) {
        const int c = i / (D / 8), e = (i % (D / 8)) * 8;
        const bool ok = c < nv;
        const size_t off = ((size_t)(c0 + c) * a.kv + g) * D + e;
        vct::cp_async16(ks + c * LD + e, ok ? kb + off : kb, ok);
        vct::cp_async16(vs + c * LD + e, ok ? vb + off : vb, ok);
      }
    } else {
      int8_t* sk = reinterpret_cast<int8_t*>(sm + L.sk);
      int8_t* sv = reinterpret_cast<int8_t*>(sm + L.sv);
      for (int i = tid; i < CH * (D / 16); i += THREADS) {
        const int c = i / (D / 16), e = (i % (D / 16)) * 16;
        const bool ok = c < nv;
        const size_t off = ((size_t)(c0 + c) * a.kv + g) * D + e;
        vct::cp_async16(sk + c * D + e, ok ? kb + off : kb, ok);
        vct::cp_async16(sv + c * D + e, ok ? vb + off : vb, ok);
      }
    }
    vct::cp_async_commit();
    if (quant) load_scales(a, b, g, c0, nv, ksc, vsc);
    vct::cp_async_wait<0>();
    __syncthreads();
    if constexpr (sizeof(Tc) == 1) {  // int8 -> bf16, exactly
      const int8_t* sk = reinterpret_cast<const int8_t*>(sm + L.sk);
      const int8_t* sv = reinterpret_cast<const int8_t*>(sm + L.sv);
      for (int i = tid; i < CH * (D / 8); i += THREADS) {
        const int c = i / (D / 8), e = (i % (D / 8)) * 8;
        uint32_t kw[4], vw[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          kw[u] = vct::pack_bf16((float)sk[c * D + e + 2 * u],
                                 (float)sk[c * D + e + 2 * u + 1]);
          vw[u] = vct::pack_bf16((float)sv[c * D + e + 2 * u],
                                 (float)sv[c * D + e + 2 * u + 1]);
        }
        *reinterpret_cast<uint4*>(ks + c * LD + e) =
            make_uint4(kw[0], kw[1], kw[2], kw[3]);
        *reinterpret_cast<uint4*>(vs + c * LD + e) =
            make_uint4(vw[0], vw[1], vw[2], vw[3]);
      }
      __syncthreads();
    }
    // scores S^T = K q^T: (16 columns, 8 rows) tiles over the warps;
    // fragment e holds column 16 mi + g (+ 8 for e >= 2), row 8 nj + 2t
    // (+ 1 for odd e)
    const int ctiles = (nv + 15) / 16;
    for (int pi = warp; pi < ctiles * (R8 / 8); pi += WARPS) {
      const int mi = pi % ctiles, nj = pi / ctiles;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t af[4], bfr[2];
        vct::ldsm_x4(af, ks + (mi * 16 + (lane & 15)) * LD + kk +
                             (lane >> 4) * 8);
        vct::ldsm_x2(bfr, qs + (nj * 8 + (lane & 7)) * LD + kk +
                              ((lane >> 3) & 1) * 8);
        vct::mma_bf16(s, af, bfr[0], bfr[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = mi * 16 + gq + 8 * (e >> 1), r = nj * 8 + 2 * tq + (e & 1);
        const float v = quant ? s[e] * ksc[c] : s[e];
        sc[r * CH + c] = v * a.scale;
      }
    }
    __syncthreads();
    chunk_softmax<bf16>(sc, ps, LP, mrow, lrow, arow, vsc, quant, nv, R, CH);
    __syncthreads();
    // O^T = O^T alpha + V^T p^T over the chunk's 16-column steps
#pragma unroll
    for (int i = 0; i < MAX_PW; ++i) {
      const int pi = warp + i * WARPS;
      if (pi < P) {
        const int mi = pi % MT, nj = pi / MT, r0 = nj * 8 + 2 * tq;
        const float a0 = arow[r0], a1 = arow[r0 + 1];
        acc[i][0] *= a0;
        acc[i][1] *= a1;
        acc[i][2] *= a0;
        acc[i][3] *= a1;
        for (int kk = 0; kk < ctiles * 16; kk += 16) {
          uint32_t af[4], bfr[2];
          vct::ldsm_x4_t(af, vs + (kk + (lane & 7) + (lane >> 4) * 8) * LD +
                                 mi * 16 + ((lane >> 3) & 1) * 8);
          vct::ldsm_x2(bfr, ps + (nj * 8 + (lane & 7)) * LP + kk +
                                ((lane >> 3) & 1) * 8);
          vct::mma_bf16(acc[i], af, bfr[0], bfr[1]);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites K, V, the scores and p
  }
  // the partial: acc [R][D] (fragment e: channel 16 mi + g (+ 8 for e >=
  // 2), row 8 nj + 2t (+ 1 for odd e)), then m and l
#pragma unroll
  for (int i = 0; i < MAX_PW; ++i) {
    const int pi = warp + i * WARPS;
    if (pi < P) {
      const int mi = pi % MT, nj = pi / MT;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = mi * 16 + gq + 8 * (e >> 1), r = nj * 8 + 2 * tq + (e & 1);
        if (r < R) part[r * D + ch] = acc[i][e];
      }
    }
  }
  for (int r = tid; r < R; r += THREADS) {
    stat[r] = mrow[r];
    stat[R + r] = lrow[r];
  }
}

// fp32 q: the same split on the CUDA cores (fp32 or int8 cache), each
// thread owning up to FMA_ACC (row, channel) accumulators.
template <typename Tc>
__device__ __forceinline__ void fma_split(const Args& a, const Layout& L,
                                          unsigned char* sm, int b, int g,
                                          int cs, int ce, float* part,
                                          float* stat) {
  const int tid = threadIdx.x;
  const int rep = a.h / a.kv, R = a.T * rep, D = a.D, CH = a.CH, ld = D + 1;
  const bool quant = a.k_scale != nullptr;
  float* qs = reinterpret_cast<float*>(sm + L.q);
  float* ks = reinterpret_cast<float*>(sm + L.k);
  float* vs = reinterpret_cast<float*>(sm + L.v);
  float* sc = reinterpret_cast<float*>(sm + L.sc);
  float* ksc = reinterpret_cast<float*>(sm + L.ksc);
  float* vsc = reinterpret_cast<float*>(sm + L.vsc);
  float* mrow = reinterpret_cast<float*>(sm + L.m);
  float* lrow = reinterpret_cast<float*>(sm + L.l);
  float* arow = reinterpret_cast<float*>(sm + L.al);
  for (int r = tid; r < R; r += THREADS) {
    mrow[r] = MNEG;
    lrow[r] = 0.f;
  }
  float acc[FMA_ACC];
#pragma unroll
  for (int i = 0; i < FMA_ACC; ++i) acc[i] = 0.f;
  constexpr int EV = 16 / sizeof(Tc);  // elements per 16-byte load
  const Tc* kb = static_cast<const Tc*>(a.k_old) + b * a.cache_bstride;
  const Tc* vb = static_cast<const Tc*>(a.v_old) + b * a.cache_bstride;
  for (int c0 = cs; c0 < ce; c0 += CH) {
    const int nv = min(CH, ce - c0);
    for (int i = tid; i < CH * (D / EV); i += THREADS) {
      const int c = i / (D / EV), e0 = (i % (D / EV)) * EV;
      float* kd = ks + c * ld + e0;
      float* vd = vs + c * ld + e0;
      if (c < nv) {
        const size_t off = ((size_t)(c0 + c) * a.kv + g) * D + e0;
        const uint4 kr = *reinterpret_cast<const uint4*>(kb + off);
        const uint4 vr = *reinterpret_cast<const uint4*>(vb + off);
        const Tc* ke = reinterpret_cast<const Tc*>(&kr);
        const Tc* ve = reinterpret_cast<const Tc*>(&vr);
#pragma unroll
        for (int u = 0; u < EV; ++u) {
          kd[u] = to_f(ke[u]);
          vd[u] = to_f(ve[u]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < EV; ++u) kd[u] = vd[u] = 0.f;
      }
    }
    if (quant) load_scales(a, b, g, c0, nv, ksc, vsc);
    vct::cp_async_wait<0>();  // q (the prologue's copies)
    __syncthreads();
    for (int i = tid; i < R * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      if (c >= nv) continue;
      const float* qr = qs + r * D;
      const float* kr = ks + c * ld;
      float d0 = 0.f;
      for (int e = 0; e < D; ++e) d0 = fmaf(qr[e], kr[e], d0);
      if (quant) d0 *= ksc[c];
      sc[i] = d0 * a.scale;
    }
    __syncthreads();
    chunk_softmax<float>(sc, sc, CH, mrow, lrow, arow, vsc, quant, nv, R,
                         CH);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < FMA_ACC; ++i) {
      const int j = tid + i * THREADS;
      if (j < R * D) {
        const int r = j / D, e = j % D;
        const float* pr = sc + r * CH;
        float s = 0.f;
        for (int c = 0; c < nv; ++c) s = fmaf(pr[c], vs[c * ld + e], s);
        acc[i] = acc[i] * arow[r] + s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < FMA_ACC; ++i) {
    const int j = tid + i * THREADS;
    if (j < R * D) part[j] = acc[i];
  }
  for (int r = tid; r < R; r += THREADS) {
    stat[r] = mrow[r];
    stat[R + r] = lrow[r];
  }
}

// The last block of (b, g) to finish merges: per row, M = the largest
// running max of the non-empty splits, weights w_s = exp(m_s - M), l =
// sum l_s w_s and acc = sum acc_s w_s in split order; then the T fresh
// columns (causal, fp32: scores, max, exp, alpha) as the reference's last
// grid step; out = (acc alpha + sum_t' p_t' v_t') / l in q's type. It
// resets the ticket for the next call. Every block holds q and the fresh
// rows in shared memory (the prologue's copies), so the merge reads only
// the partials from device memory: the splits' m and l first, all at
// once, then each output's acc_s, several splits' loads in flight.
template <typename Tq>
__device__ __forceinline__ void finish(const Args& a, const Layout& L,
                                       unsigned char* sm, int b, int g,
                                       int bg) {
  __shared__ int last;
  vct::cp_async_wait<0>();
  __threadfence();  // this block's partial, visible to the merging block
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.tickets + bg, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep = a.h / a.kv, R = a.T * rep, R8 = (R + 7) / 8 * 8;
  const int D = a.D, T = a.T, ns = a.splits;
  const int LDQ = sizeof(Tq) == 2 ? D + 8 : D;
  const float* acc_s = a.part + (size_t)bg * ns * R * D;  // [ns][R][D]
  const float* st_s = a.stat + (size_t)bg * ns * 2 * R;  // [ns][2][R]
  float* w = reinterpret_cast<float*>(sm + L.w);    // [splits][R8]: m, w
  float* ls = reinterpret_cast<float*>(sm + L.ls);  // [splits][R8]
  float* pf = reinterpret_cast<float*>(sm + L.pf);  // [R8][T]
  float* lrow = reinterpret_cast<float*>(sm + L.l);
  float* arow = reinterpret_cast<float*>(sm + L.al);
  const Tq* qs = reinterpret_cast<const Tq*>(sm + L.q);
  const Tq* kcs = reinterpret_cast<const Tq*>(sm + L.kc);
  const Tq* vcs = reinterpret_cast<const Tq*>(sm + L.vc);
  for (int i = tid; i < ns * R; i += THREADS) {
    const int sp = i / R, r = i % R;
    w[sp * R8 + r] = __ldcg(st_s + sp * 2 * R + r);  // unread when empty
    ls[sp * R8 + r] = __ldcg(st_s + sp * 2 * R + R + r);
  }
  // the fresh scores q_r . k_t' scale, t' <= t(r): a warp a pair
  for (int i = warp; i < R * T; i += WARPS) {
    const int r = i / T, tp = i % T;
    if (tp > r / rep) continue;
    const Tq* qr = qs + r * LDQ;
    const Tq* kr = kcs + tp * D;
    float d0 = 0.f;
    for (int e = lane; e < D; e += 32) d0 = fmaf(to_f(qr[e]), to_f(kr[e]), d0);
    d0 = warp_sum(d0);
    if (lane == 0) pf[r * T + tp] = d0 * a.scale;
  }
  __syncthreads();
  for (int r = tid; r < R; r += THREADS) {
    float M = MNEG;
    for (int sp = 0; sp < ns; ++sp)
      if (ls[sp * R8 + r] > 0.f) M = fmaxf(M, w[sp * R8 + r]);
    float l = 0.f;
    for (int sp = 0; sp < ns; ++sp) {
      const float lsp = ls[sp * R8 + r];
      const float wsp = lsp > 0.f ? expf(w[sp * R8 + r] - M) : 0.f;
      w[sp * R8 + r] = wsp;
      l += lsp * wsp;
    }
    const int t = r / rep;
    float mx = MNEG;
    for (int tp = 0; tp <= t; ++tp) mx = fmaxf(mx, pf[r * T + tp]);
    const float mn = fmaxf(M, mx);
    float sum = 0.f;
    for (int tp = 0; tp <= t; ++tp) {
      const float p = expf(pf[r * T + tp] - mn);
      pf[r * T + tp] = p;
      sum += p;
    }
    const float alpha = expf(M - mn);
    arow[r] = alpha;
    lrow[r] = l * alpha + sum;
  }
  __syncthreads();
  // 4 channels a thread, 8 splits' 16-byte loads in flight together (16
  // spilled the fp32 instantiation's registers); an empty split's weight
  // is 0 and its (stale) acc drops out
  Tq* out = static_cast<Tq*>(a.out);
  for (int j = tid; j < R * (D / 4); j += THREADS) {
    const int r = j / (D / 4), e = (j % (D / 4)) * 4;
    const int t = r / rep, head = g * rep + r % rep;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int sp = 0; sp < ns; ++sp) {
      const float wsp = w[sp * R8 + r];
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          acc_s + ((size_t)sp * R + r) * D + e));
      acc[0] += wsp != 0.f ? v.x * wsp : 0.f;
      acc[1] += wsp != 0.f ? v.y * wsp : 0.f;
      acc[2] += wsp != 0.f ? v.z * wsp : 0.f;
      acc[3] += wsp != 0.f ? v.w * wsp : 0.f;
    }
    Tq* o = out + (((size_t)b * T + t) * a.h + head) * D + e;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float fresh = 0.f;
      for (int tp = 0; tp <= t; ++tp)
        fresh = fresh + pf[r * T + tp] * to_f(vcs[tp * D + e + u]);
      o[u] = from_f<Tq>((acc[u] * arow[r] + fresh) / lrow[r]);
    }
  }
  if (tid == 0) a.tickets[bg] = 0;
}

template <typename Tq, typename Tc>
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char sm[];
  constexpr bool MMA = sizeof(Tq) == 2;
  const int bg = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  const int b = bg / a.kv, g = bg % a.kv;
  const int R = a.T * (a.h / a.kv);
  const Layout L = layout(R, a.D, a.T, a.CH, a.splits, MMA,
                          a.k_scale != nullptr);
  const int depth = min(max(a.depths[b], 0), a.S);
  const int cs = split * a.cps, ce = min(cs + a.cps, depth);
  const size_t at = (size_t)bg * a.splits + split;
  float* part = a.part + at * R * a.D;
  float* stat = a.stat + at * 2 * R;
  load_q_fresh<Tq>(a, L, sm, b, g);
  vct::cp_async_commit();
  if (cs < ce) {
    if constexpr (MMA)
      mma_split<Tc>(a, L, sm, b, g, cs, ce, part, stat);
    else
      fma_split<Tc>(a, L, sm, b, g, cs, ce, part, stat);
  } else {  // every column at or past the depth: an empty partial
    for (int r = threadIdx.x; r < R; r += THREADS)
      stat[R + r] = 0.f;
  }
  finish<Tq>(a, L, sm, b, g, bg);
}

// Columns a chunk: 64, fewer for heads past 128 (fp32 rows of D + 1).
int chunk_cols(int D) {
  if (D <= 128) return 64;
  const int c = 8192 / D / 16 * 16;
  return c > 16 ? c : 16;
}

// The split: about two blocks an SM over B * kv * splits, whole chunks,
// at most MAX_SPLITS.
void plan(Args& a) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  a.CH = chunk_cols(a.D);
  const int chunks = (a.S + a.CH - 1) / a.CH;
  const long long work = (long long)chunks * a.B * a.kv;
  int per = (int)((work + 2 * sms - 1) / (2 * sms));
  const int least = (chunks + MAX_SPLITS - 1) / MAX_SPLITS;
  per = per > least ? per : least;
  per = per > 1 ? per : 1;
  a.splits = (chunks + per - 1) / per;
  a.cps = per * a.CH;
}

size_t ws_bytes(const Args& a) {
  const size_t tickets = ((size_t)a.B * a.kv * 4 + 255) / 256 * 256;
  const size_t R = (size_t)a.T * (a.h / a.kv);
  return tickets + sizeof(float) * a.B * a.kv * a.splits * R * (a.D + 2);
}

// The workspace: the tickets, then the partials' acc, then their m, l.
void carve(Args& a, void* ws) {
  const size_t R = (size_t)a.T * (a.h / a.kv);
  a.tickets = static_cast<int*>(ws);
  a.part = reinterpret_cast<float*>(static_cast<char*>(ws) +
                                    ((size_t)a.B * a.kv * 4 + 255) / 256 *
                                        256);
  a.stat = a.part + (size_t)a.B * a.kv * a.splits * R * a.D;
}

Layout layout_of(const Args& a, int q_type, int cache_type) {
  return layout(a.T * (a.h / a.kv), a.D, a.T, a.CH, a.splits, q_type == 1,
                cache_type == 2);
}

template <typename Tq, typename Tc>
cudaError_t launch(const Args& a, size_t bytes, cudaStream_t st) {
  auto kern = decode_attention_kernel<Tq, Tc>;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  kern<<<a.B * a.kv * a.splits, THREADS, bytes, st>>>(a);
  return cudaGetLastError();
}

Args shape(int B, int T, int h, int kv, int D, int S) {
  Args a{};
  a.B = B;
  a.T = T;
  a.h = h;
  a.kv = kv;
  a.D = D;
  a.S = S;
  plan(a);
  return a;
}

}  // namespace

// Bytes of workspace vct_decode_attention takes at these shapes (the
// tickets, zeroed once when it is allocated, then the partials).
extern "C" unsigned long long vct_decode_attention_ws(int B, int T, int h,
                                                      int kv, int D, int S) {
  if (kv < 1 || h % kv || B < 1 || T < 1 || S < 1 || D < 1) return 0;
  return ws_bytes(shape(B, T, h, kv, D, S));
}

// The column splits of a (b, g) and the shared memory a block takes.
extern "C" int vct_decode_attention_splits(int B, int kv, int D, int S) {
  return shape(B, 1, kv, kv, D, S).splits;
}

extern "C" unsigned long long vct_decode_attention_smem(
    int q_type, int cache_type, int B, int T, int h, int kv, int D, int S) {
  if (kv < 1 || h % kv) return 0;
  return layout_of(shape(B, T, h, kv, D, S), q_type, cache_type).bytes;
}

// q_type / cache_type: 0 fp32, 1 bf16, 2 int8 (cache only, with scales);
// a float cache has q's type (the wrapper casts any other). ws:
// vct_decode_attention_ws bytes, 16-byte aligned, its tickets zero (the
// kernel leaves them zero); one call at a time per workspace.
extern "C" int vct_decode_attention(
    int q_type, int cache_type, const void* q, const void* k_old,
    const void* v_old, const void* k_cur, const void* v_cur,
    const int* depths, const float* k_scale, const float* v_scale, void* out,
    void* ws, long long cache_bstride, long long scale_bstride, int B, int T,
    int h, int kv, int D, int S, float scale, void* stream) {
  if (kv < 1 || h % kv || D % 16 || T < 1 || T > 64 || B < 1 || S < 1 ||
      (cache_type == 2) != (k_scale != nullptr) || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a = shape(B, T, h, kv, D, S);
  a.q = q;
  a.k_old = k_old;
  a.v_old = v_old;
  a.k_cur = k_cur;
  a.v_cur = v_cur;
  a.depths = depths;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.out = out;
  a.cache_bstride = cache_bstride;
  a.scale_bstride = scale_bstride;
  a.scale = scale;
  carve(a, ws);
  const int R = T * (h / kv), R8 = (R + 7) / 8 * 8;
  // register budgets: bf16, (D / 16) x (R8 / 8) output tiles over 8 warps
  // of MAX_PW; fp32, R D outputs over 256 threads of FMA_ACC
  if (q_type == 1 ? (D / 16) * (R8 / 8) > MAX_PW * WARPS
                  : R * D > FMA_ACC * THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = layout_of(a, q_type, cache_type).bytes;
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_type == 1) {
    if (cache_type == 1) return (int)launch<bf16, bf16>(a, bytes, st);
    if (cache_type == 2) return (int)launch<bf16, int8_t>(a, bytes, st);
  } else if (q_type == 0) {
    if (cache_type == 0) return (int)launch<float, float>(a, bytes, st);
    if (cache_type == 2) return (int)launch<float, int8_t>(a, bytes, st);
  }
  return (int)cudaErrorInvalidValue;
}
