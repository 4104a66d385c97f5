// Paged attention for Hopper (sm_90a): queries over a KV page pool plus the
// current, not yet written chunk, bf16 or int8 pool with per-(token, head)
// scales.
//
// Replaces the two Pallas TPU kernels of llava_plus_tpu/ops/paged_attention.py
// (launched by paged_decode_attention):
//   paged_decode1_kernel  <- _kernel_decode1: one query row per kv head
//                            (G * Tq == 1, the MHA decode step);
//   paged_general_kernel  <- _kernel: the G * Tq query rows of a kv head
//                            (GQA/MQA, chunks of up to 8 tokens), causal
//                            within the chunk.
// Same function as the plain version (ops/paged_attention.py:
// paged_attention_reference): a slot's `lengths[b]` past tokens are read
// through its page list; for int8 the k scale is folded into the scores and
// the v scale into the probabilities; the current chunk (cur_k / cur_v, chunk
// token j at position lengths + j, valid prefix cur_valid[b]) is folded in as
// a final self block, exactly as the Pallas kernels' _finish does. With
// per-head f32 slopes (MPT's ALiBi, the Pallas kernels' has_alibi) each
// scaled score loses `slope_h * (q_pos - kv_pos)`: a query row of chunk token
// t sits at q_pos = lengths + t (at lengths - 1 without a current chunk, its
// own KV already pooled), pool token s at kv_pos = s, chunk token j at
// lengths + j (so t - j in the self block); the row of column c = g * Tq + t
// takes head kvh * G + g's slope. The Mosaic
// layout workarounds of the Pallas kernels (the block-diagonal query, the
// head-major relayout of each page block) are not carried over.
//
// What bounds it on the card: each page byte a slot uses is read once and
// feeds ~2 flops per query row, far below the H100's bf16 ridge: HBM-bound.
// Pages are token-major [NP, 2, P, Hkv, D], so one token of one head is D
// contiguous elements at a stride of Hkv * D; scales are head-major [NP, 2,
// Hkv, P]. Page offsets are 64-bit: a 7B layer's pool is 2.7e8 elements.
//
// decode1 (the MHA decode step of every paged engine) is the dense decode
// kernel's design (csrc/decode_attention.cu) moved onto the page table: one
// block per (kv head, slot) would be paced by the longest slot, and a
// warp-sum of shuffles per token by its dependent chain, so:
//   split    each slot's maxp * P token positions are cut into `splits`
//            chunks of whole 64-token tiles (ops/paged_attention.
//            decode1_splits, from static shapes: graph-capturable), one block
//            per (chunk, slot x head), so one long slot is spread over many
//            SMs; a chunk that starts past the slot's length writes the empty
//            partial (m = -inf, l = 0);
//   tiles    64 tokens' K and V rows (and their scales) stream through a
//            3-stage cp.async ring, every token through its own page id (the
//            block reads its page list itself; pages smaller than a tile
//            work the same way), 4 warps sharing a tile, 16 tokens each;
//   products S^T = K q^T and O^T += V^T P^T as mma.sync m16n8k16, the tokens
//            (and D) on the m16 side and the single query as column 0 of n8;
//            f32 sums; P (times the v scale) enters as hi / lo bf16 halves
//            (~16 bits, as the Pallas kernel's f32 products keep); int8
//            converts to bf16 exactly with integer and add instructions;
//   combine  the warps merge in warp order into the chunk's partial in a
//            workspace, and the last block of a (slot, head) to finish (a
//            counter per (slot, head) in a zeroed int32 buffer that the wrapper
//            keeps; that block resets it) sums the partials in chunk order,
//            folds in the current token's self block and writes the row: no
//            atomics in any sum, one launch, no host sync.
// The general kernel (GQA / MQA, chunks of up to 8 tokens) keeps the first
// design: each warp reads whole 256-byte (bf16) or 128-byte (int8) rows with
// one coalesced load per lane, 8 tokens in flight, one block per (kv head,
// slot, group of 8 query rows), each page row read once for all the rows
// of a block.
//
// Layout: q [B, Tq, H, D] strided, D = 128; cur_k / cur_v [B, Tq, Hkv, D]
// strided; pool [NP, 2, P, Hkv, D] and scales [NP, 2, Hkv, P] contiguous;
// page_ids [B, maxp] int32 (row stride pt_sb); lengths, valid [B] int32; out
// [B, Tq, H, D] contiguous bf16.

#include "warp_mma.cuh"

#include <math_constants.h>

namespace {

using namespace warp_mma;

constexpr int HD = 128;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int KB = 8;      // tokens in flight per warp
constexpr int MAXR = 8;    // query rows per block of the general kernel
constexpr int MAXT = 8;    // chunk tokens in the self block
constexpr int D1_TILE = 64;     // pool tokens of a ring stage (decode1)
constexpr int D1_STAGES = 3;    // ring stages (decode1)
constexpr int MAX_SPLITS = 64;  // chunks of a slot (decode1)
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // the JAX mask value

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  x[0] = fa.x; x[1] = fa.y; x[2] = fb.x; x[3] = fb.y;
}

__device__ __forceinline__ void load4(const int8_t* p, float* x) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  x[0] = (float)c.x; x[1] = (float)c.y; x[2] = (float)c.z; x[3] = (float)c.w;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* cur_k;
  const __nv_bfloat16* cur_v;
  const void* pool;
  const float* scale;
  const int* page_ids;
  const int* lengths;
  const int* valid;
  const float* slopes;   // [H] f32 ALiBi slopes, or null
  __nv_bfloat16* out;
  int P, H, Hkv, Tq, maxp, has_cur;
  int q_sb, q_st, q_sh, c_sb, c_st, c_sh, pt_sb;
  float sm_scale;
};

// Online softmax of `nrows` query rows (this lane's 4 columns in qr) over
// the slot's first `len` pool tokens; each warp takes every NWARPS-th run of
// KB tokens. Tokens past `len` take no part (never read). Row r's ALiBi term
// is slope[r] * (qpos[r] - s) (slope 0 without ALiBi).
template <typename CacheT, bool QUANT, int ROWS>
__device__ __forceinline__ void sweep_pool(const Args& a, int b, int kvh, int len,
                                           int nrows, const float (&qr)[ROWS][4],
                                           const float (&slope)[ROWS], const int (&qpos)[ROWS],
                                           float (&m)[ROWS], float (&l)[ROWS],
                                           float (&acc)[ROWS][4]) {
  const int warp = threadIdx.x >> 5;
  const int d0 = (threadIdx.x & 31) * 4;
  const CacheT* pool = static_cast<const CacheT*>(a.pool);
  const size_t tok = (size_t)a.Hkv * HD;   // token to token within a page
  const size_t half = (size_t)a.P * tok;   // a page's K block to its V block
  const size_t shalf = (size_t)a.Hkv * a.P;
  const int* pt = a.page_ids + (size_t)b * a.pt_sb;

  for (int s0 = warp * KB; s0 < len; s0 += NWARPS * KB) {
    float kx[KB][4], vx[KB][4], ks[KB], vs[KB];
    bool present[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const int s = s0 + j;
      present[j] = s < len;
      if (present[j]) {
        const int pi = s / a.P;
        const int off = s - pi * a.P;
        const size_t page = (size_t)pt[pi];
        const CacheT* kp = pool + page * 2 * half + (size_t)off * tok + (size_t)kvh * HD + d0;
        load4(kp, kx[j]);
        load4(kp + half, vx[j]);
        if (QUANT) {
          const float* sp = a.scale + page * 2 * shalf + (size_t)kvh * a.P + off;
          ks[j] = sp[0];
          vs[j] = sp[shalf];
        }
      } else {
        // absent token: every value it feeds stays finite (its weight is 0)
        ks[j] = vs[j] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) kx[j][i] = vx[j][i] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= nrows) break;
      float sc[KB];
      float mb = m[r];
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        float dot = qr[r][0] * kx[j][0] + qr[r][1] * kx[j][1] +
                    qr[r][2] * kx[j][2] + qr[r][3] * kx[j][3];
        dot = warp_sum(dot);
        if (QUANT) dot *= ks[j];
        sc[j] = present[j]
                    ? dot * a.sm_scale - slope[r] * static_cast<float>(qpos[r] - (s0 + j))
                    : -CUDART_INF_F;
        mb = fmaxf(mb, sc[j]);
      }
      const float alpha = expf(m[r] - mb);
      m[r] = mb;
      float lsum = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        float p = expf(sc[j] - mb);
        lsum += p;
        if (QUANT) p *= vs[j];
        a0 += p * vx[j][0];
        a1 += p * vx[j][1];
        a2 += p * vx[j][2];
        a3 += p * vx[j][3];
      }
      l[r] = l[r] * alpha + lsum;
      acc[r][0] = acc[r][0] * alpha + a0;
      acc[r][1] = acc[r][1] * alpha + a1;
      acc[r][2] = acc[r][2] * alpha + a2;
      acc[r][3] = acc[r][3] * alpha + a3;
    }
  }
}

// The warps' partial softmax states, gathered in shared memory.
template <int ROWS>
struct Partials {
  float m[NWARPS][ROWS];
  float l[NWARPS][ROWS];
  float acc[NWARPS][ROWS][HD];
};

template <int ROWS>
__device__ __forceinline__ void store_partials(Partials<ROWS>& sm, int nrows,
                                               const float (&m)[ROWS], const float (&l)[ROWS],
                                               const float (&acc)[ROWS][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= nrows) break;
    if (lane == 0) {
      sm.m[warp][r] = m[r];
      sm.l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sm.acc[warp][r][lane * 4 + i] = acc[r][i];
  }
}

// Row r's merged pool state for output column d (one thread per column).
template <int ROWS>
__device__ __forceinline__ void merge_row(const Partials<ROWS>& sm, int r, int d,
                                          float& mx, float& lt, float& o) {
  mx = sm.m[0][r];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) mx = fmaxf(mx, sm.m[w][r]);
  lt = 0.f;
  o = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    const float f = expf(sm.m[w][r] - mx);
    lt += sm.l[w][r] * f;
    o += sm.acc[w][r][d] * f;
  }
}

// _kernel_decode1: one query row per (slot b, kv head h) (Tq == 1, H ==
// Hkv), the slot's pool tokens cut into `splits` chunks of whole 64-token
// tiles, one block per (chunk, slot x head); see the note at the top.
template <typename CacheT>
__host__ __device__ constexpr int d1_stage_bytes() {
  return 2 * D1_TILE * Elem<CacheT>::LDS + 2 * D1_TILE * 4;   // K, V rows; k, v scales
}

template <typename CacheT>
__host__ __device__ constexpr int d1_smem_bytes() {
  return D1_STAGES * d1_stage_bytes<CacheT>();
}

template <typename CacheT, bool QUANT>
__global__ void __launch_bounds__(NTHREADS, 2)
paged_decode1_kernel(const Args a, float* __restrict__ ws, int* __restrict__ counters,
                     int splits) {
  using E = Elem<CacheT>;
  constexpr int LDS = E::LDS;
  constexpr int STAGE = d1_stage_bytes<CacheT>();
  constexpr int NST = D1_STAGES;
  constexpr int KW = D1_TILE / NWARPS;   // a warp's 16 tokens of a tile
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  __shared__ float s_self;

  const int c = blockIdx.x;                  // chunk of the slot's tokens
  const int b = blockIdx.y / a.Hkv;
  const int h = blockIdx.y % a.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int len = min(a.lengths[b], a.maxp * a.P);
  // the query sits at `lengths` with a current chunk, else at lengths - 1
  const int qp = a.has_cur ? a.lengths[b] : a.lengths[b] - 1;
  const int n_tiles = (a.maxp * a.P + D1_TILE - 1) / D1_TILE;
  const int per = (n_tiles + splits - 1) / splits;
  const int s_begin = c * per * D1_TILE;
  const int s_end = min(min(n_tiles, (c + 1) * per) * D1_TILE, len);
  const int nt = s_end > s_begin ? (s_end - s_begin + D1_TILE - 1) / D1_TILE : 0;
  float* part = ws + ((size_t)blockIdx.y * splits + c) * (HD + 2);

  if (nt == 0) {
    // the chunk starts past the slot's tokens: the empty partial
    if (tid == 0) {
      part[HD] = -CUDART_INF_F;
      part[HD + 1] = 0.f;
    }
  } else {
    const CacheT* pool = static_cast<const CacheT*>(a.pool);
    const size_t tok = (size_t)a.Hkv * HD;     // token to token within a page
    const size_t half = (size_t)a.P * tok;     // a page's K block to its V block
    const size_t shalf = (size_t)a.Hkv * a.P;  // the same in the scales
    const int* pt = a.page_ids + (size_t)b * a.pt_sb;
    const int p_shift = (a.P & (a.P - 1)) == 0 ? __ffs(a.P) - 1 : -1;   // pages of 2^n tokens

    // Tile i (tokens s_begin + 64 i ...) into stage i % NST, each token's
    // K and V rows through its own page; tokens at or past s_end are
    // zero-filled (a zero value times a zero probability stays 0).
    auto load_tile = [&](int i) {
      unsigned char* st = smem + (i % NST) * STAGE;
      const int sb = s_begin + i * D1_TILE;
      constexpr int CH = E::ROW / 16;               // 16-byte chunks of a row
      for (int x = tid; x < D1_TILE * CH; x += NTHREADS) {
        const int r = x / CH, ch = x % CH;
        const int s = sb + r;
        const bool in = s < s_end;
        const int pi = p_shift >= 0 ? s >> p_shift : s / a.P;
        const size_t row = in ? (size_t)__ldg(pt + pi) * 2 * half +
                                    (size_t)(s - pi * a.P) * tok + (size_t)h * HD
                              : 0;
        const unsigned char* src = reinterpret_cast<const unsigned char*>(pool + row) + ch * 16;
        cp_async16(st + r * LDS + ch * 16, src, in);
        cp_async16(st + (D1_TILE + r) * LDS + ch * 16, src + half * sizeof(CacheT), in);
      }
      if (QUANT) {
        // thread r < 64: the k scale of token r; thread 64 + r: its v scale
        const int r = tid % D1_TILE, which = tid / D1_TILE;
        const int s = sb + r;
        const bool in = s < s_end;
        const int pi = p_shift >= 0 ? s >> p_shift : s / a.P;
        const float* src = a.scale;
        if (in)
          src += ((size_t)__ldg(pt + pi) * 2 + which) * shalf + (size_t)h * a.P + s - pi * a.P;
        cp_async4(st + 2 * D1_TILE * LDS + (which * D1_TILE + r) * 4, src, in);
      }
    };
#pragma unroll
    for (int i = 0; i < NST - 1; ++i) {
      if (i < nt) load_tile(i);
      cp_async_commit();
    }

    // S^T = K q^T and O^T += V^T P^T: the tokens (and D) as m16, the query
    // as column 0 of n8 (lanes with g == 0 hold it; the other columns are
    // zero), so each thread's row 2t accumulators carry the query's row
    // where t == 0 and zeros elsewhere.
    uint32_t qb[8][2];
    {
      const __nv_bfloat16* qr = a.q + (size_t)b * a.q_sb + (size_t)h * a.q_sh;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int col = 16 * ks + 2 * t;
        qb[ks][0] = g == 0 ? *reinterpret_cast<const uint32_t*>(qr + col) : 0u;
        qb[ks][1] = g == 0 ? *reinterpret_cast<const uint32_t*>(qr + col + 8) : 0u;
      }
    }
    const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
    float acc[8][4];   // [D tile][(d g | d g + 8) x (column 2t | 2t + 1)]
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    // running max from the mask value, as the dense decode kernel's
    float m = NEG_INF, l = 0.f;

    for (int i = 0; i < nt; ++i) {
      cp_async_wait<NST - 2>();
      __syncthreads();   // tile i landed for all; tile i - 1's stage is free
      if (i + NST - 1 < nt) load_tile(i + NST - 1);
      cp_async_commit();

      const unsigned char* st = smem + (i % NST) * STAGE;
      const unsigned char* kt = st + warp * KW * LDS;
      const unsigned char* vt = st + (D1_TILE + warp * KW) * LDS;
      const float* ks_s = reinterpret_cast<const float*>(st + 2 * D1_TILE * LDS) + warp * KW;
      const float* vs_s = ks_s + D1_TILE;
      const int sw = s_begin + i * D1_TILE + warp * KW;   // this warp's first token

      // S^T over the warp's 16 tokens: two chains of four k-steps
      float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
      const unsigned char* k0 = kt + g * LDS;
      const unsigned char* k8 = k0 + 8 * LDS;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int e0 = (16 * ks + 2 * t) * sizeof(CacheT), e8 = e0 + 8 * sizeof(CacheT);
        const uint32_t af[4] = {E::pair(k0 + e0), E::pair(k8 + e0), E::pair(k0 + e8),
                                E::pair(k8 + e8)};
        mma_16816((ks & 1) ? sb : sa, af, qb[ks][0], qb[ks][1]);
      }
      // column 2t: token g (element 0) and token g + 8 (element 2)
      float x0 = sa[0] + sb[0], x2 = sa[2] + sb[2];
      if (QUANT) {
        x0 *= ks_s[g];
        x2 *= ks_s[g + 8];
      }
      x0 = x0 * a.sm_scale - slope * static_cast<float>(qp - (sw + g));
      x2 = x2 * a.sm_scale - slope * static_cast<float>(qp - (sw + g + 8));
      if (sw + g >= s_end) x0 = -CUDART_INF_F;
      if (sw + g + 8 >= s_end) x2 = -CUDART_INF_F;
      float mx = fmaxf(m, fmaxf(x0, x2));
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float alpha = __expf(m - mx);
      m = mx;
      float p0 = __expf(x0 - m), p2 = __expf(x2 - m);
      l = l * alpha + p0 + p2;
      if (QUANT) {
        p0 *= vs_s[g];
        p2 *= vs_s[g + 8];
      }
      if (__any_sync(FULL, alpha != 1.f)) {   // the max moved
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          acc[dt][0] *= alpha;
          acc[dt][2] *= alpha;
        }
      }
      // P^T as the B operand: lane (0, t) takes P[tokens 2t, 2t + 1, 2t + 8,
      // 2t + 9] from lanes 8t and 8t + 4 (g = 2t, 2t + 1 at t = 0), as hi /
      // lo bf16 halves; every other column of B is zero
      const float y0 = __shfl_sync(FULL, p0, 8 * t), y1 = __shfl_sync(FULL, p0, 8 * t + 4);
      const float z0 = __shfl_sync(FULL, p2, 8 * t), z1 = __shfl_sync(FULL, p2, 8 * t + 4);
      uint32_t hi[2] = {0u, 0u}, lo[2] = {0u, 0u};
      if (g == 0) {
        const float pv[4] = {y0, y1, z0, z1};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const uint32_t h0 = bf16_bits(pv[2 * u]), h1 = bf16_bits(pv[2 * u + 1]);
          hi[u] = pack_hi(h0, h1);
          lo[u] = pack_hi(bf16_bits(pv[2 * u] - __uint_as_float(h0)),
                          bf16_bits(pv[2 * u + 1] - __uint_as_float(h1)));
        }
      }
      const unsigned char* v0 = vt + 2 * t * LDS;
      const unsigned char* v8 = v0 + 8 * LDS;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const int ca = (16 * dt + g) * sizeof(CacheT), cb = ca + 8 * sizeof(CacheT);
        const uint32_t af[4] = {E::column(v0 + ca), E::column(v0 + cb), E::column(v8 + ca),
                                E::column(v8 + cb)};
        mma_16816(acc[dt], af, hi[0], hi[1]);
        mma_16816(acc[dt], af, lo[0], lo[1]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with the ring: reuse it to merge

#pragma unroll
    for (int o = 4; o < 32; o <<= 1) l += __shfl_xor_sync(FULL, l, o);
    float* wacc = reinterpret_cast<float*>(smem);   // [warp][HD]
    float* wml = wacc + NWARPS * HD;                 // [warp][2]
    if (t == 0) {
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        wacc[warp * HD + 16 * dt + g] = acc[dt][0];
        wacc[warp * HD + 16 * dt + g + 8] = acc[dt][2];
      }
    }
    if (lane == 0) {
      wml[2 * warp] = m;
      wml[2 * warp + 1] = l;
    }
    __syncthreads();
    // the warps merged in warp order: this chunk's partial (m, l, acc)
    const int d = tid;   // NTHREADS == HD: one column per thread
    float M = wml[0];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) M = fmaxf(M, wml[2 * w]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = __expf(wml[2 * w] - M);
      L += wml[2 * w + 1] * f;
      O += wacc[w * HD + d] * f;
    }
    part[d] = O;
    if (d == 0) {
      part[HD] = M;
      part[HD + 1] = L;
    }
  }

  // the last block of this (slot, head) combines the partials in chunk
  // order and folds in the current token
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + blockIdx.y;
    is_last = atomicAdd(cnt, 1) == splits - 1;
    if (is_last) *cnt = 0;   // every block has counted: ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (warp == 0) {
    // the current token, at the query's own position (ALiBi distance 0):
    // a single-entry self block
    float dot = 0.f;
    if (a.has_cur) {
      const __nv_bfloat16* qr = a.q + (size_t)b * a.q_sb + (size_t)h * a.q_sh + 4 * lane;
      const __nv_bfloat16* kr = a.cur_k + (size_t)b * a.c_sb + (size_t)h * a.c_sh + 4 * lane;
#pragma unroll
      for (int e = 0; e < 4; ++e) dot += __bfloat162float(qr[e]) * __bfloat162float(kr[e]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
    }
    if (lane == 0) s_self = a.has_cur && a.valid[b] > 0 ? dot * a.sm_scale : -CUDART_INF_F;
  }
  __syncthreads();
  const float* first = ws + (size_t)blockIdx.y * splits * (HD + 2);
  const int d = tid;
  float M = s_self;
  for (int k = 0; k < splits; ++k) M = fmaxf(M, __ldcg(first + (size_t)k * (HD + 2) + HD));
  float L = 0.f, O = 0.f;
  if (M != -CUDART_INF_F) {
    for (int k = 0; k < splits; ++k) {
      const float* pk = first + (size_t)k * (HD + 2);
      const float mk = __ldcg(pk + HD);
      if (mk == -CUDART_INF_F) continue;   // an empty chunk: its acc was never written
      const float f = __expf(mk - M);
      L += __ldcg(pk + HD + 1) * f;
      O += __ldcg(pk + d) * f;
    }
    if (s_self != -CUDART_INF_F) {
      const float ps = __expf(s_self - M);
      L += ps;
      O += ps * __bfloat162float(a.cur_v[(size_t)b * a.c_sb + (size_t)h * a.c_sh + d]);
    }
  }
  a.out[((size_t)b * a.H + h) * HD + d] = __float2bfloat16(O / fmaxf(L, 1e-9f));
}

// _kernel: up to MAXR of the G * Tq query rows of kv head kvh of slot b
// (row c = g * Tq + t is head kvh * G + g at chunk token t), causal within
// the chunk.
template <typename CacheT, bool QUANT>
__global__ void __launch_bounds__(NTHREADS) paged_general_kernel(const Args a) {
  __shared__ Partials<MAXR> sm;
  __shared__ float s_self[MAXR][MAXT];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.Hkv;
  const int row0 = blockIdx.z * MAXR;
  const int nrows = min(MAXR, G * a.Tq - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = lane * 4;
  const int len = min(a.lengths[b], a.maxp * a.P);

  float qr[MAXR][4], m[MAXR], l[MAXR], acc[MAXR][4], slope[MAXR];
  int qpos[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    qr[r][0] = qr[r][1] = qr[r][2] = qr[r][3] = 0.f;
    slope[r] = 0.f;
    qpos[r] = 0;
    if (r < nrows) {
      const int c = row0 + r, g = c / a.Tq, t = c - g * a.Tq;
      load4(a.q + (size_t)b * a.q_sb + (size_t)t * a.q_st + (size_t)(kvh * G + g) * a.q_sh + d0,
            qr[r]);
      if (a.slopes != nullptr) slope[r] = a.slopes[kvh * G + g];
      qpos[r] = a.has_cur ? a.lengths[b] + t : a.lengths[b] - 1;
    }
  }
  sweep_pool<CacheT, QUANT, MAXR>(a, b, kvh, len, nrows, qr, slope, qpos, m, l, acc);
  store_partials<MAXR>(sm, nrows, m, l, acc);
  if (a.has_cur) {
    // self-block scores: chunk token j is visible to row (g, t) when
    // j <= t and j < valid[b]
    const int nvalid = a.valid[b];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r >= nrows) break;
      const int t = (row0 + r) % a.Tq;
      for (int j = warp; j < a.Tq; j += NWARPS) {
        float kx[4];
        load4(a.cur_k + (size_t)b * a.c_sb + (size_t)j * a.c_st + (size_t)kvh * a.c_sh + d0, kx);
        const float dot = warp_sum(qr[r][0] * kx[0] + qr[r][1] * kx[1] +
                                   qr[r][2] * kx[2] + qr[r][3] * kx[3]);
        if (lane == 0)
          s_self[r][j] = (j <= t && j < nvalid)
                             ? dot * a.sm_scale - slope[r] * static_cast<float>(t - j)
                             : -CUDART_INF_F;
      }
    }
  }
  __syncthreads();

  const int d = threadIdx.x;
  for (int r = 0; r < nrows; ++r) {
    const int c = row0 + r, g = c / a.Tq, t = c - g * a.Tq;
    float mx, lt, o;
    merge_row<MAXR>(sm, r, d, mx, lt, o);
    if (a.has_cur) {
      float m2 = mx;
      for (int j = 0; j < a.Tq; ++j) m2 = fmaxf(m2, s_self[r][j]);
      const float f = expf(mx - m2);
      lt *= f;
      o *= f;
      for (int j = 0; j < a.Tq; ++j) {
        const float ps = expf(s_self[r][j] - m2);
        const float cv = __bfloat162float(
            a.cur_v[(size_t)b * a.c_sb + (size_t)j * a.c_st + (size_t)kvh * a.c_sh + d]);
        lt += ps;
        o += ps * cv;
      }
    }
    a.out[(((size_t)b * a.Tq + t) * a.H + kvh * G + g) * HD + d] =
        __float2bfloat16(o / fmaxf(lt, 1e-9f));
  }
}

Args make_args(const void* q, const void* cur_k, const void* cur_v, const void* pool,
               const void* scale, const void* page_ids, const void* lengths,
               const void* valid, const void* slopes, void* out, int P, int H, int Hkv,
               int Tq, int maxp,
               int has_cur, int q_sb, int q_st, int q_sh, int c_sb, int c_st, int c_sh,
               int pt_sb, float sm_scale) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.cur_k = static_cast<const __nv_bfloat16*>(cur_k);
  a.cur_v = static_cast<const __nv_bfloat16*>(cur_v);
  a.pool = pool;
  a.scale = static_cast<const float*>(scale);
  a.page_ids = static_cast<const int*>(page_ids);
  a.lengths = static_cast<const int*>(lengths);
  a.valid = static_cast<const int*>(valid);
  a.slopes = static_cast<const float*>(slopes);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.P = P; a.H = H; a.Hkv = Hkv; a.Tq = Tq; a.maxp = maxp; a.has_cur = has_cur;
  a.q_sb = q_sb; a.q_st = q_st; a.q_sh = q_sh;
  a.c_sb = c_sb; a.c_st = c_st; a.c_sh = c_sh; a.pt_sb = pt_sb;
  a.sm_scale = sm_scale;
  return a;
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 =
// launched). `quantized` selects the int8 pool (with f32 scales) over bf16;
// without `has_cur` there is no current chunk (cur_k, cur_v, valid unused);
// `slopes` (f32 [H], or null) adds ALiBi. decode1 cuts each slot's maxp * P
// token positions into `splits` chunks of whole 64-token tiles (at most
// 64); `ws` is its f32 workspace [B * Hkv, splits, 130] and `counters` an
// int32 buffer of B * Hkv zeros, left zero; `ws_elems` and `n_counters` are
// their sizes, checked here.
extern "C" int paged_decode1_fwd(const void* q, const void* cur_k, const void* cur_v,
                                 const void* pool, const void* scale, const void* page_ids,
                                 const void* lengths, const void* valid, const void* slopes,
                                 void* out, void* ws, int ws_elems, void* counters,
                                 int n_counters, int B, int P, int H, int Hkv, int Tq, int maxp,
                                 int quantized, int has_cur, int splits,
                                 int q_sb, int q_st, int q_sh, int c_sb, int c_st, int c_sh,
                                 int pt_sb, float sm_scale, void* stream) {
  if (H != Hkv || Tq != 1 || splits < 1 || splits > MAX_SPLITS || !ws || !counters ||
      n_counters < B * Hkv || ws_elems < (long long)B * Hkv * splits * (HD + 2))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, cur_k, cur_v, pool, scale, page_ids, lengths, valid, slopes, out,
                           P, H, Hkv, Tq, maxp, has_cur, q_sb, q_st, q_sh, c_sb, c_st, c_sh,
                           pt_sb, sm_scale);
  const dim3 grid(splits, B * Hkv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (quantized) {
    constexpr int smem = d1_smem_bytes<int8_t>();
    auto kernel = paged_decode1_kernel<int8_t, true>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, NTHREADS, smem, st>>>(a, w, cnt, splits);
  } else {
    constexpr int smem = d1_smem_bytes<__nv_bfloat16>();
    auto kernel = paged_decode1_kernel<__nv_bfloat16, false>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, NTHREADS, smem, st>>>(a, w, cnt, splits);
  }
  return (int)cudaGetLastError();
}

extern "C" int paged_attention_fwd(const void* q, const void* cur_k, const void* cur_v,
                                   const void* pool, const void* scale, const void* page_ids,
                                   const void* lengths, const void* valid,
                                   const void* slopes, void* out,
                                   int B, int P, int H, int Hkv, int Tq, int maxp,
                                   int quantized, int has_cur,
                                   int q_sb, int q_st, int q_sh, int c_sb, int c_st, int c_sh,
                                   int pt_sb, float sm_scale, void* stream) {
  if (H % Hkv || Tq < 1 || Tq > MAXT) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, cur_k, cur_v, pool, scale, page_ids, lengths, valid, slopes, out,
                           P, H, Hkv, Tq, maxp, has_cur, q_sb, q_st, q_sh, c_sb, c_st, c_sh,
                           pt_sb, sm_scale);
  const dim3 grid(Hkv, B, ((H / Hkv) * Tq + MAXR - 1) / MAXR);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized) {
    paged_general_kernel<int8_t, true><<<grid, NTHREADS, 0, st>>>(a);
  } else {
    paged_general_kernel<__nv_bfloat16, false><<<grid, NTHREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
