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
// The general kernel (GQA / MQA decode, chunks of 2-8 tokens: every call
// with G * Tq > 1) is bound the same way, and its first design (one block
// per kv head, slot and 8 rows walking the slot's whole past serially, a
// 5-step shuffle sum per token and row) had decode1's old shape; it is now
// decode1's design with the query rows filling n8, where decode1 leaves 7 of
// the 8 columns empty: a block holds 8 of the G * Tq query rows of one kv
// head (row c = g * Tq + t is head kvh * G + g at chunk token t), so every
// page byte is read once for all of them (a wider group takes a block for
// each 8 rows: at 16 heads over one kv head, two such blocks side by side
// beat one block of two n8 tiles on the card); the same split, tile ring and
// products, each row's scores and probabilities in its own column (the
// running max and sum per column, P^T moved into mma's B layout with warp
// shuffles); one block per (chunk, slot x kv head x row group), the plan
// from static shapes (ops/paged_attention.general_splits), a block whose
// chunk starts past the slot's length exiting at once; one more block per
// (slot, kv head, row group) makes the current chunk's causal self block
// (up to cur_valid) a partial of its own, in parallel with the chunks; the
// last block to finish combines the partials in order, every load of a step
// issued before its sums wait on them (a lone block's time is mostly such
// round trips: its first loads, each tile's, the combine's).
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
constexpr int MAXT = 8;    // chunk tokens in the self block
constexpr int D1_TILE = 64;     // pool tokens of a ring stage
constexpr int D1_STAGES = 3;    // ring stages
constexpr int MAX_SPLITS = 64;  // chunks of a slot
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // the JAX mask value

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

// A ring stage: 64 tokens' K and V rows and their k and v scales.
template <typename CacheT>
__host__ __device__ constexpr int d1_stage_bytes() {
  return 2 * D1_TILE * Elem<CacheT>::LDS + 2 * D1_TILE * 4;   // K, V rows; k, v scales
}

template <typename CacheT>
__host__ __device__ constexpr int d1_smem_bytes() {
  return D1_STAGES * d1_stage_bytes<CacheT>();
}

// Chunk c of `splits` of a slot's maxp * P token positions (whole 64-token
// tiles): its first token and the end of its tokens below `len`; returns
// its tile count (0 for a chunk that starts past the slot's tokens).
__device__ __forceinline__ int chunk_tiles(const Args& a, int len, int splits, int c,
                                           int& s_begin, int& s_end) {
  const int n_tiles = (a.maxp * a.P + D1_TILE - 1) / D1_TILE;
  const int per = (n_tiles + splits - 1) / splits;
  s_begin = c * per * D1_TILE;
  s_end = min(min(n_tiles, (c + 1) * per) * D1_TILE, len);
  return s_end > s_begin ? (s_end - s_begin + D1_TILE - 1) / D1_TILE : 0;
}

// The tile of tokens sb .. sb + 63 of slot page list `pt`, kv head h, into
// ring stage `st`, each token's K and V rows through its own page (pages of
// 2^p_shift tokens, or p_shift -1); tokens at or past s_end are zero-filled
// (a zero value times a zero probability stays 0); with QUANT their k and v
// scales beside them.
template <typename CacheT, bool QUANT>
__device__ __forceinline__ void load_tile(const Args& a, unsigned char* st, const int* pt, int h,
                                          int sb, int s_end, int p_shift) {
  using E = Elem<CacheT>;
  constexpr int LDS = E::LDS;
  const int tid = threadIdx.x;
  const CacheT* pool = static_cast<const CacheT*>(a.pool);
  const size_t tok = (size_t)a.Hkv * HD;     // token to token within a page
  const size_t half = (size_t)a.P * tok;     // a page's K block to its V block
  const size_t shalf = (size_t)a.Hkv * a.P;  // the same in the scales
  constexpr int CH = E::ROW / 16;            // 16-byte chunks of a row
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
}

// Count this block's partial in (counter `slot`); true for the last of
// `splits` blocks, which resets the counter for the next launch. Every
// thread of the block calls it; its partial writes precede it.
__device__ __forceinline__ bool last_block(int* counters, int slot, int splits, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* cnt = counters + slot;
    *flag = atomicAdd(cnt, 1) == splits - 1;
    if (*flag) *cnt = 0;   // every block has counted: ready for the next launch
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// _kernel_decode1: one query row per (slot b, kv head h) (Tq == 1, H ==
// Hkv), the slot's pool tokens cut into `splits` chunks of whole 64-token
// tiles, one block per (chunk, slot x head); see the note at the top.
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
  int s_begin, s_end;
  const int nt = chunk_tiles(a, len, splits, c, s_begin, s_end);
  float* part = ws + ((size_t)blockIdx.y * splits + c) * (HD + 2);

  if (nt == 0) {
    // the chunk starts past the slot's tokens: the empty partial
    if (tid == 0) {
      part[HD] = -CUDART_INF_F;
      part[HD + 1] = 0.f;
    }
  } else {
    const int* pt = a.page_ids + (size_t)b * a.pt_sb;
    const int p_shift = (a.P & (a.P - 1)) == 0 ? __ffs(a.P) - 1 : -1;   // pages of 2^n tokens
    // tile i (tokens s_begin + 64 i ...) into stage i % NST
    auto load = [&](int i) {
      load_tile<CacheT, QUANT>(a, smem + (i % NST) * STAGE, pt, h, s_begin + i * D1_TILE, s_end,
                               p_shift);
    };
#pragma unroll
    for (int i = 0; i < NST - 1; ++i) {
      if (i < nt) load(i);
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
      if (i + NST - 1 < nt) load(i + NST - 1);
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
  if (!last_block(counters, blockIdx.y, splits, &is_last)) return;
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

// _kernel: 8 of the G * Tq query rows of kv head kvh of slot b (row c =
// g * Tq + t is head kvh * G + g at chunk token t; the rows of a kv head
// in `groups` groups of 8), the slot's pool tokens cut into `splits` chunks
// of whole 64-token tiles, one block per (chunk, slot x kv head x row
// group) and one for the self block; see the note at the top. decode1's
// tiles and products with the query rows as the columns of n8: thread (g,
// t) holds the scores of tokens g and g + 8 of its warp's 16 for columns 2t
// and 2t + 1, and keeps those columns' running max and sum.
template <typename CacheT, bool QUANT>
__global__ void __launch_bounds__(NTHREADS, 2)
paged_general_kernel(const Args a, float* __restrict__ ws, int* __restrict__ counters,
                     int splits, int groups) {
  using E = Elem<CacheT>;
  constexpr int LDS = E::LDS;
  constexpr int STAGE = d1_stage_bytes<CacheT>();
  constexpr int NST = D1_STAGES;
  constexpr int KW = D1_TILE / NWARPS;   // a warp's 16 tokens of a tile
  constexpr int ROWS = 8;
  constexpr int PART = ROWS * (HD + 2);  // a chunk's partial: per row acc[HD], m, l
  static_assert(NWARPS * ROWS * (HD + 2) * 4 <= d1_smem_bytes<int8_t>(), "merge in the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  __shared__ float s_self[ROWS][MAXT];

  const int c = blockIdx.x;   // chunk of the slot's tokens, or `splits`: the self block
  const int bh = blockIdx.y / groups;
  const int b = bh / a.Hkv, kvh = bh % a.Hkv;
  const int G = a.H / a.Hkv;
  const int row0 = (blockIdx.y % groups) * ROWS;
  const int nrows = min(ROWS, G * a.Tq - row0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int* pt = a.page_ids + (size_t)b * a.pt_sb;
  const int per = ((a.maxp * a.P + D1_TILE - 1) / D1_TILE + splits - 1) / splits;
  // the chunk's first page ids on their way to L1 while the length is read
  if (tid == 0 && c < splits)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(pt + min(c * per * D1_TILE, a.maxp * a.P - 1) /
                                                         a.P));
  const int len = min(a.lengths[b], a.maxp * a.P);
  // the chunks that hold some of the slot's tokens (at least chunk 0, which
  // writes the empty partial of a slot without any), then the self block
  // with a current chunk: a block past them exits at once; the live ones
  // alone are counted and combined, the self block's partial after the
  // chunks'
  const int live = max(1, min(splits, (len + per * D1_TILE - 1) / (per * D1_TILE)));
  const int parts = live + a.has_cur;
  if (c == splits ? !a.has_cur : c >= live) return;
  float* part = ws + ((size_t)blockIdx.y * (splits + 1) + min(c, live)) * PART;
  // block row r: its query (chunk token, head)
  auto token_of = [&](int r) { return (row0 + r) % a.Tq; };
  auto head_of = [&](int r) { return kvh * G + (row0 + r) / a.Tq; };
  int s_begin, s_end;
  const int nt = c < splits ? chunk_tiles(a, len, splits, c, s_begin, s_end) : 0;

  if (c == splits) {
    // the current chunk as a causal self block: chunk token j is visible to
    // a row at chunk token t when j <= t and j < valid[b] (ALiBi t - j); a
    // thread for each (row, chunk token) pair
    const int nvalid = a.valid[b];
    for (int x = tid; x < nrows * a.Tq; x += NTHREADS) {
      const int r = x / a.Tq, j = x % a.Tq, tq = token_of(r), hd = head_of(r);
      const __nv_bfloat16* qr =
          a.q + (size_t)b * a.q_sb + (size_t)tq * a.q_st + (size_t)hd * a.q_sh;
      const __nv_bfloat16* kr =
          a.cur_k + (size_t)b * a.c_sb + (size_t)j * a.c_st + (size_t)kvh * a.c_sh;
      uint2 qv[HD / 4], kv[HD / 4];
#pragma unroll
      for (int e = 0; e < HD / 4; ++e) {
        qv[e] = *reinterpret_cast<const uint2*>(qr + 4 * e);
        kv[e] = *reinterpret_cast<const uint2*>(kr + 4 * e);
      }
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < HD / 4; ++e) {
        const float2 q0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qv[e].x));
        const float2 q1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qv[e].y));
        const float2 k0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kv[e].x));
        const float2 k1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kv[e].y));
        dot += q0.x * k0.x + q0.y * k0.y + q1.x * k1.x + q1.y * k1.y;
      }
      const float sl = a.slopes != nullptr ? a.slopes[hd] : 0.f;
      s_self[r][j] = j <= tq && j < nvalid
                         ? dot * a.sm_scale - sl * static_cast<float>(tq - j)
                         : -CUDART_INF_F;
    }
    __syncthreads();
    if (tid < nrows) {
      // the row's max over its visible tokens and their probabilities
      const int r = tid;
      float M = -CUDART_INF_F, L = 0.f;
      for (int j = 0; j < a.Tq; ++j) M = fmaxf(M, s_self[r][j]);
      for (int j = 0; j < a.Tq; ++j) {
        const float p = s_self[r][j] == -CUDART_INF_F ? 0.f : __expf(s_self[r][j] - M);
        s_self[r][j] = p;
        L += p;
      }
      part[r * (HD + 2) + HD] = M;
      part[r * (HD + 2) + HD + 1] = L;
    }
    __syncthreads();
    const int d = tid;
    float cvd[MAXT];   // the chunk tokens' V at column d
#pragma unroll
    for (int j = 0; j < MAXT; ++j)
      cvd[j] = j < a.Tq ? __bfloat162float(a.cur_v[(size_t)b * a.c_sb + (size_t)j * a.c_st +
                                                   (size_t)kvh * a.c_sh + d])
                        : 0.f;
    for (int r = 0; r < nrows; ++r) {
      float O = 0.f;
#pragma unroll
      for (int j = 0; j < MAXT; ++j)
        if (j < a.Tq) O += s_self[r][j] * cvd[j];
      part[r * (HD + 2) + d] = O;
    }
  } else if (nt == 0) {
    // a slot without pool tokens: the empty partial of each row (zero sums,
    // so that the combine weighs every chunk without a branch)
    for (int r = 0; r < nrows; ++r) part[r * (HD + 2) + tid] = 0.f;
    if (tid < nrows) {
      part[tid * (HD + 2) + HD] = -CUDART_INF_F;
      part[tid * (HD + 2) + HD + 1] = 0.f;
    }
  } else {
    const int p_shift = (a.P & (a.P - 1)) == 0 ? __ffs(a.P) - 1 : -1;   // pages of 2^n tokens
    auto load = [&](int i) {
      load_tile<CacheT, QUANT>(a, smem + (i % NST) * STAGE, pt, kvh, s_begin + i * D1_TILE,
                               s_end, p_shift);
    };
#pragma unroll
    for (int i = 0; i < NST - 1; ++i) {
      if (i < nt) load(i);
      cp_async_commit();
    }

    // S^T = K Q^T and O^T += V^T P^T: the tokens (and D) as m16, row g of
    // the block as column g of n8 (columns past nrows are zero queries whose
    // sums are never written); column 2t + e (this thread's scores) takes its
    // head's slope and its query position, at `lengths` + t with a current
    // chunk, else at lengths - 1. In S^T the head dim is permuted inside each
    // k16 step, for K and Q alike (which leaves every dot product as it is):
    // k index 2t + i is d = 16 ks + 4t + i and k index 2t + 8 + i is d = 16
    // ks + 4t + 2 + i, so that a thread's four K values of a step are one
    // load
    uint32_t qb[8][2];
    float slope[2];
    int qpos[2];
    {
      const __nv_bfloat16* qr = a.q + (size_t)b * a.q_sb + (size_t)token_of(g) * a.q_st +
                                (size_t)head_of(g) * a.q_sh;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const uint2 v = g < nrows ? *reinterpret_cast<const uint2*>(qr + 16 * ks + 4 * t)
                                  : make_uint2(0u, 0u);
        qb[ks][0] = v.x;
        qb[ks][1] = v.y;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * t + e;
        const bool live = r < nrows;
        slope[e] = live && a.slopes != nullptr ? a.slopes[head_of(r)] : 0.f;
        qpos[e] = !live ? 0 : a.has_cur ? a.lengths[b] + token_of(r) : a.lengths[b] - 1;
      }
    }
    float acc[8][4];   // [D tile][(d g | d g + 8) x (column 2t | 2t + 1)]
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    // running max from the mask value, as decode1's
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    // P^T into B's layout: b0 = (tokens 2t, 2t + 1; column g), which lanes
    // 8t + g / 2 and 8t + 4 + g / 2 hold as half g % 2 of a bf16 pair
    const int src_a = 8 * t + g / 2, src_b = src_a + 4;
    const uint32_t sel = (g & 1) ? 0x7632u : 0x5410u;

    for (int i = 0; i < nt; ++i) {
      cp_async_wait<NST - 2>();
      __syncthreads();   // tile i landed for all; tile i - 1's stage is free
      if (i + NST - 1 < nt) load(i + NST - 1);
      cp_async_commit();

      const unsigned char* st = smem + (i % NST) * STAGE;
      const unsigned char* kt = st + warp * KW * LDS;
      const unsigned char* vt = st + (D1_TILE + warp * KW) * LDS;
      const float* ks_s = reinterpret_cast<const float*>(st + 2 * D1_TILE * LDS) + warp * KW;
      const float* vs_s = ks_s + D1_TILE;
      const int sw = s_begin + i * D1_TILE + warp * KW;   // this warp's first token

      // S^T over the warp's 16 tokens: two chains of four k-steps a tile
      float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
      const unsigned char* k0 = kt + g * LDS;
      const unsigned char* k8 = k0 + 8 * LDS;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int e = (16 * ks + 4 * t) * sizeof(CacheT);
        uint32_t af[4];
        E::quad(k0 + e, af[0], af[2]);
        E::quad(k8 + e, af[1], af[3]);
        mma_16816((ks & 1) ? sb : sa, af, qb[ks][0], qb[ks][1]);
      }
      // element i: token g + 8 (i / 2), column 2t + i % 2
      const float kscale[2] = {QUANT ? ks_s[g] : 1.f, QUANT ? ks_s[g + 8] : 1.f};
      const float vscale[2] = {QUANT ? vs_s[g] : 1.f, QUANT ? vs_s[g + 8] : 1.f};
      float x[4], alpha[2];
      bool moved = false;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = sw + g + 8 * (e / 2);
        const float dot = (sa[e] + sb[e]) * kscale[e / 2];
        x[e] = s < s_end ? dot * a.sm_scale - slope[e % 2] * static_cast<float>(qpos[e % 2] - s)
                         : -CUDART_INF_F;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = fmaxf(m[e], fmaxf(x[e], x[2 + e]));
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        alpha[e] = __expf(m[e] - mx);
        moved |= alpha[e] != 1.f;
        m[e] = mx;
      }
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = __expf(x[e] - m[e % 2]);
      l[0] = l[0] * alpha[0] + p[0] + p[2];
      l[1] = l[1] * alpha[1] + p[1] + p[3];
      // times the v scale, as hi / lo bf16 halves (~16 bits, as the Pallas
      // kernel's f32 products keep), packed by token row
      uint32_t hi[2], lo[2], bh[2], bl[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float p0 = p[2 * u] * vscale[u], p1 = p[2 * u + 1] * vscale[u];
        const uint32_t h0 = bf16_bits(p0), h1 = bf16_bits(p1);
        hi[u] = pack_hi(h0, h1);
        lo[u] = pack_hi(bf16_bits(p0 - __uint_as_float(h0)), bf16_bits(p1 - __uint_as_float(h1)));
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {   // b0 from token rows g, b1 from g + 8
        bh[u] = __byte_perm(__shfl_sync(FULL, hi[u], src_a), __shfl_sync(FULL, hi[u], src_b), sel);
        bl[u] = __byte_perm(__shfl_sync(FULL, lo[u], src_a), __shfl_sync(FULL, lo[u], src_b), sel);
      }
      if (__any_sync(FULL, moved)) {   // a max moved
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[dt][e] *= alpha[e % 2];
      }
      const unsigned char* v0 = vt + 2 * t * LDS;
      const unsigned char* v8 = v0 + 8 * LDS;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const int ca = (16 * dt + g) * sizeof(CacheT), cb = ca + 8 * sizeof(CacheT);
        const uint32_t af[4] = {E::column(v0 + ca), E::column(v0 + cb), E::column(v8 + ca),
                                E::column(v8 + cb)};
        mma_16816(acc[dt], af, bh[0], bh[1]);
        mma_16816(acc[dt], af, bl[0], bl[1]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with the ring: reuse it to merge

    float* wacc = reinterpret_cast<float*>(smem);   // [warp][row][HD]
    float* wml = wacc + NWARPS * ROWS * HD;          // [warp][row][2]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) l[e] += __shfl_xor_sync(FULL, l[e], o);
      const int r = 2 * t + e;
      if (g == 0) {
        wml[2 * (warp * ROWS + r)] = m[e];
        wml[2 * (warp * ROWS + r) + 1] = l[e];
      }
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        wacc[(warp * ROWS + r) * HD + 16 * dt + g] = acc[dt][e];
        wacc[(warp * ROWS + r) * HD + 16 * dt + g + 8] = acc[dt][2 + e];
      }
    }
    __syncthreads();
    // the warps merged in warp order: this chunk's partial of each row
    const int d = tid;   // NTHREADS == HD: one column per thread
    for (int r = 0; r < nrows; ++r) {
      float M = wml[2 * r];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) M = fmaxf(M, wml[2 * (w * ROWS + r)]);
      float L = 0.f, O = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const float f = __expf(wml[2 * (w * ROWS + r)] - M);
        L += wml[2 * (w * ROWS + r) + 1] * f;
        O += wacc[(w * ROWS + r) * HD + d] * f;
      }
      part[r * (HD + 2) + d] = O;
      if (d == 0) {
        part[r * (HD + 2) + HD] = M;
        part[r * (HD + 2) + HD + 1] = L;
      }
    }
  }

  // the last block of this (slot, head, row group) combines the partials in
  // order, the chunks' then the self block's; every load of a step is
  // issued before its sums wait on them (the ring is free again)
  if (!last_block(counters, blockIdx.y, parts, &is_last)) return;
  constexpr int MAXP = MAX_SPLITS + 1;
  const float* first = ws + (size_t)blockIdx.y * (splits + 1) * PART;
  float* cw = reinterpret_cast<float*>(smem);   // [row][part]: the parts' m, then weights
  float* cl = cw + ROWS * MAXP;                 // [row][part]: their l
  float* lt = cl + ROWS * MAXP;                 // [row]: the row's sum
  for (int x = tid; x < nrows * parts; x += NTHREADS) {
    const int r = x / parts, k = x % parts;
    cw[r * MAXP + k] = __ldcg(first + (size_t)k * PART + r * (HD + 2) + HD);
    cl[r * MAXP + k] = __ldcg(first + (size_t)k * PART + r * (HD + 2) + HD + 1);
  }
  __syncthreads();
  if (tid < nrows) {
    // row r's max over its parts; their weights (0 for an empty one)
    const int r = tid;
    float M = -CUDART_INF_F;
    for (int k = 0; k < parts; ++k) M = fmaxf(M, cw[r * MAXP + k]);
    float L = 0.f;
    for (int k = 0; k < parts; ++k) {
      const float mk = cw[r * MAXP + k];
      const float w = mk == -CUDART_INF_F ? 0.f : __expf(mk - M);
      cw[r * MAXP + k] = w;
      L += cl[r * MAXP + k] * w;
    }
    lt[r] = L;
  }
  __syncthreads();
  const int d = tid;
  float O[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) O[r] = 0.f;
  // four parts' loads at a time: a chain of one round trip per part would
  // make the combine the slowest step of the launch
#pragma unroll 4
  for (int k = 0; k < parts; ++k) {
    const float* pk = first + (size_t)k * PART + d;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < nrows) O[r] += cw[r * MAXP + k] * __ldcg(pk + r * (HD + 2));
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (r < nrows)
      a.out[(((size_t)b * a.Tq + token_of(r)) * a.H + head_of(r)) * HD + d] =
          __float2bfloat16(O[r] / fmaxf(lt[r], 1e-9f));
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

// The general kernel: the G * Tq query rows of a kv head in groups of 8,
// one block per (chunk, slot x kv head x group) and one more per (slot x
// kv head x group) for the current chunk's self block;
// `ws` is its f32 workspace [B * Hkv * groups, splits + 1, 8, 130] and
// `counters` an int32 buffer of B * Hkv * groups zeros, left zero; the other
// arguments as decode1's.
extern "C" int paged_attention_fwd(const void* q, const void* cur_k, const void* cur_v,
                                   const void* pool, const void* scale, const void* page_ids,
                                   const void* lengths, const void* valid, const void* slopes,
                                   void* out, void* ws, int ws_elems, void* counters,
                                   int n_counters, int B, int P, int H, int Hkv, int Tq,
                                   int maxp, int quantized, int has_cur, int splits,
                                   int q_sb, int q_st, int q_sh, int c_sb, int c_st, int c_sh,
                                   int pt_sb, float sm_scale, void* stream) {
  if (Hkv < 1 || H % Hkv || Tq < 1 || Tq > MAXT || splits < 1 || splits > MAX_SPLITS || !ws ||
      !counters)
    return (int)cudaErrorInvalidValue;
  const int groups = (H / Hkv * Tq + 7) / 8;
  const long long blocks = (long long)B * Hkv * groups;
  if (blocks > 65535 || n_counters < blocks || ws_elems < blocks * (splits + 1) * 8 * (HD + 2))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, cur_k, cur_v, pool, scale, page_ids, lengths, valid, slopes, out,
                           P, H, Hkv, Tq, maxp, has_cur, q_sb, q_st, q_sh, c_sb, c_st, c_sh,
                           pt_sb, sm_scale);
  const dim3 grid(splits + 1, (unsigned)blocks);   // the chunks, then the self block
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  auto run = [&](auto kernel, int smem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, NTHREADS, smem, st>>>(a, w, cnt, splits, groups);
    return (int)cudaGetLastError();
  };
  if (quantized) return run(paged_general_kernel<int8_t, true>, d1_smem_bytes<int8_t>());
  return run(paged_general_kernel<__nv_bfloat16, false>, d1_smem_bytes<__nv_bfloat16>());
}
