// Flash-decode attention for Hopper (sm_90a): up to 8 query tokens per
// sequence over the dense KV cache, bf16 or int8 with per-(token, kv-head)
// scales.
//
// Replaces the Pallas TPU kernel llava_plus_tpu/ops/decode_attention.py:_kernel
// (wrapper decode_attention). Same function: G = H / Hkv query rows per kv
// head, slots with seg == 0 masked (the finite mask value -0.7 f32 max), and
// for int8 the k scale folded into the scores and the v scale into the
// probabilities. Slots past the query position take no part, as in the XLA
// path it stands in for (llava_plus_tpu/ops/attention.py:quant_cache_attention);
// they are never read. (Only a row with no valid slot at all could tell the
// two apart.) With per-head f32 slopes (MPT's ALiBi, or null) each visible
// slot's scaled score loses `slope_h * (q_pos - s)`; s <= q_pos always, so
// this is the JAX bias -slope_h * |q_pos - s| that MPT's dense decode adds to
// XLA's quant_cache_attention (llava_plus_tpu/models/mpt.py).
//
// A chunk of Tq <= 8 query tokens (the speculative verify step: the current
// token and its proposals, whose k/v the cache already holds) sits at
// contiguous positions: token t at q_pos[b] + t, which is its own causal
// limit and its own ALiBi position. The XLA chain of the JAX package's dense
// verify step (llava_plus_tpu/models/llama.py, quant_cache_attention) computes
// the same function. A (batch row, kv head) then has R = G * Tq query rows,
// token-major (row r is token r / G of query head kvh * G + r % G), and the
// blocks hold them as they hold a group of R heads.
//
// What bounds it on the card: a decode step reads every visible cache byte
// once and does ~2 flops per byte per query row, far below the H100's bf16
// ridge, so it is HBM-bound: the design is about keeping every SM's share of
// the bytes in flight.
//
// Design (flash-decoding): one block per (chunk of the cache, batch row x kv
// head[, 64-row group of query heads]); ops/decode_attention.decode_splits
// picks the chunk count from the static cache length so that a batch of one
// still gives two blocks per SM. A block holds the whole group (up to 64
// query rows, so every group of the repo's models) and reads each cache row
// of its chunk once: 64-slot tiles of K and V (and the scales and segment
// ids) stream through a 3-stage cp.async ring in shared memory; 4 warps
// share each tile, warp w taking 16 MT of the tile's slots and m16 row tile
// w % MT of the group (MT = 1, 2 or 4 tiles of 16 rows, the group padded
// with zero rows), with an online softmax of its own:
//   S = Q K^T    mma.sync m16n8k16 bf16, Q fragments in registers, K rows
//                from shared memory (int8 converts exactly to bf16); f32 sums,
//                exact for bf16 products, so no more precision is needed;
//   O += P V     mma.sync m16n8k16 with P (times the v scale) as two bf16
//                halves, hi = bf16(P) and lo = bf16(P - hi): ~16 bits of P
//                reach the product, as the Pallas kernel's f32 products at
//                Precision.HIGHEST keep more than one bf16 operand would.
// A group of at most 8 rows (MHA's G = 1, GQA) takes the products
// transposed, S^T = K Q^T and O^T += V^T P^T, with the group as the n8 side:
// half the mma work of a padded m16 tile, P^T gathered into the B layout by
// lane shuffles. On the card a tile's time (~3,000 cycles at 16 slots,
// clock64 traces) goes to the warps' dependent chains (products, fragment
// loads, reductions) and to issuing the next tile's copies, not to waiting
// for the cache; TMA for K and V measured no faster.
// The warps' states merge through shared memory in a fixed order. With one
// chunk the block writes the output; otherwise it writes its f32 partial
// (m, l, acc) to the workspace, and the last block of its (row, kv head)
// to finish (a counter per (row, kv head, row group) in a zeroed int32
// buffer that the wrapper keeps; the last block resets it to 0) reads the
// partials in chunk order (at most 64 chunks: their weights sit in shared
// memory) and writes the output: deterministic, one launch,
// no host sync, nothing that depends on device values at launch (a CUDA
// graph can capture it). A chunk that starts past q_pos[b] writes the empty
// partial (m = -inf, l = 0), which the combine skips.
//
// Layout: q [B, Tq, H, D] strided, D = 128; cache [B, S, Hkv, D] strided
// (rows 16-byte aligned); scales [B, S, Hkv] f32 strided; seg [B, S] int32;
// q_pos [B] int32; out [B, Tq, H, D] contiguous bf16; workspace f32 [B, Hkv,
// splits, R, D + 2] (acc, then m and l).

#include "warp_mma.cuh"

#include <math_constants.h>

namespace {

using namespace warp_mma;

constexpr int HD = 128;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TILE = 64;       // cache slots per ring stage
constexpr int MAX_ROWS = 64;   // query rows a block holds (4 m16 tiles)
constexpr int ACC_LD = HD + 4; // f32 row stride of the warps' merge area
constexpr int MAX_SPLITS = 64; // chunks a row's combine weighs in shared memory
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;  // the JAX mask value

struct DecodeArgs {
  const __nv_bfloat16* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* seg;
  const int* q_pos;
  const float* slopes;   // [H] or null
  __nv_bfloat16* out;
  float* ws;             // [B, Hkv, splits, G, HD + 2] when splits > 1
  int* counters;         // [B * Hkv * row groups], zero between launches
  int S, H, G, Hkv, splits;
  int Tq, R;             // query tokens; rows a kv head: G * Tq
  int q_sb, q_st, q_sh, c_sb, c_ss, c_sh, s_sb, s_ss, s_sh, seg_sb;
  float sm_scale;
};

// Row r of a (batch row, kv head)'s R rows: its query token and head.
struct Row {
  int t, h;
};

__device__ __forceinline__ Row row_of(const DecodeArgs& p, int kvh, int r) {
  return {r / p.G, kvh * p.G + r % p.G};
}

__device__ __forceinline__ const __nv_bfloat16* q_row(const DecodeArgs& p, int b, Row w) {
  return p.q + (size_t)b * p.q_sb + (size_t)w.t * p.q_st + (size_t)w.h * p.q_sh;
}

__device__ __forceinline__ __nv_bfloat16* out_row(const DecodeArgs& p, int b, Row w) {
  return p.out + (((size_t)b * p.Tq + w.t) * p.H + w.h) * HD;
}

// ring stages: 3 (of 35 KB for bf16, of 19 KB for int8)
template <typename CacheT>
__host__ __device__ constexpr int ring_stages() {
  return 3;
}

template <typename CacheT>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * TILE * Elem<CacheT>::LDS + 3 * TILE * 4;   // K, V; seg, k and v scales
}

template <typename CacheT>
__host__ __device__ constexpr int smem_bytes() {
  return ring_stages<CacheT>() * stage_bytes<CacheT>();
}

// MT m16 row tiles of the group per block, 4 / MT key groups of warps;
// SMALL (a group of at most 8 rows, MT = 1): the products transposed, the
// group's rows as the n8 side (see the note at the top).
template <typename CacheT, bool QUANT, int MT, bool SMALL>
__global__ void __launch_bounds__(NTHREADS, 2)
decode_kernel(const DecodeArgs p) {
  using E = Elem<CacheT>;
  constexpr int LDS = E::LDS;
  constexpr int STAGE = stage_bytes<CacheT>();
  constexpr int NST = ring_stages<CacheT>();
  constexpr int ROWS = 16 * MT;        // query rows of the block
  constexpr int KW = 16 * MT;          // slots of a tile per warp
  constexpr int NT = KW / 8;           // n8 tiles of a warp's scores
  constexpr int KG = NWARPS / MT;      // warps that share a row tile
  static_assert(KG * KW == TILE, "the warps of a row tile cover the tile");
  static_assert(!SMALL || MT == 1, "a small group is one row tile");
  extern __shared__ __align__(16) unsigned char smem[];

  const int c = blockIdx.x;                       // chunk of the cache
  const int b = blockIdx.y / p.Hkv;
  const int kvh = blockIdx.y % p.Hkv;
  const int z = blockIdx.z;                       // 64-row group of a wider R
  const int r0 = z * MAX_ROWS;                    // this block's first row
  const int GC = min(ROWS, p.R - r0);             // query rows it holds
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int mt = warp % MT, kg = warp / MT;

  const int qp = p.q_pos[b];
  const int used = min(p.S, qp + p.Tq);           // slots past the last query never count
  const int n_tiles = (p.S + TILE - 1) / TILE;
  const int per = (n_tiles + p.splits - 1) / p.splits;
  const int s_begin = c * per * TILE;
  const int s_end = min(min(n_tiles, (c + 1) * per) * TILE, used);
  const int nt = s_end > s_begin ? (s_end - s_begin + TILE - 1) / TILE : 0;
  const size_t ws_chunk = (size_t)p.R * (HD + 2);
  float* ws_rows = p.ws + (((size_t)b * p.Hkv + kvh) * p.splits + c) * ws_chunk +
                   (size_t)r0 * (HD + 2);

  __shared__ int is_last;
  if (nt == 0 && p.splits > 1) {
    // the chunk starts past the query: the empty partial
    for (int r = tid; r < GC; r += NTHREADS) {
      ws_rows[(size_t)r * (HD + 2) + HD] = -CUDART_INF_F;
      ws_rows[(size_t)r * (HD + 2) + HD + 1] = 0.f;
    }
  } else {
    const unsigned char* kbase = static_cast<const unsigned char*>(p.k) +
                                 ((size_t)b * p.c_sb + (size_t)kvh * p.c_sh) * sizeof(CacheT);
    const unsigned char* vbase = static_cast<const unsigned char*>(p.v) +
                                 ((size_t)b * p.c_sb + (size_t)kvh * p.c_sh) * sizeof(CacheT);
    const int* segb = p.seg + (size_t)b * p.seg_sb;
    const size_t sbase = (size_t)b * p.s_sb + (size_t)kvh * p.s_sh;

    // Tile i (slots s_begin + 64 i ...) into stage i % NST; slots at or past
    // s_end are zero-filled (a zero value times a zero probability stays 0).
    auto load_tile = [&](int i) {
      unsigned char* st = smem + (i % NST) * STAGE;
      const int sb = s_begin + i * TILE;
      constexpr int CH = E::ROW / 16;               // 16-byte chunks of a row
      for (int x = tid; x < 2 * TILE * CH; x += NTHREADS) {
        const int which = x / (TILE * CH);          // 0: K, 1: V
        const int r = (x / CH) % TILE, ch = x % CH;
        const int s = sb + r;
        const bool in = s < s_end;
        const unsigned char* src =
            (which ? vbase : kbase) + (size_t)(in ? s : 0) * p.c_ss * sizeof(CacheT) + ch * 16;
        cp_async16(st + which * TILE * LDS + r * LDS + ch * 16, src, in);
      }
      int* seg_s = reinterpret_cast<int*>(st + 2 * TILE * LDS);
      if (tid < TILE) {
        const int s = sb + tid;
        const bool in = s < s_end;
        const int si = in ? s : 0;
        cp_async4(seg_s + tid, segb + si, in);
        if (QUANT) {
          cp_async4(seg_s + TILE + tid, p.ks + sbase + (size_t)si * p.s_ss, in);
          cp_async4(seg_s + 2 * TILE + tid, p.vs + sbase + (size_t)si * p.s_ss, in);
        }
      }
    };
#pragma unroll
    for (int i = 0; i < NST - 1; ++i) {
      if (i < nt) load_tile(i);
      cp_async_commit();
    }

    float* macc = reinterpret_cast<float*>(smem);            // [warp][16][ACC_LD]
    float* mml = macc + NWARPS * 16 * ACC_LD;                 // [warp][16][2]
    if constexpr (SMALL) {
      // S^T = K Q^T and O^T += V^T P^T: the slots (and D) as m16, the
      // group's rows as n8, so a row tile wastes at most 7 of 8 rows. Q as
      // the B operand (row g, zero past the group); rows 2t, 2t + 1 are
      // this thread's in the accumulators.
      uint32_t qb[8][2];
      {
        const __nv_bfloat16* qr = q_row(p, b, row_of(p, kvh, r0 + min(g, GC - 1)));
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int col = 16 * ks + 2 * t;
          qb[ks][0] = g < GC ? *reinterpret_cast<const uint32_t*>(qr + col) : 0u;
          qb[ks][1] = g < GC ? *reinterpret_cast<const uint32_t*>(qr + col + 8) : 0u;
        }
      }
      // rows 2t and 2t + 1: slope and last visible slot (rows past the
      // group take row GC - 1's; their outputs are never written)
      const Row ra = row_of(p, kvh, r0 + min(2 * t, GC - 1));
      const Row rb = row_of(p, kvh, r0 + min(2 * t + 1, GC - 1));
      const float slope0 = p.slopes ? p.slopes[ra.h] : 0.f;
      const float slope1 = p.slopes ? p.slopes[rb.h] : 0.f;
      const int last0 = min(s_end - 1, qp + ra.t), last1 = min(s_end - 1, qp + rb.t);
      float acc[8][4];   // [D tile][(d g | d g + 8) x (row 2t | 2t + 1)]
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
      float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.f, l1 = 0.f;
      const int src0 = 8 * t + g / 2, src1 = src0 + 4;   // lanes holding P[g][2t], P[g][2t+1]
      const bool odd = g & 1;

      for (int i = 0; i < nt; ++i) {
        cp_async_wait<NST - 2>();
        __syncthreads();   // tile i landed for all; tile i - 1's stage is free
        if (i + NST - 1 < nt) load_tile(i + NST - 1);
        cp_async_commit();

        const unsigned char* st = smem + (i % NST) * STAGE;
        const unsigned char* kt = st + kg * KW * LDS;
        const unsigned char* vt = st + TILE * LDS + kg * KW * LDS;
        const int* seg_s = reinterpret_cast<const int*>(st + 2 * TILE * LDS) + kg * KW;
        const float* ks_s = reinterpret_cast<const float*>(seg_s + TILE);
        const float* vs_s = ks_s + TILE;
        const int sw = s_begin + i * TILE + kg * KW;   // this warp's first slot

        // S^T over the warp's 16 slots: two chains of four k-steps
        float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
        const unsigned char* k0 = kt + g * LDS;
        const unsigned char* k8 = k0 + 8 * LDS;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int e0 = (16 * ks + 2 * t) * sizeof(CacheT), e8 = e0 + 8 * sizeof(CacheT);
          const uint32_t a[4] = {E::pair(k0 + e0), E::pair(k8 + e0), E::pair(k0 + e8),
                                 E::pair(k8 + e8)};
          mma_16816((ks & 1) ? sb : sa, a, qb[ks][0], qb[ks][1]);
        }
        // element e: slot g + 8 (e / 2), row 2t + e % 2
        float sc[4];
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = g + 8 * (e >> 1);
          const int s = sw + key;
          float x = sa[e] + sb[e];
          if (QUANT) x *= ks_s[key];
          const int last = (e & 1) ? last1 : last0;
          const int qt = qp + ((e & 1) ? rb.t : ra.t);
          x = x * p.sm_scale - ((e & 1) ? slope1 : slope0) * static_cast<float>(qt - s);
          x = s > last ? -CUDART_INF_F : (seg_s[key] != 0 ? x : MASK_VALUE);
          sc[e] = x;
          if (e & 1) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, o));
          mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, o));
        }
        const float alpha0 = __expf(m0 - mx0), alpha1 = __expf(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = __expf(sc[e] - ((e & 1) ? m1 : m0));
          if (e & 1) ps1 += pe; else ps0 += pe;
          if (QUANT) pe *= vs_s[g + 8 * (e >> 1)];
          sc[e] = pe;
        }
        l0 = l0 * alpha0 + ps0;
        l1 = l1 * alpha1 + ps1;
        if (__any_sync(FULL, alpha0 != 1.f || alpha1 != 1.f)) {   // a row max moved
#pragma unroll
          for (int dt = 0; dt < 8; ++dt) {
            acc[dt][0] *= alpha0;
            acc[dt][1] *= alpha1;
            acc[dt][2] *= alpha0;
            acc[dt][3] *= alpha1;
          }
        }
        // P^T as the B operand: this lane takes P[row g][slots 2t, 2t+1,
        // 2t+8, 2t+9] from the lanes that hold them (register g % 2, or
        // 2 + g % 2 for the second eight slots), as hi / lo bf16 halves
        float pv[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x0 = __shfl_sync(FULL, sc[2 * h], src0);
          const float x1 = __shfl_sync(FULL, sc[2 * h + 1], src0);
          const float y0 = __shfl_sync(FULL, sc[2 * h], src1);
          const float y1 = __shfl_sync(FULL, sc[2 * h + 1], src1);
          pv[2 * h] = odd ? x1 : x0;       // slot 2t (+ 8 h)
          pv[2 * h + 1] = odd ? y1 : y0;   // slot 2t + 1 (+ 8 h)
        }
        uint32_t hi[2], lo[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t h0b = bf16_bits(pv[2 * h]), h1b = bf16_bits(pv[2 * h + 1]);
          hi[h] = pack_hi(h0b, h1b);
          lo[h] = pack_hi(bf16_bits(pv[2 * h] - __uint_as_float(h0b)),
                          bf16_bits(pv[2 * h + 1] - __uint_as_float(h1b)));
        }
        const unsigned char* v0 = vt + 2 * t * LDS;
        const unsigned char* v8 = v0 + 8 * LDS;
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          const int ca = (16 * dt + g) * sizeof(CacheT), cb = ca + 8 * sizeof(CacheT);
          const uint32_t a[4] = {E::column(v0 + ca), E::column(v0 + cb), E::column(v8 + ca),
                                 E::column(v8 + cb)};
          mma_16816(acc[dt], a, hi[0], hi[1]);
          mma_16816(acc[dt], a, lo[0], lo[1]);
        }
      }
      cp_async_wait<0>();
      __syncthreads();   // every warp is done with the ring: reuse it to merge

#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        l0 += __shfl_xor_sync(FULL, l0, o);
        l1 += __shfl_xor_sync(FULL, l1, o);
      }
      float* w0 = macc + (warp * 16 + 2 * t) * ACC_LD;   // row 2t; row 2t + 1 follows
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        w0[16 * dt + g] = acc[dt][0];
        w0[ACC_LD + 16 * dt + g] = acc[dt][1];
        w0[16 * dt + g + 8] = acc[dt][2];
        w0[ACC_LD + 16 * dt + g + 8] = acc[dt][3];
      }
      if (g == 0) {
        mml[(warp * 16 + 2 * t) * 2] = m0;
        mml[(warp * 16 + 2 * t) * 2 + 1] = l0;
        mml[(warp * 16 + 2 * t + 1) * 2] = m1;
        mml[(warp * 16 + 2 * t + 1) * 2 + 1] = l1;
      }
    } else {
      // this warp's row tile: Q fragments (zero rows past the group), slopes
      const int row0 = mt * 16 + g, row1 = row0 + 8;
      // rows past the group take row GC - 1's token and head (their Q is
      // zero and their outputs are never written)
      const Row ra = row_of(p, kvh, r0 + min(row0, GC - 1));
      const Row rb = row_of(p, kvh, r0 + min(row1, GC - 1));
      uint32_t qa[8][4];
      {
        const __nv_bfloat16* q0 = q_row(p, b, ra);
        const __nv_bfloat16* q1 = q_row(p, b, rb);
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int col = 16 * ks + 2 * t;
          qa[ks][0] = row0 < GC ? *reinterpret_cast<const uint32_t*>(q0 + col) : 0u;
          qa[ks][1] = row1 < GC ? *reinterpret_cast<const uint32_t*>(q1 + col) : 0u;
          qa[ks][2] = row0 < GC ? *reinterpret_cast<const uint32_t*>(q0 + col + 8) : 0u;
          qa[ks][3] = row1 < GC ? *reinterpret_cast<const uint32_t*>(q1 + col + 8) : 0u;
        }
      }
      const float slope0 = p.slopes ? p.slopes[ra.h] : 0.f;
      const float slope1 = p.slopes ? p.slopes[rb.h] : 0.f;
      const int last0 = min(s_end - 1, qp + ra.t), last1 = min(s_end - 1, qp + rb.t);

      float acc[16][4];
#pragma unroll
      for (int dt = 0; dt < 16; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
      // running max (quad-uniform) from the mask value: a masked slot then
      // weighs exp(0) = 1 only while no valid slot has been seen, and no
      // difference of two infinities is ever taken
      float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.f, l1 = 0.f;

      for (int i = 0; i < nt; ++i) {
        cp_async_wait<NST - 2>();
        __syncthreads();   // tile i landed for all; tile i - 1's stage is free
        if (i + NST - 1 < nt) load_tile(i + NST - 1);
        cp_async_commit();

        const unsigned char* st = smem + (i % NST) * STAGE;
        const unsigned char* kt = st + kg * KW * LDS;
        const unsigned char* vt = st + TILE * LDS + kg * KW * LDS;
        const int* seg_s = reinterpret_cast<const int*>(st + 2 * TILE * LDS) + kg * KW;
        const float* ks_s = reinterpret_cast<const float*>(seg_s + TILE);
        const float* vs_s = ks_s + TILE;
        const int sw = s_begin + i * TILE + kg * KW;   // this warp's first slot

        // S = Q K^T over this warp's KW slots
        float sc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
          const unsigned char* krow = kt + (8 * n + g) * LDS;
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) {
            const int e0 = 16 * ks + 2 * t;   // element of the row
            mma_16816(sc[n], qa[ks], E::pair(krow + e0 * sizeof(CacheT)),
                      E::pair(krow + (e0 + 8) * sizeof(CacheT)));
          }
        }
        // scaled, biased, masked scores; the tile's max per row
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 8 * n + 2 * t + (e & 1);
            const int s = sw + key;
            float x = sc[n][e];
            if (QUANT) x *= ks_s[key];
            const int last = (e & 2) ? last1 : last0;
            const int qt = qp + ((e & 2) ? rb.t : ra.t);
            x = x * p.sm_scale - ((e & 2) ? slope1 : slope0) * static_cast<float>(qt - s);
            x = s > last ? -CUDART_INF_F : (seg_s[key] != 0 ? x : MASK_VALUE);
            sc[n][e] = x;
            if (e & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
          }
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
        const float alpha0 = __expf(m0 - mx0), alpha1 = __expf(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        // P, its row sums, then P times the v scale as hi / lo bf16 halves
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pe = __expf(sc[n][e] - ((e & 2) ? m1 : m0));
            if (e & 2) ps1 += pe; else ps0 += pe;
            if (QUANT) pe *= vs_s[8 * n + 2 * t + (e & 1)];
            sc[n][e] = pe;
          }
        }
        l0 = l0 * alpha0 + ps0;
        l1 = l1 * alpha1 + ps1;
        if (__any_sync(FULL, alpha0 != 1.f || alpha1 != 1.f)) {   // a row max moved
#pragma unroll
          for (int dt = 0; dt < 16; ++dt) {
            acc[dt][0] *= alpha0;
            acc[dt][1] *= alpha0;
            acc[dt][2] *= alpha1;
            acc[dt][3] *= alpha1;
          }
        }
        // O += P V: k-step kk covers the warp's slots 16 kk .. 16 kk + 15
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // A register i: row g (i even) or g + 8, slots 2t, 2t + 1 (+ 8 for i >= 2)
            const float* c = sc[2 * kk + i / 2] + 2 * (i % 2);
            const uint32_t h0 = bf16_bits(c[0]), h1 = bf16_bits(c[1]);
            hi[i] = pack_hi(h0, h1);
            lo[i] = pack_hi(bf16_bits(c[0] - __uint_as_float(h0)),
                            bf16_bits(c[1] - __uint_as_float(h1)));
          }
          const unsigned char* vrow = vt + (16 * kk + 2 * t) * LDS;
#pragma unroll
          for (int dt = 0; dt < 16; ++dt) {
            const unsigned char* col = vrow + (8 * dt + g) * sizeof(CacheT);
            const uint32_t b0 = E::column(col), b1 = E::column(col + 8 * LDS);
            mma_16816(acc[dt], hi, b0, b1);
            mma_16816(acc[dt], lo, b0, b1);
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();   // every warp is done with the ring: reuse it to merge

      l0 += __shfl_xor_sync(FULL, l0, 1);
      l0 += __shfl_xor_sync(FULL, l0, 2);
      l1 += __shfl_xor_sync(FULL, l1, 1);
      l1 += __shfl_xor_sync(FULL, l1, 2);
      float* wacc = macc + warp * 16 * ACC_LD;
#pragma unroll
      for (int dt = 0; dt < 16; ++dt) {
        *reinterpret_cast<float2*>(wacc + g * ACC_LD + 8 * dt + 2 * t) =
            make_float2(acc[dt][0], acc[dt][1]);
        *reinterpret_cast<float2*>(wacc + (g + 8) * ACC_LD + 8 * dt + 2 * t) =
            make_float2(acc[dt][2], acc[dt][3]);
      }
      if (t == 0) {
        mml[(warp * 16 + g) * 2] = m0;
        mml[(warp * 16 + g) * 2 + 1] = l0;
        mml[(warp * 16 + g + 8) * 2] = m1;
        mml[(warp * 16 + g + 8) * 2 + 1] = l1;
      }
    }
    __syncthreads();
    // the row tile's KG warps merged in warp order: the output, or this
    // chunk's partial
    for (int x = tid; x < GC * HD; x += NTHREADS) {
      const int r = x / HD, d = x % HD;
      const int rt = r / 16, rr = r % 16;
      float M = MASK_VALUE;
#pragma unroll
      for (int k = 0; k < KG; ++k) M = fmaxf(M, mml[((rt + MT * k) * 16 + rr) * 2]);
      float L = 0.f, O = 0.f;
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        const int w = rt + MT * k;
        const float f = __expf(mml[(w * 16 + rr) * 2] - M);
        L += mml[(w * 16 + rr) * 2 + 1] * f;
        O += macc[(w * 16 + rr) * ACC_LD + d] * f;
      }
      if (p.splits == 1) {
        out_row(p, b, row_of(p, kvh, r0 + r))[d] = __float2bfloat16(O / fmaxf(L, 1e-9f));
      } else {
        float* wr = ws_rows + (size_t)r * (HD + 2);
        wr[d] = O;
        if (d == 0) {
          wr[HD] = M;
          wr[HD + 1] = L;
        }
      }
    }
  }
  if (p.splits == 1) return;

  // the last block of this (row, kv head, row group) combines the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = p.counters + (size_t)blockIdx.y * gridDim.z + z;
    is_last = atomicAdd(cnt, 1) == p.splits - 1;
    if (is_last) *cnt = 0;   // every block has counted: ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* first = p.ws + ((size_t)b * p.Hkv + kvh) * p.splits * ws_chunk +
                       (size_t)r0 * (HD + 2);
  // each row's chunk weights exp(m_k - M) (0 for an empty chunk) and 1 / L
  // in shared memory (the ring is free), then the rows' sums of the partials
  float* fac = reinterpret_cast<float*>(smem);    // [GC][splits]
  float* inv = fac + GC * p.splits;               // [GC]
  for (int x = tid; x < GC * p.splits; x += NTHREADS)
    fac[x] = __ldcg(first + (size_t)(x / p.splits) * (HD + 2) + (x % p.splits) * ws_chunk + HD);
  __syncthreads();
  for (int r = tid; r < GC; r += NTHREADS) {
    float* f = fac + r * p.splits;
    float M = -CUDART_INF_F;
    for (int k = 0; k < p.splits; ++k) M = fmaxf(M, f[k]);
    float L = 0.f;
    for (int k = 0; k < p.splits; ++k) {
      const float w = f[k] == -CUDART_INF_F ? 0.f : __expf(f[k] - M);
      L += w * __ldcg(first + (size_t)r * (HD + 2) + k * ws_chunk + HD + 1);
      f[k] = w;
    }
    inv[r] = 1.f / fmaxf(L, 1e-9f);
  }
  __syncthreads();
  // two columns a load and four pairs a thread at once, so that many loads
  // of the partials are in flight (each pass waits on L2)
  constexpr int U = 4;
  const int n = GC * HD / 2;
  for (int x0 = tid; x0 < n; x0 += U * NTHREADS) {
    float2 O[U];
    const float2* src[U];
    const float* f[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x = min(x0 + u * NTHREADS, n - 1);
      const int r = x / (HD / 2), d = 2 * (x % (HD / 2));
      src[u] = reinterpret_cast<const float2*>(first + (size_t)r * (HD + 2) + d);
      f[u] = fac + r * p.splits;
      O[u] = make_float2(0.f, 0.f);
    }
#pragma unroll 4
    for (int k = 0; k < p.splits; ++k) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float2 a = __ldcg(src[u] + k * (ws_chunk / 2));
        const float w = f[u][k];
        // an empty chunk's acc was never written: select, not multiply
        O[u].x += w != 0.f ? w * a.x : 0.f;
        O[u].y += w != 0.f ? w * a.y : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x = x0 + u * NTHREADS;
      if (x >= n) break;
      const int r = x / (HD / 2), d = 2 * (x % (HD / 2));
      *reinterpret_cast<__nv_bfloat162*>(out_row(p, b, row_of(p, kvh, r0 + r)) + d) =
          __floats2bfloat162_rn(O[u].x * inv[r], O[u].y * inv[r]);
    }
  }
}

template <typename CacheT, bool QUANT, int MT, bool SMALL>
int launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<CacheT>();
  static_assert(NWARPS * 16 * (ACC_LD + 2) * 4 <= smem, "the merge area fits the ring");
  static_assert(MAX_ROWS * (MAX_SPLITS + 1) * 4 <= smem, "the combine's weights fit the ring");
  auto kernel = decode_kernel<CacheT, QUANT, MT, SMALL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.splits, B * a.Hkv, (a.R + MAX_ROWS - 1) / MAX_ROWS);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename CacheT, bool QUANT>
int launch_rows(const DecodeArgs& a, int B, cudaStream_t stream) {
  if (a.R <= 8) return launch<CacheT, QUANT, 1, true>(a, B, stream);
  if (a.R <= 16) return launch<CacheT, QUANT, 1, false>(a, B, stream);
  if (a.R <= 32) return launch<CacheT, QUANT, 2, false>(a, B, stream);
  return launch<CacheT, QUANT, 4, false>(a, B, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). `quantized`
// selects the int8 cache (k, v int8; ks, vs f32 scales) over bf16; `slopes`
// (f32 [H], or null) adds ALiBi. `Tq` (1..8) query tokens a row, token t at
// q_pos + t. `splits` chunks of the cache per (row, kv head); with splits >
// 1, `ws` is the f32 workspace [B, Hkv, splits, G * Tq, 130] and `counters`
// an int32 buffer of B * Hkv * ceil(G * Tq / 64) zeros, left zero.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* ks, const void* vs,
                                    const void* seg, const void* q_pos, const void* slopes,
                                    void* out, void* ws, void* counters,
                                    int B, int S, int H, int Hkv, int Tq, int quantized,
                                    int splits, int q_sb, int q_st, int q_sh,
                                    int c_sb, int c_ss, int c_sh,
                                    int s_sb, int s_ss, int s_sh,
                                    int seg_sb, float sm_scale, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS || (splits > 1 && (!ws || !counters)) || Tq < 1 ||
      Tq > 8)
    return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.seg = static_cast<const int*>(seg);
  a.q_pos = static_cast<const int*>(q_pos);
  a.slopes = static_cast<const float*>(slopes);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.S = S;
  a.H = H;
  a.G = H / Hkv;
  a.Hkv = Hkv;
  a.splits = splits;
  a.Tq = Tq;
  a.R = a.G * Tq;
  a.q_sb = q_sb; a.q_st = q_st; a.q_sh = q_sh;
  a.c_sb = c_sb; a.c_ss = c_ss; a.c_sh = c_sh;
  a.s_sb = s_sb; a.s_ss = s_ss; a.s_sh = s_sh;
  a.seg_sb = seg_sb;
  a.sm_scale = sm_scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return quantized ? launch_rows<int8_t, true>(a, B, st)
                   : launch_rows<__nv_bfloat16, false>(a, B, st);
}
