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
// The design streams a page's token rows in place: pages are token-major
// [NP, 2, P, Hkv, D], so one token of one head is D contiguous elements at a
// stride of Hkv * D; each warp reads whole 256-byte (bf16) or 128-byte (int8)
// rows with one coalesced load per lane and keeps 8 tokens in flight; scales
// (head-major [NP, 2, Hkv, P]) touch only the score and probability scalars.
// One block per (kv head, slot) (and per group of 8 query rows in the general
// kernel), so each page row is read once for all the rows of a block; the
// block walks its own page list (no scalar prefetch, no grid carry). Page
// offsets are 64-bit: a 7B layer's pool is 2.7e8 elements and pools grow.
// Splitting a slot's pages over several blocks is later work.
//
// Layout: q [B, Tq, H, D] strided, D = 128; cur_k / cur_v [B, Tq, Hkv, D]
// strided; pool [NP, 2, P, Hkv, D] and scales [NP, 2, Hkv, P] contiguous;
// page_ids [B, maxp] int32 (row stride pt_sb); lengths, valid [B] int32; out
// [B, Tq, H, D] contiguous bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int KB = 8;      // tokens in flight per warp
constexpr int MAXR = 8;    // query rows per block of the general kernel
constexpr int MAXT = 8;    // chunk tokens in the self block
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

// _kernel_decode1: one query row (head kvh of slot b, Tq == 1, H == Hkv).
template <typename CacheT, bool QUANT>
__global__ void __launch_bounds__(NTHREADS) paged_decode1_kernel(const Args a) {
  __shared__ Partials<1> sm;
  __shared__ float s_self;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = lane * 4;
  const int len = min(a.lengths[b], a.maxp * a.P);

  float qr[1][4], m[1] = {NEG_INF}, l[1] = {0.f}, acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
  const float slope[1] = {a.slopes != nullptr ? a.slopes[kvh] : 0.f};
  // the query sits at `lengths` with a current chunk, else at lengths - 1
  const int qpos[1] = {a.has_cur ? a.lengths[b] : a.lengths[b] - 1};
  load4(a.q + (size_t)b * a.q_sb + (size_t)kvh * a.q_sh + d0, qr[0]);
  sweep_pool<CacheT, QUANT, 1>(a, b, kvh, len, 1, qr, slope, qpos, m, l, acc);
  store_partials<1>(sm, 1, m, l, acc);
  if (a.has_cur && warp == 0) {
    // the current token, at the query's own position (ALiBi distance 0): a
    // single-entry self block
    float kx[4];
    load4(a.cur_k + (size_t)b * a.c_sb + (size_t)kvh * a.c_sh + d0, kx);
    const float dot = warp_sum(qr[0][0] * kx[0] + qr[0][1] * kx[1] +
                               qr[0][2] * kx[2] + qr[0][3] * kx[3]);
    if (lane == 0) s_self = a.valid[b] > 0 ? dot * a.sm_scale : -CUDART_INF_F;
  }
  __syncthreads();

  const int d = threadIdx.x;  // NTHREADS == HD: one output column per thread
  float mx, lt, o;
  merge_row<1>(sm, 0, d, mx, lt, o);
  if (a.has_cur) {
    const float m2 = fmaxf(mx, s_self);
    const float f = expf(mx - m2), ps = expf(s_self - m2);
    const float cv = __bfloat162float(a.cur_v[(size_t)b * a.c_sb + (size_t)kvh * a.c_sh + d]);
    lt = lt * f + ps;
    o = o * f + ps * cv;
  }
  a.out[((size_t)b * a.H + kvh) * HD + d] = __float2bfloat16(o / fmaxf(lt, 1e-9f));
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
// `slopes` (f32 [H], or null) adds ALiBi.
extern "C" int paged_decode1_fwd(const void* q, const void* cur_k, const void* cur_v,
                                 const void* pool, const void* scale, const void* page_ids,
                                 const void* lengths, const void* valid, const void* slopes,
                                 void* out, int B, int P, int H, int Hkv, int Tq, int maxp,
                                 int quantized, int has_cur,
                                 int q_sb, int q_st, int q_sh, int c_sb, int c_st, int c_sh,
                                 int pt_sb, float sm_scale, void* stream) {
  if (H != Hkv || Tq != 1) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, cur_k, cur_v, pool, scale, page_ids, lengths, valid, slopes, out,
                           P, H, Hkv, Tq, maxp, has_cur, q_sb, q_st, q_sh, c_sb, c_st, c_sh,
                           pt_sb, sm_scale);
  const dim3 grid(Hkv, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized) {
    paged_decode1_kernel<int8_t, true><<<grid, NTHREADS, 0, st>>>(a);
  } else {
    paged_decode1_kernel<__nv_bfloat16, false><<<grid, NTHREADS, 0, st>>>(a);
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
