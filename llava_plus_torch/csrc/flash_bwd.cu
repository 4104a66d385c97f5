// Flash-attention backward for Hopper (sm_90a): two kernels, bf16 in and out.
//
// Replaces the Pallas TPU kernels llava_plus_tpu/ops/flash_attention.py:
// _bwd_dkv_kernel (dK, dV) and _bwd_dq_kernel (dQ), launched by _bwd from
// _flash_bwd_rule. Same function: the recompute-free backward that replays
// the softmax from the forward's per-row logsumexp,
//   P = exp(S * scale - lse),  masked by select (causal, q_seg == k_seg,
//       k_seg != 0, q_seg != 0) AFTER the exp, so the huge lse of a row that
//       saw no key (exp overflows to inf) never reaches a product;
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - delta) * scale,
//   dK = dS^T Q,  dQ = dS K,
// with delta = rowsum(dO * O) computed by the caller (f32). With per-head
// f32 slopes (MPT's ALiBi: the Pallas use_alibi branches, _bwd_dkv_kernel
// :258-260 and _bwd_dq_kernel :348-350) the scaled score loses
// slope_h * |q_pos - k_pos| before the exp, positions taken from the tile
// indices in the padded T as the forward takes them; the absolute value
// serves the non-causal calls too. ALiBi is a template parameter, so the
// LLaMA instances compile to the code without it.
//
// What bounds them on the card: at training shapes both are compute-bound
// (dK/dV does 8*T*T*D flops per head, dQ 6*T*T*D, halved when causal, over
// ~6*T*D*2 bytes). So every product runs on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 accumulators); S, P, dP and dS stay in
// registers and never touch device memory; tiles above the causal diagonal
// are skipped. As in the forward, the f32 accumulator of P (and dS) is
// rounded to bf16 and fed straight in as the A operand of the next product.
//
// Grid, unlike the Pallas one (which carries scratch across a sequential
// grid axis): the dK/dV kernel runs one block per (batch, kv head, 64-row kv
// tile); it holds the tile's K and V in shared memory and loops over the G
// query heads of its kv head and, for each, over the q tiles that can see
// the tile. dK and dV sum the whole group in f32 registers, so GQA needs no
// atomics and no per-query-head temporaries (the JAX rule repeats k/v and
// folds afterwards: the same function). The dQ kernel runs one block per
// (batch, query head, 64-row q tile) and loops over the kv tiles up to the
// diagonal. Both are deterministic. This first version loads tiles with
// plain 16-byte loads and no pipelining; wgmma, TMA and a producer warp are
// later work.
//
// Layout: q, k, v, dO are strided [B, T, H, D] / [B, T, Hkv, D] with
// D = 128 and the last dimension contiguous; lse and delta [B, H, T] f32;
// segment ids [B, T] int32. T is a multiple of 64 (the wrapper pads with
// segment 0). Out: dq [B, T, H, D], dk and dv [B, T, Hkv, D], contiguous bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // rows of a q tile and of a kv tile
constexpr int HD = 128;         // head dim
constexpr int NTHREADS = 128;   // 4 warps, 16 rows each
constexpr int LD = HD + 8;      // smem row stride (bf16): 272 bytes, spreads banks

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 of one column from consecutive rows, packed low/high.
__device__ __forceinline__ uint32_t ld_col2(const __nv_bfloat16* p) {
  const uint16_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint16_t hi = *reinterpret_cast<const uint16_t*>(p + LD);
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// The A fragment (16 rows x 16 of k) of rows r0, r0 + 8 at k-step kc.
__device__ __forceinline__ void ld_a(uint32_t* a, const __nv_bfloat16* tile,
                                     int r0, int kc, int tig) {
  const int c = kc * 16 + tig * 2;
  a[0] = ld32(tile + r0 * LD + c);
  a[1] = ld32(tile + (r0 + 8) * LD + c);
  a[2] = ld32(tile + r0 * LD + c + 8);
  a[3] = ld32(tile + (r0 + 8) * LD + c + 8);
}

// The accumulators of n-tiles 2kc and 2kc + 1 as the A fragment of k-step kc.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*s)[4], int kc) {
  a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
  a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
  a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// C[16 x 64] = A[16 x 128] B^T where B's 64 rows (n) are rows of a smem tile
// holding the 128 values of k contiguously: A rows from a smem tile too.
__device__ __forceinline__ void mma_rows(float (*c)[4], const __nv_bfloat16* a_tile,
                                         const __nv_bfloat16* b_tile, int r0, int g,
                                         int tig) {
#pragma unroll
  for (int nt = 0; nt < BM / 8; ++nt)
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    uint32_t a[4];
    ld_a(a, a_tile, r0, kc, tig);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
      const __nv_bfloat16* brow = b_tile + (nt * 8 + g) * LD + kc * 16 + tig * 2;
      mma_16816(c[nt], a, ld32(brow), ld32(brow + 8));
    }
  }
}

// acc[16 x 128] += A[16 x 64] (from accumulators s) . B[64 x 128], B a smem
// tile read down its columns.
__device__ __forceinline__ void mma_acc_cols(float (*acc)[4], const float (*s)[4],
                                             const __nv_bfloat16* b_tile, int g, int tig) {
#pragma unroll
  for (int kc = 0; kc < BM / 16; ++kc) {
    uint32_t a[4];
    acc_to_a(a, s, kc);
    const __nv_bfloat16* col = b_tile + (kc * 16 + tig * 2) * LD + g;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      mma_16816(acc[dt], a, ld_col2(col + dt * 8), ld_col2(col + 8 * LD + dt * 8));
  }
}

__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int row_stride, int tid) {
  // 64 rows x 128 columns = 64 x 16 chunks of 16 bytes
  for (int i = tid; i < BM * (HD / 8); i += NTHREADS) {
    const int r = i / (HD / 8);
    const int c = (i % (HD / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * row_stride + c);
  }
}

__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (*acc)[4],
                                           size_t row0_off, size_t row1_off, int tig) {
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(out + row0_off + dt * 8 + tig * 2) =
        pack_bf16(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<uint32_t*>(out + row1_off + dt * 8 + tig * 2) =
        pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const int* q_seg;
  const int* kv_seg;
  const float* lse;
  const float* delta;
  const float* slopes;   // [H] f32, read only by the ALiBi instances
  int T, H, G, causal;
  int q_sb, q_st, q_sh;
  int k_sb, k_st, k_sh;
  int o_sb, o_st, o_sh;
  float sm_scale;
};

// dK, dV of one 64-row kv tile of one (batch, kv head), summed over the G
// query heads of the group. Each warp owns 16 kv rows and computes the
// transposed products (S^T = K Q^T, dP^T = V dO^T) so its rows accumulate
// in registers over the whole loop.
template <bool ALIBI>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(BwdArgs p, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BM * LD;
  __nv_bfloat16* Qs = Vs + BM * LD;
  __nv_bfloat16* Os = Qs + BM * LD;   // dO tile
  float* lse_s = reinterpret_cast<float*>(Os + BM * LD);
  float* delta_s = lse_s + BM;
  int* qseg_s = reinterpret_cast<int*>(delta_s + BM);
  int* kseg_s = qseg_s + BM;

  const int T = p.T, Hkv = p.H / p.G;
  const int k_start = blockIdx.x * BM;
  const int b = blockIdx.y / Hkv;
  const int kvh = blockIdx.y % Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int r0 = warp * 16 + g;        // this thread's kv rows: r0, r0 + 8
  const int kpos0 = k_start + r0, kpos1 = kpos0 + 8;

  load_tile(Ks, p.k + (size_t)b * p.k_sb + (size_t)kvh * p.k_sh + (size_t)k_start * p.k_st,
            p.k_st, tid);
  load_tile(Vs, p.v + (size_t)b * p.k_sb + (size_t)kvh * p.k_sh + (size_t)k_start * p.k_st,
            p.k_st, tid);
  if (tid < BM) kseg_s[tid] = p.kv_seg[(size_t)b * T + k_start + tid];
  __syncthreads();
  const int ks0 = kseg_s[r0], ks1 = kseg_s[r0 + 8];

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  const int n_tiles = T / BM;
  const int first = p.causal ? blockIdx.x : 0;   // q tiles below the diagonal see nothing
  for (int gi = 0; gi < p.G; ++gi) {
    const int h = kvh * p.G + gi;
    const float slope = ALIBI ? p.slopes[h] : 0.f;
    const __nv_bfloat16* qb = p.q + (size_t)b * p.q_sb + (size_t)h * p.q_sh;
    const __nv_bfloat16* ob = p.dout + (size_t)b * p.o_sb + (size_t)h * p.o_sh;
    const float* lrow = p.lse + ((size_t)b * p.H + h) * T;
    const float* drow = p.delta + ((size_t)b * p.H + h) * T;
    for (int i = first; i < n_tiles; ++i) {
      const int q_start = i * BM;
      __syncthreads();  // everyone is done with the previous Q / dO tile
      load_tile(Qs, qb + (size_t)q_start * p.q_st, p.q_st, tid);
      load_tile(Os, ob + (size_t)q_start * p.o_st, p.o_st, tid);
      if (tid < BM) {
        lse_s[tid] = lrow[q_start + tid];
        delta_s[tid] = drow[q_start + tid];
        qseg_s[tid] = p.q_seg[(size_t)b * T + q_start + tid];
      }
      __syncthreads();

      // S^T = K Q^T (16 kv rows x 64 q columns), then P^T.
      float s[BM / 8][4];
      mma_rows(s, Ks, Qs, r0, g, tig);
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + tig * 2 + (e & 1);
          const int qpos = q_start + col;
          const int kpos = (e < 2) ? kpos0 : kpos1;
          const int ksg = (e < 2) ? ks0 : ks1;
          const int qsg = qseg_s[col];
          const bool valid = (!p.causal || kpos <= qpos) && ksg == qsg && ksg != 0;
          float sc = s[nt][e] * p.sm_scale;
          if (ALIBI) sc -= slope * fabsf(static_cast<float>(qpos - kpos));
          const float pe = expf(sc - lse_s[col]);
          s[nt][e] = valid ? pe : 0.f;   // select: pe may be inf on a padding row
        }
      }
      // dV += P^T dO
      mma_acc_cols(dv_acc, s, Os, g, tig);

      // dP^T = V dO^T; dS^T = P^T (dP^T - delta) * scale
      float dp[BM / 8][4];
      mma_rows(dp, Vs, Os, r0, g, tig);
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + tig * 2 + (e & 1);
          dp[nt][e] = s[nt][e] * (dp[nt][e] - delta_s[col]) * p.sm_scale;
        }
      }
      // dK += dS^T Q
      mma_acc_cols(dk_acc, dp, Qs, g, tig);
    }
  }

  const size_t row0 = (((size_t)b * T + kpos0) * Hkv + kvh) * HD;
  const size_t row1 = (((size_t)b * T + kpos1) * Hkv + kvh) * HD;
  store_rows(dk, dk_acc, row0, row1, tig);
  store_rows(dv, dv_acc, row0, row1, tig);
}

// dQ of one 64-row q tile of one (batch, query head). Each warp owns 16 q
// rows, holds their Q fragments in registers and accumulates dQ over the kv
// tiles up to the diagonal.
template <bool ALIBI>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(BwdArgs p, __nv_bfloat16* __restrict__ dq) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Os = Qs + BM * LD;   // dO tile
  __nv_bfloat16* Ks = Os + BM * LD;
  __nv_bfloat16* Vs = Ks + BM * LD;
  int* kseg_s = reinterpret_cast<int*>(Vs + BM * LD);

  const int T = p.T;
  const int q_start = blockIdx.x * BM;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / p.G;
  const float slope = ALIBI ? p.slopes[h] : 0.f;   // the Pallas slopes[bh % H]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int r0 = warp * 16 + g;        // this thread's q rows: r0, r0 + 8
  const int row0 = q_start + r0, row1 = row0 + 8;

  load_tile(Qs, p.q + (size_t)b * p.q_sb + (size_t)h * p.q_sh + (size_t)q_start * p.q_st,
            p.q_st, tid);
  load_tile(Os, p.dout + (size_t)b * p.o_sb + (size_t)h * p.o_sh + (size_t)q_start * p.o_st,
            p.o_st, tid);
  __syncthreads();

  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) ld_a(qa[kc], Qs, r0, kc, tig);
  const float* lrow = p.lse + ((size_t)b * p.H + h) * T;
  const float* drow = p.delta + ((size_t)b * p.H + h) * T;
  const float lse0 = lrow[row0], lse1 = lrow[row1];
  const float dl0 = drow[row0], dl1 = drow[row1];
  const int qs0 = p.q_seg[(size_t)b * T + row0], qs1 = p.q_seg[(size_t)b * T + row1];

  float dq_acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    dq_acc[dt][0] = dq_acc[dt][1] = dq_acc[dt][2] = dq_acc[dt][3] = 0.f;

  const __nv_bfloat16* kb = p.k + (size_t)b * p.k_sb + (size_t)kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + (size_t)b * p.k_sb + (size_t)kvh * p.k_sh;
  const int n_tiles = T / BM;
  const int last = p.causal ? blockIdx.x : n_tiles - 1;
  for (int j = 0; j <= last; ++j) {
    const int k_start = j * BM;
    __syncthreads();  // everyone is done with the previous K / V tile
    load_tile(Ks, kb + (size_t)k_start * p.k_st, p.k_st, tid);
    load_tile(Vs, vb + (size_t)k_start * p.k_st, p.k_st, tid);
    if (tid < BM) kseg_s[tid] = p.kv_seg[(size_t)b * T + k_start + tid];
    __syncthreads();

    // S = Q K^T (16 q rows x 64 kv columns), then P.
    float s[BM / 8][4];
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = Ks + (nt * 8 + g) * LD + tig * 2;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc)
        mma_16816(s[nt], qa[kc], ld32(krow + kc * 16), ld32(krow + kc * 16 + 8));
    }
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);
        const int kpos = k_start + col;
        const int qpos = (e < 2) ? row0 : row1;
        const int qsg = (e < 2) ? qs0 : qs1;
        const int ksg = kseg_s[col];
        const bool valid = (!p.causal || kpos <= qpos) && ksg == qsg && ksg != 0;
        float sc = s[nt][e] * p.sm_scale;
        if (ALIBI) sc -= slope * fabsf(static_cast<float>(qpos - kpos));
        const float pe = expf(sc - ((e < 2) ? lse0 : lse1));
        s[nt][e] = valid ? pe : 0.f;   // select: pe may be inf on a padding row
      }
    }

    // dP = dO V^T; dS = P (dP - delta) * scale
    float dp[BM / 8][4];
    mma_rows(dp, Os, Vs, r0, g, tig);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
      dp[nt][0] = s[nt][0] * (dp[nt][0] - dl0) * p.sm_scale;
      dp[nt][1] = s[nt][1] * (dp[nt][1] - dl0) * p.sm_scale;
      dp[nt][2] = s[nt][2] * (dp[nt][2] - dl1) * p.sm_scale;
      dp[nt][3] = s[nt][3] * (dp[nt][3] - dl1) * p.sm_scale;
    }
    // dQ += dS K
    mma_acc_cols(dq_acc, dp, Ks, g, tig);
  }

  store_rows(dq, dq_acc, (((size_t)b * T + row0) * p.H + h) * HD,
             (((size_t)b * T + row1) * p.H + h) * HD, tig);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const void* q_seg, const void* kv_seg, const void* lse,
                  const void* delta, const void* slopes, int T, int H, int Hkv, int causal,
                  int q_sb, int q_st, int q_sh, int k_sb, int k_st, int k_sh,
                  int o_sb, int o_st, int o_sh, float sm_scale) {
  BwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.q_seg = static_cast<const int*>(q_seg);
  a.kv_seg = static_cast<const int*>(kv_seg);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.slopes = static_cast<const float*>(slopes);
  a.T = T;
  a.H = H;
  a.G = H / Hkv;
  a.causal = causal;
  a.q_sb = q_sb; a.q_st = q_st; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.o_sb = o_sb; a.o_st = o_st; a.o_sh = o_sh;
  a.sm_scale = sm_scale;
  return a;
}

template <bool ALIBI>
int launch_dkv(const BwdArgs& a, int B, void* dk, void* dv, void* stream) {
  const int smem = 4 * BM * LD * (int)sizeof(__nv_bfloat16) + 4 * BM * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<ALIBI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.T / BM, B * (a.H / a.G));
  flash_bwd_dkv_kernel<ALIBI><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv));
  return (int)cudaGetLastError();
}

template <bool ALIBI>
int launch_dq(const BwdArgs& a, int B, void* dq, void* stream) {
  const int smem = 4 * BM * LD * (int)sizeof(__nv_bfloat16) + BM * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<ALIBI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.T / BM, B * a.H);
  flash_bwd_dq_kernel<ALIBI><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<__nv_bfloat16*>(dq));
  return (int)cudaGetLastError();
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched). `slopes`
// (f32 [H], or null) selects the ALiBi instance.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* q_seg, const void* kv_seg,
                                  const void* lse, const void* delta, const void* slopes,
                                  void* dk, void* dv,
                                  int B, int T, int H, int Hkv, int causal,
                                  int q_sb, int q_st, int q_sh,
                                  int k_sb, int k_st, int k_sh,
                                  int o_sb, int o_st, int o_sh,
                                  float sm_scale, void* stream) {
  const BwdArgs a = make_args(q, k, v, dout, q_seg, kv_seg, lse, delta, slopes, T, H, Hkv,
                              causal, q_sb, q_st, q_sh, k_sb, k_st, k_sh, o_sb, o_st, o_sh,
                              sm_scale);
  return (slopes ? launch_dkv<true> : launch_dkv<false>)(a, B, dk, dv, stream);
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* q_seg, const void* kv_seg,
                                 const void* lse, const void* delta, const void* slopes,
                                 void* dq,
                                 int B, int T, int H, int Hkv, int causal,
                                 int q_sb, int q_st, int q_sh,
                                 int k_sb, int k_st, int k_sh,
                                 int o_sb, int o_st, int o_sh,
                                 float sm_scale, void* stream) {
  const BwdArgs a = make_args(q, k, v, dout, q_seg, kv_seg, lse, delta, slopes, T, H, Hkv,
                              causal, q_sb, q_st, q_sh, k_sb, k_st, k_sh, o_sb, o_st, o_sh,
                              sm_scale);
  return (slopes ? launch_dq<true> : launch_dq<false>)(a, B, dq, stream);
}
