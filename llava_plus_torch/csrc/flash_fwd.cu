// Flash-attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas TPU kernel llava_plus_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _fwd, wrapper flash_attention). Same function: causal
// online-softmax attention over [B, T, H, D] with segment-id masking
// (segment 0 = padding, masked), per-row logsumexp written beside the output.
// The ALiBi variant (MPT; the Pallas kernel's use_alibi, slope of query head
// h) is the template instance ALIBI = true: per-head f32 slopes come in by
// pointer and `slope_h * |q_pos - k_pos|` is subtracted from each scaled
// score before the mask and the running max. Positions are token indices:
// ALiBi is translation-invariant, so this equals the JAX bias for any
// contiguous positions.
//
// What bounds it on the card: prefill attention is compute-bound
// (4*T*T*D flops per head against 4*T*D*2 bytes; at T=768, D=128 about 384
// flops per byte, above the H100's ~295 bf16 ridge). So the products run on
// the tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulators), the
// softmax state stays in registers, and S/P never touch device memory.
// Tiles above the causal diagonal are skipped (half the work at T == Tkv).
// This first version keeps one 64-row q tile per block, loads K/V with plain
// 16-byte loads and no pipelining; wgmma, TMA and a producer warp are later work.
//
// Layout: q, k, v are strided [B, T, H, D] / [B, T, Hkv, D] with D = 128 and
// the last dimension contiguous; GQA reads kv head h / G in the kernel. T is
// a multiple of 64 (the wrapper pads with segment 0). Out: o [B, T, H, D]
// contiguous bf16, lse [B, H, T] f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // q rows per block: 16 per warp
constexpr int BN = 64;          // kv rows per tile
constexpr int HD = 128;         // head dim
constexpr int NTHREADS = 128;   // 4 warps
constexpr int LD = HD + 8;      // smem row stride (bf16): 272 bytes, spreads banks
// The JAX package's finite mask value (-0.7 * f32 max): a fully masked row
// stays finite instead of turning into NaN.
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

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

__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int row_stride, int tid) {
  // 64 rows x 128 columns = 64 x 16 chunks of 16 bytes
  for (int i = tid; i < 64 * (HD / 8); i += NTHREADS) {
    const int r = i / (HD / 8);
    const int c = (i % (HD / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * row_stride + c);
  }
}

template <bool ALIBI>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg,
                 const float* __restrict__ slopes,
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse,
                 int T, int H, int G, int causal,
                 int q_sb, int q_st, int q_sh,
                 int k_sb, int k_st, int k_sh,
                 float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BM * LD;
  __nv_bfloat16* Vs = Ks + BN * LD;
  int* kseg_s = reinterpret_cast<int*>(Vs + BN * LD);

  const int q_start = blockIdx.x * BM;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / G;
  const float slope = ALIBI ? slopes[h] : 0.f;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;    // row within the warp's 8-row group
  const int tig = lane & 3;   // thread in group: column pair

  const __nv_bfloat16* qb = q + (size_t)b * q_sb + (size_t)h * q_sh;
  const __nv_bfloat16* kb = k + (size_t)b * k_sb + (size_t)kvh * k_sh;
  const __nv_bfloat16* vb = v + (size_t)b * k_sb + (size_t)kvh * k_sh;

  load_tile(Qs, qb + (size_t)q_start * q_st, q_st, tid);
  __syncthreads();

  // A fragments of this warp's 16 q rows, all 8 k-steps of D.
  const int r0 = warp * 16 + g;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    const int c = kc * 16 + tig * 2;
    qa[kc][0] = ld32(Qs + r0 * LD + c);
    qa[kc][1] = ld32(Qs + (r0 + 8) * LD + c);
    qa[kc][2] = ld32(Qs + r0 * LD + c + 8);
    qa[kc][3] = ld32(Qs + (r0 + 8) * LD + c + 8);
  }

  const int row0 = q_start + r0;   // absolute q positions of this thread's rows
  const int row1 = row0 + 8;
  const int qs0 = q_seg[(size_t)b * T + row0];
  const int qs1 = q_seg[(size_t)b * T + row1];

  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max (quad-uniform)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sum
  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int n_tiles = T / BN;
  const int last = causal ? min(n_tiles - 1, (q_start + BM - 1) / BN) : n_tiles - 1;

  for (int j = 0; j <= last; ++j) {
    const int k_start = j * BN;
    __syncthreads();  // everyone is done with the previous K/V tile
    load_tile(Ks, kb + (size_t)k_start * k_st, k_st, tid);
    load_tile(Vs, vb + (size_t)k_start * k_st, k_st, tid);
    if (tid < BN) kseg_s[tid] = kv_seg[(size_t)b * T + k_start + tid];
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns (8 n-tiles of 8).
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = Ks + (nt * 8 + g) * LD + tig * 2;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc)
        mma_16816(s[nt], qa[kc], ld32(krow + kc * 16), ld32(krow + kc * 16 + 8));
    }

    // Scale, mask, and the tile's row max.
    float mx0 = MASK_VALUE, mx1 = MASK_VALUE;
    bool ok[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);
        const int kpos = k_start + col;
        const int qpos = (e < 2) ? row0 : row1;
        const int qsg = (e < 2) ? qs0 : qs1;
        const int ksg = kseg_s[col];
        const bool valid = (!causal || kpos <= qpos) && ksg == qsg && ksg != 0;
        ok[nt][e] = valid;
        float sc = s[nt][e] * sm_scale;
        if (ALIBI) sc -= slope * fabsf(static_cast<float>(qpos - kpos));
        s[nt][e] = valid ? sc : MASK_VALUE;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // Probabilities; masked ones are exactly 0 (a fully masked row would
    // otherwise get exp(0) = 1 everywhere).
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = ok[nt][0] ? expf(s[nt][0] - mn0) : 0.f;
      s[nt][1] = ok[nt][1] ? expf(s[nt][1] - mn0) : 0.f;
      s[nt][2] = ok[nt][2] ? expf(s[nt][2] - mn1) : 0.f;
      s[nt][3] = ok[nt][3] ? expf(s[nt][3] - mn1) : 0.f;
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // O += P V. The S accumulator layout of two adjacent n-tiles is the A
    // fragment layout of one k-step, so P goes from registers straight in.
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const __nv_bfloat16* vrow = Vs + (kc * 16 + tig * 2) * LD + g;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
        mma_16816(acc[dt], pa, ld_col2(vrow + dt * 8), ld_col2(vrow + 8 * LD + dt * 8));
    }
  }

  // Row sums across the quad, then normalise and write.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ls0 = (l0 == 0.f) ? 1.f : l0;
  const float ls1 = (l1 == 0.f) ? 1.f : l1;
  const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;

  __nv_bfloat16* o0 = o + (((size_t)b * T + row0) * H + h) * HD + tig * 2;
  __nv_bfloat16* o1 = o + (((size_t)b * T + row1) * H + h) * HD + tig * 2;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(o0 + dt * 8) = pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    *reinterpret_cast<uint32_t*>(o1 + dt * 8) = pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  if (tig == 0) {
    float* lrow = lse + ((size_t)b * H + h) * T;
    lrow[row0] = m0 + logf(ls0);
    lrow[row1] = m1 + logf(ls1);
  }
}

template <bool ALIBI>
int launch(const void* q, const void* k, const void* v, const void* q_seg,
           const void* kv_seg, const void* slopes, void* o, void* lse, int B, int T,
           int H, int Hkv, int causal, int q_sb, int q_st, int q_sh, int k_sb,
           int k_st, int k_sh, float sm_scale, void* stream) {
  const int smem = (BM + 2 * BN) * LD * (int)sizeof(__nv_bfloat16) + BN * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<ALIBI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(T / BM, B * H);
  flash_fwd_kernel<ALIBI><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<const float*>(slopes),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), T, H, H / Hkv, causal,
      q_sb, q_st, q_sh, k_sb, k_st, k_sh, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). `slopes`
// (f32 [H], or null) selects the ALiBi variant.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* q_seg, const void* kv_seg, const void* slopes,
                              void* o, void* lse,
                              int B, int T, int H, int Hkv, int causal,
                              int q_sb, int q_st, int q_sh,
                              int k_sb, int k_st, int k_sh,
                              float sm_scale, void* stream) {
  return (slopes ? launch<true> : launch<false>)(
      q, k, v, q_seg, kv_seg, slopes, o, lse, B, T, H, Hkv, causal, q_sb, q_st, q_sh,
      k_sb, k_st, k_sh, sm_scale, stream);
}
