// Flash-decode attention for Hopper (sm_90a): one query token per sequence
// over the dense KV cache, bf16 or int8 with per-(token, kv-head) scales.
//
// Replaces the Pallas TPU kernel llava_plus_tpu/ops/decode_attention.py:_kernel
// (wrapper decode_attention). Same function: G = H / Hkv query rows per kv
// head, slots with seg == 0 masked, online softmax, and for int8 the k scale
// folded into the scores and the v scale into the probabilities. Slots past
// the query position take no part, as in the XLA path it stands in for
// (llava_plus_tpu/ops/attention.py:quant_cache_attention); they are never
// read. (Only a row with no valid slot at all could tell the two apart.)
// With per-head f32 slopes (MPT's ALiBi, or null) each visible slot's scaled
// score loses `slope_h * (q_pos - s)`; s <= q_pos always, so this is the
// JAX bias -slope_h * |q_pos - s| that MPT's dense decode adds to XLA's
// quant_cache_attention (llava_plus_tpu/models/mpt.py).
//
// What bounds it on the card: a decode step reads every cache byte once and
// does ~2 flops per byte per query row, far below the H100's bf16 ridge, so
// it is HBM-bound. The design reads the model's [B, S, Hkv, D] cache in place
// through strides (no transposed copy), each warp streams whole 256-byte (bf16)
// or 128-byte (int8) key/value rows with one coalesced load per lane, keeps 8
// keys in flight per warp, and reads int8 directly (the scales touch only the
// score and probability scalars). One block per (kv head, batch row, chunk of
// 8 query rows) holds its chunk's rows in registers (qr[8][4], acc[8][4]), so
// each cache row is read once per chunk: once for a group of up to 8 (LLaMA's
// MHA and GQA), and G / 8 times, mostly from L2, for a wider MQA group (the
// Pallas kernel takes any G as one block; 32 rows here would spill). At batch
// 1 that is only Hkv blocks (32 at 7B), well short of the 132 SMs; splitting S
// across blocks is later work.
//
// Layout: q [B, H, D] strided, D = 128; cache [B, S, Hkv, D] strided; scales
// [B, S, Hkv] f32 strided; seg [B, S] int32; q_pos [B] int32; out [B, H, D]
// contiguous bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int KB = 8;     // keys in flight per warp
constexpr int MAXG = 8;   // query rows a block holds (blockIdx.z picks the chunk)
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

template <typename CacheT, bool QUANT>
__global__ void __launch_bounds__(NTHREADS)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const CacheT* __restrict__ kc, const CacheT* __restrict__ vc,
              const float* __restrict__ ks, const float* __restrict__ vs,
              const int* __restrict__ seg, const int* __restrict__ q_pos,
              const float* __restrict__ slopes,
              __nv_bfloat16* __restrict__ out,
              int S, int H, int G,
              int q_sb, int q_sh,
              int c_sb, int c_ss, int c_sh,
              int s_sb, int s_ss, int s_sh,
              int seg_sb, float sm_scale) {
  __shared__ float sm_m[NWARPS][MAXG];
  __shared__ float sm_l[NWARPS][MAXG];
  __shared__ float sm_acc[NWARPS][MAXG][HD];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int h0 = kvh * G + blockIdx.z * MAXG;  // this block's first query head
  const int GC = min(MAXG, G - (int)blockIdx.z * MAXG);  // and how many it holds
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d0 = lane * 4;  // this lane's 4 columns of D

  float qr[MAXG][4];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < GC) load4(q + (size_t)b * q_sb + (size_t)(h0 + g) * q_sh + d0, qr[g]);
  }

  float m[MAXG], l[MAXG], acc[MAXG][4], slope[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    slope[g] = (slopes != nullptr && g < GC) ? slopes[h0 + g] : 0.f;
    m[g] = NEG_INF;
    l[g] = 0.f;
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  }

  const int qp = q_pos[b];
  const int S_used = min(S, qp + 1);  // slots past the query never count
  const CacheT* kb = kc + (size_t)b * c_sb + (size_t)kvh * c_sh + d0;
  const CacheT* vb = vc + (size_t)b * c_sb + (size_t)kvh * c_sh + d0;
  const int* segb = seg + (size_t)b * seg_sb;

  for (int s0 = warp * KB; s0 < S_used; s0 += NWARPS * KB) {
    float kx[KB][4], vx[KB][4];
    bool present[KB], valid[KB];
    float kscale[KB], vscale[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const int s = s0 + j;
      present[j] = s < S_used;
      if (present[j]) {
        load4(kb + (size_t)s * c_ss, kx[j]);
        load4(vb + (size_t)s * c_ss, vx[j]);
        valid[j] = segb[s] != 0;
        if (QUANT) {
          const size_t si = (size_t)b * s_sb + (size_t)s * s_ss + (size_t)kvh * s_sh;
          kscale[j] = ks[si];
          vscale[j] = vs[si];
        }
      } else {
        // absent slot: every value it feeds must be finite, since its
        // probability (0) still multiplies the v scale and the values
        valid[j] = false;
        kscale[j] = vscale[j] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) kx[j][i] = vx[j][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= GC) break;
      float sc[KB];
      float mb = m[g];
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        float dot = qr[g][0] * kx[j][0] + qr[g][1] * kx[j][1] +
                    qr[g][2] * kx[j][2] + qr[g][3] * kx[j][3];
        dot = warp_sum(dot);
        if (QUANT) dot *= kscale[j];
        dot = dot * sm_scale - slope[g] * static_cast<float>(qp - (s0 + j));
        // masked slots take the finite mask value (as in the JAX kernel);
        // slots past the query get a true -inf, so exp gives 0
        sc[j] = !present[j] ? -CUDART_INF_F : (valid[j] ? dot : NEG_INF);
        mb = fmaxf(mb, sc[j]);
      }
      const float alpha = expf(m[g] - mb);
      m[g] = mb;
      float lsum = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        float p = expf(sc[j] - mb);
        lsum += p;
        if (QUANT) p *= vscale[j];
        a0 += p * vx[j][0];
        a1 += p * vx[j][1];
        a2 += p * vx[j][2];
        a3 += p * vx[j][3];
      }
      l[g] = l[g] * alpha + lsum;
      acc[g][0] = acc[g][0] * alpha + a0;
      acc[g][1] = acc[g][1] * alpha + a1;
      acc[g][2] = acc[g][2] * alpha + a2;
      acc[g][3] = acc[g][3] * alpha + a3;
    }
  }

  // Merge the warps' partial softmax states.
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= GC) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sm_acc[warp][g][d0 + i] = acc[g][i];
  }
  __syncthreads();
  const int d = threadIdx.x;  // NTHREADS == HD: one output column per thread
  for (int g = 0; g < GC; ++g) {
    float mx = sm_m[0][g];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      lt += sm_l[w][g] * f;
      o += sm_acc[w][g][d] * f;
    }
    out[((size_t)b * H + h0 + g) * HD + d] = __float2bfloat16(o / fmaxf(lt, 1e-9f));
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). `quantized`
// selects the int8 cache (k, v int8; ks, vs f32 scales) over bf16; `slopes`
// (f32 [H], or null) adds ALiBi.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* ks, const void* vs,
                                    const void* seg, const void* q_pos, const void* slopes,
                                    void* out,
                                    int B, int S, int H, int Hkv, int quantized,
                                    int q_sb, int q_sh,
                                    int c_sb, int c_ss, int c_sh,
                                    int s_sb, int s_ss, int s_sh,
                                    int seg_sb, float sm_scale, void* stream) {
  const int G = H / Hkv;
  const dim3 grid(Hkv, B, (G + MAXG - 1) / MAXG);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qq = static_cast<const __nv_bfloat16*>(q);
  if (quantized) {
    decode_kernel<int8_t, true><<<grid, NTHREADS, 0, st>>>(
        qq, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
        static_cast<const float*>(ks), static_cast<const float*>(vs),
        static_cast<const int*>(seg), static_cast<const int*>(q_pos),
        static_cast<const float*>(slopes), static_cast<__nv_bfloat16*>(out), S, H, G,
        q_sb, q_sh, c_sb, c_ss, c_sh, s_sb, s_ss, s_sh, seg_sb, sm_scale);
  } else {
    decode_kernel<__nv_bfloat16, false><<<grid, NTHREADS, 0, st>>>(
        qq, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
        nullptr, nullptr, static_cast<const int*>(seg), static_cast<const int*>(q_pos),
        static_cast<const float*>(slopes), static_cast<__nv_bfloat16*>(out), S, H, G,
        q_sb, q_sh, c_sb, c_ss, c_sh, s_sb, s_ss, s_sh, seg_sb, sm_scale);
  }
  return (int)cudaGetLastError();
}
