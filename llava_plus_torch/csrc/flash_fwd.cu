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
// What bounds it on the card: per head it reads q, k, v and writes o once
// (8 T D bytes) and does 2 T^2 D flops under the causal mask, so the ratio
// is T / 4 flops per byte against the H100's ~295 bf16 ridge. At serving's
// prefill (B = 2, T = 768) the bytes bound it (50 MB, 0.0151 ms, against
// 0.0098 ms of flops); at training rows (T = 2048) the operations do.
//
// Design: one block per (batch x head, 128-row q tile), 256 threads in two
// consumer warpgroups, each owning 64 q rows. Loads are TMA: the Q tile
// once, then K tiles of 128 kv rows with their segment ids (thread 0
// issues them) and V tiles (thread 128), through two rings of NS = 3
// shared-memory stages (K and V apart, so a K stage frees as soon as its
// scores are taken), each stage with a "full" and an "empty" mbarrier;
// each tile is one 5-d TMA instruction (both 64-column boxes), issued NS - 1
// tiles ahead, right after the consumer has issued its products so that
// the issue overlaps them. There is no producer warpgroup: with 12 warps the
// register file gives each thread 168 registers (three warps share a
// sub-partition), and ptxas kept that budget for the whole kernel even with
// setmaxnreg raising the consumers to 232 or 240 (it spilled and
// serialized the wgmma, measured on the H100); with 8 warps a thread may
// hold up to 255, and the consumers need 190-200.
//   S = Q K^T   wgmma m64n128k16, both operands in shared memory, K-major;
//   softmax     in registers, base 2 (scale folded with log2 e), f32 max
//               and sum; masked scores take the finite mask value, and a
//               row that has seen no valid key subtracts +inf, so its
//               probabilities are exactly 0 (the select after the exp);
//   O += P V    P rounded to bf16 in registers is wgmma's register A
//               operand (the accumulator layout is the A layout); V is read
//               MN-major through the transpose bit, no transposed copy.
// Tile j's S and tile j-1's O += P V are issued together, and the softmax of
// tile j runs while the tensor cores do the second (the two warpgroups
// interleave on top of that).
// The per-element mask runs only where it can matter: on tiles that cross
// the causal diagonal of the warp's rows, on the ragged last tile (T % 128
// = 64: TMA zero-fills rows past T, which are masked), and on tiles whose
// segment ids are not all the warp's one non-zero id (each warp reduces the
// tile's 128 ids with min / max). Tiles above the diagonal are skipped, and
// blocks take the heaviest q tiles first (blockIdx.y = 0 is the last tile),
// so the causal tail is short.
//
// ptxas -v (nvcc 12.9, sm_90a): 190 registers (plain) and 196 (ALiBi), no
// spills, no wgmma serialization; 232,064 bytes of shared memory (one
// block per SM).
//
// Layout: q, k, v are strided [B, T, H, D] / [B, T, Hkv, D] with D = 128 and
// the last dimension contiguous, 16-byte strides and base (the TMA maps are
// made per call from them); GQA reads kv head h / G. T is a multiple of 64
// (the wrapper pads with segment 0). Out: o [B, T, H, D] contiguous bf16,
// lse [B, H, T] f32 (a row that saw no key gets the mask value).

#include "hopper.cuh"

#include <math_constants.h>

namespace {

using namespace hopper;

constexpr int BM = 128;        // q rows per block: 64 per consumer warpgroup
constexpr int BN = 128;        // kv rows per tile
constexpr int NS = 3;          // stages of the K ring and of the V ring
constexpr int NTHREADS = 256;  // two consumer warpgroups
constexpr int BOX = BM * 128;  // bytes of one 128-row x 64-column box
constexpr int TILE = 2 * BOX;  // a 128 x 128 tile of Q, K or V
// Q, the K and V rings, the K tiles' segment ids, 1 + 4 NS mbarriers, and
// slack to align the start to 1024 bytes
constexpr int SMEM = TILE + 2 * NS * TILE + NS * BN * 4 + 128 + 1024;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// The JAX package's finite mask value (-0.7 * f32 max): a fully masked row
// stays finite instead of turning into NaN.
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr unsigned FULL = 0xffffffffu;

// Scaled (base-2) scores of this thread's 64 accumulator entries (rows r0
// and r0 + 8, columns 8 j + 2 qd + {0, 1} of the tile at k_start). MASKED
// applies the per-element mask: kv position inside T, causal, equal
// non-zero segments; a masked score becomes the mask value.
template <bool ALIBI, bool MASKED>
__device__ __forceinline__ void scores(float (&sc)[64], float scale_log2, float slope_log2,
                                       int r0, int k_start, int qd, int T, int causal,
                                       const int* kseg, int qs0, int qs1) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * qd + (e & 1);
      const int kpos = k_start + col;
      const int qpos = r0 + ((e & 2) ? 8 : 0);
      float v = sc[4 * j + e] * scale_log2;
      if (ALIBI) v -= slope_log2 * fabsf(static_cast<float>(qpos - kpos));
      if (MASKED) {
        const int ksg = kseg[col];
        const bool valid = kpos < T && (!causal || kpos <= qpos) &&
                           ksg == ((e & 2) ? qs1 : qs0) && ksg != 0;
        v = valid ? v : MASK_VALUE;
      }
      sc[4 * j + e] = v;
    }
  }
}

// One tile's online-softmax step in registers: the scores of S (per-element
// mask unless `plain`), the new running max and the factor `alpha` that
// rescales what was summed before, then P = 2^(score - max) in place and
// the row sums (l = l * alpha + sum P). A plain tile without ALiBi keeps S
// unscaled: the max commutes with the positive scale, which then folds into
// the exponent's fused multiply-add.
template <bool ALIBI>
__device__ __forceinline__ void softmax_step(float (&sc)[64], bool plain, float scale_log2,
                                             float slope_log2, int r0, int k_start, int qd,
                                             int T, int causal, const int* kseg, int qs0,
                                             int qs1, float& m0, float& m1, float& l0,
                                             float& l1, float& alpha0, float& alpha1) {
  const bool raw = !ALIBI && plain;
  if (plain) {
    if (!raw)
      scores<ALIBI, false>(sc, scale_log2, slope_log2, r0, k_start, qd, T, causal, kseg, qs0,
                           qs1);
  } else {
    scores<ALIBI, true>(sc, scale_log2, slope_log2, r0, k_start, qd, T, causal, kseg, qs0, qs1);
  }
  float mx0 = raw ? -CUDART_INF_F : MASK_VALUE, mx1 = mx0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  if (raw) {
    mx0 *= scale_log2;
    mx1 *= scale_log2;
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  alpha0 = ex2(m0 - mn0);
  alpha1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  // a row with no valid key so far subtracts +inf: every probability 0
  const float sub0 = mn0 == MASK_VALUE ? CUDART_INF_F : mn0;
  const float sub1 = mn1 == MASK_VALUE ? CUDART_INF_F : mn1;
  float ps0 = 0.f, ps1 = 0.f;
  if (raw) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -sub0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -sub0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -sub1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -sub1));
      ps0 += sc[4 * j] + sc[4 * j + 1];
      ps1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sc[4 * j] = ex2(sc[4 * j] - sub0);
      sc[4 * j + 1] = ex2(sc[4 * j + 1] - sub0);
      sc[4 * j + 2] = ex2(sc[4 * j + 2] - sub1);
      sc[4 * j + 3] = ex2(sc[4 * j + 3] - sub1);
      ps0 += sc[4 * j] + sc[4 * j + 1];
      ps1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
  }
  l0 = l0 * alpha0 + ps0;
  l1 = l1 * alpha1 + ps1;
}

// Whether a warp's 16 rows need no per-element mask against the kv tile at
// k_start: all their ids are the one non-zero q_id (q_uniform), the tile
// lies inside T and below the rows' diagonal, and its 128 ids are all q_id.
__device__ __forceinline__ bool plain_tile(bool q_uniform, int q_id, int k_start, int warp_q0,
                                           int T, int causal, const int* kseg, int lane) {
  bool plain = q_uniform && k_start + BN <= T && !(causal && k_start + BN - 1 > warp_q0);
  if (plain) {
    const int4 ids = reinterpret_cast<const int4*>(kseg)[lane];
    const int lo = min(min(ids.x, ids.y), min(ids.z, ids.w));
    const int hi = max(max(ids.x, ids.y), max(ids.z, ids.w));
    plain = __reduce_min_sync(FULL, lo) == q_id && __reduce_max_sync(FULL, hi) == q_id;
  }
  return plain;
}

template <bool ALIBI>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg,
                 const float* __restrict__ slopes,
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse,
                 int T, int H, int G, int causal, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte-swizzled tiles start on 1024-byte boundaries
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_tile = smem;                       // two boxes
  unsigned char* k_ring = smem + 2 * BOX;             // NS x two boxes
  unsigned char* v_ring = k_ring + NS * TILE;         // NS x two boxes
  int* kseg_s = reinterpret_cast<int*>(v_ring + NS * TILE);   // NS x BN ids
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kseg_s + NS * BN);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + NS;
  uint64_t* v_full = k_empty + NS;
  uint64_t* v_empty = v_full + NS;

  const int n_qt = (T + BM - 1) / BM;
  const int q_start = (n_qt - 1 - blockIdx.y) * BM;   // heaviest q tiles first
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / G;
  const int n_kt = (T + BN - 1) / BN;
  const int last = causal ? min(n_kt - 1, (q_start + BM - 1) / BN) : n_kt - 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 8);   // one arrival per consumer warp
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 issues the loads of Q and K, thread 128 those of V (one each
  // consumer warpgroup, so neither runs behind the other for it): the
  // first NS K tiles and NS - 1 V tiles here, then in iteration j K tile
  // j + NS - 1 and V tile j + NS - 2, each NS - 1 iterations ahead of use.
  auto load_k = [&](int j) {
    const int s = j % NS;
    const int k_start = j * BN;
    const int n_ids = min(BN, T - k_start);
    unsigned char* kt = k_ring + s * TILE;
    mbar_wait(&k_empty[s], ((j / NS) & 1) ^ 1);
    mbar_expect_tx(&k_full[s], TILE + n_ids * 4);
    tma_load_tile(kt, &k_map, &k_full[s], k_start, kvh, b);
    bulk_load(kseg_s + s * BN, kv_seg + (size_t)b * T + k_start, n_ids * 4, &k_full[s]);
  };
  auto load_v = [&](int j) {
    const int s = j % NS;
    unsigned char* vt = v_ring + s * TILE;
    mbar_wait(&v_empty[s], ((j / NS) & 1) ^ 1);
    mbar_expect_tx(&v_full[s], TILE);
    tma_load_tile(vt, &v_map, &v_full[s], j * BN, kvh, b);
  };
  if (threadIdx.x == 0) {
    prefetch_map(&q_map);
    prefetch_map(&k_map);
    mbar_expect_tx(q_full, 2 * BOX);
    tma_load_tile(q_tile, &q_map, q_full, q_start, h, b);
    for (int j = 0; j < NS && j <= last; ++j) load_k(j);
  } else if (threadIdx.x == 128) {
    prefetch_map(&v_map);
    for (int j = 0; j < NS - 1 && j <= last; ++j) load_v(j);
  }
  __syncwarp();

  // warpgroup cw owns q rows 64 cw .. 64 cw + 63 of the tile; cw is
  // warp-uniform as the compiler sees it (a branch on threadIdx would count
  // as divergent and serialize the wgmma)
  const int cw = __shfl_sync(FULL, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int qd = lane % 4;
  const int warp_q0 = q_start + 64 * cw + 16 * warp;   // this warp's first row
  const int r0 = warp_q0 + lane / 4;                   // this thread's rows: r0, r0 + 8
  const int r1 = r0 + 8;
  const int qs0 = r0 < T ? q_seg[(size_t)b * T + r0] : 0;
  const int qs1 = r1 < T ? q_seg[(size_t)b * T + r1] : 0;
  const int q_id = __shfl_sync(FULL, qs0, 0);
  const bool q_uniform = __all_sync(FULL, qs0 == q_id && qs1 == q_id) && q_id != 0;
  const float slope_log2 = ALIBI ? slopes[h] * LOG2E : 0.f;
  const uint32_t q_addr = smem_u32(q_tile) + cw * 64 * 128;
  const uint32_t k_addr = smem_u32(k_ring), v_addr = smem_u32(v_ring);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m0 = MASK_VALUE, m1 = MASK_VALUE;   // running max (base 2, quad-uniform)
  float l0 = 0.f, l1 = 0.f;                 // this thread's share of the row sums
  float alpha0, alpha1;
  float sc[64];
  uint32_t pa[8][4];

  // Tile j's S = Q K_j^T is issued together with O += P_{j-1} V_{j-1}, and
  // the softmax of tile j runs while the tensor cores do the second.
  mbar_wait(q_full, 0);
  mbar_wait(&k_full[0], 0);
  wgmma_fence();
  gemm_k128(sc, q_addr, BOX, k_addr, BOX, false);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax_step<ALIBI>(sc, plain_tile(q_uniform, q_id, 0, warp_q0, T, causal, kseg_s, lane),
                      scale_log2, slope_log2, r0, 0, qd, T, causal, kseg_s, qs0, qs1, m0, m1,
                      l0, l1, alpha0, alpha1);
  __syncwarp();
  if (lane == 0) mbar_arrive(&k_empty[0]);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) acc_to_a(pa[ks], sc, ks);

  for (int j = 1; j <= last; ++j) {
    const int s = j % NS, sp = (j - 1) % NS;
    mbar_wait(&k_full[s], (j / NS) & 1);
    mbar_wait(&v_full[sp], ((j - 1) / NS) & 1);
    wgmma_fence();
    gemm_k128(sc, q_addr, BOX, k_addr + s * TILE, BOX, false);
    wgmma_commit();
    gemm_rs(acc, pa, v_addr + sp * TILE, BOX);
    wgmma_commit();
    // while the tensor cores work: K tile j + NS - 1 into the stage tile
    // j - 1 freed, V tile j + NS - 2 into the one tile j - 2 freed
    if (threadIdx.x == 0 && j + NS - 1 <= last) load_k(j + NS - 1);
    if (threadIdx.x == 128 && j + NS - 2 <= last) load_v(j + NS - 2);
    __syncwarp();
    wgmma_wait<1>();
    fence_regs(sc);
    const int k_start = j * BN;
    const int* kseg = kseg_s + s * BN;
    softmax_step<ALIBI>(sc, plain_tile(q_uniform, q_id, k_start, warp_q0, T, causal, kseg, lane),
                        scale_log2, slope_log2, r0, k_start, qd, T, causal, kseg, qs0, qs1, m0,
                        m1, l0, l1, alpha0, alpha1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&k_empty[s]);
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) fence_regs(pa[ks]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&v_empty[sp]);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      acc[4 * i] *= alpha0;
      acc[4 * i + 1] *= alpha0;
      acc[4 * i + 2] *= alpha1;
      acc[4 * i + 3] *= alpha1;
    }
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) acc_to_a(pa[ks], sc, ks);
  }

  const int sl = last % NS;
  mbar_wait(&v_full[sl], (last / NS) & 1);
  wgmma_fence();
  gemm_rs(acc, pa, v_addr + sl * TILE, BOX);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) fence_regs(pa[ks]);

  // Row sums across the quad, then normalise and write the rows inside T.
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  if (r0 < T) {
    __nv_bfloat16* orow = o + (((size_t)b * T + r0) * H + h) * 128 + 2 * qd;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i) =
          pack_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
    if (qd == 0) lse[((size_t)b * H + h) * T + r0] = l0 == 0.f ? MASK_VALUE : m0 * LN2 + logf(l0);
  }
  if (r1 < T) {
    __nv_bfloat16* orow = o + (((size_t)b * T + r1) * H + h) * 128 + 2 * qd;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i) =
          pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
    if (qd == 0) lse[((size_t)b * H + h) * T + r1] = l1 == 0.f ? MASK_VALUE : m1 * LN2 + logf(l1);
  }
}

template <bool ALIBI>
int launch(const void* q, const void* k, const void* v, const void* q_seg,
           const void* kv_seg, const void* slopes, void* o, void* lse, int B, int T,
           int H, int Hkv, int causal, int q_sb, int q_st, int q_sh, int k_sb,
           int k_st, int k_sh, float sm_scale, void* stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = make_map(&q_map, q, B, T, H, q_sb, q_st, q_sh, BM);
  if (!err) err = make_map(&k_map, k, B, T, Hkv, k_sb, k_st, k_sh, BN);
  if (!err) err = make_map(&v_map, v, B, T, Hkv, k_sb, k_st, k_sh, BN);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_kernel<ALIBI>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid(B * H, (T + BM - 1) / BM);
  flash_fwd_kernel<ALIBI><<<grid, NTHREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<const float*>(slopes), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), T, H, H / Hkv, causal, sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 once launched, else cudaGetLastError() after the launch or
// hopper::TENSOR_MAP_ERROR (+ the CUDA driver's code) if a TMA map was refused.
// `slopes` (f32 [H], or null) selects the ALiBi variant.
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
