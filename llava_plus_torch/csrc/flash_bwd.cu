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
// ~6*T*D*2 bytes). S, P, dP and dS stay in registers and never touch device
// memory; tiles above the causal diagonal are skipped; the f32 accumulator
// of P (and dS) is rounded to bf16 and fed straight in as the A operand of
// the next product (dQ's dS as two bf16 halves, below).
//
// dK/dV kernel (the Hopper design; hopper.cuh): one block per (batch x kv
// head, head split, 128-row kv tile), kv tile slowest in the grid so the
// heaviest causal tiles (the first) start first. 256 threads in two
// consumer warpgroups, each owning 64 kv rows, with dK and dV in f32
// registers over the whole loop. TMA brings the K and V tiles once, then
// for each (query head, 64-row q tile) step the Q and dO tiles (one 5-d TMA
// each) with lse, delta and q segment ids (bulk copies) through a 3-stage
// shared-memory ring (full / empty mbarriers), two steps ahead; thread 0
// issues Q and the small rows, thread 128 dO, each right after its
// warpgroup has issued the step's first products. No producer warpgroup:
// with 12 warps ptxas holds every thread to 168 registers (setmaxnreg did
// not lift that), and this kernel needs 236 (ptxas -v, nvcc 12.9: 236 for
// both instances, no spills).
//   S^T  = K Q^T     wgmma m64n64k16, A = K, B = Q, both K-major in smem;
//   dP^T = V dO^T    wgmma m64n64k16, A = V, B = dO (with S^T, one group);
//   dV  += P^T dO    wgmma m64n128k16, A = P^T from registers, B = dO
//                    MN-major (transpose bit);
//   dK  += dS^T Q    the same with dS^T and Q (with dV, one group).
// P^T is replayed in base 2 (scale folded with log2 e) and masked by select
// after the exp, per element only on tiles that cross the diagonal of the
// warp's kv rows or whose segment ids are not all the warp's one non-zero
// id. Kv rows past T (T % 128 = 64: TMA zero-fills them) are not stored.
// Head split: the G query heads of a kv head go to `splits` contiguous
// ranges, one block each (ops/flash_attention.dkv_head_splits picks the
// smallest divisor of G that gives two blocks per SM; 1 for MHA). With
// splits > 1 each block writes f32 partials to a workspace and
// dkv_sum_kernel adds them in split order: deterministic, no atomics.
//
// dQ kernel (the same Hopper pieces): one block per (batch x query head,
// 128-row q tile), the last q tiles (the heaviest under causal masking)
// first; two consumer warpgroups of 64 q rows, dQ in f32 registers over the
// whole loop. TMA brings Q and dO once (thread 0 and thread 128), then the
// 64-row K and V tiles of each step, with the kv segment ids (a bulk copy),
// through a 3-stage ring (full / empty mbarriers), issued by threads 0 (K,
// ids) and 128 (V) right after their warpgroup's first products; lse, delta
// and the q segment ids of a thread's two rows are read once from global.
//   S  = Q K^T       wgmma m64n64k16, A = Q, B = K, both K-major in smem;
//   dP = dO V^T      wgmma m64n64k16 (with S, one group);
//   dQ += dS K       wgmma m64n128k16, A = dS from registers, B = K MN-major,
//                    twice: dS enters as hi = bf16(dS) and lo = bf16(dS - hi).
// The split keeps ~16 bits of dS where one bf16 operand keeps 8: a
// deliberate difference from the Pallas _bwd_dq_kernel (ds.astype(k.dtype)),
// toward the f32 plain backward, for one product more per tile (4, like
// dK/dV). P is replayed in base 2 and masked by select after the exp, per
// element only on tiles that cross the diagonal of the warp's rows or mix
// segments; a kv tile wholly above warpgroup 0's rows is skipped.
//
// Layout: q, k, v, dO are strided [B, T, H, D] / [B, T, Hkv, D] with
// D = 128 and the last dimension contiguous; lse and delta [B, H, T] f32;
// segment ids [B, T] int32. T is a multiple of 64 (the wrapper pads with
// segment 0). Out: dq [B, T, H, D], dk and dv [B, T, Hkv, D], contiguous bf16.

#include "hopper.cuh"

namespace {

constexpr int BM = 64;          // rows of a q tile of dK/dV, of a kv tile of dQ
constexpr int HD = 128;         // head dim

// ---- dK / dV: TMA ring and wgmma (see the note at the top) ----

constexpr int KV_ROWS = 128;            // kv rows per block: 64 per consumer warpgroup
constexpr int NS = 3;                   // stages of the Q / dO ring
constexpr int DKV_THREADS = 256;        // two consumer warpgroups
constexpr int KV_BOX = KV_ROWS * 128;   // bytes of a 128-row x 64-column box
constexpr int Q_BOX = BM * 128;         // bytes of a 64-row x 64-column box
// Q (two boxes), dO (two boxes), then lse, delta and q segment ids (64 each)
constexpr int STAGE = 4 * Q_BOX + 1024;
constexpr int DKV_SMEM = 4 * KV_BOX + NS * STAGE + 64 + 1024;   // + alignment slack
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct DkvArgs {
  const int* q_seg;
  const int* kv_seg;
  const float* lse;
  const float* delta;
  const float* slopes;      // [H] f32, read only by the ALiBi instance
  __nv_bfloat16* dk;        // [B, T, Hkv, D] bf16 when splits == 1
  __nv_bfloat16* dv;
  float* ws;                // [2, splits, B, T, Hkv, D] f32 partials when splits > 1
  int B, T, H, G, causal, splits;
  float sm_scale, scale_log2;
};

// P^T (MASKED: with the per-element mask) from S^T in place, replayed in
// base 2 from the lse. Rows kp0 and kp0 + 8 (kv), columns 8 j + 2 qd +
// {0, 1} (q rows of the tile at q0).
template <bool ALIBI, bool MASKED>
__device__ __forceinline__ void replay_p(float (&st)[32], const DkvArgs& p, const float* lse_s,
                                         const int* qseg_s, int q0, int kp0, int qd, int ks0,
                                         int ks1, float slope_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * qd + (e & 1);
      const int qpos = q0 + col;
      const int kpos = kp0 + ((e & 2) ? 8 : 0);
      float v = fmaf(st[4 * j + e], p.scale_log2, -lse_s[col] * LOG2E);
      if (ALIBI) v -= slope_log2 * fabsf(static_cast<float>(qpos - kpos));
      float pe = hopper::ex2(v);
      if (MASKED) {
        const int ksg = (e & 2) ? ks1 : ks0;
        const bool valid = (!p.causal || kpos <= qpos) && ksg == qseg_s[col] && ksg != 0;
        pe = valid ? pe : 0.f;   // select: pe may be inf on a padding row
      }
      st[4 * j + e] = pe;
    }
  }
}

// dK, dV of one 128-row kv tile of one (batch, kv head), summed over the
// query heads of its split of the group.
template <bool ALIBI>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap o_map,
                     const DkvArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_tile = smem;                  // two boxes
  unsigned char* v_tile = smem + 2 * KV_BOX;     // two boxes
  unsigned char* stages = smem + 4 * KV_BOX;     // NS x (Q, dO, lse, delta, ids)
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stages + NS * STAGE);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NS;

  const int T = p.T, H = p.H, G = p.G;
  const int Hkv = H / G;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int g_lo = blockIdx.y * G / p.splits;         // this block's query heads
  const int g_hi = (blockIdx.y + 1) * G / p.splits;
  const int k_start = blockIdx.z * KV_ROWS;           // z = 0 (heaviest) first
  const int n_qt = T / BM;
  const int first = p.causal ? k_start / BM : 0;      // q tiles above see nothing
  const int nq = n_qt - first;
  const int steps = (g_hi - g_lo) * nq;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 2);     // one arrival per loading thread
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 2);
      hopper::mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // Threads 0 and 128 (one each consumer warpgroup) issue the loads: K and
  // V and the first NS - 1 steps here, then in step n, once its first
  // products are issued, the step n + NS - 1 (into the stage step n - 1
  // freed), NS - 1 steps ahead of use (thread 0: Q, lse, delta and ids;
  // thread 128: dO).
  auto load_step = [&](int n) {
    const int s = n % NS;
    const int h = kvh * G + g_lo + n / nq;
    const int q0 = (first + n % nq) * BM;
    hopper::mbar_wait(&empty[s], ((n / NS) & 1) ^ 1);
    unsigned char* st = stages + s * STAGE;
    if (threadIdx.x == 128) {
      hopper::mbar_expect_tx(&full[s], 2 * Q_BOX);
      hopper::tma_load_tile(st + 2 * Q_BOX, &o_map, &full[s], q0, h, b);
      return;
    }
    hopper::mbar_expect_tx(&full[s], 2 * Q_BOX + 3 * BM * 4);
    hopper::tma_load_tile(st, &q_map, &full[s], q0, h, b);
    const size_t row = ((size_t)b * H + h) * T + q0;
    hopper::bulk_load(st + 4 * Q_BOX, p.lse + row, BM * 4, &full[s]);
    hopper::bulk_load(st + 4 * Q_BOX + BM * 4, p.delta + row, BM * 4, &full[s]);
    hopper::bulk_load(st + 4 * Q_BOX + 2 * BM * 4, p.q_seg + (size_t)b * T + q0, BM * 4,
                      &full[s]);
  };
  const bool loader = threadIdx.x % 128 == 0;
  if (loader) {
    const CUtensorMap* kv_map = threadIdx.x ? &v_map : &k_map;
    hopper::prefetch_map(kv_map);
    hopper::prefetch_map(threadIdx.x ? &o_map : &q_map);
    hopper::mbar_expect_tx(kv_full, 2 * KV_BOX);
    hopper::tma_load_tile(threadIdx.x ? v_tile : k_tile, kv_map, kv_full, k_start, kvh, b);
    for (int n = 0; n < NS - 1 && n < steps; ++n) load_step(n);
  }
  __syncwarp();

  // warpgroup cw owns kv rows 64 cw .. 64 cw + 63 of the tile; cw is
  // warp-uniform as the compiler sees it (a branch on threadIdx would count
  // as divergent and serialize the wgmma)
  const int cw = __shfl_sync(FULL, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int qd = lane % 4;
  const int warp_k0 = k_start + 64 * cw + 16 * warp;   // this warp's first kv row
  const int kp0 = warp_k0 + lane / 4;                  // this thread's kv rows: kp0, kp0 + 8
  const int kp1 = kp0 + 8;
  const int ks0 = kp0 < T ? p.kv_seg[(size_t)b * T + kp0] : 0;
  const int ks1 = kp1 < T ? p.kv_seg[(size_t)b * T + kp1] : 0;
  const int k_id = __shfl_sync(FULL, ks0, 0);
  const bool k_uniform = __all_sync(FULL, ks0 == k_id && ks1 == k_id) && k_id != 0;
  const uint32_t k_addr = hopper::smem_u32(k_tile) + cw * 64 * 128;
  const uint32_t v_addr = hopper::smem_u32(v_tile) + cw * 64 * 128;

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  hopper::mbar_wait(kv_full, 0);
  for (int n = 0; n < steps; ++n) {
    const int s = n % NS;
    const int h = kvh * G + g_lo + n / nq;
    const int q0 = (first + n % nq) * BM;
    hopper::mbar_wait(&full[s], (n / NS) & 1);
    unsigned char* stp = stages + s * STAGE;
    const uint32_t st = hopper::smem_u32(stp);
    const float* lse_s = reinterpret_cast<const float*>(stp + 4 * Q_BOX);
    const float* delta_s = lse_s + BM;
    const int* qseg_s = reinterpret_cast<const int*>(delta_s + BM);

    // S^T = K Q^T and dP^T = V dO^T (64 kv rows x 64 q columns each)
    float sT[32], dpT[32];
    hopper::wgmma_fence();
    hopper::gemm_k128(sT, k_addr, KV_BOX, st, Q_BOX, false);
    hopper::gemm_k128(dpT, v_addr, KV_BOX, st + 2 * Q_BOX, Q_BOX, false);
    hopper::wgmma_commit();
    // while the tensor cores work: step n + NS - 1 into the stage step n - 1 freed
    if (loader && n + NS - 1 < steps) load_step(n + NS - 1);
    __syncwarp();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sT);
    hopper::fence_regs(dpT);

    // P^T, with the per-element mask only where the tile can hold a masked pair
    bool plain = k_uniform && !(p.causal && q0 < warp_k0 + 15);
    if (plain) {
      const int2 ids = reinterpret_cast<const int2*>(qseg_s)[lane];
      plain = __all_sync(FULL, ids.x == k_id && ids.y == k_id);
    }
    const float slope_log2 = ALIBI ? p.slopes[h] * LOG2E : 0.f;
    if (plain)
      replay_p<ALIBI, false>(sT, p, lse_s, qseg_s, q0, kp0, qd, ks0, ks1, slope_log2);
    else
      replay_p<ALIBI, true>(sT, p, lse_s, qseg_s, q0, kp0, qd, ks0, ks1, slope_log2);

    // dS^T = P^T (dP^T - delta) * scale; then dV += P^T dO and dK += dS^T Q,
    // A from registers, dO and Q MN-major
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpT[4 * j + e] = sT[4 * j + e] * (dpT[4 * j + e] - delta_s[8 * j + 2 * qd + (e & 1)]) *
                         p.sm_scale;
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      hopper::acc_to_a(pa[ks], sT, ks);
      hopper::acc_to_a(da[ks], dpT, ks);
    }
    hopper::wgmma_fence();
    hopper::gemm_rs(dv, pa, st + 2 * Q_BOX, Q_BOX);
    hopper::gemm_rs(dk, da, st, Q_BOX);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      hopper::fence_regs(pa[ks]);
      hopper::fence_regs(da[ks]);
    }

    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // the rows inside T: bf16 straight out, or this split's f32 partials
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = half ? kp1 : kp0;
    if (kp >= T) continue;
    const size_t row = (((size_t)b * T + kp) * Hkv + kvh) * HD + 2 * qd;
    if (p.splits == 1) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(p.dk + row + 8 * j) =
            hopper::pack_bf16(dk[4 * j + 2 * half], dk[4 * j + 2 * half + 1]);
        *reinterpret_cast<uint32_t*>(p.dv + row + 8 * j) =
            hopper::pack_bf16(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
      }
    } else {
      const size_t n = (size_t)p.B * T * Hkv * HD;   // elements of one partial
      float* wk = p.ws + (size_t)blockIdx.y * n + row;
      float* wv = wk + (size_t)p.splits * n;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(wk + 8 * j) =
            make_float2(dk[4 * j + 2 * half], dk[4 * j + 2 * half + 1]);
        *reinterpret_cast<float2*>(wv + 8 * j) =
            make_float2(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
      }
    }
  }
}

// dK and dV as bf16 from the `splits` f32 partials of each, summed in split
// order (deterministic). ws [2, splits, n] (dK's, then dV's); n % 4 == 0.
__global__ void dkv_sum_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, size_t n, int splits) {
  const size_t n4 = n / 4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t which = i / n4, e = i % n4;
    const float4* src = reinterpret_cast<const float4*>(ws + which * splits * n) + e;
    float4 acc = src[0];
    for (int s = 1; s < splits; ++s) {
      const float4 x = src[s * n4];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    uint2 out;
    out.x = hopper::pack_bf16(acc.x, acc.y);
    out.y = hopper::pack_bf16(acc.z, acc.w);
    *reinterpret_cast<uint2*>((which ? dv : dk) + 4 * e) = out;
  }
}

// ---- dQ: TMA ring and wgmma (see the note at the top) ----

constexpr int DQ_ROWS = 128;            // q rows per block: 64 per consumer warpgroup
constexpr int DQ_THREADS = 256;         // two consumer warpgroups
constexpr int DQ_BOX = DQ_ROWS * 128;   // bytes of a 128-row x 64-column box
constexpr int DQ_STAGE = 4 * Q_BOX;     // a 64-row K tile and V tile, two boxes each
// Q and dO (two boxes each), the K / V ring, the kv tiles' segment ids, 1 +
// 2 NS mbarriers, and slack to align the start to 1024 bytes
constexpr int DQ_SMEM = 4 * DQ_BOX + NS * DQ_STAGE + NS * BM * 4 + 64 + 1024;

struct DqArgs {
  const int* q_seg;
  const int* kv_seg;
  const float* lse;
  const float* delta;
  const float* slopes;      // [H] f32, read only by the ALiBi instance
  __nv_bfloat16* dq;        // [B, T, H, D] bf16
  int T, H, G, causal;
  float sm_scale, scale_log2;
};

// P (MASKED: with the per-element mask) from S in place, replayed in base 2
// from the lse (nl = -lse log2 e). Rows r0 and r0 + 8 (q), columns 8 j + 2
// qd + {0, 1} (kv rows of the tile at k_start).
template <bool ALIBI, bool MASKED>
__device__ __forceinline__ void replay_p_dq(float (&sc)[32], const DqArgs& p, const int* kseg,
                                            int r0, int k_start, int qd, float nl0, float nl1,
                                            int qs0, int qs1, float slope_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * qd + (e & 1);
      const int kpos = k_start + col;
      const int qpos = r0 + ((e & 2) ? 8 : 0);
      float v = fmaf(sc[4 * j + e], p.scale_log2, (e & 2) ? nl1 : nl0);
      if (ALIBI) v -= slope_log2 * fabsf(static_cast<float>(qpos - kpos));
      float pe = hopper::ex2(v);
      if (MASKED) {
        const int ksg = kseg[col];
        const bool valid = (!p.causal || kpos <= qpos) && ksg == ((e & 2) ? qs1 : qs0) &&
                           ksg != 0;
        pe = valid ? pe : 0.f;   // select: pe may be inf on a padding row
      }
      sc[4 * j + e] = pe;
    }
  }
}

// dQ of one 128-row q tile of one (batch, query head), over the kv tiles up
// to the diagonal.
template <bool ALIBI>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap o_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const DqArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_tile = smem;                   // two boxes
  unsigned char* o_tile = smem + 2 * DQ_BOX;      // two boxes
  unsigned char* stages = smem + 4 * DQ_BOX;      // NS x (K, V)
  int* kseg_s = reinterpret_cast<int*>(stages + NS * DQ_STAGE);   // NS x BM ids
  uint64_t* qo_full = reinterpret_cast<uint64_t*>(kseg_s + NS * BM);
  uint64_t* full = qo_full + 1;
  uint64_t* empty = full + NS;

  const int T = p.T, H = p.H;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / p.G;
  const int n_qt = (T + DQ_ROWS - 1) / DQ_ROWS;
  const int q_start = (n_qt - 1 - blockIdx.y) * DQ_ROWS;   // heaviest q tiles first
  const int n_kt = T / BM;
  const int last = p.causal ? min(n_kt - 1, (q_start + DQ_ROWS - 1) / BM) : n_kt - 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qo_full, 2);     // one arrival per loading thread
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 2);
      hopper::mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // Threads 0 and 128 (one each consumer warpgroup) issue the loads: Q (thread
  // 0) and dO (thread 128) and the first NS - 1 kv tiles here, then in step
  // j, once its first products are issued, kv tile j + NS - 1 (into the stage
  // tile j - 1 freed): thread 0 K and its segment ids, thread 128 V.
  auto load_step = [&](int j) {
    const int s = j % NS;
    unsigned char* st = stages + s * DQ_STAGE;
    hopper::mbar_wait(&empty[s], ((j / NS) & 1) ^ 1);
    if (threadIdx.x == 128) {
      hopper::mbar_expect_tx(&full[s], 2 * Q_BOX);
      hopper::tma_load_tile(st + 2 * Q_BOX, &v_map, &full[s], j * BM, kvh, b);
      return;
    }
    hopper::mbar_expect_tx(&full[s], 2 * Q_BOX + BM * 4);
    hopper::tma_load_tile(st, &k_map, &full[s], j * BM, kvh, b);
    hopper::bulk_load(kseg_s + s * BM, p.kv_seg + (size_t)b * T + j * BM, BM * 4, &full[s]);
  };
  const bool loader = threadIdx.x % 128 == 0;
  if (loader) {
    const bool second = threadIdx.x != 0;
    const CUtensorMap* row_map = second ? &o_map : &q_map;
    hopper::prefetch_map(row_map);
    hopper::prefetch_map(second ? &v_map : &k_map);
    hopper::mbar_expect_tx(qo_full, 2 * DQ_BOX);
    hopper::tma_load_tile(second ? o_tile : q_tile, row_map, qo_full, q_start, h, b);
    for (int j = 0; j < NS - 1 && j <= last; ++j) load_step(j);
  }
  __syncwarp();

  // warpgroup cw owns q rows 64 cw .. 64 cw + 63 of the tile; cw is
  // warp-uniform as the compiler sees it (a branch on threadIdx would count
  // as divergent and serialize the wgmma)
  const int cw = __shfl_sync(FULL, threadIdx.x / 128, 0);
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int qd = lane % 4;
  const int wg_q0 = q_start + 64 * cw;                 // this warpgroup's first row
  const int warp_q0 = wg_q0 + 16 * warp;               // this warp's first row
  const int r0 = warp_q0 + lane / 4;                   // this thread's rows: r0, r0 + 8
  const int r1 = r0 + 8;
  const size_t lrow = ((size_t)b * H + h) * T;
  const float nl0 = r0 < T ? -p.lse[lrow + r0] * LOG2E : 0.f;
  const float nl1 = r1 < T ? -p.lse[lrow + r1] * LOG2E : 0.f;
  const float dl0 = r0 < T ? p.delta[lrow + r0] : 0.f;
  const float dl1 = r1 < T ? p.delta[lrow + r1] : 0.f;
  const int qs0 = r0 < T ? p.q_seg[(size_t)b * T + r0] : 0;
  const int qs1 = r1 < T ? p.q_seg[(size_t)b * T + r1] : 0;
  const int q_id = __shfl_sync(FULL, qs0, 0);
  const bool q_uniform = __all_sync(FULL, qs0 == q_id && qs1 == q_id) && q_id != 0;
  const float slope_log2 = ALIBI ? p.slopes[h] * LOG2E : 0.f;
  const uint32_t q_addr = hopper::smem_u32(q_tile) + cw * 64 * 128;
  const uint32_t o_addr = hopper::smem_u32(o_tile) + cw * 64 * 128;

  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;

  hopper::mbar_wait(qo_full, 0);
  for (int j = 0; j <= last; ++j) {
    const int s = j % NS;
    const int k_start = j * BM;
    const bool more = loader && j + NS - 1 <= last;
    hopper::mbar_wait(&full[s], (j / NS) & 1);
    const uint32_t st = hopper::smem_u32(stages + s * DQ_STAGE);
    // a kv tile wholly above the diagonal of this warpgroup's rows adds
    // nothing (the last tile of warpgroup 0 under causal masking)
    if (!(p.causal && k_start > wg_q0 + 63)) {
      // S = Q K^T and dP = dO V^T (64 q rows x 64 kv columns each)
      float sc[32], dp[32];
      hopper::wgmma_fence();
      hopper::gemm_k128(sc, q_addr, DQ_BOX, st, Q_BOX, false);
      hopper::gemm_k128(dp, o_addr, DQ_BOX, st + 2 * Q_BOX, Q_BOX, false);
      hopper::wgmma_commit();
      // while the tensor cores work: kv tile j + NS - 1 into the stage tile
      // j - 1 freed
      if (more) load_step(j + NS - 1);
      __syncwarp();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      // P, with the per-element mask only where the tile can hold a masked pair
      const int* kseg = kseg_s + s * BM;
      bool plain = q_uniform && !(p.causal && k_start + BM - 1 > warp_q0);
      if (plain) {
        const int2 ids = reinterpret_cast<const int2*>(kseg)[lane];
        plain = __all_sync(FULL, ids.x == q_id && ids.y == q_id);
      }
      if (plain)
        replay_p_dq<ALIBI, false>(sc, p, kseg, r0, k_start, qd, nl0, nl1, qs0, qs1, slope_log2);
      else
        replay_p_dq<ALIBI, true>(sc, p, kseg, r0, k_start, qd, nl0, nl1, qs0, qs1, slope_log2);

      // dS = P (dP - delta) * scale, in f32; it enters dQ += dS K as two bf16
      // halves, hi = bf16(dS) and lo = bf16(dS - hi), so about 16 bits of dS
      // reach the product (the Pallas kernel rounds dS to bf16)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        dp[i] = sc[i] * (dp[i] - ((i & 2) ? dl1 : dl0)) * p.sm_scale;
        sc[i] = dp[i] - __bfloat162float(__float2bfloat16_rn(dp[i]));
      }
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        hopper::acc_to_a(hi[ks], dp, ks);
        hopper::acc_to_a(lo[ks], sc, ks);
      }
      // dQ += dS K: A from registers, K MN-major (transpose bit)
      hopper::wgmma_fence();
      hopper::gemm_rs(dq, hi, st, Q_BOX);
      hopper::gemm_rs(dq, lo, st, Q_BOX);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        hopper::fence_regs(hi[ks]);
        hopper::fence_regs(lo[ks]);
      }
    } else if (more) {
      load_step(j + NS - 1);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // the rows inside T, bf16
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= T) continue;
    __nv_bfloat16* row = p.dq + (((size_t)b * T + r) * H + h) * HD + 2 * qd;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          hopper::pack_bf16(dq[4 * j + 2 * half], dq[4 * j + 2 * half + 1]);
  }
}

template <bool ALIBI>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const DkvArgs& a,
               int Hkv, int q_sb, int q_st, int q_sh, int k_sb, int k_st, int k_sh, int o_sb,
               int o_st, int o_sh, void* stream) {
  CUtensorMap k_map, v_map, q_map, o_map;
  int err = hopper::make_map(&k_map, k, a.B, a.T, Hkv, k_sb, k_st, k_sh, KV_ROWS);
  if (!err) err = hopper::make_map(&v_map, v, a.B, a.T, Hkv, k_sb, k_st, k_sh, KV_ROWS);
  if (!err) err = hopper::make_map(&q_map, q, a.B, a.T, a.H, q_sb, q_st, q_sh, BM);
  if (!err) err = hopper::make_map(&o_map, dout, a.B, a.T, a.H, o_sb, o_st, o_sh, BM);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<ALIBI>, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  if (cerr != cudaSuccess) return (int)cerr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(a.B * Hkv, a.splits, (a.T + KV_ROWS - 1) / KV_ROWS);
  flash_bwd_dkv_kernel<ALIBI><<<grid, DKV_THREADS, DKV_SMEM, s>>>(k_map, v_map, q_map, o_map, a);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess || a.splits == 1) return (int)cerr;
  const size_t n = (size_t)a.B * a.T * Hkv * HD;
  const int blocks = (int)((2 * n / 4 + 255) / 256 < 4096 ? (2 * n / 4 + 255) / 256 : 4096);
  dkv_sum_kernel<<<blocks, 256, 0, s>>>(a.ws, a.dk, a.dv, n, a.splits);
  return (int)cudaGetLastError();
}

template <bool ALIBI>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const DqArgs& a,
              int B, int Hkv, int q_sb, int q_st, int q_sh, int k_sb, int k_st, int k_sh,
              int o_sb, int o_st, int o_sh, void* stream) {
  CUtensorMap q_map, o_map, k_map, v_map;
  int err = hopper::make_map(&q_map, q, B, a.T, a.H, q_sb, q_st, q_sh, DQ_ROWS);
  if (!err) err = hopper::make_map(&o_map, dout, B, a.T, a.H, o_sb, o_st, o_sh, DQ_ROWS);
  if (!err) err = hopper::make_map(&k_map, k, B, a.T, Hkv, k_sb, k_st, k_sh, BM);
  if (!err) err = hopper::make_map(&v_map, v, B, a.T, Hkv, k_sb, k_st, k_sh, BM);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<ALIBI>, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid(B * a.H, (a.T + DQ_ROWS - 1) / DQ_ROWS);
  flash_bwd_dq_kernel<ALIBI><<<grid, DQ_THREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      q_map, o_map, k_map, v_map, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 once launched, else cudaGetLastError() after the launch or
// hopper::TENSOR_MAP_ERROR (+ the CUDA driver's code) if a TMA map was refused.
// `slopes` (f32 [H], or null) selects the ALiBi instance. `splits` (a
// divisor of H / Hkv) splits each kv head's query heads into that many
// contiguous ranges, one block each; with splits > 1 `ws` is an f32
// workspace [2, splits, B, T, Hkv, 128] for the partials, summed by a
// second kernel into dk and dv.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* q_seg, const void* kv_seg,
                                  const void* lse, const void* delta, const void* slopes,
                                  void* dk, void* dv, void* ws,
                                  int B, int T, int H, int Hkv, int causal, int splits,
                                  int q_sb, int q_st, int q_sh,
                                  int k_sb, int k_st, int k_sh,
                                  int o_sb, int o_st, int o_sh,
                                  float sm_scale, void* stream) {
  DkvArgs a;
  a.q_seg = static_cast<const int*>(q_seg);
  a.kv_seg = static_cast<const int*>(kv_seg);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.slopes = static_cast<const float*>(slopes);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.ws = static_cast<float*>(ws);
  a.B = B;
  a.T = T;
  a.H = H;
  a.G = H / Hkv;
  a.causal = causal;
  a.splits = splits;
  a.sm_scale = sm_scale;
  a.scale_log2 = sm_scale * LOG2E;
  if (splits < 1 || a.G % splits || (splits > 1 && !ws)) return (int)cudaErrorInvalidValue;
  return (slopes ? launch_dkv<true> : launch_dkv<false>)(q, k, v, dout, a, Hkv, q_sb, q_st,
                                                          q_sh, k_sb, k_st, k_sh, o_sb, o_st,
                                                          o_sh, stream);
}

// Returns 0 once launched, else cudaGetLastError() after the launch or
// hopper::TENSOR_MAP_ERROR (+ the CUDA driver's code) if a TMA map was refused.
// `slopes` (f32 [H], or null) selects the ALiBi instance.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* q_seg, const void* kv_seg,
                                 const void* lse, const void* delta, const void* slopes,
                                 void* dq,
                                 int B, int T, int H, int Hkv, int causal,
                                 int q_sb, int q_st, int q_sh,
                                 int k_sb, int k_st, int k_sh,
                                 int o_sb, int o_st, int o_sh,
                                 float sm_scale, void* stream) {
  DqArgs a;
  a.q_seg = static_cast<const int*>(q_seg);
  a.kv_seg = static_cast<const int*>(kv_seg);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.slopes = static_cast<const float*>(slopes);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.T = T;
  a.H = H;
  a.G = H / Hkv;
  a.causal = causal;
  a.sm_scale = sm_scale;
  a.scale_log2 = sm_scale * LOG2E;
  return (slopes ? launch_dq<true> : launch_dq<false>)(q, k, v, dout, a, B, Hkv, q_sb, q_st,
                                                        q_sh, k_sb, k_st, k_sh, o_sb, o_st,
                                                        o_sh, stream);
}
