// Weight-only int8 / int4 matmul for Hopper (sm_90a): y = x @ dequant(w).
//
// Replaces the Pallas TPU kernels llava_plus_tpu/ops/quant_matmul.py
// _int8_kernel (launched by matmul_int8) and _int4_kernel (launched by
// matmul_int4), and tools/bench_int4_variants.py _int4n_kernel (launched by
// matmul_int4_native). Same functions:
//   int8: x [R, K] bf16 @ qw [K, N] int8, f32 accumulation, times the
//         per-output-channel scale [N] f32 (the Pallas kernel leaves the
//         scale to its caller; here it is applied after the f32 sums);
//   int4: x [R, K] bf16 @ packed qw [K/2, N] int8 with per-32-row-block
//         scales [K/32, N] f32: w[k, n] = bf16(f32(nibble) * scale), rounded
//         once per element, as the Pallas kernel does. Within each 32-row
//         block the packing is split-half: the low nibble of packed row j
//         holds row j, the high nibble row j + 16;
//   int4 native (int4n): packed qw [K, N/2] uint8, element (k, n) in byte
//         (k, n/2), the low nibble for even n, the high one for odd n, with
//         the same block scales and the same rounding; f32 out. The Pallas
//         variant's grid takes K / bk steps of bk = min(K, 4096) and drops
//         the last K % bk rows; these kernels run over all of K.
// The output is bf16 or f32 (the lm_head's logits, and always for int4n),
// [R, N] row-major.
//
// What bounds it on the card: at decode rows (R = the engine's slots, 1..16;
// later speculation's up to 32) the weight stream, K * N bytes (int8) or
// K * N / 2 + K * N / 8 (int4 in either layout, and its block scales) per
// call, against 3.35 TB/s; at prefill and training rows (768 a prompt,
// thousands in a batch, QLoRA's 4 x 2048) the products, against 989 bf16
// TFLOP/s. The weights move from device memory as int8 or nibbles and are
// widened to bf16 right before the tensor cores: int8 exactly with masks and
// a bf16x2 add (csrc/warp_mma.cuh); int4 as byte permutes under the
// exponent of 2^23, an f32 subtract, the f32 multiply by the block scale
// and one rounding to bf16 (int4_pairs, native_pairs below): about four
// instructions a weight, twice int8's work per weight byte. At prefill rows
// the wgmma of the previous step hides it (~450 TFLOP/s); at decode rows it
// is what holds the int4 stream at 29-54% of its bytes bound on the H100's
// 7B shapes (rounding with integer instructions instead, or eight warps a
// block, measured slower).
//
// Each layout takes one of two kernels, by row count (ops/quant_matmul.
// int8_plan / int4_plan / int4n_plan, the cuts INT8_CUT = 32, INT4_CUT and
// INT4N_CUT measured on the card):
//   decode rows   <layout>_stream_kernel: 128-column strips of the weight,
//                 each cut into K chunks so that every SM holds two or three
//                 blocks streaming equal bytes; 8 KB weight tiles by TMA
//                 through a 4-stage ring (int8: 64 k rows of 128 bytes;
//                 int4: 64 packed rows of 128 bytes, 128 k rows; int4n: 128
//                 k rows of 64 bytes, 64-byte swizzled), int4's block-scale
//                 rows of the strip beside them, x's rows by cp.async;
//                 mma.sync with the weight as the m16 side and x's rows as
//                 n8 (out^T = W^T x^T: one row costs an n8 tile, not a
//                 padded m16); the chunks' f32 parts summed in chunk order
//                 by the last block of the strip (a counter it resets): one
//                 launch, deterministic, no host sync;
//   prefill rows  <layout>_wgmma_kernel: 128-row x 256-column output tiles,
//                 x and the weight (int4: and its block scales) by TMA into
//                 a ring of swizzled tiles; each thread converts its weight
//                 bytes straight into wgmma's register A operand (the
//                 transposed product again: the weight's columns are M, x's
//                 rows N) while the previous step's wgmma m64n128k16 run;
//                 the tiles of a last, partial wave cut into K chunks,
//                 combined as above.
// The three layouts differ only where a warp's A registers come from
// (slab_load): int8 and split-half int4 hold one column a byte, so a
// thread's four columns are one 4-byte load of each of its rows; native
// int4 holds two columns of one row a byte, so a thread's four columns at
// rows k and k + 1 are two bytes of each, which one ldmatrix.trans brings
// as one register.

// Shapes (every layout): K % 128 == 0, N % 64 == 0; x rows with a 16-byte aligned stride,
// the last dimension contiguous; qw, scales and out contiguous.

#include "hopper.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int QBLOCK = 32;      // int4 scale block along K

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

namespace qk {

using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using warp_mma::FULL;
using warp_mma::i8x_pair;

// The weight layouts: int8 [K, N]; split-half int4 [K/2, N] (a byte holds
// one column at rows j and j + 16 of a 32-row block); native int4 [K, N/2]
// (a byte holds columns 2c and 2c + 1 of one row).
enum Lay { I8, I4, I4N };

// out[r, col .. col + 3] = v, bf16 or f32.
template <bool OUT_F32>
__device__ __forceinline__ void store4(void* out, int r, int col, int N, float4 v) {
  if (OUT_F32) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + (size_t)r * N + col) = v;
  } else {
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + (size_t)r * N + col) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// v times the columns' per-channel scales (int8), or v itself (int4: a null
// scale, the block scales were applied to the weights).
__device__ __forceinline__ float4 scaled(float4 v, const float* scale, int col) {
  if (scale == nullptr) return v;
  const float4 s = *reinterpret_cast<const float4*>(scale + col);
  return make_float4(v.x * s.x, v.y * s.y, v.z * s.z, v.w * s.w);
}

// Byte e (0..3) of u, a nibble n of an int4 weight stored as n ^ 8 = n + 8
// (the rest of the byte 0), as the f32 n, exactly and without the
// quarter-rate converter: the byte is permuted in as the low byte of a word
// under the exponent of 2^23 (the float 2^23 + 8 + n), and 2^23 + 8 is
// subtracted.
__device__ __forceinline__ float nibble_f32(uint32_t u, int e) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | e)) - 8388616.f;
}

// The signed nibbles of four bytes (one column each) of rows k (w0) and k +
// 1 (w1) -- the low nibbles, or with HI the high ones -- each times its
// column's scale in f32 and rounded to bf16 once: out[e] is byte e's pair,
// the low half from row k. One f32 multiply and one rounding, as the Pallas
// kernel's f32 multiply and cast.
template <bool HI>
__device__ __forceinline__ void int4_pairs(uint32_t w0, uint32_t w1, const float4& s,
                                           uint32_t (&out)[4]) {
  const uint32_t u0 = ((HI ? w0 >> 4 : w0) & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t u1 = ((HI ? w1 >> 4 : w1) & 0x0F0F0F0Fu) ^ 0x08080808u;
  const float sc[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    out[e] = pack_bf16(nibble_f32(u0, e) * sc[e], nibble_f32(u1, e) * sc[e]);
}

// The native layout's counterpart: r holds two bytes of row k (bytes 0, 1:
// columns c .. c + 3, the low nibble of each byte first) and the same two
// of row k + 1 (bytes 2, 3), as ldmatrix.trans delivers them; out[q] is
// column c + q's pair (rows k, k + 1) times s[q], rounded to bf16 once.
__device__ __forceinline__ void native_pairs(uint32_t r, const float4& s, uint32_t (&out)[4]) {
  const uint32_t u[2] = {(r & 0x0F0F0F0Fu) ^ 0x08080808u,           // columns c, c + 2
                         ((r >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u};   // columns c + 1, c + 3
  const float sc[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    out[q] = pack_bf16(nibble_f32(u[q & 1], q >> 1) * sc[q],
                       nibble_f32(u[q & 1], 2 + (q >> 1)) * sc[q]);
}

// The A registers of two m16 tiles for one k16 step, from the words of this
// thread's four rows (k, k + 1, k + 8, k + 9; four columns each, byte 0:
// m-tile 0 row g; 1: m-tile 0 row g + 8; 2, 3: m-tile 1). int8: the bytes
// themselves (s unused); int4: the low (HI false) or high nibbles of the
// packed rows times their scales s.
template <bool INT4, bool HI>
__device__ __forceinline__ void a_frags(const uint32_t (&wd)[4], const float4& s,
                                        uint32_t (&a)[2][4]) {
  if constexpr (INT4) {
    uint32_t r01[4], r89[4];
    int4_pairs<HI>(wd[0], wd[1], s, r01);
    int4_pairs<HI>(wd[2], wd[3], s, r89);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      a[j][0] = r01[2 * j];
      a[j][1] = r01[2 * j + 1];
      a[j][2] = r89[2 * j];
      a[j][3] = r89[2 * j + 1];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      a[j][0] = i8x_pair(wd[0], wd[1], 2 * j);
      a[j][1] = i8x_pair(wd[0], wd[1], 2 * j + 1);
      a[j][2] = i8x_pair(wd[2], wd[3], 2 * j);
      a[j][3] = i8x_pair(wd[2], wd[3], 2 * j + 1);
    }
  }
}

// The same for the native layout, from two ldmatrix.trans registers: r01
// holds the thread's columns c .. c + 3 at rows k and k + 1, r89 at rows k +
// 8 and k + 9 (column c + 2 j is m-tile j's row g, c + 2 j + 1 its row g + 8).
__device__ __forceinline__ void native_frags(uint32_t r01, uint32_t r89, const float4& s,
                                             uint32_t (&a)[2][4]) {
  uint32_t p01[4], p89[4];
  native_pairs(r01, s, p01);
  native_pairs(r89, s, p89);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    a[j][0] = p01[2 * j];
    a[j][1] = p01[2 * j + 1];
    a[j][2] = p89[2 * j];
    a[j][3] = p89[2 * j + 1];
  }
}

// k16 steps of a slab: int8 a slab is 16 rows, one step; split-half int4 16
// packed rows, two steps (the low nibbles, then the high); native int4 32
// rows, two steps. Every slab of int4 is one 32-row scale block.
template <Lay L>
__host__ __device__ constexpr int slab_steps() { return L == I8 ? 1 : 2; }

// The bytes behind warp w's A registers for slab `sl` of a 128-column
// weight tile in shared memory as TMA wrote it (a decode stage, or a
// warpgroup's box of a prefill stage): int8 and split-half int4 rows of 128
// bytes, 128-byte swizzled; native rows of 64 bytes, 64-byte swizzled.
// m-tile j's row g is column 4 (8 w + g) + 2 j of the tile and its row g + 8
// the next column: the columns are permuted inside the warp, and the stores
// undo it. Byte layouts: one 4-byte load at each of the thread's rows k, k +
// 1, k + 8, k + 9 (k = 16 sl + 2 t) brings its four columns. Native: lane l
// gives row 32 sl + l of the warp's 16-byte column of the slab to one
// ldmatrix.x4.trans, whose four 8-row matrices return the thread's two bytes
// (its four columns) of rows k and k + 1, then k + 8 and k + 9, of each of
// the slab's two k16 steps.
template <Lay L>
__device__ __forceinline__ void slab_load(const unsigned char* tile, int sl, int w, int lane,
                                          uint32_t (&raw)[4]) {
  if constexpr (L == I4N) {
    const int row = 32 * sl + lane;
    warp_mma::ldmatrix_x4_trans(raw, tile + row * 64 + (((w ^ (row >> 1)) & 3) << 4));
  } else {
    const int wc = 4 * (8 * w + lane / 4);   // the thread's byte column of the tile
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = 16 * sl + 2 * (lane % 4) + (q & 1) + 8 * (q >> 1);
      raw[q] = *reinterpret_cast<const uint32_t*>(tile + row * 128 +
                                                  ((((wc >> 4) ^ row) & 7) << 4) + (wc & 15));
    }
  }
}

// The A registers of the warp's two m16 tiles for k16 step h of the slab,
// from slab_load's bytes; s: the thread's four columns' block scales of the
// slab (int4).
template <Lay L>
__device__ __forceinline__ void step_frags(const uint32_t (&raw)[4], const float4& s, int h,
                                           uint32_t (&a)[2][4]) {
  if constexpr (L == I4N) {
    native_frags(raw[2 * h], raw[2 * h + 1], s, a);
  } else if constexpr (L == I4) {
    if (h == 0)
      a_frags<true, false>(raw, s, a);
    else
      a_frags<true, true>(raw, s, a);
  } else {
    a_frags<false, false>(raw, s, a);
  }
}

// The last block of an output tile (rows r0 .., columns c0 .. of `cols`, a
// multiple of 4) sums the tile's split-K partials in split order (element
// (r, col) of split k at part[k * stride + (r - r0) * ld + col - c0]),
// applies the scale (int8; null for int4) and writes the tile: the same sums
// in the same order on every launch. Four outputs a thread at once, so that
// many loads of the partials are in flight (each waits on L2).
template <bool OUT_F32>
__device__ void finish_tile(const float* part, size_t stride, int ld, int splits,
                            const float* scale, void* out, int R, int N, int r0, int rows,
                            int c0, int cols, int tid, int nthreads) {
  constexpr int U = 4;
  const int q = cols / 4, n = rows * q;
  for (int x0 = tid; x0 < n; x0 += U * nthreads) {
    float4 v[U];
    const float* src[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = x0 + u * nthreads;
      const int rr = e / q, cc = 4 * (e % q);
      live[u] = e < n && r0 + rr < R && c0 + cc < N;
      src[u] = part + (live[u] ? (size_t)rr * ld + cc : 0);
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 4
    for (int k = 0; k < splits; ++k)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(src[u] + k * stride));
        v[u].x += p.x;
        v[u].y += p.y;
        v[u].z += p.z;
        v[u].w += p.w;
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!live[u]) continue;
      const int e = x0 + u * nthreads;
      const int r = r0 + e / q, col = c0 + 4 * (e % q);
      store4<OUT_F32>(out, r, col, N, scaled(v[u], scale, col));
    }
  }
}

// Count this block's partial of tile `tile` in; true for the last block of
// the tile, which resets the counter for the next launch. Every thread of
// the block calls it; the block's partial writes precede it.
__device__ __forceinline__ bool last_of_tile(int* counters, int tile, int splits, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(counters + tile, 1) == splits - 1;
    if (*flag) counters[tile] = 0;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// -- decode rows: the weight stream over every SM ---------------------------------

constexpr int SN = 128;             // weight columns of a strip: 32 per warp
constexpr int SK = 64;              // 128-byte rows of a byte layout's tile (8 KB, one stage)
constexpr int SST = 4;              // ring stages
constexpr int SNTHREADS = 128;      // 4 warps
constexpr int SLABS = 4;            // slabs of a stage (every layout)

// k rows of a stage: int8 a tile's 64 rows; int4 its 64 packed rows (two k
// a byte); native int4 128 rows of 64 bytes (the same 8 KB); shared bytes
// of an x row of the stage
template <Lay L>
__host__ __device__ constexpr int stream_krows() { return L == I8 ? SK : 2 * SK; }
template <Lay L>
__host__ __device__ constexpr int stream_ldx() { return 2 * stream_krows<L>() + 16; }

// A stage: the 8 KB weight tile (swizzled by TMA), the x tile and (int4)
// the strip's block scales of the stage's k rows, rounded to the 1024 bytes
// a swizzled tile starts on.
template <int NR, Lay L>
__host__ __device__ constexpr int stream_stage() {
  return (SK * SN + 8 * NR * stream_ldx<L>() + (L != I8 ? 2 * SK / QBLOCK * SN * 4 : 0) +
          1023) / 1024 * 1024;
}

template <int NR, Lay L>
__host__ __device__ constexpr int stream_smem() {
  return SST * stream_stage<NR, L>() + SST * 8 + 1024;   // + the mbarriers, + alignment
}

// x's B fragments of the stage's k16 step ks by ldmatrix, from the x tile
// (8 NR rows of XLD bytes): matrix 2 m + h is rows 8 (n + m) .. + 7, k 16 ks
// + 8 h .. + 7.
template <int NR, int XLD>
__device__ __forceinline__ void x_frags(const unsigned char* xt, int ks, int lane,
                                        uint32_t (&b)[NR][2]) {
  const int m8 = lane / 8;
  if constexpr (NR == 1) {
    warp_mma::ldmatrix_x2(b[0], xt + (lane % 8) * XLD + 2 * (16 * ks + 8 * (m8 & 1)));
  } else {
#pragma unroll
    for (int n = 0; n < NR; n += 2) {
      uint32_t r[4];
      warp_mma::ldmatrix_x4(r, xt + (8 * (n + m8 / 2) + lane % 8) * XLD +
                                   2 * (16 * ks + 8 * (m8 & 1)));
      b[n][0] = r[0];
      b[n][1] = r[1];
      b[n + 1][0] = r[2];
      b[n + 1][1] = r[3];
    }
  }
}

// One k16 step of the warp's products: two m16 tiles of the weight (a) by
// NR n8 tiles of x (b) into acc.
template <int NR>
__device__ __forceinline__ void mma_step(float (&acc)[2][NR][4], const uint32_t (&a)[2][4],
                                         const uint32_t (&b)[NR][2]) {
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    warp_mma::mma_16816(acc[0][n], a[0], b[n][0], b[n][1]);
    warp_mma::mma_16816(acc[1][n], a[1], b[n][0], b[n][1]);
  }
}

// One 32-row slab of a native decode stage: the warp's A registers by
// slab_load (one ldmatrix.x4.trans) and native_frags, times its four
// columns' scales s, against x's fragments, two k16 steps. With four or
// more n8 tiles both steps' x fragments come first, then both steps'
// conversion, then the products (measured 7-26% faster at 48 rows than
// step by step, which is as fast at 1 and 16 rows).
template <int NR, int XLD>
__device__ __forceinline__ void native_slab(const unsigned char* wt, const unsigned char* xt,
                                            const float4& s, int sl, int warp, int lane,
                                            float (&acc)[2][NR][4]) {
  uint32_t raw[4];
  slab_load<I4N>(wt, sl, warp, lane, raw);
  if constexpr (NR >= 4) {
    uint32_t b[2][NR][2], a[2][2][4];
    x_frags<NR, XLD>(xt, 2 * sl, lane, b[0]);
    x_frags<NR, XLD>(xt, 2 * sl + 1, lane, b[1]);
    native_frags(raw[0], raw[1], s, a[0]);
    native_frags(raw[2], raw[3], s, a[1]);
    mma_step<NR>(acc, a[0], b[0]);
    mma_step<NR>(acc, a[1], b[1]);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t a[2][4], b[NR][2];
      native_frags(raw[2 * h], raw[2 * h + 1], s, a);
      x_frags<NR, XLD>(xt, 2 * sl + h, lane, b);
      mma_step<NR>(acc, a, b);
    }
  }
}

// One block per (strip of 128 weight columns, K chunk); the plan
// (ops/quant_matmul.int8_plan, int4_plan, int4n_plan) picks the chunks so
// that two or three blocks of every SM stream about the same bytes. Thread
// 0 brings each 8 KB weight tile with one TMA load (a map made once per
// weight and kept by the wrapper), SST - 1 tiles ahead; the threads copy
// x's tile (and, for int4, the strip's block scales) beside it with
// cp.async. Warp w owns columns 32 w .. 32 w + 31 of the strip over every k
// step of the chunk, so no sums cross warps. The product is transposed,
// out^T = W^T x^T: the weight is mma's A side (m16) and x's 8 NR rows the n8
// side, so a decode row costs one n8 tile, not a padded m16. A thread's A
// registers come from one 4-byte load at each of its rows (int8, int4) or
// from native_slab: its columns 32 w + 4 g .. + 3 are rows g and g + 8 of
// m-tiles 0 and 1 (permuted inside the warp, undone where the sums are
// stored); int4 converts them with the thread's four scales of the slab's
// block. With one chunk the block writes its columns (int8: scaled);
// otherwise it writes its f32 part to the workspace, and the last block of
// the strip to count in (a counter per strip, reset by that block) sums the
// parts in chunk order, scales and writes: deterministic, one launch.
template <int NR, bool OUT_F32, Lay L>
__device__ __forceinline__ void stream_body(const CUtensorMap* w_map,
                                            const __nv_bfloat16* __restrict__ x,
                                            const float* __restrict__ scale,
                                            void* __restrict__ out, float* __restrict__ ws,
                                            int* __restrict__ counters, int R, int K, int N,
                                            int ldx, int splits) {
  constexpr bool NIB = L != I8;   // int4 values, block scales beside each stage
  constexpr int ROWS = 8 * NR;
  constexpr int KR = stream_krows<L>();
  constexpr int XLD = stream_ldx<L>();
  constexpr int stage = stream_stage<NR, L>();
  constexpr int SCALE_OFF = SK * SN + ROWS * XLD;   // int4: the stage's [KR / 32][SN] scales
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SST * stage);
  __shared__ int is_last;

  const int n0 = blockIdx.x * SN;
  const int c = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kt_all = K / KR;
  const int per = (kt_all + splits - 1) / splits;
  const int kt0 = c * per;
  const int nt = max(0, min(kt_all, kt0 + per) - kt0);

  if (tid == 0) {
    for (int s = 0; s < SST; ++s) mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
    hopper::prefetch_map(w_map);
  }
  __syncthreads();

  // tile i into stage i % SST: the weight by TMA (thread 0: byte column n0,
  // or n0 / 2 for native; row k0, or k0 / 2 for split-half; bytes past N
  // read as zeros), x by cp.async (rows past R zero-filled), int4's scales
  // by cp.async (columns past N zero-filled)
  auto load_tile = [&](int i) {
    unsigned char* st = smem + (i % SST) * stage;
    const int k0 = (kt0 + i) * KR;
    if (tid == 0) {
      mbar_expect_tx(&full[i % SST], SK * SN);
      hopper::tma_load_2d(st, w_map, &full[i % SST], L == I4N ? n0 / 2 : n0,
                          L == I4 ? k0 / 2 : k0);
    }
    for (int e = tid; e < ROWS * (KR / 8); e += SNTHREADS) {
      const int r = e / (KR / 8), ch = e % (KR / 8);
      const bool in = r < R;
      warp_mma::cp_async16(st + SK * SN + r * XLD + 16 * ch,
                           x + (size_t)(in ? r : 0) * ldx + k0 + 8 * ch, in);
    }
    if constexpr (NIB) {
      static_assert(KR / QBLOCK * SN / 4 == SNTHREADS, "one 16-byte scale copy a thread");
      const int r = tid / (SN / 4), col = n0 + 4 * (tid % (SN / 4));
      const bool in = col < N;
      warp_mma::cp_async16(st + SCALE_OFF + 16 * tid,
                           scale + (size_t)(k0 / QBLOCK + r) * N + (in ? col : 0), in);
    }
  };
#pragma unroll
  for (int i = 0; i < SST - 1; ++i) {
    if (i < nt) load_tile(i);
    warp_mma::cp_async_commit();
  }

  float acc[2][NR][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < NR; ++n) acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;
  const int wc = 32 * warp + 4 * g;   // this thread's 4 columns of the strip

  for (int i = 0; i < nt; ++i) {
    warp_mma::cp_async_wait<SST - 2>();
    __syncthreads();   // x tile i landed for all; tile i - 1's stage is free
    if (i + SST - 1 < nt) {
      // the stage's last readers were generic loads, its next writer is TMA
      if (tid == 0) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_tile(i + SST - 1);
    }
    warp_mma::cp_async_commit();
    mbar_wait(&full[i % SST], (i / SST) & 1);   // weight tile i landed

    const unsigned char* wt = smem + (i % SST) * stage;
    const unsigned char* xt = wt + SK * SN;
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (L == I4N) {
        s = *reinterpret_cast<const float4*>(wt + SCALE_OFF + 4 * (sl * SN + wc));
        native_slab<NR, XLD>(wt, xt, s, sl, warp, lane, acc);
      } else {
        // the byte layouts, written out in full (the same work through
        // slab_load and x_frags measured 5-9% slower at 1 and 16 rows)
        const int k = 16 * sl + 2 * t;   // this thread's rows k, k + 1, k + 8, k + 9
        uint32_t wd[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = k + (q & 1) + 8 * (q >> 1);   // 128-byte swizzled rows
          wd[q] = *reinterpret_cast<const uint32_t*>(wt + row * SN +
                                                     ((((wc >> 4) ^ row) & 7) << 4) + (wc & 15));
        }
        if constexpr (NIB)
          s = *reinterpret_cast<const float4*>(wt + SCALE_OFF + 4 * (sl * SN + wc));
#pragma unroll
        for (int h = 0; h < slab_steps<L>(); ++h) {
          const int ks = slab_steps<L>() * sl + h;   // the k16 step of the stage
          uint32_t a[2][4];
          if (h == 0)
            a_frags<NIB, false>(wd, s, a);
          else
            a_frags<NIB, true>(wd, s, a);
          // x's B fragments by ldmatrix: matrix 2 m + h is rows 8 (n + m) ..
          // + 7, k 16 ks + 8 h .. + 7
          uint32_t b[NR][2];
          const int m8 = lane / 8;
          if constexpr (NR == 1) {
            warp_mma::ldmatrix_x2(b[0], xt + (lane % 8) * XLD + 2 * (16 * ks + 8 * (m8 & 1)));
          } else {
#pragma unroll
            for (int n = 0; n < NR; n += 2) {
              uint32_t r[4];
              warp_mma::ldmatrix_x4(r, xt + (8 * (n + m8 / 2) + lane % 8) * XLD +
                                           2 * (16 * ks + 8 * (m8 & 1)));
              b[n][0] = r[0];
              b[n][1] = r[1];
              b[n + 1][0] = r[2];
              b[n + 1][1] = r[3];
            }
          }
#pragma unroll
          for (int n = 0; n < NR; ++n) {
            warp_mma::mma_16816(acc[0][n], a[0], b[n][0], b[n][1]);
            warp_mma::mma_16816(acc[1][n], a[1], b[n][0], b[n][1]);
          }
        }
      }
    }
  }

  // acc[j][n] holds (column wc + 2 j, x row 8 n + 2 t), (that column, row +
  // 1), then column + 1 for both rows
  const float* col_scale = NIB ? nullptr : scale;
  const int col = n0 + wc;
  if (col < N) {
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * n + 2 * t + e;
        if (r >= R) continue;
        const float4 v = make_float4(acc[0][n][e], acc[0][n][2 + e], acc[1][n][e],
                                     acc[1][n][2 + e]);
        if (splits == 1)
          store4<OUT_F32>(out, r, col, N, scaled(v, col_scale, col));
        else
          *reinterpret_cast<float4*>(ws + ((size_t)c * R + r) * N + col) = v;
      }
  }
  if (splits == 1) return;
  if (last_of_tile(counters, blockIdx.x, splits, &is_last))
    finish_tile<OUT_F32>(ws + n0, (size_t)R * N, N, splits, col_scale, out, R, N, 0, R, n0, SN,
                         tid, SNTHREADS);
}

template <int NR, bool OUT_F32>
__global__ void __launch_bounds__(SNTHREADS)
int8_stream_kernel(const __grid_constant__ CUtensorMap w_map,
                   const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                   void* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                   int R, int K, int N, int ldx, int splits) {
  stream_body<NR, OUT_F32, I8>(&w_map, x, scale, out, ws, counters, R, K, N, ldx, splits);
}

template <int NR, bool OUT_F32>
__global__ void __launch_bounds__(SNTHREADS)
int4_stream_kernel(const __grid_constant__ CUtensorMap w_map,
                   const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                   void* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                   int R, int K, int N, int ldx, int splits) {
  stream_body<NR, OUT_F32, I4>(&w_map, x, scale, out, ws, counters, R, K, N, ldx, splits);
}

template <int NR, bool OUT_F32>
__global__ void __launch_bounds__(SNTHREADS)
int4n_stream_kernel(const __grid_constant__ CUtensorMap w_map,
                    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                    void* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                    int R, int K, int N, int ldx, int splits) {
  stream_body<NR, OUT_F32, I4N>(&w_map, x, scale, out, ws, counters, R, K, N, ldx, splits);
}

// -- prefill and training rows: wgmma -------------------------------------------

constexpr int PW_COLS = 256;           // weight columns of a block: 128 per consumer warpgroup
constexpr int PX_ROWS = 128;           // x rows of a block
constexpr int PK = 64;                 // k of a ring stage (128 bytes of x rows)
constexpr int PX_BYTES = PX_ROWS * 128;       // a stage's x tile: 128 rows x 64 bf16
constexpr int PNTHREADS = 256;         // two consumer warpgroups
constexpr int PTILE = PX_ROWS * PW_COLS;   // f32 sums of a partial tile

// A stage: the x tile; two weight boxes of 128 columns (int8: 64 rows of
// 128 bytes; int4: 32 packed rows of 128 bytes; native: 64 rows of 64
// bytes); int4's block scales of its 256 columns (two rows of f32,
// unswizzled). Ring stages: as many as fit.
template <Lay L>
__host__ __device__ constexpr int pw_box() { return L == I8 ? PK * 128 : PK * 64; }
template <Lay L>
__host__ __device__ constexpr int pstage() {
  return PX_BYTES + 2 * pw_box<L>() + (L != I8 ? PK / QBLOCK * PW_COLS * 4 : 0);
}
template <Lay L>
__host__ __device__ constexpr int pstages() { return L != I8 ? 8 : 6; }
template <Lay L>
__host__ __device__ constexpr int psmem() {
  return pstages<L>() * pstage<L>() + 2 * pstages<L>() * 8 + 1024;
}

// One block per (256 weight columns, 128 x rows[, K chunk]) (which tiles
// are cut into K chunks: wgmma_entry). The product is transposed, out^T =
// W^T x^T, so the weight is wgmma's register operand A: each warp of a
// warpgroup takes its A registers for a slab from the TMA-fed, swizzled
// weight box of its warpgroup (slab_load: columns 4 (8 w + g) .. + 3 of the
// box, which are rows g and g + 8 of m-tiles 0 and 1, permuted inside the
// warpgroup's 128 and undone at the store), converted to bf16 pairs in
// registers (int8 exactly; int4, in either layout, two k16 steps a slab,
// times the block scales of the stage) and issues m64n128k16 with x's tile
// (128 rows, K-major, swizzled) as B from shared memory. The bf16 weights
// never touch shared memory. Two register sets of A: step i + 1 is
// converted while step i's eight products run, and the set is written only
// after the products that read it have retired (ptxas then keeps the wgmma
// pipelined). Thread 0 issues the TMA loads, a ring's depth ahead.
template <Lay L>
__device__ __forceinline__ void wgmma_body(const CUtensorMap* x_map, const CUtensorMap* w_map,
                                           const CUtensorMap* s_map,
                                           const float* __restrict__ scale,
                                           void* __restrict__ out, float* __restrict__ ws,
                                           int* __restrict__ counters, int R, int K, int N,
                                           int splits, int dp_tiles, int out_f32) {
  constexpr bool NIB = L != I8;
  constexpr int PST = pstages<L>();
  constexpr int PSTAGE = pstage<L>();
  constexpr int BOX = pw_box<L>();
  constexpr int SCALE_OFF = PX_BYTES + 2 * BOX;   // int4: [2][256] f32 block scales
  constexpr int KS = slab_steps<L>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + PST * PSTAGE);
  uint64_t* empty = full + PST;
  __shared__ int is_last;

  // output tiles in order (columns fastest): the first dp_tiles over all of
  // K, one block each; every later one cut into `splits` K chunks
  const int n_tiles = (N + PW_COLS - 1) / PW_COLS;
  const int b = blockIdx.x;
  const int tile = b < dp_tiles ? b : dp_tiles + (b - dp_tiles) / splits;
  const int c = b < dp_tiles ? 0 : (b - dp_tiles) % splits;
  const int chunks = b < dp_tiles ? 1 : splits;   // block-uniform
  const int n0 = (tile % n_tiles) * PW_COLS;
  const int m0 = (tile / n_tiles) * PX_ROWS;
  // a cut tile's partial of chunk c (f32, 128 x 256)
  float* part = chunks > 1 ? ws + ((size_t)(tile - dp_tiles) * splits + c) * PTILE : nullptr;
  const int kt_all = K / PK;
  const int per = (kt_all + chunks - 1) / chunks;
  const int kt0 = c * per;
  const int nt = max(0, min(kt_all, kt0 + per) - kt0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < PST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // stage j % PST gets x tile j, both weight boxes (byte columns n0 and n0
  // + 128, or n0 / 2 and n0 / 2 + 64 for native; rows k0, or k0 / 2 for
  // split-half) and (int4) their scales
  auto load = [&](int j) {
    const int s = j % PST;
    const int k0 = (kt0 + j) * PK;
    const int wrow = L == I4 ? k0 / 2 : k0;
    const int wbyte = L == I4N ? n0 / 2 : n0;
    unsigned char* st = smem + s * PSTAGE;
    mbar_expect_tx(&full[s], PSTAGE);
    hopper::tma_load_2d(st, x_map, &full[s], k0, m0);
    hopper::tma_load_2d(st + PX_BYTES, w_map, &full[s], wbyte, wrow);
    hopper::tma_load_2d(st + PX_BYTES + BOX, w_map, &full[s], wbyte + (L == I4N ? 64 : 128),
                        wrow);
    if constexpr (NIB) hopper::tma_load_2d(st + SCALE_OFF, s_map, &full[s], n0, k0 / QBLOCK);
  };
  if (tid == 0) {
    hopper::prefetch_map(x_map);
    hopper::prefetch_map(w_map);
    if constexpr (NIB) hopper::prefetch_map(s_map);
    for (int j = 0; j < PST && j < nt; ++j) load(j);
  }
  __syncwarp();

  // warpgroup wg owns weight columns n0 + 128 wg .. + 127 (its box); wg is
  // warp-uniform as the compiler sees it
  const int wg = __shfl_sync(FULL, tid / 128, 0);
  const int w = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int wc = 4 * (8 * w + g);   // this thread's 4 columns of the warpgroup's 128
  float acc[2][64];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[j][e] = 0.f;

  auto convert = [&](uint32_t (&A)[4][2][4], int i) {
    const int s = i % PST;
    mbar_wait(&full[s], (i / PST) & 1);
    const unsigned char* st = smem + s * PSTAGE;
    const unsigned char* box = st + PX_BYTES + wg * BOX;
#pragma unroll
    for (int sl = 0; sl < 4 / KS; ++sl) {
      uint32_t raw[4];
      slab_load<L>(box, sl, w, lane, raw);
      float4 sc = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (NIB)
        sc = *reinterpret_cast<const float4*>(st + SCALE_OFF +
                                              4 * (sl * PW_COLS + 128 * wg + wc));
#pragma unroll
      for (int h = 0; h < KS; ++h) step_frags<L>(raw, sc, h, A[KS * sl + h]);
    }
  };
  auto issue = [&](uint32_t (&A)[4][2][4], int i) {
    const uint32_t x_addr = hopper::smem_u32(smem + (i % PST) * PSTAGE);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t db = hopper::desc_sw128(x_addr + 32 * ks, 16, 1024);
      hopper::wgmma_rs_m64n128_k(acc[0], A[ks][0], db);
      hopper::wgmma_rs_m64n128_k(acc[1], A[ks][1], db);
    }
    hopper::wgmma_commit();
  };
  auto retire = [&](uint32_t (&A)[4][2][4], int i) {
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      hopper::fence_regs(A[ks][0]);
      hopper::fence_regs(A[ks][1]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % PST]);
    // step i - 1 + PST into the stage that both warpgroups freed a step ago
    if (tid == 0 && i >= 1 && i - 1 + PST < nt) {
      mbar_wait(&empty[(i - 1) % PST], ((i - 1) / PST) & 1);
      load(i - 1 + PST);
    }
    __syncwarp();
  };
  uint32_t a0[4][2][4], a1[4][2][4];
  if (nt > 0) convert(a0, 0);
  for (int i = 0; i < nt; i += 2) {
    issue(a0, i);
    if (i + 1 < nt) convert(a1, i + 1);
    retire(a0, i);
    if (i + 1 >= nt) break;
    issue(a1, i + 1);
    if (i + 2 < nt) convert(a0, i + 2);
    retire(a1, i + 1);
  }

  // acc[j][4 n + e]: weight column wc + 2 j (e < 2) or + 2 j + 1 (e >= 2)
  // of the warpgroup's 128, x row 8 n + 2 t + e % 2
  const float* col_scale = NIB ? nullptr : scale;
  const int col = n0 + 128 * wg + wc;
  if (col < N) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = m0 + 8 * n + 2 * t + e;
        if (r >= R) continue;
        const float4 v = make_float4(acc[0][4 * n + e], acc[0][4 * n + 2 + e],
                                     acc[1][4 * n + e], acc[1][4 * n + 2 + e]);
        if (chunks > 1)
          *reinterpret_cast<float4*>(part + (r - m0) * PW_COLS + col - n0) = v;
        else if (out_f32)
          store4<true>(out, r, col, N, scaled(v, col_scale, col));
        else
          store4<false>(out, r, col, N, scaled(v, col_scale, col));
      }
  }
  if (chunks == 1) return;
  if (last_of_tile(counters, tile, chunks, &is_last)) {
    const float* first = part - (size_t)c * PTILE;
    if (out_f32)
      finish_tile<true>(first, PTILE, PW_COLS, chunks, col_scale, out, R, N, m0, PX_ROWS, n0,
                        PW_COLS, tid, PNTHREADS);
    else
      finish_tile<false>(first, PTILE, PW_COLS, chunks, col_scale, out, R, N, m0, PX_ROWS, n0,
                         PW_COLS, tid, PNTHREADS);
  }
}

__global__ void __launch_bounds__(PNTHREADS, 1)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map, const float* __restrict__ scale,
                  void* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                  int R, int K, int N, int splits, int dp_tiles, int out_f32) {
  wgmma_body<I8>(&x_map, &w_map, nullptr, scale, out, ws, counters, R, K, N, splits, dp_tiles,
                 out_f32);
}

__global__ void __launch_bounds__(PNTHREADS, 1)
int4_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap s_map, void* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ counters, int R, int K, int N,
                  int splits, int dp_tiles, int out_f32) {
  wgmma_body<I4>(&x_map, &w_map, &s_map, nullptr, out, ws, counters, R, K, N, splits, dp_tiles,
                 out_f32);
}

__global__ void __launch_bounds__(PNTHREADS, 1)
int4n_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap s_map, void* __restrict__ out,
                   float* __restrict__ ws, int* __restrict__ counters, int R, int K, int N,
                   int splits, int dp_tiles, int out_f32) {
  wgmma_body<I4N>(&x_map, &w_map, &s_map, nullptr, out, ws, counters, R, K, N, splits,
                  dp_tiles, out_f32);
}

template <int NR, bool OUT_F32, Lay L>
int launch_stream(const CUtensorMap& w_map, const void* x, const void* scale, void* out,
                  void* ws, void* counters, int R, int K, int N, int ldx, int splits,
                  cudaStream_t st) {
  constexpr int smem = stream_smem<NR, L>();
  const auto kernel = [] {
    if constexpr (L == I8)
      return int8_stream_kernel<NR, OUT_F32>;
    else if constexpr (L == I4)
      return int4_stream_kernel<NR, OUT_F32>;
    else
      return int4n_stream_kernel<NR, OUT_F32>;
  }();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((N + SN - 1) / SN, splits), SNTHREADS, smem, st>>>(
      w_map, static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale), out,
      static_cast<float*>(ws), static_cast<int*>(counters), R, K, N, ldx, splits);
  return (int)cudaGetLastError();
}

// x rows a decode block holds, at most: int8's cut is 32 rows, int4's and
// int4n's 48 at most (ops/quant_matmul.INT8_CUT, INT4_CUT, INT4N_CUT)
template <Lay L>
constexpr int stream_max_rows() { return L == I8 ? 32 : 48; }

template <bool OUT_F32, Lay L>
int stream_rows(const CUtensorMap& w_map, const void* x, const void* scale, void* out,
                void* ws, void* counters, int R, int K, int N, int ldx, int splits,
                cudaStream_t st) {
  if (R <= 8)
    return launch_stream<1, OUT_F32, L>(w_map, x, scale, out, ws, counters, R, K, N, ldx,
                                        splits, st);
  if (R <= 16)
    return launch_stream<2, OUT_F32, L>(w_map, x, scale, out, ws, counters, R, K, N, ldx,
                                        splits, st);
  if (L == I8 || R <= 32)
    return launch_stream<4, OUT_F32, L>(w_map, x, scale, out, ws, counters, R, K, N, ldx,
                                        splits, st);
  if constexpr (L != I8)
    return launch_stream<6, OUT_F32, L>(w_map, x, scale, out, ws, counters, R, K, N, ldx,
                                        splits, st);
  return (int)cudaErrorInvalidValue;
}

// The decode entry points' checks and launch (int4: the packed weight's
// map, K the unpacked depth; int4n writes f32 only).
template <Lay L>
int stream_entry(const void* x, void* out, const void* w_map, const void* scale, void* ws,
                 int ws_elems, void* counters, int n_counters, int R, int K, int N, int ldx,
                 int out_f32, int splits, void* stream) {
  if (R < 1 || R > stream_max_rows<L>() || splits < 1 || !w_map || (L == I4N && !out_f32))
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (!ws || !counters || ws_elems < (long long)splits * R * N ||
                     n_counters < (N + SN - 1) / SN))
    return (int)cudaErrorInvalidValue;
  const CUtensorMap& map = *static_cast<const CUtensorMap*>(w_map);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (L == I4N)
    return stream_rows<true, L>(map, x, scale, out, ws, counters, R, K, N, ldx, splits, st);
  else
    return out_f32 ? stream_rows<true, L>(map, x, scale, out, ws, counters, R, K, N, ldx,
                                          splits, st)
                   : stream_rows<false, L>(map, x, scale, out, ws, counters, R, K, N, ldx,
                                           splits, st);
}

// The prefill entry points' checks, maps and launch.
template <Lay L>
int wgmma_entry(const void* x, void* out, const void* qw, const void* scale, void* ws,
                int ws_elems, void* counters, int n_counters, int R, int K, int N, int ldx,
                int out_f32, int splits, int dp_tiles, void* stream) {
  const int tiles = ((N + PW_COLS - 1) / PW_COLS) * ((R + PX_ROWS - 1) / PX_ROWS);
  if (R < 1 || splits < 1 || dp_tiles < 0 || dp_tiles > tiles || (L == I4N && !out_f32))
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && dp_tiles < tiles &&
      (!ws || !counters || n_counters < tiles ||
       ws_elems < (long long)(tiles - dp_tiles) * splits * PTILE))
    return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, w_map, s_map;
  int err = hopper::make_map_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, R, 2ll * ldx,
                                PK, PX_ROWS);
  if (!err) {
    if constexpr (L == I4N)   // [K, N/2] bytes, boxes of 64 rows x 64 bytes
      err = hopper::make_map_2d(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, qw, N / 2, K, N / 2, 64,
                                PK, CU_TENSOR_MAP_SWIZZLE_64B);
    else
      err = hopper::make_map_2d(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, qw, N,
                                L == I4 ? K / 2 : K, N, 128, L == I4 ? PK / 2 : PK);
  }
  if (!err && L != I8)
    err = hopper::make_map_2d(&s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N, K / QBLOCK,
                              4ll * N, PW_COLS, PK / QBLOCK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  constexpr int smem = psmem<L>();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = dp_tiles + (tiles - dp_tiles) * splits;
  cudaError_t cerr;
  if constexpr (L == I8) {
    cerr = cudaFuncSetAttribute(int8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
    if (cerr != cudaSuccess) return (int)cerr;
    int8_wgmma_kernel<<<grid, PNTHREADS, smem, st>>>(
        x_map, w_map, static_cast<const float*>(scale), out, static_cast<float*>(ws),
        static_cast<int*>(counters), R, K, N, splits, dp_tiles, out_f32);
  } else {
    const auto kernel = L == I4 ? int4_wgmma_kernel : int4n_wgmma_kernel;
    cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (cerr != cudaSuccess) return (int)cerr;
    kernel<<<grid, PNTHREADS, smem, st>>>(x_map, w_map, s_map, out, static_cast<float*>(ws),
                                          static_cast<int*>(counters), R, K, N, splits, dp_tiles,
                                          out_f32);
  }
  return (int)cudaGetLastError();
}

}  // namespace qk

}  // namespace

// Each returns cudaGetLastError() after the launch (0 = launched).
//
// The TMA map of a weight as the decode kernels read it, 8 KB tiles:
// int8's [K, N] or int4's packed [K/2, N] (`native` 0) in tiles of 64 rows x
// 128 bytes, 128-byte swizzled; the native [K, N/2] (`native` 1) in tiles
// of 128 rows x 64 bytes, 64-byte swizzled. `rows` x `row_bytes` is the
// stored array. Written to `map` (128 bytes, 64-byte aligned); made once
// per weight by the caller, who keeps it.
extern "C" int quant_matmul_weight_map(const void* qw, int rows, int row_bytes, int native,
                                       void* map) {
  auto* m = static_cast<CUtensorMap*>(map);
  if (native)
    return hopper::make_map_2d(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, qw, row_bytes, rows, row_bytes,
                               qk::SN / 2, 2 * qk::SK, CU_TENSOR_MAP_SWIZZLE_64B);
  return hopper::make_map_2d(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, qw, row_bytes, rows, row_bytes,
                             qk::SN, qk::SK);
}

// Decode rows (int8: R <= 32; int4, int4n: R <= 48): 128-column strips,
// each cut into `splits` K chunks of whole tiles (int8: 64 k rows; int4,
// int4n: 128); `w_map` is the weight's map from quant_matmul_weight_map;
// with splits > 1, `ws` is the f32 workspace [splits, R, N] and `counters`
// an int32 buffer of ceil(N / 128) zeros, left zero. `ws_elems` and
// `n_counters` are the buffers' sizes: the geometry lives here, so a caller
// that sized them by another is refused. int8's scale is [N] per channel,
// int4's and int4n's [K/32, N]; int4n takes out_f32 = 1 only.
extern "C" int quant_matmul_int8_stream(const void* x, void* out, const void* w_map,
                                        const void* scale, void* ws, int ws_elems,
                                        void* counters, int n_counters, int R, int K, int N,
                                        int ldx, int out_f32, int splits, void* stream) {
  return qk::stream_entry<qk::I8>(x, out, w_map, scale, ws, ws_elems, counters, n_counters, R,
                                  K, N, ldx, out_f32, splits, stream);
}

extern "C" int quant_matmul_int4_stream(const void* x, void* out, const void* w_map,
                                        const void* scale, void* ws, int ws_elems,
                                        void* counters, int n_counters, int R, int K, int N,
                                        int ldx, int out_f32, int splits, void* stream) {
  return qk::stream_entry<qk::I4>(x, out, w_map, scale, ws, ws_elems, counters, n_counters, R,
                                  K, N, ldx, out_f32, splits, stream);
}

extern "C" int quant_matmul_int4n_stream(const void* x, void* out, const void* w_map,
                                         const void* scale, void* ws, int ws_elems,
                                         void* counters, int n_counters, int R, int K, int N,
                                         int ldx, int out_f32, int splits, void* stream) {
  return qk::stream_entry<qk::I4N>(x, out, w_map, scale, ws, ws_elems, counters, n_counters, R,
                                   K, N, ldx, out_f32, splits, stream);
}

// Prefill and training rows: 128-row x 256-column output tiles, the first
// `dp_tiles` (in order, columns fastest) over all of K, every later one cut
// into `splits` K chunks of whole 64-row steps (so that a last, partial wave
// of tiles spreads over the SMs); with splits > 1, `ws` is the f32
// workspace [tiles - dp_tiles, splits, 128, 256] and `counters` an int32
// buffer of one zero per output tile, left zero; `ws_elems` and
// `n_counters` are their sizes, checked here. int4n takes out_f32 = 1 only.
// Returns hopper::TENSOR_MAP_ERROR (+ the CUDA driver's code) if a TMA map
// was refused.
extern "C" int quant_matmul_int8_wgmma(const void* x, void* out, const void* qw,
                                       const void* scale, void* ws, int ws_elems,
                                       void* counters, int n_counters, int R, int K, int N,
                                       int ldx, int out_f32, int splits, int dp_tiles,
                                       void* stream) {
  return qk::wgmma_entry<qk::I8>(x, out, qw, scale, ws, ws_elems, counters, n_counters, R, K, N,
                                 ldx, out_f32, splits, dp_tiles, stream);
}

extern "C" int quant_matmul_int4_wgmma(const void* x, void* out, const void* qw,
                                       const void* scale, void* ws, int ws_elems,
                                       void* counters, int n_counters, int R, int K, int N,
                                       int ldx, int out_f32, int splits, int dp_tiles,
                                       void* stream) {
  return qk::wgmma_entry<qk::I4>(x, out, qw, scale, ws, ws_elems, counters, n_counters, R, K, N,
                                 ldx, out_f32, splits, dp_tiles, stream);
}

extern "C" int quant_matmul_int4n_wgmma(const void* x, void* out, const void* qw,
                                        const void* scale, void* ws, int ws_elems,
                                        void* counters, int n_counters, int R, int K, int N,
                                        int ldx, int out_f32, int splits, int dp_tiles,
                                        void* stream) {
  return qk::wgmma_entry<qk::I4N>(x, out, qw, scale, ws, ws_elems, counters, n_counters, R, K,
                                  N, ldx, out_f32, splits, dp_tiles, stream);
}
