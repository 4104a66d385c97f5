// Weight-only int8 / int4 matmul for Hopper (sm_90a): y = x @ dequant(w).
//
// Replaces the Pallas TPU kernels llava_plus_tpu/ops/quant_matmul.py
// _int8_kernel (launched by matmul_int8) and _int4_kernel (launched by
// matmul_int4), and tools/bench_int4_variants.py _int4n_kernel (launched by
// matmul_int4_native). Same functions:
//   int8: x [R, K] bf16 @ qw [K, N] int8, f32 accumulation, times the
//         per-output-channel scale [N] f32 (the Pallas kernel leaves the
//         scale to its caller; here it is applied in the epilogue);
//   int4: x [R, K] bf16 @ packed qw [K/2, N] int8 with per-32-row-block
//         scales [K/32, N] f32 applied while the tile is converted. Within
//         each 32-row block the packing is split-half: the low nibble of
//         packed row j holds row j, the high nibble row j + 16;
//   int4 native: packed qw [K, N/2] uint8, element (k, n) in byte (k, n/2),
//         the low nibble for even n, the high one for odd n, with the same
//         block scales; f32 out. The Pallas variant's grid takes K / bk
//         steps of bk = min(K, 4096) and drops the last K % bk rows; this
//         kernel runs over all of K.
// The output is bf16 or f32 (the lm_head's logits), [R, N] row-major.
//
// What bounds it on the card: at decode (R = the engine's slots, 1..16) the
// weight stream, K * N bytes (int8) or K * N / 2 (int4) per call, against
// 3.35 TB/s; at prefill (R in the thousands) the products. The weights move
// from device memory as int8 (half of bf16's bytes, a quarter for int4) and
// are widened to bf16 only in shared memory, right before mma.sync m16n8k16
// (bf16 operands, f32 accumulators). Each 128-deep K tile is fetched into
// registers while the previous one is multiplied. Two tile shapes: 16 rows
// by 32 columns for R <= 16 (decode: more blocks to spread the weight stream
// over the SMs), 64 by 64 for larger R. This first version has no split-K,
// no wgmma and no TMA; those are later work.
//
// Shapes (every layout): K % 128 == 0, N % 64 == 0; x rows with a 16-byte aligned stride,
// the last dimension contiguous; qw, scales and out contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 128;         // K depth of one tile
constexpr int NTHREADS = 128;   // 4 warps
constexpr int QBLOCK = 32;      // int4 scale block along K
constexpr int LDX = BK + 8;     // smem row stride of the x tile (bf16)

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

// Two bf16 of one column from consecutive rows (row stride ld), packed low/high.
__device__ __forceinline__ uint32_t ld_col2(const __nv_bfloat16* p, int ld) {
  const uint16_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint16_t hi = *reinterpret_cast<const uint16_t*>(p + ld);
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Signed byte e (0..3) of a 32-bit word, sign-extended.
__device__ __forceinline__ int sbyte(uint32_t word, int e) {
  return static_cast<int>(static_cast<int8_t>((word >> (8 * e)) & 0xffu));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// BITS: 8 or 4. BM x BN: the block's output tile. OUT_F32: f32 or bf16 out.
// NATIVE (BITS 4 only): the [K, N/2] column-pair layout instead of split-half;
// it changes only the weight tile's fetch and its unpack into Ws.
template <int BITS, int BM, int BN, bool OUT_F32, bool NATIVE = false>
__global__ void __launch_bounds__(NTHREADS)
quant_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ qw,
                    const float* __restrict__ scale,
                    void* __restrict__ out,
                    int R, int K, int N, int ldx) {
  constexpr int WM = BM / 16;             // warps along M
  constexpr int WN = 4 / WM;              // warps along N
  constexpr int NT = BN / WN / 8;         // 8-column mma tiles per warp
  constexpr int LDW = BN + 8;             // smem row stride of the weight tile
  constexpr int XCH = BM * BK / 8 / NTHREADS;              // uint4 of x a thread loads
  constexpr int WROWS = BITS == 8 || NATIVE ? BK : BK / 2; // stored rows of a tile
  constexpr int WROWB = NATIVE ? BN / 2 : BN;              // stored bytes of a tile row
  constexpr int WCH = WROWS * WROWB / 16 / NTHREADS;       // uint4 of weights a thread loads
  constexpr int SCH = BK / QBLOCK * BN / 4;                // uint4 of int4 scales a tile has
  static_assert(WM * WN == 4 && NT >= 1, "warp layout");
  static_assert(XCH >= 1 && WCH >= 1 && SCH <= NTHREADS, "tile shape");
  static_assert(!NATIVE || BITS == 4, "the native layout is int4");

  __shared__ __align__(16) __nv_bfloat16 Xs[BM * LDX];
  __shared__ __align__(16) __nv_bfloat16 Ws[BK * LDW];
  __shared__ __align__(16) float Ss[BITS == 4 ? BK / QBLOCK * BN : 4];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;      // row within the 8-row group
  const int tig = lane & 3;     // column pair
  const int rb = (warp / WN) * 16;
  const int cb = (warp % WN) * (BN / WN);

  uint4 xr[XCH], wr[WCH], sr = make_uint4(0, 0, 0, 0);

  auto fetch = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < XCH; ++j) {
      const int i = tid + j * NTHREADS;
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int row = m0 + r;
      xr[j] = row < R
          ? *reinterpret_cast<const uint4*>(x + (size_t)row * ldx + k0 + c)
          : make_uint4(0, 0, 0, 0);
    }
    const int wrow0 = BITS == 8 || NATIVE ? k0 : k0 / 2;
    const int ldw = NATIVE ? N / 2 : N;                     // bytes of a stored row
#pragma unroll
    for (int j = 0; j < WCH; ++j) {
      const int i = tid + j * NTHREADS;
      const int r = i / (WROWB / 16), c = (i % (WROWB / 16)) * 16;
      wr[j] = *reinterpret_cast<const uint4*>(qw + (size_t)(wrow0 + r) * ldw
                                              + (NATIVE ? n0 / 2 : n0) + c);
    }
    if (BITS == 4 && tid < SCH) {
      const int r = tid / (BN / 4), c = (tid % (BN / 4)) * 4;
      sr = *reinterpret_cast<const uint4*>(scale + (size_t)(k0 / QBLOCK + r) * N + n0 + c);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  const int n_tiles = K / BK;
  fetch(0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // everyone is done reading the previous tile
#pragma unroll
    for (int j = 0; j < XCH; ++j) {
      const int i = tid + j * NTHREADS;
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(Xs + r * LDX + c) = xr[j];
    }
    if (BITS == 4) {
      if (tid < SCH) {
        const int r = tid / (BN / 4), c = (tid % (BN / 4)) * 4;
        *reinterpret_cast<uint4*>(Ss + r * BN + c) = sr;
      }
      __syncthreads();  // the scales are in place before the conversion
    }
#pragma unroll
    for (int j = 0; j < WCH; ++j) {
      const int i = tid + j * NTHREADS;
      const int r = i / (WROWB / 16), c = (i % (WROWB / 16)) * 16;
      if (NATIVE) {
        // 16 bytes of row r hold columns 2c .. 2c + 31: byte e is column
        // 2c + 2e (low nibble) and 2c + 2e + 1 (high); value = nibble *
        // scale[r / 32], rounded to bf16 once, as the Pallas kernel does.
        const float* srow = Ss + (r / QBLOCK) * BN + 2 * c;
        uint32_t packed[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int p = sbyte(word_of(wr[j], e / 4), e % 4);
          const int lo = static_cast<int>(static_cast<uint32_t>(p) << 28) >> 28;
          const int hi = p >> 4;
          packed[e] = pack_bf16((float)lo * srow[2 * e], (float)hi * srow[2 * e + 1]);
        }
        uint4* dst = reinterpret_cast<uint4*>(Ws + r * LDW + 2 * c);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dst[q] = make_uint4(packed[4 * q], packed[4 * q + 1], packed[4 * q + 2],
                              packed[4 * q + 3]);
      } else if (BITS == 8) {
        // 16 int8 of row r -> 16 bf16 (exact: |q| <= 127)
        uint32_t packed[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t w = word_of(wr[j], e / 2);
          const int s = (e % 2) * 2;
          packed[e] = pack_bf16((float)sbyte(w, s), (float)sbyte(w, s + 1));
        }
        uint4* dst = reinterpret_cast<uint4*>(Ws + r * LDW + c);
        dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
      } else {
        // packed row r of the tile: block kb = r / 16, rows klo = 32 kb + r % 16
        // (low nibbles) and klo + 16 (high nibbles); value = nibble * scale,
        // rounded to bf16 once, as the Pallas kernel does in f32.
        const int kb = r / (QBLOCK / 2);
        const int klo = kb * QBLOCK + r % (QBLOCK / 2);
        const float* srow = Ss + kb * BN + c;
        uint32_t plo[8], phi[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t w = word_of(wr[j], e / 2);
          const int s = (e % 2) * 2;
          const int p0 = sbyte(w, s), p1 = sbyte(w, s + 1);
          const int lo0 = static_cast<int>(static_cast<uint32_t>(p0) << 28) >> 28;
          const int lo1 = static_cast<int>(static_cast<uint32_t>(p1) << 28) >> 28;
          const int hi0 = p0 >> 4, hi1 = p1 >> 4;
          const float s0 = srow[2 * e], s1 = srow[2 * e + 1];
          plo[e] = pack_bf16((float)lo0 * s0, (float)lo1 * s1);
          phi[e] = pack_bf16((float)hi0 * s0, (float)hi1 * s1);
        }
        uint4* dlo = reinterpret_cast<uint4*>(Ws + klo * LDW + c);
        uint4* dhi = reinterpret_cast<uint4*>(Ws + (klo + QBLOCK / 2) * LDW + c);
        dlo[0] = make_uint4(plo[0], plo[1], plo[2], plo[3]);
        dlo[1] = make_uint4(plo[4], plo[5], plo[6], plo[7]);
        dhi[0] = make_uint4(phi[0], phi[1], phi[2], phi[3]);
        dhi[1] = make_uint4(phi[4], phi[5], phi[6], phi[7]);
      }
    }
    __syncthreads();
    if (kt + 1 < n_tiles) fetch(kt + 1);  // in flight during the products

#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4];
      const __nv_bfloat16* xa = Xs + (rb + g) * LDX + ks * 16 + tig * 2;
      a[0] = ld32(xa);
      a[1] = ld32(xa + 8 * LDX);
      a[2] = ld32(xa + 8);
      a[3] = ld32(xa + 8 * LDX + 8);
      const __nv_bfloat16* wb = Ws + (ks * 16 + tig * 2) * LDW + cb + g;
#pragma unroll
      for (int t = 0; t < NT; ++t)
        mma_16816(acc[t], a, ld_col2(wb + t * 8, LDW), ld_col2(wb + 8 * LDW + t * 8, LDW));
    }
  }

  // Epilogue: the per-channel scale (int8), then bf16 or f32 pairs.
  const int row0 = m0 + rb + g, row1 = row0 + 8;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = n0 + cb + t * 8 + tig * 2;
    float s0 = 1.f, s1 = 1.f;
    if (BITS == 8) {
      s0 = scale[col];
      s1 = scale[col + 1];
    }
    const float v[4] = {acc[t][0] * s0, acc[t][1] * s1, acc[t][2] * s0, acc[t][3] * s1};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h == 0 ? row0 : row1;
      if (row >= R) continue;
      if (OUT_F32) {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + (size_t)row * N + col) =
            make_float2(v[2 * h], v[2 * h + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + (size_t)row * N + col) =
            pack_bf16(v[2 * h], v[2 * h + 1]);
      }
    }
  }
}

template <int BITS, bool OUT_F32, bool NATIVE = false>
int launch(const void* x, const void* qw, const void* scale, void* out,
           int R, int K, int N, int ldx, cudaStream_t stream) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const int8_t*>(qw);
  const auto* sp = static_cast<const float*>(scale);
  if (R <= 16) {
    constexpr int BM = 16, BN = 32;
    quant_matmul_kernel<BITS, BM, BN, OUT_F32, NATIVE>
        <<<dim3(N / BN, 1), NTHREADS, 0, stream>>>(xp, qp, sp, out, R, K, N, ldx);
  } else {
    constexpr int BM = 64, BN = 64;
    quant_matmul_kernel<BITS, BM, BN, OUT_F32, NATIVE>
        <<<dim3(N / BN, (R + BM - 1) / BM), NTHREADS, 0, stream>>>(xp, qp, sp, out, R, K, N, ldx);
  }
  return (int)cudaGetLastError();
}

template <int BITS>
int dispatch(const void* x, const void* qw, const void* scale, void* out,
             int R, int K, int N, int ldx, int out_f32, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch<BITS, true>(x, qw, scale, out, R, K, N, ldx, s)
                 : launch<BITS, false>(x, qw, scale, out, R, K, N, ldx, s);
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 = launched).
extern "C" int quant_matmul_int8(const void* x, const void* qw, const void* scale,
                                 void* out, int R, int K, int N, int ldx,
                                 int out_f32, void* stream) {
  return dispatch<8>(x, qw, scale, out, R, K, N, ldx, out_f32, stream);
}

extern "C" int quant_matmul_int4(const void* x, const void* qw, const void* scale,
                                 void* out, int R, int K, int N, int ldx,
                                 int out_f32, void* stream) {
  return dispatch<4>(x, qw, scale, out, R, K, N, ldx, out_f32, stream);
}

// qw: the native [K, N/2] layout; out is always f32, as the Pallas variant's.
extern "C" int quant_matmul_int4_native(const void* x, const void* qw, const void* scale,
                                        void* out, int R, int K, int N, int ldx,
                                        void* stream) {
  return launch<4, true, true>(x, qw, scale, out, R, K, N, ldx,
                               static_cast<cudaStream_t>(stream));
}
