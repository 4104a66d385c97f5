// Hopper building blocks shared by the flash kernels and the quantized matmuls (sm_90a): mbarriers,
// TMA tile loads and bulk copies, wgmma shared-memory descriptors and the
// wgmma instructions the kernels issue, and the host side of a TMA tensor
// map.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle: a tile
// of R rows x 64 bf16 (128 bytes a row) is R * 128 contiguous bytes, 8-row
// groups of 1024 bytes, the 16-byte chunks of row r XOR-ed with r % 8. Every
// tile starts on a 1024-byte boundary. A head dim of 128 is two such tiles
// ("boxes"): columns 0-63, then 64-127. The wgmma descriptors below describe
// exactly that layout:
//   K-major (the reduction runs along the 128-byte rows): SBO = 1024 bytes
//     between 8-row groups, LBO unused; a 16-wide k-step inside a box moves
//     the start address by 32 bytes;
//   MN-major (rows run along the reduction, e.g. V in O += P V): SBO = 1024
//     bytes between 8-row groups of the reduction, LBO = the box's size
//     between the two 64-column halves of the 128 output columns; a 16-row
//     k-step moves the start by 16 * 128 bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of parity `parity` has completed. A fresh barrier
// counts the phase before it (parity 1) as complete. A wait that outlasts
// ~2^34 cycles (seconds) traps: a lost arrival or a short TMA transfer then
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  for (uint32_t n = 1; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && (n & 1023) == 0 && clock64() - t0 > (1ll << 34)) __trap();
  }
}

// ---- TMA and bulk copies -----------------------------------------------------

// A tile of `rows` rows x 128 columns of one (batch, head) from a tensor
// map made by make_map, into shared memory as its two 64-column boxes (see
// the top of this file); completion (the full tile's bytes, rows past T
// zero-filled) is reported to `bar`.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(0),
      "r"(head), "r"(batch)
      : "memory");
}

// A box of a 2-d tensor map (make_map_2d) at element coordinates (inner,
// outer) into shared memory; completion is reported to `bar` (the whole
// box's bytes, elements past the tensor's edges zero-filled).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

// Bring a tensor map (a kernel parameter) into the TMA unit's cache ahead
// of its first load.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, reported to `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across a
// fence, commit or wait: they change under it asynchronously.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor with the 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// The f32 accumulator of a wgmma (64 x N, this thread's 4 values per 8
// columns) as the bf16 register A operand of k-step `ks` (columns 16 ks ..
// 16 ks + 15): the two layouts line up pair for pair.
template <int NACC>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[NACC], int ks) {
  a[0] = pack_bf16(d[8 * ks + 0], d[8 * ks + 1]);
  a[1] = pack_bf16(d[8 * ks + 2], d[8 * ks + 3]);
  a[2] = pack_bf16(d[8 * ks + 4], d[8 * ks + 5]);
  a[3] = pack_bf16(d[8 * ks + 6], d[8 * ks + 7]);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: both operands in shared memory
// (descriptors), K-major; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t desc_a,
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: both operands in shared memory
// (descriptors), K-major; `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a,
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (the bf16 pairs of
// an accumulator's layout), B in shared memory MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n128_mn(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers, B in shared
// memory K-major (its 128 rows of 16 k each, as in gemm_k128).
__device__ __forceinline__ void wgmma_rs_m64n128_k(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---- k-loops of wgmma ------------------------------------------------------

// desc + bytes as an ordered instruction: each descriptor of a k-loop is
// then made right before the wgmma that reads it, from the one before,
// instead of all of them up front in registers of their own.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  uint64_t out;
  asm volatile("add.s64 %0, %1, %2;\n" : "=l"(out) : "l"(desc), "l"((uint64_t)(bytes >> 4)));
  return out;
}

// D[64 x 128] (+)= A B^T over a head dim of 128 (eight k-steps): A (64
// rows) and B (128 rows) K-major, each in two boxes (columns 0-63, 64-127)
// `a_box` / `b_box` bytes apart.
__device__ __forceinline__ void gemm_k128(float (&d)[64], uint32_t a, uint32_t a_box, uint32_t b,
                                          uint32_t b_box, bool accumulate) {
  uint64_t da = desc_sw128(a, 16, 1024), db = desc_sw128(b, 16, 1024);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    wgmma_ss_m64n128(d, da, db, accumulate || ks > 0);
    da = desc_add(da, ks == 3 ? a_box - 96 : 32);
    db = desc_add(db, ks == 3 ? b_box - 96 : 32);
  }
}

// The same with B of 64 rows: D[64 x 64].
__device__ __forceinline__ void gemm_k128(float (&d)[32], uint32_t a, uint32_t a_box, uint32_t b,
                                          uint32_t b_box, bool accumulate) {
  uint64_t da = desc_sw128(a, 16, 1024), db = desc_sw128(b, 16, 1024);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    wgmma_ss_m64n64(d, da, db, accumulate || ks > 0);
    da = desc_add(da, ks == 3 ? a_box - 96 : 32);
    db = desc_add(db, ks == 3 ? b_box - 96 : 32);
  }
}

// D[64 x 128] += A B over KS k-steps of 16: A from registers (bf16 pairs in
// the accumulator layout), B MN-major: 16 KS rows of 128 columns in two
// boxes (columns 0-63, 64-127) `b_box` bytes apart.
template <int KS>
__device__ __forceinline__ void gemm_rs(float (&d)[64], const uint32_t (&a)[KS][4], uint32_t b,
                                        uint32_t b_box) {
  uint64_t db = desc_sw128(b, b_box, 1024);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    wgmma_rs_m64n128_mn(d, a[ks], db);
    db = desc_add(db, 16 * 128);
  }
}

// ---- host: TMA tensor maps ---------------------------------------------------

// cuTensorMapEncodeTiled is a CUDA driver function; it is taken through the
// runtime's entry-point query, so the library needs no link against libcuda.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error code an entry point returns when a tensor map cannot be made (no
// CUDA driver entry point, or the CUDA driver refuses the map): past every
// cudaError_t value.
constexpr int TENSOR_MAP_ERROR = 10000;

// A bf16 [B, T, heads, 128] tensor with element strides (sb, st, sh) and a
// contiguous last dim, as a 5-d map (dims inner to outer: 64 columns, T,
// the two column halves, heads, B) whose box is 64 columns x `rows` rows x
// both halves of one (batch, head), 128-byte swizzled: one TMA instruction
// brings a 128-column tile as its two 64-column boxes. Rows past T read as
// zeros. Returns 0 or TENSOR_MAP_ERROR (+ the CUDA driver's code).
inline int make_map(CUtensorMap* map, const void* base, int B, int T, int heads, int sb, int st,
                    int sh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return TENSOR_MAP_ERROR;
  const cuuint64_t dims[5] = {64, (cuuint64_t)T, 2, (cuuint64_t)heads, (cuuint64_t)B};
  // a dim of extent 1 is never stepped: its stride (which PyTorch may give
  // as anything) is replaced by one the CUDA driver takes
  auto stride = [](int extent, int s) { return (cuuint64_t)(extent == 1 ? 128 : s) * 2; };
  const cuuint64_t strides[4] = {stride(T, st), 128, stride(heads, sh), stride(B, sb)};
  const cuuint32_t box[5] = {64, (cuuint32_t)rows, 2, 1, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

// A 2-d tensor (`inner` contiguous elements a row, `outer` rows of
// `row_bytes`) as a map whose box is `box_inner` x `box_outer` elements,
// 128-byte swizzled (box_inner elements must span 128 bytes), or laid out
// row after row with SWIZZLE_NONE (box_inner elements a multiple of 16
// bytes). Elements past the edges read as zeros. Returns 0 or
// TENSOR_MAP_ERROR (+ the CUDA driver's code).
inline int make_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                       int inner, int outer, long long row_bytes, int box_inner,
                       int box_outer, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return TENSOR_MAP_ERROR;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  // a single row is never stepped: give the stride the CUDA driver takes
  const cuuint64_t strides[1] = {(cuuint64_t)(outer == 1 ? 128 : row_bytes)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

}  // namespace hopper
