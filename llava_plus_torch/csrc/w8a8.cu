// W8A8 for Hopper (sm_90a): the per-row int8 quantization of a prefill's
// activations and the epilogue that turns the int8 x int8 product back into
// the activation dtype.
//
// Replaces no Pallas kernel: the JAX package computes W8A8 in XLA
// (llava_plus_tpu/ops/quant.py:146 _w8a8_matmul), which fuses the row
// reduction and the quantize into one pass over x and the two scale
// multiplies into the int32 product's epilogue. These two kernels are those
// fusions; the int8 product between them is torch._int_mm (cuBLASLt IMMA),
// as the JAX package leaves it to XLA's dot_general.
//
// The arithmetic is the JAX function's, bit for bit (ops/w8a8.py has the
// plain versions):
//   amax  = max(|x|) over the row (or the amax given for it), floored at 1e-6
//           rounded to x's dtype
//   inv   = 127 / f32(amax)                              (an f32 division)
//   xq    = int8(clip(round_half_even(f32(x) * inv), -127, 127))
//   scale = f32(amax / 127 in x's dtype): a bf16 row rounds the quotient to
//           bf16 (f32 has more than 2 * 8 + 2 mantissa bits, so rounding
//           the f32 quotient to bf16 is the correctly rounded bf16 one)
//   out   = dtype((f32(acc) * scale) * col_scale)
// Every product and quotient is written with the _rn intrinsics, so that
// no fused multiply-add or approximate division changes a bit.
//
// What bounds them on the card: both are elementwise passes far below the
// H100's ridge, so HBM bytes: the quantize reads x once (2 or 4 bytes an
// element) and writes one byte an element and 4 a row; the epilogue reads
// the 4-byte int32 sums and writes 2 (bf16) or 4 (f32) bytes an element.
// Design: the quantize takes one 256-thread block a row, loads the row in
// 16-byte vectors into shared memory while it reduces the row's absmax
// (warp shuffles, then one word a warp), and quantizes from shared memory,
// so x is read from HBM once. The epilogue gives each thread 8 consecutive
// elements of one row (N % 8 == 0): two 16-byte loads of sums, two of
// column scales, one 16- or 32-byte store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QTHREADS = 256;
constexpr int ETHREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float floor_in_dtype();
template <>
__device__ __forceinline__ float floor_in_dtype<float>() { return 1e-6f; }
template <>
__device__ __forceinline__ float floor_in_dtype<__nv_bfloat16>() {
  return __bfloat162float(__float2bfloat16_rn(1e-6f));
}

template <typename T>
__device__ __forceinline__ float row_scale(float amax);
template <>
__device__ __forceinline__ float row_scale<float>(float amax) { return __fdiv_rn(amax, 127.0f); }
template <>
__device__ __forceinline__ float row_scale<__nv_bfloat16>(float amax) {
  return __bfloat162float(__float2bfloat16_rn(__fdiv_rn(amax, 127.0f)));
}

__device__ __forceinline__ int8_t quantize_one(float v, float inv) {
  int q = __float2int_rn(__fmul_rn(v, inv));   // round half to even
  return static_cast<int8_t>(max(-127, min(127, q)));
}

// One block a row. x rows are `stride` elements apart and 16-byte aligned;
// K * sizeof(T) % 16 == 0; the row sits in dynamic shared memory. With
// `given` (one value a row, in x's dtype) the row's absmax is given and the
// block skips its reduction: a row-parallel product's rows hold a slice of
// K, and their absmax is the maximum over every rank's slice.
template <typename T>
__global__ void __launch_bounds__(QTHREADS)
w8a8_quantize_rows_kernel(const T* __restrict__ x, long long stride, int K,
                          int8_t* __restrict__ xq, float* __restrict__ scales,
                          const T* __restrict__ given) {
  extern __shared__ uint4 row[];
  constexpr int PER = 16 / sizeof(T);   // elements a vector
  __shared__ float warp_max[QTHREADS / 32];
  const int r = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x + r * stride);
  const int nvec = K / PER;

  float m = 0.0f;
  for (int i = threadIdx.x; i < nvec; i += QTHREADS) {
    uint4 v = src[i];
    row[i] = v;   // read back by this same thread below
    if (given == nullptr) {
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < PER; ++j) m = fmaxf(m, fabsf(to_f32(e[j])));
    }
  }
  float amax;
  if (given != nullptr) {
    amax = to_f32(given[r]);
  } else {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    amax = warp_max[0];
#pragma unroll
    for (int w = 1; w < QTHREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  }
  amax = fmaxf(amax, floor_in_dtype<T>());
  const float inv = __fdiv_rn(127.0f, amax);
  if (threadIdx.x == 0) scales[r] = row_scale<T>(amax);

  int8_t* dst = xq + static_cast<long long>(r) * K;
  for (int i = threadIdx.x; i < nvec; i += QTHREADS) {
    uint4 v = row[i];
    const T* e = reinterpret_cast<const T*>(&v);
    if constexpr (PER == 8) {
      uint2 out;
      int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = quantize_one(to_f32(e[j]), inv);
      reinterpret_cast<uint2*>(dst)[i] = out;
    } else {
      uint32_t out;
      int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = quantize_one(to_f32(e[j]), inv);
      reinterpret_cast<uint32_t*>(dst)[i] = out;
    }
  }
}

__device__ __forceinline__ void store8(float* out, const float* v) {
  reinterpret_cast<float4*>(out)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(out)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* out, const float* v) {
  uint4 packed;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int j = 0; j < 4; ++j) p[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(out) = packed;
}

// out[r, n] = (f32(acc[r, n]) * row_scale[r]) * col_scale[n], 8 elements a
// thread; acc and out are contiguous [R, N], N % 8 == 0.
template <typename O>
__global__ void __launch_bounds__(ETHREADS)
w8a8_epilogue_kernel(const int* __restrict__ acc, const float* __restrict__ rs,
                     const float* __restrict__ cs, O* __restrict__ out, int N,
                     long long groups) {
  const int gpr = N / 8;   // groups of 8 a row
  for (long long g = blockIdx.x * static_cast<long long>(ETHREADS) + threadIdx.x; g < groups;
       g += static_cast<long long>(gridDim.x) * ETHREADS) {
    const long long r = g / gpr;
    const int n = static_cast<int>(g - r * gpr) * 8;
    const int4* a = reinterpret_cast<const int4*>(acc + r * N + n);
    const float4* c = reinterpret_cast<const float4*>(cs + n);
    int4 a0 = a[0], a1 = a[1];
    float4 c0 = c[0], c1 = c[1];
    const int ai[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float ci[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float s = rs[r];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(__fmul_rn(__int2float_rn(ai[j]), s), ci[j]);
    store8(out + r * N + n, v);
  }
}

}  // namespace

// x: bf16 (x_bf16 = 1) or f32 [R, K], rows `stride` elements apart; xq int8
// [R, K] contiguous; scales f32 [R]; amax null, or each row's absmax [R] in
// x's dtype (the reduction is then skipped).
extern "C" int w8a8_quantize_rows(const void* x, int x_bf16, int R, int K, int stride,
                                  void* xq, void* scales, const void* amax, void* stream) {
  const int elem = x_bf16 ? 2 : 4;
  const size_t smem = static_cast<size_t>(K) * elem;
  if (R < 1 || K < 1 || smem % 16 || (static_cast<size_t>(stride) * elem) % 16 ||
      smem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16) {
    err = cudaFuncSetAttribute(w8a8_quantize_rows_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    w8a8_quantize_rows_kernel<__nv_bfloat16><<<R, QTHREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), stride, K, static_cast<int8_t*>(xq),
        static_cast<float*>(scales), static_cast<const __nv_bfloat16*>(amax));
  } else {
    err = cudaFuncSetAttribute(w8a8_quantize_rows_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    w8a8_quantize_rows_kernel<float><<<R, QTHREADS, smem, st>>>(
        static_cast<const float*>(x), stride, K, static_cast<int8_t*>(xq),
        static_cast<float*>(scales), static_cast<const float*>(amax));
  }
  return static_cast<int>(cudaGetLastError());
}

// acc int32 [R, N] and out [R, N] contiguous (out f32 when out_f32, else
// bf16); row_scale f32 [R], col_scale f32 [N]; N % 8 == 0.
extern "C" int w8a8_epilogue(const void* acc, const void* row_scale, const void* col_scale,
                             void* out, int out_f32, int R, int N, int sms, void* stream) {
  if (R < 1 || N < 8 || N % 8 || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = static_cast<long long>(R) * (N / 8);
  const long long want = (groups + ETHREADS - 1) / ETHREADS;
  const int grid = static_cast<int>(want < 16LL * sms ? want : 16LL * sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    w8a8_epilogue_kernel<float><<<grid, ETHREADS, 0, st>>>(
        static_cast<const int*>(acc), static_cast<const float*>(row_scale),
        static_cast<const float*>(col_scale), static_cast<float*>(out), N, groups);
  else
    w8a8_epilogue_kernel<__nv_bfloat16><<<grid, ETHREADS, 0, st>>>(
        static_cast<const int*>(acc), static_cast<const float*>(row_scale),
        static_cast<const float*>(col_scale), static_cast<__nv_bfloat16*>(out), N, groups);
  return static_cast<int>(cudaGetLastError());
}
