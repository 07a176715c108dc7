// Helpers shared by the FlashAttention-2 kernels (flash_fwd.cu,
// flash_bwd.cu): fp32 widening and rounding of the input type, and the
// staging of a tile of rows of one head into shared memory.
//
// Tensors are in the port's public layout [B, S, heads, D], contiguous;
// lse and delta are float32 [B * H, S].

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kThreads = 128;
// The finite "minus infinity" of the TPU kernels: a masked score is
// -1e30, so exp(score - m) is exactly 0 against any real m and no NaN
// arises from a row whose keys are all masked.
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back: the TPU kernels' `.astype(dtype)`
// before a matrix product (round to nearest even, as XLA's convert).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Rows [row0, row0 + R) of head h of src [B, S, nh, D] into dst[R][ld]
// as fp32; rows at or past S are zeros. Consecutive threads read
// consecutive elements of a row.
template <typename T, int R, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int b, int h, int nh, int S,
                                          int row0) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = row0 + r;
    float x = 0.f;
    if (s < S) x = to_f<T>(src[((int64_t(b) * S + s) * nh + h) * D + d]);
    dst[r * ld + d] = x;
  }
}

// Row r of the [B, S, nh, D] tensor at head h: the offset of element 0.
__device__ __forceinline__ int64_t row_offset(int b, int s, int h, int nh,
                                              int S, int D) {
  return ((int64_t(b) * S + s) * nh + h) * D;
}

// return FN<T, D>(args...) for a run-time head dim D; -1 for one not
// taken.
#define FLASH_DISPATCH_D(D, FN, T, ...)              \
  switch (D) {                                       \
    case 16: return FN<T, 16>(__VA_ARGS__);          \
    case 32: return FN<T, 32>(__VA_ARGS__);          \
    case 64: return FN<T, 64>(__VA_ARGS__);          \
    case 128: return FN<T, 128>(__VA_ARGS__);        \
    default: return -1;                              \
  }

// return FN<T>(args...) for a run-time type code (0 fp32, 1 fp16,
// 2 bf16, the codes of the Python wrappers); -1 for another.
#define FLASH_DISPATCH_T(CODE, FN, ...)                        \
  switch (CODE) {                                              \
    case 0: return FN<float>(__VA_ARGS__);                     \
    case 1: return FN<__half>(__VA_ARGS__);                    \
    case 2: return FN<__nv_bfloat16>(__VA_ARGS__);             \
    default: return -1;                                        \
  }

}  // namespace flash
