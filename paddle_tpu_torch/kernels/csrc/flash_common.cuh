// Helpers shared by the FlashAttention-2 kernels (flash_fwd.cu,
// flash_bwd.cu): fp32 widening and rounding of the input type, the
// staging of a tile of rows of one head into shared memory, and the
// inline PTX of the tensor-core kernels (cp.async, ldmatrix, mma.sync).
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

// ---------------------------------------------------- tensor cores ---
//
// The bf16/fp16 kernels keep tiles in their input type in shared
// memory, rows of D + 8 elements: the 16-byte pad shifts each row by
// four banks, so the eight row addresses of an ldmatrix phase fall in
// eight distinct bank quads for every D in {16, 32, 64, 128}.

template <int D>
__host__ __device__ constexpr int tc_ld() { return D + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, asynchronously; the bytes past
// src_bytes (0 or 16) are zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes from global to shared (one float of lse or delta), zeros when
// src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until every committed group of this thread has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [row0, row0 + R) of head h of src [B, S, nh, D] into dst[R][D + 8]
// in T, by 16-byte cp.async copies; rows at or past S are zeros. The
// caller commits the group.
template <typename T, int R, int D>
__device__ __forceinline__ void cp_tile(T* dst, const T* src, int b, int h,
                                        int nh, int S, int row0) {
  constexpr int CH = D * int(sizeof(T)) / 16;   // chunks per row
  constexpr int EPC = 16 / int(sizeof(T));      // elements per chunk
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const int s = row0 + r;
    const T* g = s < S ? src + row_offset(b, s, h, nh, S, D) + c * EPC : src;
    cp_async16(dst + r * tc_ld<D>() + c * EPC, g, s < S ? 16 : 0);
  }
}

// Four 8 x 8 matrices of 16-bit elements; lane l gives the address of
// row l % 8 of matrix l / 8 and receives in r[i] the elements (l / 4,
// 2 (l % 4) + {0, 1}) of matrix i (of its transpose with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Lane l's address for the A fragment of the 16 x 16 block at (row0,
// col0) of a row-major tile: matrices (rows 0-7, cols 0-7), (8-15, 0-7),
// (0-7, 8-15), (8-15, 8-15) are a0..a3 of mma.m16n8k16.
template <int LD, typename T>
__device__ __forceinline__ const T* frag_a(const T* tile, int row0,
                                           int col0, int lane) {
  return tile + (row0 + (lane & 15)) * LD + col0 + (lane >> 4) * 8;
}

// Lane l's address for the B fragments of two n-tiles when B = X^T and
// X is a row-major tile whose rows are B's columns (K in Q.K^T): rows
// n0..n0+15 of X, cols k0..k0+15. r[0], r[1] are b0, b1 of the n-tile
// of rows n0..n0+7; r[2], r[3] those of rows n0+8..n0+15.
template <int LD, typename T>
__device__ __forceinline__ const T* frag_bt(const T* tile, int n0, int k0,
                                            int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 +
         ((lane >> 3) & 1) * 8;
}

// Lane l's address, for ldsm_x4_t, of the B fragments of two n-tiles
// when B = X itself (V in P.V): rows k0..k0+15 of X, cols n0..n0+15.
// r[0], r[1] are b0, b1 of cols n0..n0+7; r[2], r[3] of n0+8..n0+15.
template <int LD, typename T>
__device__ __forceinline__ const T* frag_b(const T* tile, int k0, int n0,
                                           int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
         (lane >> 4) * 8;
}

// Two floats rounded to T (nearest even) in one 32-bit register, the
// first in the low half: the element order of an mma fragment.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 x = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// c += a . b on the tensor cores: a 16 x 16 (row), b 16 x 8 (col) in T,
// c 16 x 8 in fp32. Lane l (g = l / 4, t = l % 4) holds c[0], c[1] at
// (g, 2t + {0, 1}) and c[2], c[3] at (g + 8, 2t + {0, 1}).
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16 x 16 block of P (or dS) from the fp32
// accumulators of the two n-tiles that hold its columns 0-7 and 8-15:
// FA2's reuse of a product's output as the next product's input, with
// the rounding to T that the TPU kernels' `.astype` makes.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack2<T>(lo[0], lo[1]);
  a[1] = pack2<T>(lo[2], lo[3]);
  a[2] = pack2<T>(hi[0], hi[1]);
  a[3] = pack2<T>(hi[2], hi[3]);
}

// 2^x by the SFU's ex2 (one instruction; results below 2^-126 flush to
// 0). The tensor-core kernels take exp(a - b) as 2^(a log2 e - b log2 e)
// with the scale D^-1/2 folded into one FFMA: a few ulps from expf.
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Sum (or max) over the four lanes of a quad, which hold one row of an
// mma accumulator.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
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

// The same for a template of D alone (the fp32 kernels).
#define FLASH_DISPATCH_DIM(D, FN, ...)               \
  switch (D) {                                       \
    case 16: return FN<16>(__VA_ARGS__);             \
    case 32: return FN<32>(__VA_ARGS__);             \
    case 64: return FN<64>(__VA_ARGS__);             \
    case 128: return FN<128>(__VA_ARGS__);           \
    default: return -1;                              \
  }

// Whether a grid of gx x gy blocks is within the card's limits
// (gx < 2^31, gy < 2^16); a launch beyond them returns -1.
inline bool grid_fits(int64_t gx, int64_t gy) {
  return gx <= 0x7fffffff && gy <= 65535;
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

// The same for the 16-bit codes alone (1 fp16, 2 bf16): the
// tensor-core kernels.
#define FLASH_DISPATCH_T16(CODE, FN, ...)                      \
  switch (CODE) {                                              \
    case 1: return FN<__half>(__VA_ARGS__);                    \
    case 2: return FN<__nv_bfloat16>(__VA_ARGS__);             \
    default: return -1;                                        \
  }

}  // namespace flash
