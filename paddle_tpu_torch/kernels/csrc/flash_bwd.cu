// FlashAttention-2 backward for Hopper (sm_90a): two kernels, dQ and
// dK/dV, as on the TPU.
//
// Replaces the TPU backward kernels of paddle_tpu/kernels/flash_attention.py,
// launched by `_flash_bwd_impl`:
//   flash_dq_kernel  <- `_dq_kernel`, `_dq_kernel_grouped`,
//                       `_dq_kernel_stream`, `_dq_kernel_stream_grouped`
//   flash_dkv_kernel <- `_dkv_kernel`, `_dkv_kernel_grouped`,
//                       `_dkv_kernel_stream`, `_dkv_kernel_stream_grouped`
// (each family is one function in four TPU memory layouts).
//
//   q, dout [B, S, H, D]    bf16 | fp16 | fp32
//   k, v    [B, S, Hkv, D]  same type; G = H / Hkv
//   lse     [B * H, S]      fp32, from the forward
//   delta   [B * H, S]      fp32, rowsum(dout * out) - g_lse (the wrapper
//                           computes it with torch ops, as XLA did)
//   dq      [B, S, H, D]    q's type
//   dk, dv  [B, S, Hkv, D]  k's and v's type, summed over the G query
//                           heads of each kv head in fp32
//
// The arithmetic is the TPU kernels': the scores are recomputed in fp32
// times D^-1/2 with masked keys at the finite -1e30, P = exp(s - lse),
// dP = dout . v^T, and
//   dQ:    dS = P (dP - delta) rounded to k's type;  dq = D^-1/2 dS . k
//   dK/dV: P rounded to dout's type;  dv = P^T . dout;
//          dS = P (dP - delta) rounded to q's type;  dk = D^-1/2 dS^T . q
// with every sum in fp32.
//
// What bounds them: operations (6 and 8 S^2 D flops per (b, h), half
// with the causal mask, on O(S D) elements moved).
//
// What the design does about it: tiles staged once in shared memory and
// reused from there, register tiles of fp32 FMAs on the CUDA cores (no
// tensor cores yet; wgmma and TMA are later work), strides of D + 1 and
// 32 + 1 floats against bank conflicts, and no tile past the causal
// diagonal. Neither kernel uses atomics: each output element is summed
// by one thread in a fixed order, so the gradients are the same from run
// to run.
//
// dQ: grid (ceil(S / 64), B * H), 128 threads. A block holds a 64-row
// tile of q and dout with their lse and delta, and walks the 32-key
// tiles of the kv head h / G. Thread t owns rows ty + 16 i (ty = t / 8,
// i < 4), keys tx + 8 j (tx = t % 8, j < 4) of the score tile and
// columns tx + 8 j (j < D / 8) of dq.
//
// dK/dV: grid (ceil(S / 32), B * Hkv), 128 threads. A block holds a
// 32-key tile of k and v and walks, for each of the G query heads of its
// kv head, the 32-row tiles of q and dout that can see those keys; dk
// and dv stay in fp32 registers across the whole walk. Thread t owns
// rows ty + 16 i (i < 2), keys tx + 8 j (j < 4) of the score tile, and
// keys ty + 16 i (i < 2), columns tx + 8 j (j < D / 8) of dk and dv.
//
// Rows and keys past a ragged S are zero-filled and masked, so any
// S >= 1 is taken.

#include "flash_common.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------- dQ ----

constexpr int kDqBQ = 64;
constexpr int kDqBK = 32;

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kDqBQ * (D + 1) + 2 * kDqBK * (D + 1) +
                          kDqBQ * (kDqBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int Hkv, int causal, float scale) {
  constexpr int LDD = D + 1;
  constexpr int LDS = kDqBK + 1;
  constexpr int RI = 4;
  constexpr int CJ = 4;
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kDqBQ][LDD]
  float* dOs = Qs + kDqBQ * LDD;     // [kDqBQ][LDD]
  float* Ks = dOs + kDqBQ * LDD;     // [kDqBK][LDD]
  float* Vs = Ks + kDqBK * LDD;      // [kDqBK][LDD]
  float* dSs = Vs + kDqBK * LDD;     // [kDqBQ][LDS]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kDqBQ;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;

  load_tile<T, kDqBQ, D>(Qs, LDD, q, b, h, H, S, q0);
  load_tile<T, kDqBQ, D>(dOs, LDD, dout, b, h, H, S, q0);
  float lse_r[RI], del_r[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    lse_r[i] = qi < S ? lse[int64_t(bh) * S + qi] : 0.f;
    del_r[i] = qi < S ? delta[int64_t(bh) * S + qi] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (S + kDqBK - 1) / kDqBK;
  if (causal) n_kt = min(n_kt, (q0 + kDqBQ - 1) / kDqBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kDqBK;
    __syncthreads();  // the last tile's dS.K is done with Ks and dSs
    load_tile<T, kDqBK, D>(Ks, LDD, k, b, hk, Hkv, S, k0);
    load_tile<T, kDqBK, D>(Vs, LDD, v, b, hk, Hkv, S, k0);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], ov[RI], kv[CJ], vv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LDD + d];
        ov[i] = dOs[(ty + 16 * i) * LDD + d];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        kv[j] = Ks[(tx + 8 * j) * LDD + d];
        vv[j] = Vs[(tx + 8 * j) * LDD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kj = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (kj >= S || qi >= S || (causal && kj > qi)) x = kNegInf;
        const float p = expf(x - lse_r[i]);
        dSs[r * LDS + tx + 8 * j] = round_to<T>(p * (dp[i][j] - del_r[i]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kDqBK; ++c) {
      float sv[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) sv[i] = dSs[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[c * LDD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    T* o = dq + row_offset(b, qi, h, H, S, D);
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 8 * j] = from_f<T>(scale * acc[i][j]);
  }
}

// -------------------------------------------------------------- dK/dV ---

constexpr int kKvBQ = 32;
constexpr int kKvBK = 32;

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * kKvBK * (D + 1) + 2 * kKvBQ * (D + 1) +
                          2 * kKvBQ * (kKvBK + 1) + 2 * kKvBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int Hkv, int causal,
                     float scale) {
  constexpr int LDD = D + 1;
  constexpr int LDS = kKvBK + 1;
  constexpr int RI = 2;        // score tile: query rows per thread
  constexpr int CJ = 4;        // score tile: keys per thread
  constexpr int KI = 2;        // dk/dv tile: keys per thread
  constexpr int DJ = D / 8;    // dk/dv tile: columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                  // [kKvBK][LDD]
  float* Vs = Ks + kKvBK * LDD;      // [kKvBK][LDD]
  float* Qs = Vs + kKvBK * LDD;      // [kKvBQ][LDD]
  float* dOs = Qs + kKvBQ * LDD;     // [kKvBQ][LDD]
  float* Ps = dOs + kKvBQ * LDD;     // [kKvBQ][LDS]
  float* dSs = Ps + kKvBQ * LDS;     // [kKvBQ][LDS]
  float* lse_s = dSs + kKvBQ * LDS;  // [kKvBQ]
  float* del_s = lse_s + kKvBQ;      // [kKvBQ]

  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.x * kKvBK;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;

  load_tile<T, kKvBK, D>(Ks, LDD, k, b, hk, Hkv, S, k0);
  load_tile<T, kKvBK, D>(Vs, LDD, v, b, hk, Hkv, S, k0);
  float dk_acc[KI][DJ], dv_acc[KI][DJ];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_qt = (S + kKvBQ - 1) / kKvBQ;
  const int qt0 = causal ? k0 / kKvBQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const int64_t row0 = (int64_t(b) * H + h) * S;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kKvBQ;
      __syncthreads();  // the last tile's products are done with smem
      load_tile<T, kKvBQ, D>(Qs, LDD, q, b, h, H, S, q0);
      load_tile<T, kKvBQ, D>(dOs, LDD, dout, b, h, H, S, q0);
      if (threadIdx.x < kKvBQ) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < S ? lse[row0 + qi] : 0.f;
        del_s[threadIdx.x] = qi < S ? delta[row0 + qi] : 0.f;
      }
      __syncthreads();

      float s[RI][CJ], dp[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[RI], ov[RI], kv[CJ], vv[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          qv[i] = Qs[(ty + 16 * i) * LDD + d];
          ov[i] = dOs[(ty + 16 * i) * LDD + d];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          kv[j] = Ks[(tx + 8 * j) * LDD + d];
          vv[j] = Vs[(tx + 8 * j) * LDD + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
        const int qi = q0 + r;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = tx + 8 * j;
          const int kj = k0 + c;
          float x = s[i][j] * scale;
          if (kj >= S || qi >= S || (causal && kj > qi)) x = kNegInf;
          const float p = round_to<T>(expf(x - lse_s[r]));
          Ps[r * LDS + c] = p;
          dSs[r * LDS + c] = round_to<T>(p * (dp[i][j] - del_s[r]));
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int r = 0; r < kKvBQ; ++r) {
        float pv[KI], sv[KI], ov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          pv[i] = Ps[r * LDS + ty + 16 * i];
          sv[i] = dSs[r * LDS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          ov[j] = dOs[r * LDD + tx + 8 * j];
          qv[j] = Qs[r * LDD + tx + 8 * j];
        }
#pragma unroll
        for (int i = 0; i < KI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= S) continue;
    const int64_t off = row_offset(b, kj, hk, Hkv, S, D);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 8 * j] = from_f<T>(scale * dk_acc[i][j]);
      dv[off + tx + 8 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// ------------------------------------------------------------ launch ---

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int S,
              int H, int Hkv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((S + kDqBQ - 1) / kDqBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, Hkv, causal, scale);
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int B, int S, int H, int Hkv, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((S + kKvBK - 1) / kKvBK, B * Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hkv, causal, scale);
  return int(cudaGetLastError());
}

template <typename T>
int dq_typed(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, int B, int S,
             int H, int Hkv, int D, int causal, float scale,
             cudaStream_t stream) {
  FLASH_DISPATCH_D(D, launch_dq, T, q, k, v, dout, lse, delta, dq, B, S, H,
                   Hkv, causal, scale, stream)
}

template <typename T>
int dkv_typed(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dk, void* dv,
              int B, int S, int H, int Hkv, int D, int causal, float scale,
              cudaStream_t stream) {
  FLASH_DISPATCH_D(D, launch_dkv, T, q, k, v, dout, lse, delta, dk, dv, B,
                   S, H, Hkv, causal, scale, stream)
}

bool bad_shape(int B, int S, int H, int Hkv) {
  return B < 0 || S < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
         int64_t(B) * H > 65535;
}

}  // namespace

// Each returns 0 on success, -1 for arguments the kernel does not take,
// else the cudaError_t of the launch.
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, int B, int S, int H,
                        int Hkv, int D, int dtype, int causal, float scale,
                        void* stream) {
  if (bad_shape(B, S, H, Hkv)) return -1;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_T(dtype, dq_typed, q, k, v, dout, lse, delta, dq, B, S, H,
                   Hkv, D, causal, scale, s)
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int B,
                         int S, int H, int Hkv, int D, int dtype, int causal,
                         float scale, void* stream) {
  if (bad_shape(B, S, H, Hkv)) return -1;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_T(dtype, dkv_typed, q, k, v, dout, lse, delta, dk, dv, B, S,
                   H, Hkv, D, causal, scale, s)
}
