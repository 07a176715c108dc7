// FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces the TPU forward kernels of paddle_tpu/kernels/flash_attention.py,
// launched by `_flash_fwd_impl`: `_fwd_kernel`, `_fwd_kernel_grouped`,
// `_fwd_kernel_stream_grouped` and `_fwd_kernel_stream`. Those four are
// one function laid out four ways for the TPU's VMEM (whole-sequence K/V
// blocks or double-buffered streaming, the query-head group folded into
// the rows or not); on this card one kernel per input type covers them.
//
//   q    [B, S, H, D]    bf16 | fp16 | fp32
//   k, v [B, S, Hkv, D]  same type; H % Hkv == 0, G = H / Hkv
//   out  [B, S, H, D]    q's type: softmax(q.k^T * D^-1/2 [causal]) . v
//   lse  [B * H, S]      fp32 log-sum-exp of each row's scaled scores
//
// The arithmetic is the TPU kernel's: scores in fp32 multiplied by
// D^-1/2, masked keys set to the finite -1e30, an online softmax over
// 64-key tiles with m, l and the accumulator in fp32, P rounded to v's
// type before P.V, and at the end out = acc / max(l, 1e-30),
// lse = m + log(max(l, 1e-30)).
//
// What bounds it: operations. Per (b, h) it does 4 S^2 D flops (half
// with the causal mask) on 2 S D (H + 2 Hkv) / H elements moved, far
// above the card's ~295 flops per byte of bf16.
//
// Two kernels, chosen by the input type (flash_attention.py routes):
//
// flash_fwd_mma (bf16, fp16): the products on the tensor cores. Grid
// (B * H, ceil(S / 64)), 128 threads; the query tiles go heaviest first
// (blockIdx.y = 0 is the last tile, whose causal key walk is longest),
// so the triangle's long rows do not form a tail. Each of the 4 warps
// owns 16 query rows; its Q fragments are loaded once by ldmatrix and
// stay in registers for the whole key walk. The 64-key K and V tiles of
// kv head h / G (grouped K/V are never repeated) stay in the input type
// and pass through a 2-stage shared-memory ring filled by 16-byte
// cp.async copies: tile j + 1 is in flight while tile j is multiplied.
// S = Q.K^T takes K by ldmatrix, O += P.V takes V by ldmatrix.trans,
// both as mma.sync.m16n8k16 with fp32 accumulation. The online softmax
// runs on the accumulator fragments (a row lives in one quad of lanes:
// two shuffles for its max), and P is rounded to the input type in
// registers to become P.V's A operand directly (no shared-memory round
// trip). Rows of D + 8 elements keep ldmatrix free of bank conflicts.
// Only the diagonal tile and a ragged last tile are masked; no tile past
// the diagonal is loaded. The softmax between the products costs
// instructions on every score, so the scale is folded with log2 e into
// one FFMA before the SFU's ex2: p = 2^(s c - m c),
// c = D^-1/2 log2 e, with m the running max of the unscaled dot (the
// scaled max divided by the scale, exactly) and lse = m D^-1/2 +
// log(l). P then differs from the plain version's exp(s D^-1/2 - m) by
// a few ulps before its rounding. wgmma and TMA are the next step.
//
// flash_fwd (fp32): the products as fp32 FMAs on the CUDA cores (the
// tensor cores have no full-fp32 product; TF32 keeps ~3 digits). Each
// block keeps a 64-row query tile in shared memory and streams the
// 64-key tiles through one buffer, K for the scores and then V for P.V;
// each thread computes a 4 x 8 tile of scores and a 4 x D/8 tile of the
// output in registers. Strides of D + 1 and 64 + 1 floats keep the
// shared-memory reads free of bank conflicts. Grid (ceil(S / 64),
// B * H); thread t owns query rows ty + 16 i (ty = t / 8, i < 4), key
// columns tx + 8 j (tx = t % 8, j < 8) and output columns tx + 8 j
// (j < D / 8); row max and row sum take three shuffles.
//
// Rows and keys past a ragged S are zero-filled and masked, so any
// S >= 1 is taken.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;
constexpr int kBK = 64;

// ------------------------------------------------ fp32, CUDA cores ----

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int S, int H, int Hkv,
                     int causal, float scale) {
  constexpr int LDD = D + 1;
  constexpr int LDP = kBK + 1;
  constexpr int RI = 4;        // query rows per thread
  constexpr int CJ = 8;        // key columns per thread
  constexpr int DJ = D / 8;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBQ][LDD]
  float* KVs = Qs + kBQ * LDD;       // [kBK][LDD]: K, then V
  float* Ps = KVs + kBK * LDD;       // [kBQ][LDP]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;

  load_tile<float, kBQ, D>(Qs, LDD, q, b, h, H, S, q0);

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's P.V is done with KVs and Ps
    load_tile<float, kBK, D>(KVs, LDD, k, b, hk, Hkv, S, k0);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * LDD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = KVs[(tx + 8 * j) * LDD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qi = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kj = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (kj >= S || (causal && kj > qi)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[r * LDP + tx + 8 * j] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P complete; every read of K done
    load_tile<float, kBK, D>(KVs, LDD, v, b, hk, Hkv, S, k0);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = KVs[c * LDD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    float* o = out + row_offset(b, qi, h, H, S, D);
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 8 * j] = acc[i][j] / ls;
    if (tx == 0) lse[int64_t(bh) * S + qi] = m[i] + logf(ls);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int H, int Hkv, int causal,
           float scale, cudaStream_t stream) {
  const int64_t gx = (S + kBQ - 1) / kBQ, gy = int64_t(B) * H;
  if (!grid_fits(gx, gy)) return -1;
  const size_t smem = fwd_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(gx, gy), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, H,
      Hkv, causal, scale);
  return int(cudaGetLastError());
}

// ------------------------------------------------- tensor cores ----

template <int D>
constexpr size_t fwd_mma_smem_bytes() {
  return 2 * size_t(kBQ + 4 * kBK) * tc_ld<D>();   // Q, 2 x (K, V)
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         float* __restrict__ lse, int S, int H, int Hkv,
                         int causal, float scale) {
  constexpr int LD = tc_ld<D>();
  constexpr int KD = D / 16;     // k-steps of Q.K^T
  constexpr int NK = kBK / 8;    // n-tiles of the scores
  constexpr int ND = D / 8;      // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_tc[];
  T* Qs = reinterpret_cast<T*>(smem_tc);     // [kBQ][LD]
  T* Ks = Qs + kBQ * LD;                     // [2][kBK][LD]
  T* Vs = Ks + 2 * kBK * LD;                 // [2][kBK][LD]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest first
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp + g;         // and row0 + 8

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);

  cp_tile<T, kBQ, D>(Qs, q, b, h, H, S, q0);
  cp_tile<T, kBK, D>(Ks, k, b, hk, Hkv, S, 0);
  cp_tile<T, kBK, D>(Vs, v, b, hk, Hkv, S, 0);
  cp_async_commit();

  uint32_t qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's part
  const float c = scale * kLog2e;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; every warp is done with kt - 1
    if (kt + 1 < n_kt) {
      const int nxt = (kt + 1) & 1;
      cp_tile<T, kBK, D>(Ks + nxt * kBK * LD, k, b, hk, Hkv, S,
                         (kt + 1) * kBK);
      cp_tile<T, kBK, D>(Vs + nxt * kBK * LD, v, b, hk, Hkv, S,
                         (kt + 1) * kBK);
    }
    cp_async_commit();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], frag_a<LD>(Qs, 16 * warp, 16 * kk, lane));
    }
    const T* Kt = Ks + (kt & 1) * kBK * LD;
    const T* Vt = Vs + (kt & 1) * kBK * LD;

    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, frag_bt<LD>(Kt, 8 * n, 16 * kk, lane));
        mma16816<T>(s[n], qf[kk], kb[0], kb[1]);
        mma16816<T>(s[n + 1], qf[kk], kb[2], kb[3]);
      }

    // mask (the diagonal tile and a ragged last tile only), and the
    // online softmax of rows row0 (e < 2) and row0 + 8 (e >= 2); m is
    // kept on the unscaled dot, whose max is the scaled one's divided
    // by the scale, and p = 2^(s c - m c) with c = D^-1/2 log2 e
    const int k0 = kt * kBK;
    const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > q0 + 16 * warp);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int kj = k0 + 8 * n + 2 * t + (e & 1);
          const int qi = row0 + 8 * (e >> 1);
          if (kj >= S || (causal && kj > qi)) s[n][e] = kNegInf;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2_approx((m[r] - m_new) * c);
      m[r] = m_new;
      mc[r] = m_new * c;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(s[n][e], c, -mc[e >> 1]));
        rs[e >> 1] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O += round(P) . V
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, frag_b<LD>(Vt, 16 * kk, 8 * n, lane));
        mma16816<T>(o[n], pa, vb[0], vb[1]);
        mma16816<T>(o[n + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    const float ls = fmaxf(quad_sum(l[r]), 1e-30f);
    if (qi >= S) continue;
    T* orow = out + row_offset(b, qi, h, H, S, D) + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack2<T>(o[n][2 * r] / ls, o[n][2 * r + 1] / ls);
    if (t == 0) lse[int64_t(bh) * S + qi] = m[r] * scale + logf(ls);
  }
}

template <typename T, int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int H, int Hkv, int causal,
               float scale, cudaStream_t stream) {
  const int64_t gx = int64_t(B) * H, gy = (S + kBQ - 1) / kBQ;
  if (!grid_fits(gx, gy)) return -1;
  const size_t smem = fwd_mma_smem_bytes<D>();
  auto kernel = flash_fwd_mma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(gx, gy), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, Hkv,
      causal, scale);
  return int(cudaGetLastError());
}

template <typename T>
int launch_mma_typed(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int S, int H, int Hkv, int D,
                     int causal, float scale, cudaStream_t stream) {
  FLASH_DISPATCH_D(D, launch_mma, T, q, k, v, out, lse, B, S, H, Hkv, causal,
                   scale, stream)
}

bool bad_shape(int B, int S, int H, int Hkv) {
  return B < 0 || S < 0 || H < 1 || Hkv < 1 || H % Hkv != 0;
}

}  // namespace

// Each returns 0 on success, -1 for arguments the kernel does not take
// (flash_fwd takes fp32 alone, flash_fwd_mma bf16 and fp16 alone), else
// the cudaError_t of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int S, int H,
                         int Hkv, int D, int dtype, int causal, float scale,
                         void* stream) {
  if (bad_shape(B, S, H, Hkv) || dtype != 0) return -1;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_DIM(D, launch, q, k, v, out, lse, B, S, H, Hkv, causal,
                     scale, s)
}

extern "C" int flash_fwd_mma(const void* q, const void* k, const void* v,
                             void* out, float* lse, int B, int S, int H,
                             int Hkv, int D, int dtype, int causal,
                             float scale, void* stream) {
  if (bad_shape(B, S, H, Hkv)) return -1;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_T16(dtype, launch_mma_typed, q, k, v, out, lse, B, S, H,
                     Hkv, D, causal, scale, s)
}
