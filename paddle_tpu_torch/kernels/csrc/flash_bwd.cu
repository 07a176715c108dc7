// FlashAttention-2 backward for Hopper (sm_90a): dQ and dK/dV in two
// kernels, as on the TPU.
//
// Replaces the TPU backward kernels of paddle_tpu/kernels/flash_attention.py,
// launched by `_flash_bwd_impl`:
//   flash_dq_mma_kernel,  <- `_dq_kernel`, `_dq_kernel_grouped`,
//   flash_dq_kernel          `_dq_kernel_stream`, `_dq_kernel_stream_grouped`
//   flash_dkv_mma_kernel, <- `_dkv_kernel`, `_dkv_kernel_grouped`,
//   flash_dkv_kernel         `_dkv_kernel_stream`, `_dkv_kernel_stream_grouped`
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
// with every sum in fp32. dk is scaled by D^-1/2 once, at the end, as
// the plain version does; the TPU kernel scales each tile's product, a
// difference of fp32 rounding only; so is dq, likewise. The tensor-core
// kernels take P as 2^((s D^-1/2 - lse) log2 e), with the scale and
// log2 e folded into one FFMA (dK/dV: one FFMA and one multiply) before
// the SFU's ex2: a few ulps from exp before P's rounding.
//
// What bounds them: operations (6 and 8 S^2 D flops per (b, h), half
// with the causal mask, on O(S D) elements moved).
//
// Neither kernel uses atomics: each output element is summed by one
// thread in a fixed order, so the gradients are the same from run to
// run. No tile past the causal diagonal is read.
//
// flash_dkv_mma (bf16, fp16): the four products on the tensor cores
// (mma.sync.m16n8k16, fp32 accumulation). Grid (B * Hkv, ceil(S / 64)),
// 128 threads; blockIdx.y = 0 is key tile 0, whose causal walk is the
// longest, so the heaviest blocks start first. A block keeps its 64 keys
// of K and V in shared memory; each warp owns 16 of them as the mma's M
// dimension, so its dK and dV accumulators (16 x D fp32 each) are its
// own. The block walks the G query heads of its kv head and, for each,
// the BQ-row tiles of q and dout (with their lse and delta) that can see
// its keys, through a 2-stage cp.async ring: the next tile is in flight
// while this one is multiplied. Per tile and warp:
//   S^T = K . q^T          (K by ldmatrix as A, q by ldmatrix as B)
//   P^T = exp(S^T D^-1/2 - lse), masked, rounded to dout's type
//   dV += P^T . dout       (P^T from the accumulators as A, dout by
//                           ldmatrix.trans)
//   dP^T = V . dout^T
//   dS^T = P^T (dP^T - delta), rounded to q's type
//   dK += dS^T . q         (q by ldmatrix.trans)
// The bound on it is registers: dK and dV hold 2 x 16 x D fp32 in each
// warp, 128 a thread at D = 128, so BQ is 32 at D = 128 (64 below) and
// S^T is spent (packed into P^T) before dP^T is formed; K and V come
// from shared memory each time rather than living in registers. Rows of
// D + 8 elements keep ldmatrix free of bank conflicts.
//
// flash_dq_mma (bf16, fp16): the dK/dV design with the query rows as
// the mma's M dimension. Grid (B * H, ceil(S / 64)), 128 threads, the
// query tiles heaviest first (blockIdx.y = 0 is the last tile, whose
// causal walk is longest). Each warp owns 16 query rows: its q and dout
// fragments are loaded by ldmatrix once and stay in registers, with its
// rows' lse and delta, for the whole walk; the 64-key K and V tiles of kv
// head h / G arrive through a 2-stage cp.async ring, and the causal walk
// stops at the tile's diagonal. Per 16 keys and warp:
//   S = q . K^T, dP = dout . V^T      (K, V by ldmatrix)
//   P = 2^(S D^-1/2 log2 e - lse log2 e), masked (diagonal and ragged
//       tiles only)
//   dS = P (dP - delta), rounded to k's type in registers as the A
//        operand of
//   dQ += dS . K                      (K by ldmatrix.trans)
// The bound on it is registers: the dQ accumulator is 16 x D fp32 a warp
// (64 a thread at D = 128) beside q's and dout's fragments (32 each), so
// S and dP are formed 16 keys at a time and spent at once. dq is scaled
// by D^-1/2 once, at the end.
//
// flash_dkv and flash_dq (fp32): fp32 FMAs on the CUDA cores, with tiles
// staged once in shared memory as fp32 and reused from there, and
// strides of D + 1 and 32 + 1 floats against bank conflicts.
//
// dQ (fp32): grid (ceil(S / 64), B * H), 128 threads. A block holds a 64-row
// tile of q and dout with their lse and delta, and walks the 32-key
// tiles of the kv head h / G. Thread t owns rows ty + 16 i (ty = t / 8,
// i < 4), keys tx + 8 j (tx = t % 8, j < 4) of the score tile and
// columns tx + 8 j (j < D / 8) of dq.
//
// dK/dV (fp32): grid (ceil(S / 32), B * Hkv), 128 threads. A block holds
// a 32-key tile of k and v and walks, for each of the G query heads of
// its kv head, the 32-row tiles of q and dout that can see those keys;
// dk and dv stay in fp32 registers across the whole walk. Thread t owns
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int H, int Hkv,
                     int causal, float scale) {
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

  load_tile<float, kKvBK, D>(Ks, LDD, k, b, hk, Hkv, S, k0);
  load_tile<float, kKvBK, D>(Vs, LDD, v, b, hk, Hkv, S, k0);
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
      load_tile<float, kKvBQ, D>(Qs, LDD, q, b, h, H, S, q0);
      load_tile<float, kKvBQ, D>(dOs, LDD, dout, b, h, H, S, q0);
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
          const float p = expf(x - lse_s[r]);
          Ps[r * LDS + c] = p;
          dSs[r * LDS + c] = p * (dp[i][j] - del_s[r]);
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
      dk[off + tx + 8 * j] = scale * dk_acc[i][j];
      dv[off + tx + 8 * j] = dv_acc[i][j];
    }
  }
}

// ------------------------------------------- dK/dV, tensor cores ---

constexpr int kTcBK = 64;

template <int D>
__host__ __device__ constexpr int dkv_mma_bq() { return D >= 128 ? 32 : 64; }

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K, V; 2 stages of (q, dout) in the input type; 2 of (lse, delta)
  return 2 * size_t(2 * kTcBK + 4 * dkv_mma_bq<D>()) * tc_ld<D>() +
         sizeof(float) * 4 * dkv_mma_bq<D>();
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int H, int Hkv,
                         int causal, float scale) {
  constexpr int LD = tc_ld<D>();
  constexpr int BQ = dkv_mma_bq<D>();
  constexpr int KD = D / 16;     // k-steps over D
  constexpr int NQ = BQ / 8;     // n-tiles over the tile's queries
  constexpr int ND = D / 8;      // n-tiles over D
  extern __shared__ __align__(16) unsigned char smem_tc[];
  T* Ks = reinterpret_cast<T*>(smem_tc);     // [kTcBK][LD]
  T* Vs = Ks + kTcBK * LD;                   // [kTcBK][LD]
  T* Qs = Vs + kTcBK * LD;                   // [2][BQ][LD]
  T* dOs = Qs + 2 * BQ * LD;                 // [2][BQ][LD]
  float* rows_s = reinterpret_cast<float*>(dOs + 2 * BQ * LD);
  // rows_s: [2][lse[BQ], delta[BQ]]

  const int bhk = blockIdx.x;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.y * kTcBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + 16 * warp;              // this warp's first key
  const int key0 = kw0 + g;                    // and key0 + 8

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  const int per_head = n_qt - qt0;
  const int n_it = G * per_head;

  // the q, dout, lse and delta tiles of step `it` into ring stage `st`
  auto stage = [&](int it, int st) {
    const int h = hk * G + it / per_head;
    const int q0 = (qt0 + it % per_head) * BQ;
    cp_tile<T, BQ, D>(Qs + st * BQ * LD, q, b, h, H, S, q0);
    cp_tile<T, BQ, D>(dOs + st * BQ * LD, dout, b, h, H, S, q0);
    if (threadIdx.x < 2 * BQ) {
      const int i = threadIdx.x % BQ, qi = q0 + i;
      const float* src = threadIdx.x < BQ ? lse : delta;
      const int64_t off = (int64_t(b) * H + h) * S + qi;
      cp_async4(rows_s + st * 2 * BQ + threadIdx.x, qi < S ? src + off : src,
                qi < S ? 4 : 0);
    }
  };

  cp_tile<T, kTcBK, D>(Ks, k, b, hk, Hkv, S, k0);
  cp_tile<T, kTcBK, D>(Vs, v, b, hk, Hkv, S, k0);
  stage(0, 0);
  cp_async_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();   // step it landed; every warp is done with it - 1
    if (it + 1 < n_it) stage(it + 1, (it + 1) & 1);
    cp_async_commit();
    const int st = it & 1;
    const T* Qt = Qs + st * BQ * LD;
    const T* dOt = dOs + st * BQ * LD;
    const float* lse_t = rows_s + st * 2 * BQ;
    const float* del_t = lse_t + BQ;
    const int q0 = (qt0 + it % per_head) * BQ;
    // masks only where a key of this warp can pass a query of the tile,
    // or at a ragged edge
    const bool edge = q0 + BQ > S || kw0 + 16 > S ||
                      (causal && kw0 + 15 > q0);

    // S^T = K . q^T, then P^T rounded to the input type
    float pt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4];
      ldsm_x4(ka, frag_a<LD>(Ks, 16 * warp, 16 * kk, lane));
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        uint32_t qb[4];
        ldsm_x4(qb, frag_bt<LD>(Qt, 8 * n, 16 * kk, lane));
        mma16816<T>(pt[n], ka, qb[0], qb[1]);
        mma16816<T>(pt[n + 1], ka, qb[2], qb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);   // query of the tile
        // exp(s D^-1/2 - lse) as 2^((s D^-1/2 - lse) log2 e); a masked
        // key's weight is exactly 0, as exp(-1e30 - lse) is
        float p = exp2_approx(fmaf(pt[n][e], scale, -lse_t[c]) * kLog2e);
        if (edge) {
          const int qi = q0 + c, kj = key0 + 8 * (e >> 1);
          if (kj >= S || qi >= S || (causal && kj > qi)) p = 0.f;
        }
        pt[n][e] = round_to<T>(p);
      }

    // dV += P^T . dout
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
      uint32_t pa[4];
      acc_to_a<T>(pa, pt[2 * kk], pt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t ob[4];
        ldsm_x4_t(ob, frag_b<LD>(dOt, 16 * kk, 8 * n, lane));
        mma16816<T>(dv_acc[n], pa, ob[0], ob[1]);
        mma16816<T>(dv_acc[n + 1], pa, ob[2], ob[3]);
      }
    }

    // dP^T = V . dout^T, then dS^T = P^T (dP^T - delta)
    float dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t va[4];
      ldsm_x4(va, frag_a<LD>(Vs, 16 * warp, 16 * kk, lane));
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        uint32_t ob[4];
        ldsm_x4(ob, frag_bt<LD>(dOt, 8 * n, 16 * kk, lane));
        mma16816<T>(dpt[n], va, ob[0], ob[1]);
        mma16816<T>(dpt[n + 1], va, ob[2], ob[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[n][e] = pt[n][e] * (dpt[n][e] - del_t[8 * n + 2 * t + (e & 1)]);

    // dK += dS^T . q (dS^T rounded to q's type in acc_to_a)
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
      uint32_t sa[4];
      acc_to_a<T>(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t qb[4];
        ldsm_x4_t(qb, frag_b<LD>(Qt, 16 * kk, 8 * n, lane));
        mma16816<T>(dk_acc[n], sa, qb[0], qb[1]);
        mma16816<T>(dk_acc[n + 1], sa, qb[2], qb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key0 + 8 * r;
    if (kj >= S) continue;
    const int64_t off = row_offset(b, kj, hk, Hkv, S, D) + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n) = pack2<T>(
          scale * dk_acc[n][2 * r], scale * dk_acc[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
          pack2<T>(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// ------------------------------------------------ dQ, tensor cores ---

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // q, dout; 2 stages of (K, V); all in the input type
  return 2 * size_t(6 * kTcBK) * tc_ld<D>();
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int H, int Hkv, int causal, float scale) {
  constexpr int LD = tc_ld<D>();
  constexpr int KD = D / 16;     // k-steps over D
  constexpr int ND = D / 8;      // n-tiles over D
  extern __shared__ __align__(16) unsigned char smem_tc[];
  T* Qs = reinterpret_cast<T*>(smem_tc);     // [kTcBK][LD]
  T* dOs = Qs + kTcBK * LD;                  // [kTcBK][LD]
  T* Ks = dOs + kTcBK * LD;                  // [2][kTcBK][LD]
  T* Vs = Ks + 2 * kTcBK * LD;               // [2][kTcBK][LD]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBK;   // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp + g;         // and row0 + 8

  int n_kt = (S + kTcBK - 1) / kTcBK;
  if (causal) n_kt = min(n_kt, (q0 + kTcBK - 1) / kTcBK + 1);

  cp_tile<T, kTcBK, D>(Qs, q, b, h, H, S, q0);
  cp_tile<T, kTcBK, D>(dOs, dout, b, h, H, S, q0);
  cp_tile<T, kTcBK, D>(Ks, k, b, hk, Hkv, S, 0);
  cp_tile<T, kTcBK, D>(Vs, v, b, hk, Hkv, S, 0);
  cp_async_commit();

  // each lane's two rows: lse times log2 e, and delta
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    lse2[r] = qi < S ? lse[int64_t(bh) * S + qi] * kLog2e : 0.f;
    del[r] = qi < S ? delta[int64_t(bh) * S + qi] : 0.f;
  }
  uint32_t qf[KD][4], df[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float c = scale * kLog2e;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; every warp is done with kt - 1
    if (kt + 1 < n_kt) {
      const int nxt = (kt + 1) & 1;
      cp_tile<T, kTcBK, D>(Ks + nxt * kTcBK * LD, k, b, hk, Hkv, S,
                           (kt + 1) * kTcBK);
      cp_tile<T, kTcBK, D>(Vs + nxt * kTcBK * LD, v, b, hk, Hkv, S,
                           (kt + 1) * kTcBK);
    }
    cp_async_commit();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldsm_x4(qf[kk], frag_a<LD>(Qs, 16 * warp, 16 * kk, lane));
        ldsm_x4(df[kk], frag_a<LD>(dOs, 16 * warp, 16 * kk, lane));
      }
    }
    const T* Kt = Ks + (kt & 1) * kTcBK * LD;
    const T* Vt = Vs + (kt & 1) * kTcBK * LD;
    const int k0 = kt * kTcBK;
    // masks only the diagonal tile and a ragged last tile
    const bool edge =
        k0 + kTcBK > S || (causal && k0 + kTcBK - 1 > q0 + 16 * warp);

    // 16 keys at a time: S and dP for them, dS, then dQ += dS . K
#pragma unroll
    for (int grp = 0; grp < kTcBK / 16; ++grp) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, frag_bt<LD>(Kt, 16 * grp, 16 * kk, lane));
        mma16816<T>(s[0], qf[kk], kb[0], kb[1]);
        mma16816<T>(s[1], qf[kk], kb[2], kb[3]);
        ldsm_x4(vb, frag_bt<LD>(Vt, 16 * grp, 16 * kk, lane));
        mma16816<T>(dp[0], df[kk], vb[0], vb[1]);
        mma16816<T>(dp[1], df[kk], vb[2], vb[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // exp(s D^-1/2 - lse) as 2^(s D^-1/2 log2 e - lse log2 e); a
          // masked key's weight is exactly 0, as exp(-1e30 - lse) is
          float p = exp2_approx(fmaf(s[n][e], c, -lse2[e >> 1]));
          if (edge) {
            const int kj = k0 + 16 * grp + 8 * n + 2 * t + (e & 1);
            const int qi = row0 + 8 * (e >> 1);
            if (kj >= S || qi >= S || (causal && kj > qi)) p = 0.f;
          }
          s[n][e] = p * (dp[n][e] - del[e >> 1]);
        }
      uint32_t da[4];
      acc_to_a<T>(da, s[0], s[1]);   // dS rounded to k's type
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t kb[4];
        ldsm_x4_t(kb, frag_b<LD>(Kt, 16 * grp, 8 * n, lane));
        mma16816<T>(acc[n], da, kb[0], kb[1]);
        mma16816<T>(acc[n + 1], da, kb[2], kb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= S) continue;
    T* o = dq + row_offset(b, qi, h, H, S, D) + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(o + 8 * n) =
          pack2<T>(scale * acc[n][2 * r], scale * acc[n][2 * r + 1]);
  }
}

// ------------------------------------------------------------ launch ---

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int S,
              int H, int Hkv, int causal, float scale, cudaStream_t stream) {
  const int64_t gx = (S + kDqBQ - 1) / kDqBQ, gy = int64_t(B) * H;
  if (!grid_fits(gx, gy)) return -1;
  const size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(gx, gy), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, Hkv, causal, scale);
  return int(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int B, int S, int H, int Hkv, int causal,
               float scale, cudaStream_t stream) {
  const int64_t gx = (S + kKvBK - 1) / kKvBK, gy = int64_t(B) * Hkv;
  if (!grid_fits(gx, gy)) return -1;
  const size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_dkv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(gx, gy), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), S, H, Hkv,
      causal, scale);
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv_mma(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int S, int H, int Hkv,
                   int causal, float scale, cudaStream_t stream) {
  const int64_t gx = int64_t(B) * Hkv, gy = (S + kTcBK - 1) / kTcBK;
  if (!grid_fits(gx, gy)) return -1;
  const size_t smem = dkv_mma_smem_bytes<D>();
  auto kernel = flash_dkv_mma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(gx, gy), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hkv, causal, scale);
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch_dq_mma(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, int B, int S, int H, int Hkv, int causal,
                  float scale, cudaStream_t stream) {
  const int64_t gx = int64_t(B) * H, gy = (S + kTcBK - 1) / kTcBK;
  if (!grid_fits(gx, gy)) return -1;
  const size_t smem = dq_mma_smem_bytes<D>();
  auto kernel = flash_dq_mma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(gx, gy), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, Hkv, causal, scale);
  return int(cudaGetLastError());
}

template <typename T>
int dq_mma_typed(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int B, int S, int H, int Hkv, int D, int causal,
                 float scale, cudaStream_t stream) {
  FLASH_DISPATCH_D(D, launch_dq_mma, T, q, k, v, dout, lse, delta, dq, B, S,
                   H, Hkv, causal, scale, stream)
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
int dkv_mma_typed(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int B, int S, int H, int Hkv, int D,
                  int causal, float scale, cudaStream_t stream) {
  FLASH_DISPATCH_D(D, launch_dkv_mma, T, q, k, v, dout, lse, delta, dk, dv,
                   B, S, H, Hkv, causal, scale, stream)
}

bool bad_shape(int B, int S, int H, int Hkv) {
  return B < 0 || S < 0 || H < 1 || Hkv < 1 || H % Hkv != 0;
}

}  // namespace

// Each returns 0 on success, -1 for arguments the kernel does not take
// (flash_dq and flash_dkv take fp32 alone, flash_dq_mma and
// flash_dkv_mma bf16 and fp16 alone), else the cudaError_t of the
// launch.
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, int B, int S, int H,
                        int Hkv, int D, int dtype, int causal, float scale,
                        void* stream) {
  if (bad_shape(B, S, H, Hkv) || dtype != 0) return -1;
  if (B == 0 || S == 0) return 0;
  return dq_typed<float>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, D,
                         causal, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_dq_mma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int S,
                            int H, int Hkv, int D, int dtype, int causal,
                            float scale, void* stream) {
  if (bad_shape(B, S, H, Hkv)) return -1;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_T16(dtype, dq_mma_typed, q, k, v, dout, lse, delta, dq, B,
                     S, H, Hkv, D, causal, scale, s)
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int B,
                         int S, int H, int Hkv, int D, int dtype, int causal,
                         float scale, void* stream) {
  if (bad_shape(B, S, H, Hkv) || dtype != 0) return -1;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_DIM(D, launch_dkv, q, k, v, dout, lse, delta, dk, dv, B, S,
                     H, Hkv, causal, scale, s)
}

extern "C" int flash_dkv_mma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int B,
                             int S, int H, int Hkv, int D, int dtype,
                             int causal, float scale, void* stream) {
  if (bad_shape(B, S, H, Hkv)) return -1;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_T16(dtype, dkv_mma_typed, q, k, v, dout, lse, delta, dk, dv,
                     B, S, H, Hkv, D, causal, scale, s)
}
