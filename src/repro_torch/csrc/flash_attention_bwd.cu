// K4b — the gradient of K4 (flash attention backward), for Hopper (sm_90a).
//
// The reference has no TPU kernel for it: it trains through `attention()`
// (src/repro/models/attention.py), a q-chunked jnp softmax that XLA
// differentiates. The port trains through K4 (csrc/flash_attention.cu), so
// its gradient needs a kernel of its own. For batch b, query head h (kv
// head h / G), query row i and key j, with K4's visibility rule
//   visible(i, j) = j <= i (causal) and j > i - window (window > 0),
// K4's forward saves lse_i = log sum_j exp(s_ij), s_ij = q_i . k_j * scale,
// and this file computes, in f32 whatever the input type:
//   P_ij  = exp(s_ij - lse_i)            (0 where not visible)
//   D_i   = sum_d dO_id O_id
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dV_j  = sum_{h in group, i} P_ij dO_i
//   dK_j  = scale sum_{h in group, i} dS_ij q_i
//   dQ_i  = scale sum_j dS_ij k_j
// rounded once to the input type on the way out. Three launches a call:
//   (a) delta_kernel: D, one warp a row;
//   (b) dkdv_kernel: one block per (b, kv head, 32-key tile). It loops over
//       the group's G query heads and over the 32-row query tiles whose mask
//       can see the tile, recomputes P and dS for the tile pair and
//       accumulates dV and dK in registers. Summing the group inside the
//       block gives GQA's dk / dv without atomics;
//   (c) dq_kernel: one block per (b, head, 32-row query tile), looping over
//       the key tiles its rows can see and accumulating dQ in registers.
// No float atomics anywhere and every sum runs in a fixed order, so two
// calls give the same bits (a resumed training run repeats its losses bit
// for bit).
//
// What bounds it on this card. At Qwen2.5's train shape (B 8, 14 q / 2 kv
// heads, S 512, hd 64, causal) the five products over the visible pairs
// are ~9.4 GFLOP against ~33 MB of inputs and outputs: on tensor cores a
// few microseconds of either. This first design runs on the f32 CUDA
// cores (67 TFLOP/s at best) from shared memory, so the products bound it:
// each tile pair is staged as f32 in shared memory (rows padded by 16
// bytes, so the 16-byte reads of eight neighbouring threads hit eight
// distinct bank groups), scores and dO V^T come from 2 x 2 register
// micro-tiles of 16-byte reads, and each thread keeps hd / 32 rows of dK
// and dV (or of dQ) times four head dims in registers. Tensor cores
// (mma.sync, as K4's forward, then wgmma and TMA) are the next design.
// Inputs are read and the outputs written through their strides (head dim
// contiguous), like K4.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

struct Strides {  // element strides of the batch, head and sequence dims
  long long b, h, s;
};

constexpr int BQ = 32;   // query rows a tile
constexpr int BK = 32;   // keys a tile
constexpr int NT = 256;  // threads a block
constexpr int PAD = 4;   // floats of padding a shared row (16 bytes)
constexpr int LDP = BK + PAD;  // row of the P / dS tiles

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ bool visible(int i, int j, int S, int causal,
                                        int window) {
  return i < S && j < S && (!causal || j <= i) && (!window || j > i - window);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows [r0, r0 + ROWS) of one operand into shared f32 [ROWS][HD + PAD];
// rows past S are zero-filled
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int r0, int S) {
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    float x = 0.f;
    if (r0 + r < S) x = to_f<T>(src[(long long)(r0 + r) * stride + d]);
    dst[r * (HD + PAD) + d] = x;
  }
}

// The tile pair's P and scale * dS, [BQ][LDP] each (P only where wanted):
// thread (tr, tk) computes rows 2 tr + {0, 1} at keys tk and tk + 16.
template <int HD>
__device__ __forceinline__ void tile_scores(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* D_s, float* Ps, float* dSs, int q0,
    int k0, int S, int causal, int window, float scale) {
  constexpr int LD = HD + PAD;
  const int tr = threadIdx.x / 16, tk = threadIdx.x % 16;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 qv[2], ov[2], kv[2], vv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qv[r] = *reinterpret_cast<const float4*>(Qs + (2 * tr + r) * LD + d);
      ov[r] = *reinterpret_cast<const float4*>(dOs + (2 * tr + r) * LD + d);
      kv[r] = *reinterpret_cast<const float4*>(Ks + (tk + 16 * r) * LD + d);
      vv[r] = *reinterpret_cast<const float4*>(Vs + (tk + 16 * r) * LD + d);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[r][c] = dot4(qv[r], kv[c], s[r][c]);
        dp[r][c] = dot4(ov[r], vv[c], dp[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 2 * tr + r;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = tk + 16 * c;
      float p = 0.f;
      if (visible(q0 + row, k0 + col, S, causal, window))
        p = expf(s[r][c] * scale - lse_s[row]);
      if (Ps != nullptr) Ps[row * LDP + col] = p;
      dSs[row * LDP + col] = scale * (p * (dp[r][c] - D_s[row]));
    }
  }
}

// (a) D[b, h, i] = sum_d dO O, one warp a row (lanes over d, then a fixed
// butterfly)
template <typename T>
__global__ void __launch_bounds__(NT)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, Strides os, Strides ds, int H, int S,
             int HD, long long n_rows) {
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int i = (int)(row % S);
  const int h = (int)(row / S % H);
  const int b = (int)(row / S / H);
  const T* orow = o + b * os.b + h * os.h + i * os.s;
  const T* drow = dout + b * ds.b + h * ds.h + i * ds.s;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32)
    acc = fmaf(to_f<T>(orow[d]), to_f<T>(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int HD> constexpr size_t dkdv_smem() {
  return sizeof(float) * ((size_t)(2 * BK + 2 * BQ) * (HD + PAD)
                          + 2 * BQ * LDP + 2 * BQ);
}
template <int HD> constexpr size_t dq_smem() {
  return sizeof(float) * ((size_t)(2 * BK + 2 * BQ) * (HD + PAD)
                          + BQ * LDP + 2 * BQ);
}

// (b) dK and dV of one (b, kv head, key tile)
template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, Strides qs, Strides ks,
            Strides vs, Strides dos, Strides dks, Strides dvs, int H, int G,
            int S, int causal, int window, float scale) {
  constexpr int LD = HD + PAD;
  constexpr int DC = HD / 4;            // 4-dim chunks of a row
  constexpr int KPT = BK / (NT / DC);   // keys a thread accumulates
  static_assert(KPT * (NT / DC) == BK, "threads must tile the key tile");
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                     // [BK][LD]
  float* Vs = Ks + BK * LD;             // [BK][LD]
  float* Qs = Vs + BK * LD;             // [BQ][LD]
  float* dOs = Qs + BQ * LD;            // [BQ][LD]
  float* Ps = dOs + BQ * LD;            // [BQ][LDP]
  float* dSs = Ps + BQ * LDP;           // [BQ][LDP]
  float* lse_s = dSs + BQ * LDP;        // [BQ]
  float* D_s = lse_s + BQ;              // [BQ]

  const int n_kt = gridDim.x;
  const int kt = n_kt - 1 - blockIdx.x;  // (causal: the heaviest tile first)
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * BK;
  const int tid = threadIdx.x;
  const int td = tid % DC, tj = tid / DC;

  stage<T, HD, BK>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, S);
  stage<T, HD, BK>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, S);

  // the query rows that can see a key of this tile: [i_lo, i_hi)
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window ? min(S, k0 + BK - 1 + window) : S;

  float acc_k[KPT][4], acc_v[KPT][4];
#pragma unroll
  for (int c = 0; c < KPT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[c][e] = acc_v[c][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * dos.b + h * dos.h;
    const float* lb = lse + ((long long)b * H + h) * S;
    const float* Db = delta + ((long long)b * H + h) * S;
    for (int q0 = (i_lo / BQ) * BQ; q0 < i_hi; q0 += BQ) {
      __syncthreads();                  // the previous pair is consumed
      stage<T, HD, BQ>(Qs, qb, qs.s, q0, S);
      stage<T, HD, BQ>(dOs, db, dos.s, q0, S);
      if (tid < BQ) {
        const bool in = q0 + tid < S;
        lse_s[tid] = in ? lb[q0 + tid] : CUDART_INF_F;
        D_s[tid] = in ? Db[q0 + tid] : 0.f;
      }
      __syncthreads();
      tile_scores<HD>(Qs, dOs, Ks, Vs, lse_s, D_s, Ps, dSs, q0, k0, S, causal,
                      window, scale);
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        const float4 ov = *reinterpret_cast<const float4*>(dOs + i * LD + 4 * td);
        const float4 qv = *reinterpret_cast<const float4*>(Qs + i * LD + 4 * td);
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
          const float p = Ps[i * LDP + tj * KPT + c];
          const float ds = dSs[i * LDP + tj * KPT + c];
          acc_v[c][0] = fmaf(p, ov.x, acc_v[c][0]);
          acc_v[c][1] = fmaf(p, ov.y, acc_v[c][1]);
          acc_v[c][2] = fmaf(p, ov.z, acc_v[c][2]);
          acc_v[c][3] = fmaf(p, ov.w, acc_v[c][3]);
          acc_k[c][0] = fmaf(ds, qv.x, acc_k[c][0]);
          acc_k[c][1] = fmaf(ds, qv.y, acc_k[c][1]);
          acc_k[c][2] = fmaf(ds, qv.z, acc_k[c][2]);
          acc_k[c][3] = fmaf(ds, qv.w, acc_k[c][3]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < KPT; ++c) {
    const int j = k0 + tj * KPT + c;
    if (j >= S) continue;
    T* kr = dk + b * dks.b + hk * dks.h + j * dks.s + 4 * td;
    T* vr = dv + b * dvs.b + hk * dvs.h + j * dvs.s + 4 * td;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kr[e] = from_f<T>(acc_k[c][e]);
      vr[e] = from_f<T>(acc_v[c][e]);
    }
  }
}

// (c) dQ of one (b, head, query tile)
template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, Strides qs, Strides ks, Strides vs, Strides dos,
          Strides dqs, int H, int G, int S, int causal, int window,
          float scale) {
  constexpr int LD = HD + PAD;
  constexpr int DC = HD / 4;
  constexpr int RPT = BQ / (NT / DC);   // rows a thread accumulates
  static_assert(RPT * (NT / DC) == BQ, "threads must tile the query tile");
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                     // [BK][LD]
  float* Vs = Ks + BK * LD;             // [BK][LD]
  float* Qs = Vs + BK * LD;             // [BQ][LD]
  float* dOs = Qs + BQ * LD;            // [BQ][LD]
  float* dSs = dOs + BQ * LD;           // [BQ][LDP]
  float* lse_s = dSs + BQ * LDP;        // [BQ]
  float* D_s = lse_s + BQ;              // [BQ]

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int td = tid % DC, ti = tid / DC;

  stage<T, HD, BQ>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  stage<T, HD, BQ>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, S);
  if (tid < BQ) {
    const bool in = q0 + tid < S;
    const long long r = ((long long)b * H + h) * S + q0 + tid;
    lse_s[tid] = in ? lse[r] : CUDART_INF_F;
    D_s[tid] = in ? delta[r] : 0.f;
  }
  // the keys any row of this tile can see: [k_lo, k_hi)
  const int n_rows = min(BQ, S - q0);
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(S, q0 + n_rows) : S;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  float acc[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();                    // the previous tile is consumed
    stage<T, HD, BK>(Ks, kb, ks.s, k0, S);
    stage<T, HD, BK>(Vs, vb, vs.s, k0, S);
    __syncthreads();
    tile_scores<HD>(Qs, dOs, Ks, Vs, lse_s, D_s, nullptr, dSs, q0, k0, S,
                    causal, window, scale);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(Ks + j * LD + 4 * td);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float ds = dSs[(ti * RPT + r) * LDP + j];
        acc[r][0] = fmaf(ds, kv.x, acc[r][0]);
        acc[r][1] = fmaf(ds, kv.y, acc[r][1]);
        acc[r][2] = fmaf(ds, kv.z, acc[r][2]);
        acc[r][3] = fmaf(ds, kv.w, acc[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = q0 + ti * RPT + r;
    if (i >= S) continue;
    T* qr = dq + b * dqs.b + h * dqs.h + i * dqs.s + 4 * td;
#pragma unroll
    for (int e = 0; e < 4; ++e) qr[e] = from_f<T>(acc[r][e]);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int B, H, Hkv, S, causal, window;
  float scale;
};

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem_kv = dkdv_smem<HD>(), smem_q = dq_smem<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(dkdv_kernel<T, HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_kv);
    cudaFuncSetAttribute(dq_kernel<T, HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_q);
    attr_set = true;
  }
  const int G = a.H / a.Hkv;
  const long long n_rows = (long long)a.B * a.H * a.S;
  const int rows_per_block = NT / 32;
  delta_kernel<T><<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block),
                    NT, 0, stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta,
      a.os, a.dos, a.H, a.S, HD, n_rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid_kv((a.S + BK - 1) / BK, a.Hkv, a.B);
  dkdv_kernel<T, HD><<<grid_kv, NT, smem_kv, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.qs, a.ks, a.vs,
      a.dos, a.dks, a.dvs, a.H, G, a.S, a.causal, a.window, a.scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid_q((a.S + BQ - 1) / BQ, a.H, a.B);
  dq_kernel<T, HD><<<grid_q, NT, smem_q, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.dqs, a.H, G,
      a.S, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const Args&, cudaStream_t);

template <int HD>
LaunchFn pick_hd(int dtype) {
  if (dtype == 0) return launch<float, HD>;
  if (dtype == 1) return launch<__nv_bfloat16, HD>;
  if (dtype == 2) return launch<__half, HD>;
  return nullptr;
}

LaunchFn pick(int dtype, int HD) {
  if (HD == 64) return pick_hd<64>(dtype);
  if (HD == 128) return pick_hd<128>(dtype);
  if (HD == 256) return pick_hd<256>(dtype);
  return nullptr;
}

Strides at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 f32, 1 bf16, 2 f16 (q,
// k, v, o, dout, dq, dk and dv alike). lse (from K4's forward) and delta
// (scratch, written here) are contiguous f32 [B, H, S]. strides: 24 element
// strides, the (batch, head, sequence) strides of q, k, v, o, dout, dq, dk
// and dv in that order; every head dim is contiguous. The caller has
// checked shapes, dtypes, H % Hkv == 0, hd in {64, 128, 256} and S >= 1.
// Three launches on the stream; returns the first non-zero
// cudaGetLastError(), else 0.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const long long* strides, int B, int H, int Hkv, int S, int HD,
    int dtype, int causal, int window, float scale, int device,
    void* stream) {
  cudaSetDevice(device);
  const LaunchFn fn = pick(dtype, HD);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, static_cast<const float*>(lse),
         static_cast<float*>(delta), dq, dk, dv,
         at(strides, 0), at(strides, 1), at(strides, 2), at(strides, 3),
         at(strides, 4), at(strides, 5), at(strides, 6), at(strides, 7),
         B, H, Hkv, S, causal, window, scale};
  return fn(a, static_cast<cudaStream_t>(stream));
}
