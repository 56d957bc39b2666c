// K4 — tiled online-softmax attention (flash attention, forward), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`). For batch b
// and query head h (kv head h / G, G = H / Hkv), query row i and key j at
// positions i and j of one sequence:
//   visible(i, j) = j < S and (!causal or j <= i)
//                   and (window == 0 or j > i - window)
//   out[b, h, i, :] = softmax_j(q[b, h, i] . k[b, h / G, j] * scale | visible)
//                     @ v[b, h / G, :]
// in f32 whatever the input type (f32, bf16 or f16), rounded once to the
// input type on the way out. Masked keys get p = 0. Every row sees at
// least itself; a row with l == 0 would still give exactly 0, as in the
// reference.
//
// What bounds it on this card: at Qwen2.5's shapes (hd 64, S <= 1024) the
// operations, not the bytes of Q, K, V and O. Per visible (query, key)
// pair, QK^T's 2 * hd flops multiply bf16 by bf16, which tensor cores do
// exactly at 989 TFLOP/s with f32 sums; PV's 2 * hd take f32
// probabilities, so they need f32 units (67 TFLOP/s). This kernel runs
// both on the CUDA cores in f32. What the design does: one block of 4 warps owns 32 query rows of one head
// (grid: query tiles x H x B, the longest causal tiles first), walks the
// 32-key tiles its rows can see (causal and window bound the walk), and
// keeps each warp's 8 rows of running max, sum and accumulator in registers
// — scores never leave the chip. K is staged transposed (and padded, so
// neither the staging writes nor the reads conflict on a bank) and V as is,
// both converted to f32 once per tile; each K or V value read from shared
// memory feeds the 8 rows of its warp, and Q and the probabilities are read
// as broadcast float4. Any S works: the ragged tail of the last tile is
// masked in-kernel, nothing is padded. Inputs are read and the output
// written through their strides (last dim contiguous), so the caller's
// [B, S, H, hd] projections need no transpose copy. Tensor cores (wgmma),
// TMA and asynchronous copies are left for later work, as are the TPU
// version's artifacts: its 128 x 128 blocking and its (bq, 128) replicated
// m / l scratch are not carried over.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;          // query rows per block
constexpr int KT = 32;          // keys per tile (one per lane)
constexpr int NW = 4;           // warps per block
constexpr int RW = BQ / NW;     // rows per warp, held in registers
constexpr int NT = 32 * NW;     // threads per block
constexpr int KTP = KT + 1;     // padded row of the transposed K tile
constexpr float NEG = -1e30f;   // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Strides {  // element strides of the batch, head and sequence dims
  long long b, h, s;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
             Strides vs, Strides os, int H, int G, int S, int causal,
             int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // [BQ][HD]
  float* Vs = Qs + BQ * HD;             // [KT][HD]
  float* Ps = Vs + KT * HD;             // [NW][RW][KT] probabilities
  float* Kt = Ps + NW * RW * KT;        // [HD][KTP] transposed keys

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = qt * BQ;
  const int n_rows = min(BQ, S - q0);

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    Qs[i] = r < n_rows ? to_f32(qb[(q0 + r) * qs.s + d]) : 0.f;
  }

  // the keys any row of this block can see: [k_lo, k_hi)
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(S, q0 + n_rows) : S;

  const int row0 = warp * RW;           // this warp's first row in the tile
  float m[RW], l[RW], acc[RW][HD / 32];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) acc[r][j] = 0.f;
  }
  // positions of this warp's rows: the first and the last that exist
  const int wp_first = q0 + row0;
  const int wp_last = q0 + min(row0 + RW, n_rows) - 1;
  float* Pw = Ps + warp * RW * KT;

  for (int t0 = (k_lo / KT) * KT; t0 < k_hi; t0 += KT) {
    __syncthreads();                    // the previous tile is consumed
    for (int i = tid; i < KT * HD; i += NT) {
      const int kk = i / HD, d = i % HD;
      const int kp = t0 + kk;
      float kv = 0.f, vv = 0.f;
      if (kp < S) {
        kv = to_f32(kb[kp * ks.s + d]);
        vv = to_f32(vb[kp * vs.s + d]);
      }
      Kt[d * KTP + kk] = kv;
      Vs[kk * HD + d] = vv;
    }
    __syncthreads();

    // skip (warp-uniformly) a tile none of this warp's rows can see
    if (row0 >= n_rows) continue;
    if (causal && t0 > wp_last) continue;
    if (window && t0 + KT - 1 <= wp_first - window) continue;

    // scores: lane = key of the tile, 8 rows at once
    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float k0 = Kt[(d + 0) * KTP + lane];
      const float k1 = Kt[(d + 1) * KTP + lane];
      const float k2 = Kt[(d + 2) * KTP + lane];
      const float k3 = Kt[(d + 3) * KTP + lane];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (row0 + r) * HD + d);
        s[r] = fmaf(qv.x, k0, s[r]);
        s[r] = fmaf(qv.y, k1, s[r]);
        s[r] = fmaf(qv.z, k2, s[r]);
        s[r] = fmaf(qv.w, k3, s[r]);
      }
    }

    // online softmax per row; p goes to this warp's strip of shared memory
    const int kp = t0 + lane;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int qp = q0 + row0 + r;
      const bool vis = row0 + r < n_rows && kp < S && (!causal || kp <= qp) &&
                       (!window || kp > qp - window);
      const float sc = vis ? s[r] * scale : NEG;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float alpha = expf(m[r] - m_new);
      const float p = vis ? expf(sc - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) acc[r][j] *= alpha;
      Pw[r * KT + lane] = p;
    }
    __syncwarp();

    // acc += p @ V: lane owns dims lane + 32 j
#pragma unroll 2
    for (int kk = 0; kk < KT; kk += 4) {
      float vr[4][HD / 32];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < HD / 32; ++j) vr[e][j] = Vs[(kk + e) * HD + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(Pw + r * KT + kk);
#pragma unroll
        for (int j = 0; j < HD / 32; ++j) {
          acc[r][j] = fmaf(p4.x, vr[0][j], acc[r][j]);
          acc[r][j] = fmaf(p4.y, vr[1][j], acc[r][j]);
          acc[r][j] = fmaf(p4.z, vr[2][j], acc[r][j]);
          acc[r][j] = fmaf(p4.w, vr[3][j], acc[r][j]);
        }
      }
    }
    __syncwarp();                       // Pw is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (row0 + r >= n_rows) break;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    T* orow = ob + (q0 + row0 + r) * os.s;
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) orow[lane + 32 * j] = from_f32<T>(acc[r][j] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, Strides os, int B, int H, int Hkv, int S,
           int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BQ * HD + KT * HD + NW * RW * KT + HD * KTP);
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(flash_kernel<T, HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    attr_set = true;
  }
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, H, H / Hkv,
      S, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int HD, const void* q, const void* k, const void* v, void* o,
                Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
                int Hkv, int S, int causal, int window, float scale,
                cudaStream_t stream) {
  if (HD == 64)
    return launch<T, 64>(q, k, v, o, qs, ks, vs, os, B, H, Hkv, S, causal,
                         window, scale, stream);
  if (HD == 128)
    return launch<T, 128>(q, k, v, o, qs, ks, vs, os, B, H, Hkv, S, causal,
                          window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 f32, 1 bf16, 2 f16 (q,
// k, v and o alike). Strides are in elements for the batch, head and
// sequence dims; the head dim is contiguous. The caller has checked shapes,
// dtypes, H % Hkv == 0, hd in {64, 128}, and S >= 1. Returns
// cudaGetLastError().
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, int B, int H, int Hkv, int S, int HD, int dtype, int causal,
    int window, float scale, int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  if (dtype == 0)
    return dispatch_hd<float>(HD, q, k, v, o, qs, ks, vs, os, B, H, Hkv, S,
                              causal, window, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(HD, q, k, v, o, qs, ks, vs, os, B, H,
                                      Hkv, S, causal, window, scale, st);
  if (dtype == 2)
    return dispatch_hd<__half>(HD, q, k, v, o, qs, ks, vs, os, B, H, Hkv, S,
                               causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
