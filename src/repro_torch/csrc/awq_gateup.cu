// K3 — fused gate/up int4 GLU front for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `awq_gateup_pallas`
// (src/repro/kernels/awq_matmul.py, body `_awq_gateup_kernel`). It computes
//     g[m, n] = sum_k bf16(x[m, k] * sg[k]) * Wg[k, n]      (f32 accumulation)
//     u[m, n] = sum_k bf16(x[m, k] * su[k]) * Wu[k, n]
//     out     = silu(g) * u
// with both weights AWQ-packed at the same GS and N: qw [K/8, N] int32
// (nibble j of a word is row 8w+j), scales [K/GS, N] f32, zeros [K/GS, N]
// int8, W[k, n] = bf16((nib - z) * s) as K1 dequantizes. sg / su are the two
// linears' per-K AWQ input scales, applied in f32 before the bf16 rounding,
// exactly as `qlinear_apply` forms bf16(f32(x) * input_scale) for each
// linear; without them (the TPU kernel's function) x is only rounded to
// bf16. x is [M, K] bf16 or f32 and crosses HBM once for both products.
// Output: f32 silu(g) * u (the TPU function), or, for the model's bf16
// activations, rounded as the two-linear MLP rounds it: g and u to bf16,
// silu in f32 rounded to bf16, the product rounded to bf16.
//
// What bounds it on this card: at decode (M = 1..num_slots) the two packed
// weights stream from HBM — 2 x (0.5 byte per weight + 5 bytes of scale and
// zero per GS weights), ~5.0 MB for the 896 -> 4864 pair — against 3.35
// TB/s; the arithmetic is far below the tensor cores' rate. What the design
// does about it: K1's layout, doubled. A block owns COLS = 8 output columns
// of BOTH weights and splits K over KLANES = 32 thread rows; each thread
// dequantizes one packed word of each weight per step in registers, and
// every x element it reads (16-byte vectors) feeds one word of each. The 32
// partials per column and weight are summed through shared memory in a
// fixed order (deterministic, no atomics), so a row's result does not depend
// on M or on its neighbours. M is tiled by TM = 1/2/4/8 rows in registers
// (grid.y = ceil(M / TM)), so any M works without padding. Tensor cores
// (wgmma) and TMA pipelining are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 8;               // output columns per block
constexpr int KLANES = 32;            // thread rows splitting K
constexpr int THREADS = COLS * KLANES;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void dequant8(uint32_t word, float z, float s,
                                         float w[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w[j] = bf16_round(((float)((word >> (4 * j)) & 0xFu) - z) * s);
}

template <int TM, typename TX, bool SCALED>
__global__ void __launch_bounds__(THREADS)
awq_gateup_kernel(const TX* __restrict__ x,
                  const int32_t* __restrict__ qg,
                  const float* __restrict__ sg,
                  const int8_t* __restrict__ zg,
                  const int32_t* __restrict__ qu,
                  const float* __restrict__ su,
                  const int8_t* __restrict__ zu,
                  const float* __restrict__ isg,
                  const float* __restrict__ isu,
                  void* __restrict__ out, int out_bf16,
                  int M, int K, int N, int group_size) {
  __shared__ float red[2][TM][KLANES][COLS + 1];
  const int c = threadIdx.x % COLS;
  const int kl = threadIdx.x / COLS;
  const int n = blockIdx.x * COLS + c;
  const int m0 = blockIdx.y * TM;
  const int mt = min(TM, M - m0);

  float accg[TM], accu[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) accg[m] = accu[m] = 0.f;

  if (n < N) {
    const int words = K / 8;
    const int words_per_group = group_size / 8;
#pragma unroll 2
    for (int w = kl; w < words; w += KLANES) {
      const size_t gi = (size_t)(w / words_per_group) * N + n;
      float wg[8], wu[8];
      dequant8((uint32_t)qg[(size_t)w * N + n], (float)zg[gi], sg[gi], wg);
      dequant8((uint32_t)qu[(size_t)w * N + n], (float)zu[gi], su[gi], wu);
      float ag[8], au[8];
      if (SCALED) {
        load8(isg + (size_t)w * 8, ag);
        load8(isu + (size_t)w * 8, au);
      }
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        if (m < mt) {
          float xv[8];
          load8(x + (size_t)(m0 + m) * K + (size_t)w * 8, xv);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float xg = bf16_round(SCALED ? xv[j] * ag[j] : xv[j]);
            const float xu = SCALED ? bf16_round(xv[j] * au[j]) : xg;
            accg[m] = fmaf(xg, wg[j], accg[m]);
            accu[m] = fmaf(xu, wu[j], accu[m]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    red[0][m][kl][c] = accg[m];
    red[1][m][kl][c] = accu[m];
  }
  __syncthreads();

  if (threadIdx.x < TM * COLS) {
    const int m = threadIdx.x / COLS;
    const int cc = threadIdx.x % COLS;
    const int nn = blockIdx.x * COLS + cc;
    if (m < mt && nn < N) {
      float g = 0.f, u = 0.f;
      for (int k = 0; k < KLANES; ++k) {
        g += red[0][m][k][cc];
        u += red[1][m][k][cc];
      }
      const size_t o = (size_t)(m0 + m) * N + nn;
      if (out_bf16) {
        g = bf16_round(g);
        u = bf16_round(u);
        const float s = bf16_round(g / (1.f + expf(-g)));
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(s * u);
      } else {
        static_cast<float*>(out)[o] = g / (1.f + expf(-g)) * u;
      }
    }
  }
}

template <int TM, typename TX>
void launch(const void* x, const void* qg, const void* sg, const void* zg,
            const void* qu, const void* su, const void* zu, const void* isg,
            const void* isu, void* out, int out_bf16, int M, int K, int N,
            int group_size, cudaStream_t stream) {
  dim3 grid((N + COLS - 1) / COLS, (M + TM - 1) / TM);
  const TX* xp = static_cast<const TX*>(x);
  const int32_t* qgp = static_cast<const int32_t*>(qg);
  const int32_t* qup = static_cast<const int32_t*>(qu);
  const float* sgp = static_cast<const float*>(sg);
  const float* sup = static_cast<const float*>(su);
  const int8_t* zgp = static_cast<const int8_t*>(zg);
  const int8_t* zup = static_cast<const int8_t*>(zu);
  const float* isgp = static_cast<const float*>(isg);
  const float* isup = static_cast<const float*>(isu);
  if (isg != nullptr) {
    awq_gateup_kernel<TM, TX, true><<<grid, THREADS, 0, stream>>>(
        xp, qgp, sgp, zgp, qup, sup, zup, isgp, isup, out, out_bf16, M, K, N,
        group_size);
  } else {
    awq_gateup_kernel<TM, TX, false><<<grid, THREADS, 0, stream>>>(
        xp, qgp, sgp, zgp, qup, sup, zup, isgp, isup, out, out_bf16, M, K, N,
        group_size);
  }
}

template <typename TX>
void dispatch_m(const void* x, const void* qg, const void* sg, const void* zg,
                const void* qu, const void* su, const void* zu,
                const void* isg, const void* isu, void* out, int out_bf16,
                int M, int K, int N, int group_size, cudaStream_t s) {
  if (M == 1) {
    launch<1, TX>(x, qg, sg, zg, qu, su, zu, isg, isu, out, out_bf16, M, K,
                  N, group_size, s);
  } else if (M == 2) {
    launch<2, TX>(x, qg, sg, zg, qu, su, zu, isg, isu, out, out_bf16, M, K,
                  N, group_size, s);
  } else if (M <= 4) {
    launch<4, TX>(x, qg, sg, zg, qu, su, zu, isg, isu, out, out_bf16, M, K,
                  N, group_size, s);
  } else {
    launch<8, TX>(x, qg, sg, zg, qu, su, zu, isg, isu, out, out_bf16, M, K,
                  N, group_size, s);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). The caller has checked shapes,
// dtypes, contiguity and 16-byte alignment of x and of both input-scale
// vectors (both given or both null); K % 8 == 0, K % group_size == 0,
// group_size % 8 == 0. x is f32 when x_f32, else bf16; out is bf16 when
// out_bf16, else f32. Returns cudaGetLastError().
extern "C" int awq_gateup_f32(const void* x, const void* qg, const void* sg,
                              const void* zg, const void* qu, const void* su,
                              const void* zu, const void* isg,
                              const void* isu, void* out, int x_f32,
                              int out_bf16, int M, int K, int N,
                              int group_size, int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    dispatch_m<float>(x, qg, sg, zg, qu, su, zu, isg, isu, out, out_bf16, M,
                      K, N, group_size, s);
  } else {
    dispatch_m<__nv_bfloat16>(x, qg, sg, zg, qu, su, zu, isg, isu, out,
                              out_bf16, M, K, N, group_size, s);
  }
  return (int)cudaGetLastError();
}
