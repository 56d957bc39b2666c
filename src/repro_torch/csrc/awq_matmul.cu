// K1 — fused int4 unpack + dequantize + matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `awq_matmul_pallas`
// (src/repro/kernels/awq_matmul.py, body `_awq_matmul_kernel` and
// `_unpack_dequant`). It computes
//     out[m, n] = sum_k x[m, k] * W[k, n]                  (f32 accumulation)
//     W[k, n]   = bf16( (nib_{k%8}(qw[k/8, n]) - z[k/GS, n]) * s[k/GS, n] )
// with x [M, K] bf16, qw [K/8, N] int32 (nibble j of a word is row 8w+j),
// scales [K/GS, N] f32, zeros [K/GS, N] int8, out [M, N] f32. W is rounded
// to bf16 exactly as the reference casts it to the compute dtype, so every
// product x*W is exact in f32 and only the order of the sums differs.
//
// What bounds it on this card: at decode (M = 1..num_slots) the product is
// a GEMV whose time is the weight stream — 0.5 byte per weight plus 5 bytes
// of scale and zero per GS weights — against 3.35 TB/s of HBM; the
// arithmetic (2*M*K*N operations) is far below the tensor cores' rate.
// What the design does about it: weights cross HBM only in packed form and
// are expanded in registers. A block owns COLS = 8 output columns and splits
// K over KLANES = 32 thread rows, so each warp reads four 32-byte sectors of
// packed words per step and the grid has N/8 column blocks (112 for N = 896)
// to keep many SMs streaming; the 32 partial sums per column are reduced
// through shared memory in a fixed order (deterministic, no atomics). M is
// tiled by TM rows held in registers (grid.y = ceil(M / TM)), so any M works
// without row padding; x rows are read as 16-byte vectors. Tensor cores
// (wgmma) and TMA pipelining are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 8;               // output columns per block
constexpr int KLANES = 32;            // thread rows splitting K
constexpr int THREADS = COLS * KLANES;

template <int TM>
__global__ void __launch_bounds__(THREADS)
awq_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                  const int32_t* __restrict__ qw,
                  const float* __restrict__ scales,
                  const int8_t* __restrict__ zeros,
                  float* __restrict__ out,
                  int M, int K, int N, int group_size) {
  __shared__ float red[TM][KLANES][COLS + 1];
  const int c = threadIdx.x % COLS;
  const int kl = threadIdx.x / COLS;
  const int n = blockIdx.x * COLS + c;
  const int m0 = blockIdx.y * TM;
  const int mt = min(TM, M - m0);

  float acc[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) acc[m] = 0.f;

  if (n < N) {
    const int words = K / 8;
    const int words_per_group = group_size / 8;
#pragma unroll 4
    for (int w = kl; w < words; w += KLANES) {
      const int g = w / words_per_group;
      const float s = scales[(size_t)g * N + n];
      const float z = (float)zeros[(size_t)g * N + n];
      const uint32_t word = (uint32_t)qw[(size_t)w * N + n];
      float wv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = ((float)((word >> (4 * j)) & 0xFu) - z) * s;
        wv[j] = __bfloat162float(__float2bfloat16_rn(d));
      }
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        if (m < mt) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              x + (size_t)(m0 + m) * K + (size_t)w * 8);
          const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[m] = fmaf(__bfloat162float(xv[j]), wv[j], acc[m]);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) red[m][kl][c] = acc[m];
  __syncthreads();

  if (threadIdx.x < TM * COLS) {
    const int m = threadIdx.x / COLS;
    const int cc = threadIdx.x % COLS;
    const int nn = blockIdx.x * COLS + cc;
    if (m < mt && nn < N) {
      float sum = 0.f;
      for (int k = 0; k < KLANES; ++k) sum += red[m][k][cc];
      out[(size_t)(m0 + m) * N + nn] = sum;
    }
  }
}

template <int TM>
void launch(const void* x, const void* qw, const void* scales,
            const void* zeros, void* out, int M, int K, int N,
            int group_size, cudaStream_t stream) {
  dim3 grid((N + COLS - 1) / COLS, (M + TM - 1) / TM);
  awq_matmul_kernel<TM><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(qw),
      static_cast<const float*>(scales), static_cast<const int8_t*>(zeros),
      static_cast<float*>(out), M, K, N, group_size);
}

}  // namespace

// Plain C entry point (loaded with ctypes). The caller has checked shapes,
// dtypes, contiguity and 16-byte alignment of x; K % 8 == 0,
// K % group_size == 0, group_size % 8 == 0. Returns cudaGetLastError().
extern "C" int awq_matmul_bf16(const void* x, const void* qw,
                               const void* scales, const void* zeros,
                               void* out, int M, int K, int N,
                               int group_size, int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 1) {
    launch<1>(x, qw, scales, zeros, out, M, K, N, group_size, s);
  } else if (M == 2) {
    launch<2>(x, qw, scales, zeros, out, M, K, N, group_size, s);
  } else if (M <= 4) {
    launch<4>(x, qw, scales, zeros, out, M, K, N, group_size, s);
  } else {
    launch<8>(x, qw, scales, zeros, out, M, K, N, group_size, s);
  }
  return (int)cudaGetLastError();
}
