// K1 — fused int4 unpack + dequantize + matmul for Hopper (sm_90a), on
// tensor cores.
//
// Replaces the Pallas TPU kernel `awq_matmul_pallas`
// (src/repro/kernels/awq_matmul.py, body `_awq_matmul_kernel` and
// `_unpack_dequant`). It computes
//     out[m, n] = sum_k bf16(x[m, k] * s_in[k]) * W[k, n]  (f32 accumulation)
//     W[k, n]   = bf16( (nib_{k%8}(qw[k/8, n]) - z[k/GS, n]) * s[k/GS, n] )
// with x [M, K] bf16 or f32, qw [K/8, N] int32 (nibble j of a word is row
// 8w+j), scales [K/GS, N] f32, zeros [K/GS, N] int8. s_in is the linear's
// optional per-K AWQ input scale, applied in f32 before the bf16 rounding
// as `qlinear_apply` applies it; without it (the TPU kernel's function) x
// is only rounded to bf16. out is [M, N] f32 (the TPU function) or bf16
// (the model's activations: the f32 total rounded once). Every product is
// exact in f32, and the sums follow the rule stated in awq_common.cuh, so
// a row's bits do not depend on M, and each total equals K3's for the
// same weight.
//
// What bounds it on this card, and what the design does about it. Qwen2.5's
// K1 shapes are narrow in N (896 for q, o and down, 128 for k and v), so a
// tile of columns alone gives too few blocks for 132 SMs; where it does,
// the spans are split over blocks as well (grid.z), each span's partial
// goes to scratch, and a merge launch adds them in span order (two
// launches a call):
//   - Decode (M <= 16): the packed weight streams from HBM once (0.4 MB
//     for 896 -> 896, 2.2 MB for down at GS 64, against 3.35 TB/s); the
//     arithmetic is tiny, so latency sets the time. `awq_skinny` with one
//     weight: 16 columns a block, one span per warp; K 896's 7 spans stay
//     in one block, down's 38 go in 8 groups (448 blocks at N 896).
//   - Prefill (M > 16): at M 1024 down is 8.9 GFLOP, so the multiply-adds
//     bound it: `awq_wide` with one weight (64 columns x 64 or 128 rows a
//     block). Where that fills less than half the SMs and the partials are
//     small (the chunk step's M 64: 14 blocks at N 896), the spans are
//     split so that about two blocks run on each SM.
// The wrapper picks the split (`span_block`) and allocates the scratch.
//   - A MoE layer's routed experts (the expert axis, awq_common.cuh): one
//     launch for all E experts' down projections over their capacity
//     rows, [E, M, 1408] -> [E, M, 2048] for qwen2-moe; decode streams
//     every expert's packed weight once (60 x 1.6 MB at GS 64).
#include "awq_common.cuh"

namespace {

// the epilogue: out[o] from the total, rounded once to bf16 or kept f32
struct LinearOut {
  static constexpr int NW = 1;
  static constexpr bool SPLITS = true;   // narrow N: split spans
  __device__ static void store(void* out, size_t o, int out_bf16,
                               const float (&t)[1]) {
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(t[0]);
    else
      static_cast<float*>(out)[o] = t[0];
  }
};

}  // namespace

// Plain C entry point (loaded with ctypes). The caller has checked shapes,
// dtypes, contiguity and 16-byte alignment of x and of the input scale
// (null: unscaled); K % 8 == 0, K % group_size == 0, group_size % 8 == 0.
// x is f32 when x_f32, else bf16; out is bf16 when out_bf16, else f32.
// Every tensor holds `experts` stacked slices (1 for a plain linear): x
// [E, M, K], qw [E, K/8, N], scales and zeros [E, K/GS, N], input scale
// [E, K], out [E, M, N]. span_block is the number of spans a block takes
// (all of them: no split); when it splits K, part holds E * ceil(K / 128)
// * M * N floats. Returns cudaGetLastError().
extern "C" int awq_matmul(const void* x, const void* qw, const void* scales,
                          const void* zeros, const void* input_scale,
                          void* out, void* part, int x_f32, int out_bf16,
                          int M, int K, int N, int group_size,
                          int span_block, int experts, int device,
                          void* stream) {
  cudaSetDevice(device);
  Args a = make_args(x, out, part, out_bf16, M, K, N, group_size,
                     span_block, experts);
  a.q[0] = static_cast<const int32_t*>(qw);
  a.s[0] = static_cast<const float*>(scales);
  a.z[0] = static_cast<const int8_t*>(zeros);
  a.is[0] = static_cast<const float*>(input_scale);
  if (span_splits(a) > 1 && part == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch<LinearOut>(a, x_f32 != 0, static_cast<cudaStream_t>(stream));
}
