// K3 — fused gate/up int4 GLU front for Hopper (sm_90a), on tensor cores.
//
// Replaces the Pallas TPU kernel `awq_gateup_pallas`
// (src/repro/kernels/awq_matmul.py, body `_awq_gateup_kernel`). It computes
//     g[m, n] = sum_k bf16(x[m, k] * sg[k]) * Wg[k, n]      (f32 accumulation)
//     u[m, n] = sum_k bf16(x[m, k] * su[k]) * Wu[k, n]
//     out     = silu(g) * u
// with both weights AWQ-packed at the same GS and N, dequantized as K1
// dequantizes. sg / su are the two linears' per-K AWQ input scales;
// without them (the TPU kernel's function) x is only rounded to bf16.
// Output: f32 silu(g) * u (the TPU function), or, for the model's bf16
// activations, rounded as the two-linear MLP rounds it: g and u to bf16,
// silu in f32 rounded to bf16, the product rounded to bf16. g and u are
// summed under the rule stated in awq_common.cuh, so each equals, bit for
// bit, K1's total for that weight.
//
// What bounds it on this card, and what the design does about it:
//   - Decode (M <= 16): the two packed weights stream from HBM once,
//     ~5.0 MB for the 896 -> 4864 pair at GS 64, against 3.35 TB/s; the
//     arithmetic is tiny, so latency sets the time. `awq_skinny` with two
//     weights gives a block 16 output columns of both (304 blocks at
//     N 4864, all resident on 132 SMs), one round trip to memory a span.
//   - Prefill (M > 16): at M 1024 the pair is 17.9 GFLOP, so the
//     multiply-adds bound it: tensor cores, not CUDA cores. `awq_wide` with
//     two weights dequantizes both 64-column weight tiles once per span for
//     64 or 128 rows, and scales x once per input-scale vector.
//   - A MoE layer's routed experts (the expert axis, awq_common.cuh): one
//     launch for all E experts' gate/up fronts over their capacity rows,
//     [E, M, 2048] -> [E, M, 1408] for qwen2-moe (60 experts, ~184 MB of
//     packed pairs a layer, read once).
#include "awq_common.cuh"

namespace {

// the epilogue: out[o] from the two totals
struct GluOut {
  static constexpr int NW = 2;
  static constexpr bool SPLITS = false;  // N 4864 fills the SMs
  __device__ static void store(void* out, size_t o, int out_bf16,
                               const float (&t)[2]) {
    float g = t[0], u = t[1];
    if (out_bf16) {
      g = bf16_round(g);
      u = bf16_round(u);
      const float s = bf16_round(g / (1.f + expf(-g)));
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(s * u);
    } else {
      static_cast<float*>(out)[o] = g / (1.f + expf(-g)) * u;
    }
  }
};

}  // namespace

// Plain C entry point (loaded with ctypes). The caller has checked shapes,
// dtypes, contiguity and 16-byte alignment of x and of both input-scale
// vectors (both given or both null); K % 8 == 0, K % group_size == 0,
// group_size % 8 == 0. x is f32 when x_f32, else bf16; out is bf16 when
// out_bf16, else f32. Every tensor holds `experts` stacked slices (1 for
// one GLU front), laid out as in awq_matmul.cu. Returns
// cudaGetLastError().
extern "C" int awq_gateup_f32(const void* x, const void* qg, const void* sg,
                              const void* zg, const void* qu, const void* su,
                              const void* zu, const void* isg,
                              const void* isu, void* out, int x_f32,
                              int out_bf16, int M, int K, int N,
                              int group_size, int experts, int device,
                              void* stream) {
  cudaSetDevice(device);
  Args a = make_args(x, out, nullptr, out_bf16, M, K, N, group_size, 0,
                     experts);
  a.q[0] = static_cast<const int32_t*>(qg);
  a.q[1] = static_cast<const int32_t*>(qu);
  a.s[0] = static_cast<const float*>(sg);
  a.s[1] = static_cast<const float*>(su);
  a.z[0] = static_cast<const int8_t*>(zg);
  a.z[1] = static_cast<const int8_t*>(zu);
  a.is[0] = static_cast<const float*>(isg);
  a.is[1] = static_cast<const float*>(isu);
  return launch<GluOut>(a, x_f32 != 0, static_cast<cudaStream_t>(stream));
}
