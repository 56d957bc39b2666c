// The int4 AWQ products of K1 (awq_matmul.cu: one weight) and K3
// (awq_gateup.cu: the gate/up pair) on Hopper (sm_90a) tensor cores: the
// device code both kernels share, templated on the output functor `Out`
// (its NW, the number of weights, and its epilogue `Out::store`).
//
// Every weight is AWQ-packed: qw [K/8, N] int32 (nibble j of a word is row
// 8w+j), scales [K/GS, N] f32, zeros [K/GS, N] int8, and its dequantized
// value is W[k, n] = bf16((nib - z) * s). x is [M, K] bf16 or f32; each
// weight w has an optional per-K AWQ input scale is[w], applied in f32
// before the bf16 rounding, exactly as `qlinear_apply` forms
// bf16(f32(x) * input_scale); without it x is only rounded to bf16.
//
// The summation rule. Every output (m, n) of each weight is summed the same
// way whatever M is and whichever block computes it:
//   1. K is cut into spans of SPAN = 128 k (the last may be shorter);
//   2. within a span k advances in steps of 16, each one
//      mma.sync.m16n8k16 (bf16 operands, f32 accumulation) into the span's
//      accumulator, which starts at 0; a span has ceil(its k / 16) steps;
//   3. the dequantized weight is the A operand (16 output columns x 16 k,
//      column n in A row n % 16) and bf16(f32(x) * s_in) the B operand
//      (16 k x 8 rows, row m in B column m % 8);
//   4. k past K is zero in both operands;
//   5. the span partials are added into an f32 total in span order from 0;
//   6. the epilogue (`Out::store`) is applied to the weights' totals.
// bf16 x bf16 products are exact in f32, so only the order of the sums
// differs from the plain version; a row's bits do not depend on M, on its
// neighbours, on how the spans are split over blocks, or on the run. A
// weight's total is the same in K1 and K3.
//
// Two kernels, each for any NW (and a merge pass for split spans):
//   - `awq_skinny` (M <= 16): 16 output columns of every weight and one or
//     two B tiles of 8 rows a block. Its 8 warps take the spans
//     round-robin. A warp copies its whole span into its own shared memory
//     at once (cp.async: packed words, scales, x rows, input scales; zeros
//     by plain loads), so a span costs one round trip to memory; then each
//     lane dequantizes just the nibbles of its A fragment (k = 2t, 2t+1,
//     2t+8, 2t+9 of columns g and g + 8) and forms its B fragment. Span
//     partials meet in shared memory and are added in span order.
//   - `awq_wide` (M > 16): BN = 64 output columns x BM rows a block (one
//     warp per 32 columns x 16 rows). For each span it dequantizes the
//     block's weight tiles to bf16 in shared memory once, for all BM rows,
//     and scales x into bf16 in shared memory once (one tile per input
//     scale vector); the warps read fragments with ldmatrix and run the
//     MMAs. The next span's packed words, scales, zeros and x are loaded
//     into registers while this span multiplies.
// Where `Out::SPLITS`, either kernel may split the spans over blocks as
// well (grid.z: block z takes spans [z, z + 1) * span_block; SPLIT is a
// template flag, so an unsplit kernel carries no code for it): then each
// span's partial goes to scratch, and `awq_merge` adds them in span order
// and applies the epilogue.
//
// The expert axis. A MoE layer's routed experts are E weights of one
// shape, stacked: qw [E, K/8, N], scales and zeros [E, K/GS, N], input
// scales [E, K], and their rows a capacity buffer x [E, M, K] -> out
// [E, M, N] (partials [E][nspan][NW][M][N]). One launch covers them all:
// grid.z runs over experts x span splits, and a block first moves every
// pointer to its expert's slice (`at_expert`), then runs the code above
// unchanged, so expert e's rows are bit-equal to a launch on expert e
// alone. A plain linear is the case E = 1. A nibble reaches its float by one byte permute
// (no shifts per nibble, no int-to-float conversion), and a power-of-two
// GS finds its group by a shift. wgmma and TMA are left for later work (a
// different instruction may sum in a different order, so it has to take
// every M at once).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPAN = 128;       // k per span: two GS-64 groups
constexpr int WARPS = 8;        // warps per decode block
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// two floats -> bf16x2 (lo in the low half: the lower k of an MMA pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// bf16((nib - z) * s) of nibbles 2b and 2b + 1 (byte b) of a word. Each
// nibble is moved into the low byte of 2^23 (one byte permute), which
// reads as the exact float 2^23 + nib; zb = 2^23 + z, so the subtraction
// is exact and equals nib - z.
__device__ __forceinline__ uint32_t dequant2(uint32_t word, int b, float zb,
                                             float s) {
  const uint32_t sel = 0x7440u + b;   // bytes: nibble, 0, 0, 0x4B
  const float lo = __uint_as_float(__byte_perm(word & 0x0F0F0F0Fu,
                                               0x4B000000u, sel));
  const float hi = __uint_as_float(__byte_perm((word >> 4) & 0x0F0F0F0Fu,
                                               0x4B000000u, sel));
  return pack_bf16((lo - zb) * s, (hi - zb) * s);
}

__device__ __forceinline__ float zero_biased(int8_t z) {
  return 8388608.f + (float)z;
}

// d (16 x 8, f32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// steps of 16 k in the span that starts at k0
__device__ __forceinline__ int span_steps(int k0, int K) {
  return (min(SPAN, K - k0) + 15) / 16;
}

struct Args {
  const void* x;
  const int32_t* q[2];
  const float* s[2];
  const int8_t* z[2];
  const float* is[2];     // input scales (null: unscaled)
  void* out;
  float* part;            // span partials [nspan][NW][M][N] when split
  int out_bf16, M, K, N, gs;
  int gs_shift;           // log2(gs) when gs is a power of two, else -1
  int span_block;         // spans per block along grid.z
  int experts;            // stacked weights, one slice of x and out each
};

__host__ __device__ __forceinline__ int num_spans(int K) {
  return (K + SPAN - 1) / SPAN;
}

// blocks along grid.z for one expert: span groups of a.span_block spans
__host__ __device__ __forceinline__ int span_splits(const Args& a) {
  return (num_spans(a.K) + a.span_block - 1) / a.span_block;
}

// the arguments of expert e: every pointer moved to that expert's slice
template <int NW, typename TX>
__device__ __forceinline__ Args at_expert(const Args& a, int e) {
  Args b = a;
  const size_t groups = (size_t)(a.K / a.gs) * a.N;
  b.x = static_cast<const TX*>(a.x) + (size_t)e * a.M * a.K;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    b.q[w] = a.q[w] + (size_t)e * (a.K / 8) * a.N;
    b.s[w] = a.s[w] + (size_t)e * groups;
    b.z[w] = a.z[w] + (size_t)e * groups;
    if (a.is[w] != nullptr) b.is[w] = a.is[w] + (size_t)e * a.K;
  }
  const size_t mn = (size_t)a.M * a.N;
  b.out = static_cast<unsigned char*>(a.out) +
          (size_t)e * mn * (a.out_bf16 ? 2 : 4);
  if (a.part != nullptr)
    b.part = a.part + (size_t)e * num_spans(a.K) * NW * mn;
  return b;
}

// k's quantization group (a shift for the usual power-of-two GS)
__device__ __forceinline__ int group_of(int k, const Args& a) {
  return a.gs_shift >= 0 ? k >> a.gs_shift : k / a.gs;
}

// 4 / 16 bytes global -> shared; src_bytes 0 zero-fills without reading
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// groups a span's words can touch, at most (the words sit at k0 + 8r,
// r < 16, with k0 a multiple of SPAN)
__host__ __device__ __forceinline__ int span_groups(int gs) {
  return min(SPAN / 8, (SPAN - 8) / gs + 2);
}

// span partial of weight w at (m, n), when the spans are split
__device__ __forceinline__ float* part_at(const Args& a, int nw, int sp,
                                          int w, int m, int n) {
  return a.part + ((size_t)(sp * nw + w) * a.M + m) * a.N + n;
}

// ------------------------------------------------------------------------
// Decode: 16 columns of every weight x NB tiles of 8 rows per block.
// ------------------------------------------------------------------------
// One warp's copy of its span: packed words [NW][16 rows][16 columns],
// (scale, biased zero) pairs [NW][groups][16], each word row's group [16],
// x rows [NB * 8][XLD] as stored, input scales [NW][SPAN]. A row of x is
// padded by 16 bytes so the fragment reads hit every bank once.
template <typename TX> __host__ __device__ constexpr int x_ld() {
  return SPAN + 16 / (int)sizeof(TX);
}
template <int NW, typename TX, int NB>
__host__ __device__ constexpr int skinny_stage_bytes(int ngroups) {
  return NW * 16 * 16 * 4 + NW * ngroups * 16 * 8 + 16 * 4 +
         NB * 8 * x_ld<TX>() * (int)sizeof(TX) + NW * SPAN * 4;
}

template <class Out, typename TX, bool SCALED, int NB, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
awq_skinny(Args args) {
  constexpr int NW = Out::NW;
  const int splits = span_splits(args);
  const int expert = blockIdx.z / splits;
  const Args a = at_expert<NW, TX>(args, expert);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * 16, m0 = blockIdx.y * 8 * NB;
  const int K = a.K, N = a.N, gs = a.gs;
  constexpr int XLD = x_ld<TX>();
  const int ngmax = span_groups(gs);
  unsigned char* stage =
      smem + (size_t)warp * skinny_stage_bytes<NW, TX, NB>(ngmax);
  uint32_t* wsm = reinterpret_cast<uint32_t*>(stage);        // [NW][16][16]
  float2* szm = reinterpret_cast<float2*>(wsm + NW * 16 * 16);  // [NW][ng][16]
  int* rgm = reinterpret_cast<int*>(szm + NW * ngmax * 16);  // [16]
  TX* xsm = reinterpret_cast<TX*>(rgm + 16);                 // [NB*8][XLD]
  float* issm = reinterpret_cast<float*>(xsm + NB * 8 * XLD);  // [NW][SPAN]
  // span partials of one round, over the stages once every warp is done:
  // [warp][weight][tile][lane * 4 + c]
  float* red = reinterpret_cast<float*>(smem);
  const int sp_lo = (blockIdx.z - expert * splits) * a.span_block;
  const int sp_hi = min(num_spans(K), sp_lo + a.span_block);
  float tot[NW][NB] = {};    // thread < 128: element threadIdx.x of each tile

  for (int r0 = sp_lo; r0 < sp_hi; r0 += WARPS) {
    float acc[NW][NB][4] = {};
    const int sp = r0 + warp;
    if (sp < sp_hi) {
      const int k0 = sp * SPAN, kend = min(K, k0 + SPAN);
      const int rows = (kend - k0) / 8, g_a = group_of(k0, a);
      const int ng = group_of(kend - 8, a) - g_a + 1;
      // every copy of the span is in flight before any is waited on
#pragma unroll
      for (int i = 0; i < 8 * NW; ++i) {
        const int idx = lane + 32 * i, r = (idx >> 4) & 15;
        const int n = n0 + (idx & 15);
        const bool ok = r < rows && n < N;
        cp_async4(wsm + idx,
                  a.q[i / 8] + (ok ? (size_t)(k0 / 8 + r) * N + n : 0), ok);
      }
#pragma unroll
      for (int i = 0; i < 4 * NB; ++i) {
        const int idx = lane + 32 * i, row = idx >> 4, kc = idx & 15;
        const bool ok = m0 + row < a.M && k0 + 8 * kc < K;
        const TX* src = static_cast<const TX*>(a.x) +
                        (ok ? (size_t)(m0 + row) * K + k0 + 8 * kc : 0);
        constexpr int PER = 16 / (int)sizeof(TX);  // elements a copy
#pragma unroll
        for (int h = 0; h < 8 / PER; ++h)
          cp_async16(xsm + row * XLD + 8 * kc + h * PER, src + h * PER, ok);
      }
      if (SCALED) {
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          const bool ok = k0 + 4 * lane < K;
          cp_async16(issm + i * SPAN + 4 * lane,
                     a.is[i] + (ok ? k0 + 4 * lane : 0), ok);
        }
      }
      // scales and zeros of the span's groups, entry e = 16 * group + column
      if (lane < 16) rgm[lane] = group_of(k0 + 8 * lane, a) - g_a;
      for (int base = 0; base < ng * 16; base += 64) {
        float sv[NW][2];
        int8_t zv[NW][2];
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = base + lane + 32 * i, n = n0 + (e & 15);
            const bool ok = e < ng * 16 && n < N;
            const size_t at = ok ? (size_t)(g_a + (e >> 4)) * N + n : 0;
            sv[w][i] = ok ? a.s[w][at] : 0.f;
            zv[w][i] = ok ? a.z[w][at] : (int8_t)0;
          }
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = base + lane + 32 * i;
            if (e < ng * 16)
              szm[w * ngmax * 16 + e] =
                  make_float2(sv[w][i], zero_biased(zv[w][i]));
          }
      }
      cp_async_wait_all();
      __syncwarp();

      const int steps = span_steps(k0, K);
#pragma unroll 2
      for (int st = 0; st < steps; ++st) {
        const int kk = k0 + 16 * st;
        const bool hi = kk + 8 < K;               // second 8 k inside K
        const int2 g = *reinterpret_cast<const int2*>(rgm + 2 * st);
        uint32_t af[NW][4];
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = grp + 8 * c;          // A row grp / grp + 8
            const uint32_t* wr = wsm + (w * 16 + 2 * st) * 16 + col;
            const float2* sz = szm + w * ngmax * 16 + col;
            const float2 s0 = sz[g.x * 16], s1 = sz[g.y * 16];
            af[w][c] = dequant2(wr[0], tig, s0.y, s0.x);
            af[w][2 + c] = hi ? dequant2(wr[16], tig, s1.y, s1.x) : 0u;
          }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const TX* xr = xsm + (8 * j + grp) * XLD + 16 * st + 2 * tig;
          uint32_t b[SCALED ? NW : 1][2];         // [variant][k half]
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x0, x1;
            if constexpr (sizeof(TX) == 2) {
              const uint32_t raw =
                  *reinterpret_cast<const uint32_t*>(xr + 8 * h);
              x0 = __uint_as_float(raw << 16);
              x1 = __uint_as_float(raw & 0xFFFF0000u);
            } else {
              const float2 v = *reinterpret_cast<const float2*>(xr + 8 * h);
              x0 = v.x;
              x1 = v.y;
            }
            const bool on = h == 0 || hi;
#pragma unroll
            for (int v = 0; v < (SCALED ? NW : 1); ++v) {
              float y0 = x0, y1 = x1;
              if (SCALED) {
                const float2 s = *reinterpret_cast<const float2*>(
                    issm + v * SPAN + 16 * st + 2 * tig + 8 * h);
                y0 *= s.x;
                y1 *= s.y;
              }
              b[v][h] = on ? pack_bf16(y0, y1) : 0u;
            }
          }
#pragma unroll
          for (int w = 0; w < NW; ++w)
            mma(acc[w][j], af[w], b[SCALED ? w : 0][0], b[SCALED ? w : 0][1]);
        }
      }
    }
    __syncthreads();                    // every warp is done with its stage
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          red[((warp * NW + w) * NB + j) * 128 + lane * 4 + c] = acc[w][j][c];
    __syncthreads();
    if (threadIdx.x < 128) {
      const int live = min(WARPS, sp_hi - r0);
      if constexpr (SPLIT) {            // each span's partial to scratch
        const int l = threadIdx.x >> 2, c = threadIdx.x & 3;
        const int n = n0 + (l >> 2) + (c >= 2 ? 8 : 0);
        for (int v = 0; v < live; ++v)
#pragma unroll
          for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              const int m = m0 + 8 * j + 2 * (l & 3) + (c & 1);
              if (n < N && m < a.M)
                *part_at(a, NW, r0 + v, w, m, n) =
                    red[((v * NW + w) * NB + j) * 128 + threadIdx.x];
            }
      } else {
        for (int v = 0; v < live; ++v)            // span order
#pragma unroll
          for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int j = 0; j < NB; ++j)
              tot[w][j] += red[((v * NW + w) * NB + j) * 128 + threadIdx.x];
      }
    }
    __syncthreads();
  }

  if (!SPLIT && threadIdx.x < 128) {
    const int l = threadIdx.x >> 2, c = threadIdx.x & 3;
    const int n = n0 + (l >> 2) + (c >= 2 ? 8 : 0);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int m = m0 + 8 * j + 2 * (l & 3) + (c & 1);
      float t[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) t[w] = tot[w][j];
      if (n < N && m < a.M)
        Out::store(a.out, (size_t)m * N + n, a.out_bf16, t);
    }
  }
}

// ------------------------------------------------------------------------
// Prefill: BN columns of every weight x BM rows per block, one warp per 32
// columns x 16 rows (2 x BM / 16 warps).
// ------------------------------------------------------------------------
constexpr int BN = 64;
constexpr int LDS = SPAN + 8;   // bf16 row stride: ldmatrix reads no bank twice

template <int BM> __host__ __device__ constexpr int wide_threads() {
  return 32 * 2 * (BM / 16);
}

// the weight tiles [NW][BN][LDS], then the x tiles [1 or NW][BM][LDS]
template <int NW, int BM, bool SCALED> constexpr size_t wide_smem() {
  return (size_t)(NW * BN + (SCALED ? NW : 1) * BM) * LDS *
         sizeof(__nv_bfloat16);
}

// what one thread loads for a span: WI packed words of each weight (rows
// thread / 64 + (threads / 64) i of the span, column thread % 64) with
// their scales and biased zeros, and 4 chunks of 8 x values as they are
// stored (rows thread / 16 + (threads / 16) i, k chunk thread % 16) with
// that chunk's input scales; zeros outside M, N, K
template <int NW, typename TX, int WI> struct Stage {
  uint4 xr[4][sizeof(TX) / 2];
  float is[NW][8];                      // 16-byte aligned after xr
  uint32_t q[NW][WI];
  float s[NW][WI], zb[NW][WI];
};

// element e of a chunk of 8 x values held as stored
__device__ __forceinline__ float x_elem(const uint4 (&r)[1], int e) {
  const uint32_t w = reinterpret_cast<const uint32_t*>(r)[e / 2];
  return __uint_as_float(e & 1 ? w & 0xFFFF0000u : w << 16);
}
__device__ __forceinline__ float x_elem(const uint4 (&r)[2], int e) {
  return __uint_as_float(reinterpret_cast<const uint32_t*>(r)[e]);
}

template <int T, int NW, typename TX, bool SCALED, int WI>
__device__ __forceinline__ void wide_load(const Args& a, int k0, int n0,
                                          int m0, Stage<NW, TX, WI>& st) {
  const int K = a.K, N = a.N;
  const int n = n0 + threadIdx.x % BN;
#pragma unroll
  for (int i = 0; i < WI; ++i) {
    const int k = k0 + 8 * (threadIdx.x / BN + (T / BN) * i);
    const bool ok = k < K && n < N;
    const size_t gi = (size_t)group_of(k, a) * N + n;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      st.q[w][i] = ok ? (uint32_t)a.q[w][(size_t)(k / 8) * N + n] : 0u;
      st.s[w][i] = ok ? a.s[w][gi] : 0.f;
      st.zb[w][i] = zero_biased(ok ? a.z[w][gi] : (int8_t)0);
    }
  }
  const int kx = k0 + 8 * (threadIdx.x % 16);
  const TX* x = static_cast<const TX*>(a.x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + threadIdx.x / 16 + (T / 16) * i;
    const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)m * K + kx);
#pragma unroll
    for (int h = 0; h < (int)(sizeof(TX) / 2); ++h)
      st.xr[i][h] = (m < a.M && kx < K) ? p[h] : make_uint4(0, 0, 0, 0);
  }
  if (SCALED) {
#pragma unroll
    for (int v = 0; v < NW; ++v)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(st.is[v] + 4 * h) =
            kx < K ? *reinterpret_cast<const float4*>(a.is[v] + kx + 4 * h)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// dequantize / scale what `wide_load` brought into the span's bf16 tiles
// (out-of-range entries are 0 and stay 0: s = 0 and x = 0)
template <int T, int BM, int NW, typename TX, bool SCALED, int WI>
__device__ __forceinline__ void wide_store(const Stage<NW, TX, WI>& st,
                                           __nv_bfloat16* wt,
                                           __nv_bfloat16* xt) {
  const int c = threadIdx.x % BN;
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < WI; ++i) {
      const float zb = st.zb[w][i], s = st.s[w][i];
      uint4 v;
      v.x = dequant2(st.q[w][i], 0, zb, s);
      v.y = dequant2(st.q[w][i], 1, zb, s);
      v.z = dequant2(st.q[w][i], 2, zb, s);
      v.w = dequant2(st.q[w][i], 3, zb, s);
      const int r = threadIdx.x / BN + (T / BN) * i;
      *reinterpret_cast<uint4*>(wt + (w * BN + c) * LDS + 8 * r) = v;
    }
  const int kc = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = threadIdx.x / 16 + (T / 16) * i;
#pragma unroll
    for (int v = 0; v < (SCALED ? NW : 1); ++v) {
      uint32_t h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x0 = x_elem(st.xr[i], 2 * e), x1 = x_elem(st.xr[i], 2 * e + 1);
        if (SCALED) {
          x0 *= st.is[v][2 * e];
          x1 *= st.is[v][2 * e + 1];
        }
        h[e] = pack_bf16(x0, x1);
      }
      *reinterpret_cast<uint4*>(xt + (v * BM + row) * LDS + 8 * kc) =
          make_uint4(h[0], h[1], h[2], h[3]);
    }
  }
}

template <class Out, int BM, typename TX, bool SCALED, bool SPLIT>
__global__ void __launch_bounds__(wide_threads<BM>(), BM == 64 ? 2 : 1)
awq_wide(Args args) {
  constexpr int NW = Out::NW;
  const int splits = span_splits(args);
  const int expert = blockIdx.z / splits;
  const Args a = at_expert<NW, TX>(args, expert);
  constexpr int T = wide_threads<BM>();
  constexpr int WI = 16 * BN / T;       // words a thread loads per weight
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem);  // [NW][BN][LDS]
  __nv_bfloat16* xt = wt + NW * BN * LDS;         // [1 or NW][BM][LDS]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int wc = warp & 1, wr = warp >> 1;        // 32 columns x 16 rows
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int K = a.K;
  const int sp_lo = (blockIdx.z - expert * splits) * a.span_block;
  const int sp_hi = min(num_spans(K), sp_lo + a.span_block);

  // this lane's ldmatrix addresses (bytes) at k 0 of a tile: A (weight)
  // x4 = rows 0-7 / 8-15 at k 0-7, then at k 8-15; B (x) x4 = rows 0-7 at
  // k 0-7 / 8-15, then rows 8-15
  const uint32_t a_addr =
      smem_u32(wt + (wc * 32 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
               (lane >> 4) * 8);
  const uint32_t b_addr =
      smem_u32(xt + (wr * 16 + (lane & 7) + (lane >> 4) * 8) * LDS +
               ((lane >> 3) & 1) * 8);
  constexpr uint32_t WT_B = BN * LDS * sizeof(__nv_bfloat16);
  constexpr uint32_t XT_B = BM * LDS * sizeof(__nv_bfloat16);
  constexpr uint32_t COLS16_B = 16 * LDS * sizeof(__nv_bfloat16);

  // this thread's output element of fragment (i, j, c)
  auto col = [&](int i, int c) {
    return n0 + wc * 32 + 16 * i + grp + (c >= 2 ? 8 : 0);
  };
  auto row = [&](int j, int c) {
    return m0 + wr * 16 + 8 * j + 2 * tig + (c & 1);
  };

  // [weight][column tile][row tile][4]
  float tot[NW][2][2][4] = {};
  Stage<NW, TX, WI> st;
  wide_load<T, NW, TX, SCALED>(a, sp_lo * SPAN, n0, m0, st);
  for (int sp = sp_lo; sp < sp_hi; ++sp) {
    __syncthreads();                    // the last span's MMAs are done
    wide_store<T, BM, NW, TX, SCALED>(st, wt, xt);
    __syncthreads();
    if (sp + 1 < sp_hi)                 // lands while this span multiplies
      wide_load<T, NW, TX, SCALED>(a, (sp + 1) * SPAN, n0, m0, st);
    float acc[NW][2][2][4] = {};
    const int steps = span_steps(sp * SPAN, K);
    for (int ks = 0; ks < steps; ++ks) {
      const uint32_t kb = ks * 16 * sizeof(__nv_bfloat16);
      uint32_t bx[SCALED ? NW : 1][4];
#pragma unroll
      for (int v = 0; v < (SCALED ? NW : 1); ++v)
        ldsm_x4(b_addr + v * XT_B + kb, bx[v]);
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t af[4];
          ldsm_x4(a_addr + w * WT_B + i * COLS16_B + kb, af);
          const uint32_t(&b)[4] = bx[SCALED ? w : 0];
          mma(acc[w][i][0], af, b[0], b[1]);
          mma(acc[w][i][1], af, b[2], b[3]);
        }
    }
    if constexpr (SPLIT) {              // this span's partial to scratch
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int n = col(i, c), m = row(j, c);
              if (n < a.N && m < a.M)
                *part_at(a, NW, sp, w, m, n) = acc[w][i][j][c];
            }
    } else {
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) tot[w][i][j][c] += acc[w][i][j][c];
    }
  }
  if constexpr (SPLIT) return;

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = col(i, c), m = row(j, c);
        float t[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) t[w] = tot[w][i][j][c];
        if (n < a.N && m < a.M)
          Out::store(a.out, (size_t)m * a.N + n, a.out_bf16, t);
      }
}

// ------------------------------------------------------------------------
// Split spans: add every span's partial in span order, then the epilogue.
// ------------------------------------------------------------------------
template <class Out>
__global__ void __launch_bounds__(256) awq_merge(Args args) {
  constexpr int NW = Out::NW;
  const size_t mn = (size_t)args.M * args.N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn * args.experts) return;
  // x is not read here: its element type does not matter
  const Args a = at_expert<NW, __nv_bfloat16>(args, (int)(i / mn));
  const size_t e = i % mn;
  const int nspan = num_spans(a.K);
  float t[NW] = {};
  for (int sp = 0; sp < nspan; ++sp)
#pragma unroll
    for (int w = 0; w < NW; ++w)
      t[w] += a.part[(size_t)(sp * NW + w) * mn + e];
  Out::store(a.out, e, a.out_bf16, t);
}

// raise a kernel's dynamic shared memory limit once to what it needs
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

template <class Out, typename TX, bool SCALED, int NB, bool SPLIT>
int launch_skinny(const Args& a, cudaStream_t stream) {
  static size_t allowed = 48 << 10;
  const size_t smem = (size_t)WARPS *
      skinny_stage_bytes<Out::NW, TX, NB>(span_groups(a.gs));
  const cudaError_t e =
      allow_smem(awq_skinny<Out, TX, SCALED, NB, SPLIT>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + 15) / 16, (a.M + 8 * NB - 1) / (8 * NB),
            span_splits(a) * a.experts);
  awq_skinny<Out, TX, SCALED, NB, SPLIT><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class Out, int BM, typename TX, bool SCALED, bool SPLIT>
int launch_wide(const Args& a, cudaStream_t stream) {
  static size_t allowed = 48 << 10;
  constexpr size_t smem = wide_smem<Out::NW, BM, SCALED>();
  const cudaError_t e =
      allow_smem(awq_wide<Out, BM, TX, SCALED, SPLIT>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM,
            span_splits(a) * a.experts);
  awq_wide<Out, BM, TX, SCALED, SPLIT>
      <<<grid, wide_threads<BM>(), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class Out, typename TX, bool SCALED, bool SPLIT>
int launch_m(const Args& a, cudaStream_t stream) {
  if (a.M <= 8) return launch_skinny<Out, TX, SCALED, 1, SPLIT>(a, stream);
  if (a.M <= 16) return launch_skinny<Out, TX, SCALED, 2, SPLIT>(a, stream);
  if (a.M <= 64) return launch_wide<Out, 64, TX, SCALED, SPLIT>(a, stream);
  return launch_wide<Out, 128, TX, SCALED, SPLIT>(a, stream);
}

// the kernel for M: decode up to 16 rows, prefill above (64-row tiles up
// to M 64, else 128); split spans (only where `Out::SPLITS`) add a merge
// launch
template <class Out, typename TX, bool SCALED>
int launch_tx(const Args& a, cudaStream_t stream) {
  if constexpr (Out::SPLITS) {
    if (span_splits(a) > 1) {
      const int e = launch_m<Out, TX, SCALED, true>(a, stream);
      if (e != 0) return e;
      const size_t n = (size_t)a.M * a.N * a.experts;
      awq_merge<Out><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(a);
      return (int)cudaGetLastError();
    }
  }
  return launch_m<Out, TX, SCALED, false>(a, stream);
}

// the common arguments of both entry points (weights, input scales and
// the output are filled in by the caller)
inline Args make_args(const void* x, void* out, void* part, int out_bf16,
                      int M, int K, int N, int group_size, int span_block,
                      int experts) {
  Args a{};
  a.experts = experts;
  a.x = x;
  a.out = out;
  a.part = static_cast<float*>(part);
  a.out_bf16 = out_bf16;
  a.M = M;
  a.K = K;
  a.N = N;
  a.gs = group_size;
  a.gs_shift = -1;
  for (int sh = 0; sh < 31; ++sh)
    if (group_size == 1 << sh) a.gs_shift = sh;
  a.span_block = span_block > 0 ? span_block : num_spans(K);
  return a;
}

template <class Out>
int launch(const Args& a, bool x_f32, cudaStream_t stream) {
  const bool scaled = a.is[0] != nullptr;
  if (x_f32)
    return scaled ? launch_tx<Out, float, true>(a, stream)
                  : launch_tx<Out, float, false>(a, stream);
  return scaled ? launch_tx<Out, __nv_bfloat16, true>(a, stream)
                : launch_tx<Out, __nv_bfloat16, false>(a, stream);
}

}  // namespace
