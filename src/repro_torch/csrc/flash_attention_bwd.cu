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
// rounded once to the input type on the way out.
//
// What bounds it on this card. At Qwen2.5's train shape (B 8, 14 q / 2 kv
// heads, S 512, hd 64, causal) the five products over the visible pairs
// are ~9.4 GFLOP against ~33 MB of inputs and outputs: ~10 us of either
// at the card's peaks. With the scores recomputed once more for dQ (no
// atomics) and P and dS split in two halves (below), the kernels issue
// ~2x those flops through mma.sync, whose rate on Hopper sits below
// wgmma's. What sets the time is how evenly the causal triangle's work
// spreads over the 132 SMs and how well a warp's chain of ldmatrix, MMA,
// exp and hi / lo conversions keeps its tensor core busy: with two warps
// an SM sub-partition (registers allow no more) the chains stall, and the
// call runs at ~14x its bound (PERF.md), neither HBM- nor MMA-bound.
//
// The design, for bf16 and f16 inputs (the train path's types): two
// launches a call, all five products on tensor cores (mma.sync m16n8k16,
// f32 sums, operands fed from shared memory by ldmatrix; .trans where the
// reduction runs over the tile's rows).
//   (a) dq_mma_kernel: one block of 4 warps per (b, head, 64-row query
//       tile), 16 rows a warp, as K4's forward. It first computes D for
//       its rows (dO from its staged tile, O from device memory), keeps
//       them and writes them out for (b); then walks the key tiles its
//       rows can see: S = Q K^T and dP = dO V^T (bf16 x bf16 products,
//       exact), P and dS in the score fragments, dQ += dS K. Folding D
//       into this launch saves the third launch of the first design (a
//       few us at the train shape, where the whole call is tens of us)
//       and reads O once.
//   (b) dkdv_mma_kernel: one block per (b, kv head, 32-key tile), 16 keys
//       a warp. It computes the transposed scores S^T = K Q^T and
//       dP^T = V dO^T (keys as rows, queries as columns; lse and D indexed
//       by column), so P^T and dS^T land in the A-operand layout and
//       dV += P^T dO, dK += dS^T Q need no trip through shared memory.
//       Its work is the list of (group head, query tile) items whose
//       queries can see the tile; the block runs two streams of them
//       (even and odd items) on two sets of warps, and at the end the odd
//       stream's dK / dV go through shared memory into the even one's, a
//       fixed order. Summing the group inside the block gives GQA's
//       dk / dv without atomics.
//   - P and dS are f32. Before dV = P^T dO, dK = dS^T Q and dQ = dS K each
//     is split into hi = T(x) and lo = T(x - hi), both halves go through
//     the tensor cores (K4's PV): the residual is about 2^-16 x (bf16),
//     2^-22 x (f16), far below the output's rounding.
//   - Tiles stay in their own type in shared memory, copied with 16-byte
//     cp.async in a ring of stages (lse and D with 4-byte copies), in the
//     layout wgmma's 128-byte swizzle reads: 64-column panels of 128-byte
//     rows, the 16-byte chunk c of row r stored at c ^ (r % 8), so the
//     eight rows of an ldmatrix read hit eight distinct bank groups.
//     Head dims 80 and 96 (hubert-xlarge, phi-3-vision) take two panels,
//     the second holding a row's chunks 8, 9 (and 10, 11) at their
//     swizzled places and the rest of it never written or read: the
//     tiles are sized for 128 columns (shared memory is not what limits
//     these kernels), while every product, copy and loop runs over the
//     HD / 16 k-chunks and HD / 8 n-tiles that exist, so no MMA works on
//     padding. The copies walk a tile's 10 or 12 chunks a row in whole
//     passes of the block's threads and one partial pass.
//   - Keeping the card full. 64 keys a block would give 128 blocks at the
//     train shape, under one wave of 132 SMs, with key tile 0 doing 8x
//     the work of the last. So the key tiles are smaller (32 keys: 256
//     blocks of 4 warps at hd 64, ~2 resident an SM) and each block
//     splits its item list over two warp sets, halving the longest walk.
//     Under causal masking every query sees key tile 0 and the last query
//     tile sees every key: those heaviest tiles start first (dK / dV by
//     ascending key tile, dQ by descending query tile), in rounds of one
//     block an SM with every other round reversed, so an SM that took a
//     heavy tile takes a light one next. (Splitting the group across
//     blocks instead would add ~2 x 29 MB of f32 partials at the train
//     shape, more than the whole bound.)
//   - Registers. A warp keeps dK and dV for 16 keys x its head dims and
//     the item's S^T and dP^T: at hd 64, over 64-query items, 64 + 64
//     floats a lane. At hd 128 and 256 two warps share a 16-key group,
//     both computing its scores (the same instructions on the same data,
//     the same bits) and each keeping half the head dims, over 32-query
//     items; at hd 80 and 96 one warp keeps a group's 80 or 96 dims (10
//     or 12 n-tiles) over 32-query items, as many floats as hd 64's. dQ
//     keeps 16 rows x hd (hd / 2 floats a lane) over 64-key tiles at hd
//     64, 32-key tiles above. Head dim 32 (glm4-9b's smoke config) takes
//     hd 64's tiles (64-key dQ tiles in a ring of 3, 64-query dK / dV
//     items): its sums are half of hd 64's (16 floats of dQ, 16 + 16 of
//     dK / dV a lane), so the tiles that spill nothing at hd 64 fit with
//     room, and 32-wide ones would only double the walks' steps. Its rows
//     fill half of each 128-byte panel row (4 of the 8 swizzled chunks);
//     the other half is never written or read, and every loop runs the
//     2 k-chunks and 4 n-tiles that exist, so no MMA works on padding.
//     Shared memory is hd 64's (64 KB for dQ), which is not what limits
//     the blocks an SM. ptxas gives the unrolled loops
//     what __launch_bounds__(NT, 1) allows (2 blocks an SM at hd 64);
//     nothing spills at hd 32, 64, 80, 96 and 128, while at hd 256 dQ's 128 floats
//     of sums spill a few dozen bytes. chip_smoke.py's build line shows
//     each kernel's registers and spills.
//   - No float atomics anywhere and every sum runs in a fixed order, so
//     two calls give the same bits (a resumed training run repeats its
//     losses bit for bit), and a batch row's gradients do not depend on
//     the batch around it.
//   - Any S works: rows and keys past S are zero-filled by the copies and
//     masked in-kernel; tiles every pair of which is visible skip the
//     mask, and a warp skips an item or tile none of its pairs can see.
// f32 inputs, which only the tests pass, take a CUDA-core body of their
// own (f32 has no exact tensor-core product; three launches: D, dK / dV,
// dQ, each tile pair staged as f32 in shared memory). This is dispatch
// by type: a bf16 or f16 call never takes it. wgmma and TMA are left for
// later work; the 128-byte-swizzled tiles and 64-row (4-warp) query
// tiles are laid out for them.
// Inputs are read and the outputs written through their strides (head dim
// contiguous, rows 16-byte aligned for bf16 / f16; the wrapper checks).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

struct Strides {  // element strides of the batch, head and sequence dims
  long long b, h, s;
};

__device__ __forceinline__ bool visible(int i, int j, int S, int causal,
                                        int window) {
  return i < S && j < S && (!causal || j <= i) && (!window || j > i - window);
}


// ------------------------------------------------------------------------
// Tensor-core body: bf16 / f16.
// ------------------------------------------------------------------------
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static __device__ __forceinline__ T2 pack(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float lo(T2 x) { return __low2float(x); }
  static __device__ __forceinline__ float hi(T2 x) { return __high2float(x); }
};
template <> struct Pair<__half> {
  using T2 = __half2;
  static __device__ __forceinline__ T2 pack(float a, float b) {
    return __floats2half2_rn(a, b);
  }
  static __device__ __forceinline__ float lo(T2 x) { return __low2float(x); }
  static __device__ __forceinline__ float hi(T2 x) { return __high2float(x); }
};

template <typename T2>
__device__ __forceinline__ uint32_t as_u32(T2 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; src_bytes 0 zero-fills without reading
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 2^x, flushing results below 2^-126 to 0 (2^-inf = 0: a row whose lse is
// +inf saw no key and gets P = 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (16 x 8, f32) += a (16 x 16) * b (16 x 8)
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&d)[4],
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<__half>(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout of m16n8k16 (PTX ISA): lane = 4 * grp + tig. An f32
// accumulator holds rows grp (c0, c1) and grp + 8 (c2, c3) at columns
// 2 * tig + {0, 1}; an A operand holds the same rows at columns
// 2 * tig + {0, 1} (a0 / a1) and 2 * tig + 8 + {0, 1} (a2 / a3). So the
// accumulators of two neighbouring 8-column tiles, packed in pairs, are
// the A operand of a product that reduces over those 16 columns.

// The A operand (hi and lo halves, T) of the 16 columns 16 kc .. 16 kc + 15
// of a 16-row f32 fragment x[n][4] (8 columns each)
template <typename T, int N>
__device__ __forceinline__ void split_a(const float (&x)[N][4], int kc,
                                        uint32_t (&xh)[4], uint32_t (&xl)[4]) {
  using P2 = Pair<T>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // i: (columns + 0 | + 8) x (row grp | grp + 8)
    const float x0 = x[2 * kc + i / 2][2 * (i % 2)];
    const float x1 = x[2 * kc + i / 2][2 * (i % 2) + 1];
    const auto h = P2::pack(x0, x1);
    xh[i] = as_u32(h);
    xl[i] = as_u32(P2::pack(x0 - P2::lo(h), x1 - P2::hi(h)));
  }
}

// Shared tiles: [ROWS][HD] in T as 64-column panels of 128-byte rows, the
// 16-byte chunk c of row r at c ^ (r % 8) within its row (wgmma's 128-byte
// swizzle); a tile takes ROWS x pad64(HD) x 2 bytes (hd 80 and 96: two
// panels, the second partly used). Byte offset of chunk c (8 elements) of
// row r:
__host__ __device__ constexpr int pad64(int hd) { return (hd + 63) / 64 * 64; }

template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// copy rows [r0, r0 + ROWS) of one operand (row stride `stride`) into a
// swizzled tile at dst; rows past S are zero-filled. ROWS x HD / 8 chunks
// in passes of NT threads, the last partial where NT does not divide them
// (hd 80)
template <typename T, int HD, int ROWS, int NT>
__device__ __forceinline__ void copy_tile(uint32_t dst, const T* src,
                                          long long stride, int r0, int S) {
  constexpr int CH = HD / 8;            // 16-byte chunks a row
#pragma unroll
  for (int p = 0; p < (ROWS * CH + NT - 1) / NT; ++p) {
    const int idx = p * NT + threadIdx.x;
    if (ROWS * CH % NT != 0 && idx >= ROWS * CH) break;
    const int r = idx / CH, c = idx % CH;
    const bool ok = r0 + r < S;
    cp_async16(dst + swz<ROWS>(r, c),
               ok ? src + (long long)(r0 + r) * stride + c * 8 : src,
               ok ? 16 : 0);
  }
}

// This lane's part of an ldmatrix x4 address in a swizzled tile: its row
// (byte offset) and the xor of its chunk. Pattern A (rows lane % 16,
// chunk lane / 16) reads a 16 x 16 A operand, or with .trans a B operand
// whose reduction runs over the tile's rows; pattern B (rows lane % 8 +
// 8 (lane / 16), chunk (lane / 8) % 2) reads the B operands of two
// 8-row n-tiles whose reduction runs over the tile's columns.
struct Lane {
  uint32_t row, x;
};
__device__ __forceinline__ Lane lane_a(int lane) {
  return Lane{(uint32_t)(lane % 16) * 128,
              (uint32_t)(((lane / 16) ^ (lane % 8)) << 4)};
}
__device__ __forceinline__ Lane lane_b(int lane) {
  return Lane{(uint32_t)(lane % 8 + (lane / 16) * 8) * 128,
              (uint32_t)((((lane / 8) % 2) ^ (lane % 8)) << 4)};
}
// address of the 16 x 16 block at rows r0 (a multiple of 8) and columns
// c0 (a multiple of 16) of a swizzled [ROWS][HD] tile
template <int ROWS>
__device__ __forceinline__ uint32_t tile_addr(uint32_t tile, Lane l, int r0,
                                             int c0) {
  const int c = c0 / 8;                 // even: the lane's chunk adds 0 or 1
  return tile + (uint32_t)((c >> 3) * ROWS * 128 + r0 * 128) + l.row +
         ((uint32_t)((c & 7) << 4) ^ l.x);
}

// ---- (a) dQ (and D) of one (b, head, 64-row query tile)
template <int HD> struct DqCfg {
  static constexpr int NT = 128;        // 4 warps, 16 query rows each
  static constexpr int BQ = 64;
  static constexpr int BK = HD <= 64 ? 64 : 32;   // keys a tile
  static constexpr int NS = HD <= 64 ? 3 : 2;      // K / V ring stages
  static constexpr uint32_t Q_BYTES = BQ * pad64(HD) * 2;
  static constexpr uint32_t K_BYTES = BK * pad64(HD) * 2;
  static constexpr size_t SMEM = 2 * Q_BYTES + 2 * NS * K_BYTES;
};

template <typename T, int HD>
__global__ void __launch_bounds__(DqCfg<HD>::NT, 1)
dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, T* __restrict__ dq, Strides qs,
              Strides ks, Strides vs, Strides os, Strides dos, Strides dqs,
              int H, int G, int S, int n_qt, int causal, int window,
              float scale, float scale_log2, int n_sm) {
  using C = DqCfg<HD>;
  using P2 = Pair<T>;
  constexpr int BK = C::BK, NS = C::NS;
  constexpr int NKT = BK / 8;           // 8-key score tiles
  constexpr int NDT = HD / 8;           // 8-dim dQ tiles
  extern __shared__ __align__(128) unsigned char smem_q[];
  const uint32_t q_s = smem_u32(smem_q), do_s = q_s + C::Q_BYTES;
  const uint32_t k_s = do_s + C::Q_BYTES, v_s = k_s + NS * C::K_BYTES;

  // One block per (query tile, batch row, head), the longest causal walks
  // (the last query tiles) first, in rounds of n_sm with every other
  // round reversed (as K4's forward)
  const int n_items = gridDim.x;
  const int rnd = blockIdx.x / n_sm, in_rnd = blockIdx.x % n_sm;
  const int rnd_len = min(n_sm, n_items - rnd * n_sm);
  const int item = rnd * n_sm + (rnd % 2 ? rnd_len - 1 - in_rnd : in_rnd);
  const int BH = n_items / n_qt;
  const int qt = n_qt - 1 - item / BH;
  const int b = item % BH / H;
  const int h = item % H;
  const int hk = h / G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int q0 = qt * C::BQ;
  const int n_rows = min(C::BQ, S - q0);

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const T* ob = o + b * os.b + h * os.h;

  // the key tiles any row of this block can see: from t_first to k_hi
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(S, q0 + n_rows) : S;
  const int t_first = (k_lo / BK) * BK;
  const int n_tiles = (k_hi - t_first + BK - 1) / BK;

  // Q and dO: group 0; K / V tile i of the walk: group i + 1, ring slot
  // i % NS (groups past the walk's end are empty, so the count stays
  // uniform)
  copy_tile<T, HD, C::BQ, C::NT>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, S);
  copy_tile<T, HD, C::BQ, C::NT>(do_s, dob, dos.s, q0, S);
  cp_async_commit();
  auto stage_tile = [&](int i, int slot) {
    if (i < n_tiles) {
      copy_tile<T, HD, BK, C::NT>(k_s + slot * C::K_BYTES, kb, ks.s,
                                  t_first + i * BK, S);
      copy_tile<T, HD, BK, C::NT>(v_s + slot * C::K_BYTES, vb, vs.s,
                                  t_first + i * BK, S);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) stage_tile(i, i);

  const int row0 = warp * 16;           // this warp's first row in the tile
  const int r_a = q0 + row0 + grp, r_b = r_a + 8;
  const int wp_first = q0 + row0;
  const int wp_last = q0 + min(row0 + 16, n_rows) - 1;
  const bool warp_live = row0 < n_rows;

  // D for this warp's 16 rows: each lane takes dims 64 m + 2 lane +
  // {0, 1} of every row (O's loads all issued while Q and dO land; at hd
  // 80 and 96 only lanes 0-7 or 0-15 have dims in the second 64), then a
  // butterfly per row: every lane holds the same sum. Written out for
  // (b); rows grp and grp + 8 kept.
  constexpr int NM = pad64(HD) / 64;
  auto has = [&](int m) { return HD % 64 == 0 || 64 * m + 2 * lane < HD; };
  typename P2::T2 ov[16][NM];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int m = 0; m < NM; ++m)
      ov[r][m] = q0 + row0 + r < S && has(m)
                     ? *reinterpret_cast<const typename P2::T2*>(
                           ob + (long long)(q0 + row0 + r) * os.s + 64 * m +
                           2 * lane)
                     : P2::pack(0.f, 0.f);
  cp_async_wait<NS - 1>();              // Q and dO have landed (this thread's)
  __syncthreads();                      // ... everyone's
  float d_a = 0.f, d_b = 0.f;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      if (!has(m)) continue;
      const int d = 64 * m + 2 * lane;
      const auto dv = *reinterpret_cast<const typename P2::T2*>(
          smem_q + C::Q_BYTES + swz<C::BQ>(row0 + r, d / 8) + (d % 8) * 2);
      acc = fmaf(P2::lo(ov[r][m]), P2::lo(dv), acc);
      acc = fmaf(P2::hi(ov[r][m]), P2::hi(dv), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0 && q0 + row0 + r < S)
      delta[((long long)b * H + h) * S + q0 + row0 + r] = acc;
    if (grp == r % 8) {
      if (r < 8) d_a = acc;
      else d_b = acc;
    }
  }
  // -lse in the log2 domain; rows past S are masked
  const float* lb = lse + ((long long)b * H + h) * S;
  const float nl_a = r_a < S ? -lb[r_a] * LOG2E : 0.f;
  const float nl_b = r_b < S ? -lb[r_b] * LOG2E : 0.f;

  const Lane la = lane_a(lane), lbn = lane_b(lane);
  float acc[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int slot = 0;                         // it % NS
  for (int it = 0; it < n_tiles; ++it, slot = slot + 1 == NS ? 0 : slot + 1) {
    cp_async_wait<NS - 2>();            // tile it has landed (this thread's part)
    __syncthreads();                    // ... everyone's; slot it - 1 is free
    stage_tile(it + NS - 1, slot == 0 ? NS - 1 : slot - 1);
    const int t0 = t_first + it * BK;
    const uint32_t kt = k_s + slot * C::K_BYTES, vt = v_s + slot * C::K_BYTES;
    // skip (warp-uniformly) a tile none of this warp's rows can see
    if (!warp_live || (causal && t0 > wp_last) ||
        (window && t0 + BK - 1 <= wp_first - window))
      continue;
    // every key of the tile visible to every row of this warp: no mask
    const bool interior = t0 + BK <= S && wp_last < S &&
                          (!causal || t0 + BK - 1 <= wp_first) &&
                          (!window || t0 > wp_last - window);
    // S = Q K^T and dP = dO V^T: s[j], dp[j] cover keys t0 + 8 j + 2 tig
    float s[NKT][4], dp[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t qf[4], of[4];
      ldsm_x4(tile_addr<C::BQ>(q_s, la, row0, 16 * kc), qf);
      ldsm_x4(tile_addr<C::BQ>(do_s, la, row0, 16 * kc), of);
#pragma unroll
      for (int jp = 0; jp < NKT / 2; ++jp) {
        uint32_t kf[4], vf[4];
        ldsm_x4(tile_addr<BK>(kt, lbn, 16 * jp, 16 * kc), kf);
        ldsm_x4(tile_addr<BK>(vt, lbn, 16 * jp, 16 * kc), vf);
        mma<T>(s[2 * jp], qf, kf[0], kf[1]);
        mma<T>(s[2 * jp + 1], qf, kf[2], kf[3]);
        mma<T>(dp[2 * jp], of, vf[0], vf[1]);
        mma<T>(dp[2 * jp + 1], of, vf[2], vf[3]);
      }
    }
    // P = 2^(s scale log2 e - lse log2 e), dS = P (dP - D), in s and dp
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(fmaf(s[j][e], scale_log2, e < 2 ? nl_a : nl_b));
        if (!interior &&
            !visible(e < 2 ? r_a : r_b, t0 + 8 * j + 2 * tig + (e & 1), S,
                     causal, window))
          p = 0.f;
        dp[j][e] = p * (dp[j][e] - (e < 2 ? d_a : d_b));
      }
    }
    // dQ += dS K, dS = hi + lo, both halves exact in T
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t sh[4], sl[4];
      split_a<T>(dp, kc, sh, sl);
#pragma unroll
      for (int dt = 0; dt < NDT / 2; ++dt) {
        uint32_t kf[4];
        ldsm_x4_t(tile_addr<BK>(kt, la, 16 * kc, 16 * dt), kf);
        mma<T>(acc[2 * dt], sh, kf[0], kf[1]);
        mma<T>(acc[2 * dt + 1], sh, kf[2], kf[3]);
        mma<T>(acc[2 * dt], sl, kf[0], kf[1]);
        mma<T>(acc[2 * dt + 1], sl, kf[2], kf[3]);
      }
    }
  }
  cp_async_wait<0>();

  if (!warp_live) return;
  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int j = 0; j < NDT; ++j) {
    const int d = 8 * j + 2 * tig;
    if (r_a < S)
      *reinterpret_cast<typename P2::T2*>(dqb + (long long)r_a * dqs.s + d) =
          P2::pack(acc[j][0] * scale, acc[j][1] * scale);
    if (r_b < S)
      *reinterpret_cast<typename P2::T2*>(dqb + (long long)r_b * dqs.s + d) =
          P2::pack(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// ---- (b) dK and dV of one (b, kv head, 32-key tile)
template <int HD> struct DkdvCfg {
  static constexpr int KG = 2;          // 16-key groups a block
  static constexpr int DS = HD <= 96 ? 1 : 2;      // warps sharing a group
  static constexpr int SPLIT = 2;       // item streams a block
  static constexpr int NT = 32 * KG * DS * SPLIT;
  static constexpr int BKV = 16 * KG;   // keys a block
  static constexpr int BQ = HD <= 64 ? 64 : 32;    // queries an item
  static constexpr int HDW = HD / DS;   // dK / dV head dims a warp keeps
  static constexpr int NS = 2;          // ring stages (SPLIT items each)
  static constexpr uint32_t KV_BYTES = BKV * pad64(HD) * 2;
  static constexpr uint32_t Q_BYTES = BQ * pad64(HD) * 2;
  // K, V; then the ring's Q / dO tiles [NS][SPLIT][2]; then its lse / D
  // rows, f32 [NS][SPLIT][2][BQ]
  static constexpr uint32_t LSD_OFF = 2 * KV_BYTES + NS * SPLIT * 2 * Q_BYTES;
  static constexpr size_t SMEM = LSD_OFF + NS * SPLIT * 2 * BQ * 4;
  // the odd stream's dK / dV handed to the even one (over the ring)
  static_assert(32 * KG * HD * 4 <= NS * SPLIT * 2 * Q_BYTES,
                "the ring holds the odd stream's partial sums");
};

template <typename T, int HD>
__global__ void __launch_bounds__(DkdvCfg<HD>::NT, 1)
dkdv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, Strides qs, Strides ks,
                Strides vs, Strides dos, Strides dks, Strides dvs, int H,
                int Hkv, int G, int S, int n_kt, int causal, int window,
                float scale, float scale_log2, int n_sm) {
  using C = DkdvCfg<HD>;
  using P2 = Pair<T>;
  constexpr int BQ = C::BQ, BKV = C::BKV, HDW = C::HDW, NS = C::NS;
  constexpr int SPLIT = C::SPLIT;
  static_assert(SPLIT == 2, "the odd stream's sums go into the even one's");
  constexpr int NQT = BQ / 8;           // 8-query score tiles
  constexpr int NDT = HDW / 8;          // 8-dim dK / dV tiles a warp keeps
  extern __shared__ __align__(128) unsigned char smem_kv[];
  const uint32_t k_s = smem_u32(smem_kv), v_s = k_s + C::KV_BYTES;
  const uint32_t ring = v_s + C::KV_BYTES;
  float* lsd = reinterpret_cast<float*>(smem_kv + C::LSD_OFF);

  // One block per (key tile, batch row, kv head). Under causal masking
  // every query row sees key tile 0 and the last tile only its own rows,
  // so the low key tiles are the heaviest: they start first, in rounds of
  // n_sm with every other round reversed.
  const int n_items = gridDim.x;
  const int rnd = blockIdx.x / n_sm, in_rnd = blockIdx.x % n_sm;
  const int rnd_len = min(n_sm, n_items - rnd * n_sm);
  const int item = rnd * n_sm + (rnd % 2 ? rnd_len - 1 - in_rnd : in_rnd);
  const int BH = n_items / n_kt;        // batch rows x kv heads
  const int kt = item / BH;
  const int b = item % BH / Hkv;
  const int hk = item % Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int kg = warp % C::KG;          // this warp's 16-key group,
  const int dh = warp / C::KG % C::DS;  // its part of the head dims,
  const int sp = warp / (C::KG * C::DS);   // its item stream
  const int k0 = kt * BKV;
  const int kf = k0 + 16 * kg;          // this warp's first key
  const int kl = min(kf + 15, S - 1);   // ... and its last that exists
  const int key_a = kf + grp, key_b = key_a + 8;

  // the query rows that can see a key of this tile: [i_lo, i_hi); its
  // items: (head g of the group, query tile), t = g * nq + tile
  const int k_last = min(S, k0 + BKV) - 1;
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window ? min(S, k_last + window) : S;
  const int qt_lo = i_lo / BQ;
  const int nq = (i_hi + BQ - 1) / BQ - qt_lo;
  const int n_work = G * nq;
  const int n_it = (n_work + SPLIT - 1) / SPLIT;

  copy_tile<T, HD, BKV, C::NT>(k_s, k + b * ks.b + hk * ks.h, ks.s, k0, S);
  copy_tile<T, HD, BKV, C::NT>(v_s, v + b * vs.b + hk * vs.h, vs.s, k0, S);
  // items SPLIT it .. SPLIT it + SPLIT - 1 into ring slot `slot`: Q, dO,
  // lse and D rows (one copy group per stage, empty past the end)
  auto stage_items = [&](int it, int slot) {
#pragma unroll
    for (int s = 0; s < SPLIT; ++s) {
      const int t = it * SPLIT + s;
      if (t < n_work) {
        const int h = hk * G + t / nq;
        const int q0 = (qt_lo + t % nq) * BQ;
        const uint32_t dst = ring + (slot * SPLIT + s) * 2 * C::Q_BYTES;
        copy_tile<T, HD, BQ, C::NT>(dst, q + b * qs.b + h * qs.h, qs.s, q0, S);
        copy_tile<T, HD, BQ, C::NT>(dst + C::Q_BYTES,
                                    dout + b * dos.b + h * dos.h, dos.s, q0,
                                    S);
        float* ld = lsd + (slot * SPLIT + s) * 2 * BQ;
        const long long row = ((long long)b * H + h) * S;
        for (int i = threadIdx.x; i < 2 * BQ; i += C::NT) {
          const int r = i % BQ;
          const bool ok = q0 + r < S;
          const float* src = (i < BQ ? lse : delta) + row + (ok ? q0 + r : 0);
          cp_async4(smem_u32(ld + i), src, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
  stage_items(0, 0);                    // K and V join stage 0's group
#pragma unroll
  for (int i = 1; i < NS - 1; ++i) stage_items(i, i);

  const Lane la = lane_a(lane), lbn = lane_b(lane);
  float dka[NDT][4], dva[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  int slot = 0;                         // it % NS
  for (int it = 0; it < n_it; ++it, slot = slot + 1 == NS ? 0 : slot + 1) {
    cp_async_wait<NS - 2>();            // stage it has landed (this thread's)
    __syncthreads();                    // ... everyone's; slot it - 1 is free
    stage_items(it + NS - 1, slot == 0 ? NS - 1 : slot - 1);
    const int t = it * SPLIT + sp;
    if (t >= n_work) continue;
    const int q0 = (qt_lo + t % nq) * BQ;
    const int ql = min(q0 + BQ, S) - 1;
    // skip (warp-uniformly) an item none of this warp's keys is seen by
    if (kf >= S || (causal && ql < kf) || (window && kl <= q0 - window))
      continue;
    // every pair of keys and queries visible: no mask
    const bool interior = kf + 15 < S && q0 + BQ <= S &&
                          (!causal || kf + 15 <= q0) &&
                          (!window || kf > ql - window);
    const uint32_t qt_s = ring + (slot * SPLIT + sp) * 2 * C::Q_BYTES;
    const uint32_t dot_s = qt_s + C::Q_BYTES;
    const float* ls = lsd + (slot * SPLIT + sp) * 2 * BQ;
    const float* Ds = ls + BQ;
    // S^T = K Q^T and dP^T = V dO^T: st[j], dpt[j] cover queries
    // q0 + 8 j + 2 tig + {0, 1} at keys key_a (c0, c1) and key_b (c2, c3)
    float st[NQT][4], dpt[NQT][4];
#pragma unroll
    for (int j = 0; j < NQT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t kf4[4], vf4[4];
      ldsm_x4(tile_addr<BKV>(k_s, la, 16 * kg, 16 * kc), kf4);
      ldsm_x4(tile_addr<BKV>(v_s, la, 16 * kg, 16 * kc), vf4);
#pragma unroll
      for (int jp = 0; jp < NQT / 2; ++jp) {
        uint32_t qf[4], of[4];
        ldsm_x4(tile_addr<BQ>(qt_s, lbn, 16 * jp, 16 * kc), qf);
        ldsm_x4(tile_addr<BQ>(dot_s, lbn, 16 * jp, 16 * kc), of);
        mma<T>(st[2 * jp], kf4, qf[0], qf[1]);
        mma<T>(st[2 * jp + 1], kf4, qf[2], qf[3]);
        mma<T>(dpt[2 * jp], vf4, of[0], of[1]);
        mma<T>(dpt[2 * jp + 1], vf4, of[2], of[3]);
      }
    }
    // P^T and dS^T = P^T (dP^T - D), lse and D by column
#pragma unroll
    for (int j = 0; j < NQT; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * tig);
      const float2 d2 = *reinterpret_cast<const float2*>(Ds + 8 * j + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        float p = exp2_ftz(fmaf(st[j][e], scale_log2,
                                -(c ? l2.y : l2.x) * LOG2E));
        if (!interior &&
            !visible(q0 + 8 * j + 2 * tig + c, e < 2 ? key_a : key_b, S,
                     causal, window))
          p = 0.f;
        dpt[j][e] = p * (dpt[j][e] - (c ? d2.y : d2.x));
        st[j][e] = p;
      }
    }
    // dV += P^T dO and dK += dS^T Q over the item's queries, each f32
    // operand as hi + lo
#pragma unroll
    for (int qc = 0; qc < BQ / 16; ++qc) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      split_a<T>(st, qc, ph, pl);
      split_a<T>(dpt, qc, sh, sl);
#pragma unroll
      for (int dt = 0; dt < NDT / 2; ++dt) {
        uint32_t of[4], qf[4];
        ldsm_x4_t(tile_addr<BQ>(dot_s, la, 16 * qc, dh * HDW + 16 * dt), of);
        ldsm_x4_t(tile_addr<BQ>(qt_s, la, 16 * qc, dh * HDW + 16 * dt), qf);
        mma<T>(dva[2 * dt], ph, of[0], of[1]);
        mma<T>(dva[2 * dt + 1], ph, of[2], of[3]);
        mma<T>(dka[2 * dt], sh, qf[0], qf[1]);
        mma<T>(dka[2 * dt + 1], sh, qf[2], qf[3]);
        mma<T>(dva[2 * dt], pl, of[0], of[1]);
        mma<T>(dva[2 * dt + 1], pl, of[2], of[3]);
        mma<T>(dka[2 * dt], sl, qf[0], qf[1]);
        mma<T>(dka[2 * dt + 1], sl, qf[2], qf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free

  // the odd stream's sums go into the even one's (lane-contiguous, one
  // f32 a lane per register), which adds them and writes dK and dV
  constexpr int NF = NDT * 4;           // floats of one accumulator a lane
  float* part = reinterpret_cast<float*>(smem_kv + 2 * C::KV_BYTES) +
                (kg * C::DS + dh) * 2 * NF * 32 + lane;
  if (sp == 1) {
#pragma unroll
    for (int j = 0; j < NDT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[(4 * j + e) * 32] = dka[j][e];
        part[(NF + 4 * j + e) * 32] = dva[j][e];
      }
  }
  __syncthreads();
  if (sp == 1) return;
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[j][e] += part[(4 * j + e) * 32];
      dva[j][e] += part[(NF + 4 * j + e) * 32];
    }
  T* dkb = dk + b * dks.b + hk * dks.h;
  T* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int j = 0; j < NDT; ++j) {
    const int d = dh * HDW + 8 * j + 2 * tig;
    if (key_a < S) {
      *reinterpret_cast<typename P2::T2*>(dkb + (long long)key_a * dks.s + d) =
          P2::pack(dka[j][0] * scale, dka[j][1] * scale);
      *reinterpret_cast<typename P2::T2*>(dvb + (long long)key_a * dvs.s + d) =
          P2::pack(dva[j][0], dva[j][1]);
    }
    if (key_b < S) {
      *reinterpret_cast<typename P2::T2*>(dkb + (long long)key_b * dks.s + d) =
          P2::pack(dka[j][2] * scale, dka[j][3] * scale);
      *reinterpret_cast<typename P2::T2*>(dvb + (long long)key_b * dvs.s + d) =
          P2::pack(dva[j][2], dva[j][3]);
    }
  }
}

// ------------------------------------------------------------------------
// CUDA-core body: f32 (T = float).
// ------------------------------------------------------------------------
constexpr int BQ = 32;   // query rows a tile
constexpr int BK = 32;   // keys a tile
constexpr int NT = 256;  // threads a block
constexpr int PAD = 4;   // floats of padding a shared row (16 bytes)
constexpr int LDP = BK + PAD;  // row of the P / dS tiles

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
    if (r0 + r < S) x = src[(long long)(r0 + r) * stride + d];
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
    acc = fmaf(orow[d], drow[d], acc);
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
  constexpr int NTJ = NT / DC;          // threads along the keys
  // keys a thread accumulates (hd 80 and 96: 12 or 10 key groups of 3 or
  // 4 keys cover the 32, the last group partly; the threads past them
  // only stage and score)
  constexpr int KPT = (BK + NTJ - 1) / NTJ;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                     // [BK][LD]
  float* Vs = Ks + BK * LD;             // [BK][LD]
  float* Qs = Vs + BK * LD;             // [BQ][LD]
  float* dOs = Qs + BQ * LD;            // [BQ][LD]
  float* Ps = dOs + BQ * LD;            // [BQ][LDP]
  float* dSs = Ps + BQ * LDP;           // [BQ][LDP]
  float* lse_s = dSs + BQ * LDP;        // [BQ]
  float* D_s = lse_s + BQ;              // [BQ]

  // causal: every query row sees key tile 0, so the low tiles are the
  // heaviest and start first
  const int kt = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * BK;
  const int tid = threadIdx.x;
  const int td = tid % DC, tj = tid / DC;
  // this thread's keys tj KPT + c, c < n_acc (none past the tile)
  const int n_acc = tj < NTJ ? min(KPT, BK - tj * KPT) : 0;

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
          if (c >= n_acc) break;
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
    if (c >= n_acc || j >= S) continue;
    T* kr = dk + b * dks.b + hk * dks.h + j * dks.s + 4 * td;
    T* vr = dv + b * dvs.b + hk * dvs.h + j * dvs.s + 4 * td;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kr[e] = acc_k[c][e];
      vr[e] = acc_v[c][e];
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
  constexpr int NTI = NT / DC;          // threads along the rows
  constexpr int RPT = (BQ + NTI - 1) / NTI;   // rows a thread accumulates
                                              // (the last group partly)
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
  const int n_acc = ti < NTI ? min(RPT, BQ - ti * RPT) : 0;

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
        if (r >= n_acc) break;
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
    if (r >= n_acc || i >= S) continue;
    T* qr = dq + b * dqs.b + h * dqs.h + i * dqs.s + 4 * td;
#pragma unroll
    for (int e = 0; e < 4; ++e) qr[e] = acc[r][e];
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
int launch_mma(const Args& a, cudaStream_t stream) {
  using QC = DqCfg<HD>;
  using KC = DkdvCfg<HD>;
  static int n_sm = 0;
  if (n_sm == 0) {
    cudaFuncSetAttribute(dq_mma_kernel<T, HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)QC::SMEM);
    cudaFuncSetAttribute(dkdv_mma_kernel<T, HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)KC::SMEM);
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  const int G = a.H / a.Hkv;
  const float scale_log2 = a.scale * 1.4426950408889634f;
  const int n_qt = (a.S + QC::BQ - 1) / QC::BQ;
  dq_mma_kernel<T, HD><<<n_qt * a.B * a.H, QC::NT, QC::SMEM, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq),
      a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, a.H, G, a.S, n_qt, a.causal,
      a.window, a.scale, scale_log2, n_sm);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int n_kt = (a.S + KC::BKV - 1) / KC::BKV;
  dkdv_mma_kernel<T, HD><<<n_kt * a.B * a.Hkv, KC::NT, KC::SMEM, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.qs, a.ks,
      a.vs, a.dos, a.dks, a.dvs, a.H, a.Hkv, G, a.S, n_kt, a.causal,
      a.window, a.scale, scale_log2, n_sm);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const Args& a, cudaStream_t stream) {
  using T = float;
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
  if (dtype == 0) return launch_f32<HD>;
  if (dtype == 1) return launch_mma<__nv_bfloat16, HD>;
  if (dtype == 2) return launch_mma<__half, HD>;
  return nullptr;
}

LaunchFn pick(int dtype, int HD) {
  if (HD == 32) return pick_hd<32>(dtype);
  if (HD == 64) return pick_hd<64>(dtype);
  if (HD == 80) return pick_hd<80>(dtype);
  if (HD == 96) return pick_hd<96>(dtype);
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
// checked shapes, dtypes, H % Hkv == 0, hd in {32, 64, 80, 96, 128, 256} and
// S >= 1.
// For bf16 / f16 the caller has also checked 16-byte aligned pointers and
// strides. Two launches on the stream (three for f32); returns the first
// non-zero cudaGetLastError(), else 0.
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
