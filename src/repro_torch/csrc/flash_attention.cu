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
// What bounds it on this card. At Qwen2.5's shapes (hd 64, S <= 1024) the
// work is a few hundred MFLOP against a few MB of Q, K, V and O: a
// microsecond or two of either. What sets the time is latency: each block
// walks its key tiles one after the other, each tile a chain of copy, MMA,
// softmax and MMA, and the longest walk (the last causal query tile) ends
// the call. What the design does about it, for bf16 and f16 inputs (the
// main path's types):
//   - Both products run on tensor cores (mma.sync m16n8k16, f32 sums),
//     their operands fed from shared memory by ldmatrix. QK^T multiplies
//     bf16 by bf16 (or f16 by f16): exact products, so only the order of
//     the f32 sums differs from the plain version.
//   - PV keeps the f32 probabilities. Each p is split into hi = T(p) and
//     lo = T(p - hi) and both halves go through the tensor cores against
//     the V tile, which is exact in its own type; the residual is about
//     2^-16 p (bf16) and 2^-22 p (f16), far below the output's rounding.
//   - A block of 4 warps owns 64 query rows of one head, 16 per warp; the
//     scores, the running max and sum and the output accumulator stay in
//     registers in the MMA fragment layout, and the probabilities go from
//     the score fragments straight into the A operand of PV. The softmax
//     runs in the log2 domain (scale * log2(e) folded into one multiply,
//     ex2.approx), and tiles every row of a warp sees whole skip the mask.
//   - K/V tiles of 64 keys are staged in their own type with 16-byte
//     cp.async in a ring of 3 (2 at hd 128): two tiles' copies are in
//     flight while one is used, and one barrier a tile frees the oldest
//     slot. Rows are padded by 16 bytes so ldmatrix reads no bank twice; a
//     k-chunk's fragments are all loaded before its MMAs, and PV's hi and lo
//     products are ordered so no MMA waits on the one before.
//   - Causal and window bounds cut the walk; a warp skips a tile none of
//     its rows can see. The blocks run the heaviest causal query tiles
//     first, in rounds of one block an SM, every other round reversed, so
//     the second wave pairs heavy tiles with light ones.
//   - Any S works: rows and keys past S are zero-filled by the copy and
//     masked in-kernel.
// Inputs are read and the output written through their strides (head dim
// contiguous, 16-byte aligned rows; the wrapper checks), so the caller's
// [B, S, H, hd] projections need no transpose copy.
//
// f32 inputs, which only the tests pass, take a CUDA-core body of their
// own (f32 has no exact tensor-core product): a block of 4 warps owns 32
// rows, 8 per warp in registers, over 32-key tiles converted into shared
// memory. This is dispatch by type: a bf16 or f16 call never takes it.
// The TPU version's 128 x 128 blocking and (bq, 128) replicated m / l
// scratch are not carried over; wgmma and TMA are left for later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;   // the reference's NEG_INF

struct Strides {  // element strides of the batch, head and sequence dims
  long long b, h, s;
};

// ------------------------------------------------------------------------
// Tensor-core body: bf16 / f16.
// ------------------------------------------------------------------------
constexpr int MQ = 64;          // query rows per block (16 per warp)
constexpr int MK = 64;          // keys per tile
constexpr int MW = 4;           // warps per block
constexpr int MT = 32 * MW;     // threads per block
static_assert(MQ == MK, "Q and K / V tiles are copied by one routine");

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

// 16 bytes global -> shared; src_bytes 0 zero-fills without reading
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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

// 2^x, flushing results below 2^-126 to 0 (probabilities relative to the
// running max: those add nothing)
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
// 2 * tig + {0, 1} (a0 / a1) and 2 * tig + 8 + {0, 1} (a2 / a3).
// copy stages of the K / V ring: three at hd 64 (64 KB of shared memory),
// two at hd 128 (the tests' width; 122 KB would leave one block an SM)
template <int HD> __host__ __device__ constexpr int stages() {
  return HD == 64 ? 3 : 2;
}
template <typename T, int HD> constexpr size_t mma_smem() {
  return sizeof(T) * (size_t)(MQ + 2 * stages<HD>() * MK) * (HD + 8);
}

template <typename T, int HD>
__global__ void __launch_bounds__(MT)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int H, int G, int S,
                 int n_qt, int causal, int window, float scale_log2, int n_sm) {
  using P2 = Pair<T>;
  constexpr int LD = HD + 8;            // padded row (elements)
  constexpr int CH = HD / 8;            // 16-byte chunks per row
  constexpr int NKT = MK / 8;           // 8-key score tiles per warp
  constexpr int NDT = HD / 8;           // 8-wide output tiles per warp
  constexpr int NS = stages<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [MQ][LD]
  T* Ks = Qs + MQ * LD;                     // [NS][MK][LD]
  T* Vs = Ks + NS * MK * LD;                // [NS][MK][LD]

  // One block per (query tile, batch row, head), heaviest causal query
  // tiles first. Blocks start on the SMs in rounds of n_sm; every other
  // round takes its items in reverse, so an SM that got a heavy tile in
  // one round gets a light one in the next and the SMs' loads even out.
  const int n_items = gridDim.x;
  const int rnd = blockIdx.x / n_sm, in_rnd = blockIdx.x % n_sm;
  const int rnd_len = min(n_sm, n_items - rnd * n_sm);
  const int item = rnd * n_sm +
                   (rnd % 2 ? rnd_len - 1 - in_rnd : in_rnd);
  const int BH = n_items / n_qt;        // batch rows x heads
  const int qt = n_qt - 1 - item / BH;
  const int b = item % BH / H;
  const int h = item % H;
  const int hk = h / G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;
  const int q0 = qt * MQ;
  const int n_rows = min(MQ, S - q0);

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  // the key tiles any row of this block can see: from t_first to k_hi
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(S, q0 + n_rows) : S;
  const int t_first = (k_lo / MK) * MK;
  const int n_tiles = (k_hi - t_first + MK - 1) / MK;

  // Copies: a pass of the block's threads covers RPP rows of a tile, each
  // thread one 16-byte chunk at a fixed (row, column) of the pass.
  constexpr int RPP = MT / CH;
  constexpr uint32_t TILE = MK * LD * sizeof(T);      // bytes of a tile
  const int st_r = tid / CH, st_c = (tid % CH) * 8;
  const uint32_t st_off = (st_r * LD + st_c) * sizeof(T);
  // copy rows [r0, r0 + 64) of one operand into the tile at dst
  auto stage = [&](uint32_t dst, const T* src, long long stride, int r0) {
    const T* g = src + (long long)(r0 + st_r) * stride + st_c;
#pragma unroll
    for (int p = 0; p < MK / RPP; ++p) {
      const bool ok = r0 + st_r + p * RPP < S;
      cp_async16(dst + st_off + p * RPP * LD * sizeof(T), ok ? g : src,
                 ok ? 16 : 0);
      g += RPP * stride;
    }
  };
  const uint32_t q_s = smem_u32(Qs), k_s = smem_u32(Ks), v_s = smem_u32(Vs);
  // tile i of the walk into ring slot i % NS, one copy group per tile
  // (empty past the walk's end, so the group count stays uniform)
  auto stage_tile = [&](int i, int slot) {
    if (i < n_tiles) {
      stage(k_s + slot * TILE, kb, ks.s, t_first + i * MK);
      stage(v_s + slot * TILE, vb, vs.s, t_first + i * MK);
    }
    cp_async_commit();
  };
  stage(q_s, qb, qs.s, q0);             // Q joins tile 0's group
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) stage_tile(i, i);

  const int row0 = warp * 16;           // this warp's first row in the tile
  const int r_a = q0 + row0 + grp;      // positions of this thread's rows
  const int r_b = r_a + 8;
  const int wp_first = q0 + row0;
  const int wp_last = q0 + min(row0 + 16, n_rows) - 1;
  const bool warp_live = row0 < n_rows;
  // this lane's ldmatrix row addresses (bytes) within a Q, K or V tile
  const uint32_t q_ld = q_s + ((row0 + lane % 16) * LD + (lane / 16) * 8) * sizeof(T);
  const uint32_t k_ld = ((lane % 8 + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8) *
                        sizeof(T);
  const uint32_t v_ld = ((lane % 16) * LD + (lane / 16) * 8) * sizeof(T);

  uint32_t qa[HD / 16][4];
  float acc[NDT][4];
  // running max (log2 domain: scores times scale * log2(e)) and this
  // thread's share of the running sum, for rows r_a and r_b
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int slot = 0;                         // it % NS
  for (int it = 0; it < n_tiles; ++it, slot = slot + 1 == NS ? 0 : slot + 1) {
    cp_async_wait<NS - 2>();            // tile it has landed (this thread's part)
    __syncthreads();                    // ... everyone's; slot it - 1 is free
    stage_tile(it + NS - 1, slot == 0 ? NS - 1 : slot - 1);
    if (it == 0) {                      // Q fragments, once
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) ldsm_x4(q_ld + kc * 16 * sizeof(T), qa[kc]);
    }
    const int t0 = t_first + it * MK;
    const uint32_t kt = k_s + slot * TILE + k_ld;
    const uint32_t vt = v_s + slot * TILE + v_ld;
    // skip (warp-uniformly) a tile none of this warp's rows can see
    if (!warp_live || (causal && t0 > wp_last) ||
        (window && t0 + MK - 1 <= wp_first - window))
      continue;
    // every key of the tile visible to every row of this warp: no mask
    const bool interior = t0 + MK <= S && wp_last < S &&
                          (!causal || t0 + MK - 1 <= wp_first) &&
                          (!window || t0 > wp_last - window);
    // scores: s[j] covers keys t0 + 8 j + 2 tig + {0, 1}
    float s[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t kf[NKT / 2][4];          // this k-chunk's K fragments, first
#pragma unroll
      for (int jp = 0; jp < NKT / 2; ++jp)
        ldsm_x4(kt + (jp * 16 * LD + kc * 16) * sizeof(T), kf[jp]);
#pragma unroll
      for (int jp = 0; jp < NKT / 2; ++jp) {
        mma<T>(s[2 * jp], qa[kc], kf[jp][0], kf[jp][1]);
        mma<T>(s[2 * jp + 1], qa[kc], kf[jp][2], kf[jp][3]);
      }
    }
    // scale into the log2 domain, mask, running max over the row's quad
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale_log2;
        if (!interior) {
          const int kp = t0 + 8 * j + 2 * tig + (e & 1);
          const int qp = e < 2 ? r_a : r_b;
          const bool vis = kp < S && qp < S && (!causal || kp <= qp) &&
                           (!window || kp > qp - window);
          if (!vis) s[j][e] = NEG;
        }
      }
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2_ftz(m_a - mn_a), al_b = exp2_ftz(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    // a row that has seen nothing yet keeps max NEG: offset its masked
    // scores by 0 instead, so they give 2^NEG = 0, not 2^0
    const float mu_a = mn_a == NEG ? 0.f : mn_a;
    const float mu_b = mn_b == NEG ? 0.f : mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      s[j][0] = exp2_ftz(s[j][0] - mu_a);
      s[j][1] = exp2_ftz(s[j][1] - mu_a);
      s[j][2] = exp2_ftz(s[j][2] - mu_b);
      s[j][3] = exp2_ftz(s[j][3] - mu_b);
      ps_a += s[j][0] + s[j][1];
      ps_b += s[j][2] + s[j][3];
    }
    l_a = l_a * al_a + ps_a;
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      acc[j][0] *= al_a;
      acc[j][1] *= al_a;
      acc[j][2] *= al_b;
      acc[j][3] *= al_b;
    }
    // acc += p @ V, p = hi + lo, both halves exact in T
#pragma unroll
    for (int kc = 0; kc < MK / 16; ++kc) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        // x: (keys 16 kc + {0..7} | +8) x (row grp | grp + 8)
        const float p0 = s[2 * kc + x / 2][2 * (x % 2)];
        const float p1 = s[2 * kc + x / 2][2 * (x % 2) + 1];
        const auto hi = P2::pack(p0, p1);
        const auto lo = P2::pack(p0 - P2::lo(hi), p1 - P2::hi(hi));
        ph[x] = as_u32(hi);
        pl[x] = as_u32(lo);
      }
      uint32_t vf[NDT / 2][4];          // this key-chunk's V fragments
#pragma unroll
      for (int dp = 0; dp < NDT / 2; ++dp)
        ldsm_x4_t(vt + (kc * 16 * LD + dp * 16) * sizeof(T), vf[dp]);
      // the hi products, then the lo ones: no MMA waits on the one before
#pragma unroll
      for (int dp = 0; dp < NDT / 2; ++dp) {
        mma<T>(acc[2 * dp], ph, vf[dp][0], vf[dp][1]);
        mma<T>(acc[2 * dp + 1], ph, vf[dp][2], vf[dp][3]);
      }
#pragma unroll
      for (int dp = 0; dp < NDT / 2; ++dp) {
        mma<T>(acc[2 * dp], pl, vf[dp][0], vf[dp][1]);
        mma<T>(acc[2 * dp + 1], pl, vf[dp][2], vf[dp][3]);
      }
    }
  }
  cp_async_wait<0>();                   // (no tile: Q's copy still lands)

  // the row sums: the quad's four shares
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  if (!warp_live) return;
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
  for (int j = 0; j < NDT; ++j) {
    const int d = 8 * j + 2 * tig;
    if (r_a < S)
      *reinterpret_cast<typename P2::T2*>(ob + r_a * os.s + d) =
          P2::pack(acc[j][0] * inv_a, acc[j][1] * inv_a);
    if (r_b < S)
      *reinterpret_cast<typename P2::T2*>(ob + r_b * os.s + d) =
          P2::pack(acc[j][2] * inv_b, acc[j][3] * inv_b);
  }
}

template <typename T, int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
               int Hkv, int S, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = mma_smem<T, HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(flash_mma_kernel<T, HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    attr_set = true;
  }
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  const int n_qt = (S + MQ - 1) / MQ;
  flash_mma_kernel<T, HD><<<n_qt * B * H, MT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, H,
      H / Hkv, S, n_qt, causal, window, scale * 1.4426950408889634f, n_sm);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// CUDA-core body: f32.
// ------------------------------------------------------------------------
constexpr int BQ = 32;          // query rows per block
constexpr int KT = 32;          // keys per tile (one per lane)
constexpr int NW = 4;           // warps per block
constexpr int RW = BQ / NW;     // rows per warp, held in registers
constexpr int NT = 32 * NW;     // threads per block
constexpr int KTP = KT + 1;     // padded row of the transposed K tile

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

template <int HD>
__global__ void __launch_bounds__(NT)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Strides qs, Strides ks, Strides vs, Strides os, int G, int S,
                 int causal, int window, float scale) {
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

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    Qs[i] = r < n_rows ? qb[(q0 + r) * qs.s + d] : 0.f;
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
        kv = kb[kp * ks.s + d];
        vv = vb[kp * vs.s + d];
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
    float* orow = ob + (q0 + row0 + r) * os.s;
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) orow[lane + 32 * j] = acc[r][j] * inv;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
               int Hkv, int S, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BQ * HD + KT * HD + NW * RW * KT + HD * KTP);
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(flash_f32_kernel<HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    attr_set = true;
  }
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_f32_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os,
      H / Hkv, S, causal, window, scale);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, const void*, void*, Strides,
                         Strides, Strides, Strides, int, int, int, int, int,
                         int, float, cudaStream_t);

LaunchFn pick(int dtype, int HD) {
  if (HD != 64 && HD != 128) return nullptr;
  const bool wide = HD == 128;
  if (dtype == 0) return wide ? launch_f32<128> : launch_f32<64>;
  if (dtype == 1)
    return wide ? launch_mma<__nv_bfloat16, 128> : launch_mma<__nv_bfloat16, 64>;
  if (dtype == 2) return wide ? launch_mma<__half, 128> : launch_mma<__half, 64>;
  return nullptr;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 f32, 1 bf16, 2 f16 (q,
// k, v and o alike). Strides are in elements for the batch, head and
// sequence dims; the head dim is contiguous. The caller has checked shapes,
// dtypes, H % Hkv == 0, hd in {64, 128}, S >= 1 and, for bf16 / f16,
// 16-byte aligned pointers and strides. Returns cudaGetLastError().
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, int B, int H, int Hkv, int S, int HD, int dtype, int causal,
    int window, float scale, int device, void* stream) {
  cudaSetDevice(device);
  const LaunchFn fn = pick(dtype, HD);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, k, v, o, Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss},
            Strides{vsb, vsh, vss}, Strides{osb, osh, oss}, B, H, Hkv, S,
            causal, window, scale, static_cast<cudaStream_t>(stream));
}
