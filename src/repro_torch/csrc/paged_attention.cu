// K2 — fused int8 dequant + multi-query masked attention over KV pages,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention_chunk`
// (src/repro/kernels/paged_attention.py, body `_paged_attn_kernel`). For
// every batch row b and kv head h, the C·G query rows of the chunk
// (row r = chunk token r / G, group r % G) attend over the slot's pages:
//   k[t] = k_codes[table[b, t / P], t % P, h, :] * ks[...]   (f32 dequant)
//   visible(r, t) = pos[b, c] >= 0 and
//       (t < pos[b, 0] and (window == 0 or t > rpos[b, c] - window))   committed
//    or (0 <= t - pos[b, 0] < C and amask[b, c, t - pos[b, 0]])          in span
// where a null amask stands for the default: in-span token j is visible to
// query c iff j <= c, pos[b, j] >= 0 and (window == 0 or j > c - window)
//   out[b, c, h, g, :] = softmax_t(q · k[t] * scale | visible) @ v[t]
// in f32; a row that sees nothing gives exactly 0, as in the reference
// `chunk_visibility_ref` / `paged_attention_chunk_ref`.
//
// What bounds it on this card: the bytes of the pages it reads (int8 codes
// plus f32 scale strips, about 2*hd + 8 bytes per key and head) and the
// f32 operations (4*hd per visible query-key pair and head, on the CUDA
// cores: q is f32) both take well under a microsecond at the serving
// engine's shapes, so what holds it back is parallelism and latency: a
// block that walks its keys serially, or one warp that does a block's work
// while the others wait. What the design does about it:
//   - The keys are split over blocks (flash-decoding). A block takes one
//     slot b, one kv head h, one span of SPAN = 128 keys and a group of RW
//     = 8 of the C·G query rows: grid (spans, B * Hkv, row groups). The
//     span length is fixed, so a slot's split points depend only on its own
//     pos[b, 0] + C, and a row's result does not depend on the other slots
//     of the batch. Spans past the slot's last visible key exit at once, as
//     do row groups of padding queries only.
//   - Inside a block the 4 warps split the span again, 32 keys each, and
//     all work on the group's 8 rows at once (registers: 8 scores a lane,
//     lane = key; 8 x hd / 32 accumulators, lane = output dim), so every K
//     or V value read from shared memory feeds 8 rows. A warp's 32 keys are
//     one tile, so its softmax is taken once, with no running rescale; the
//     block then merges its warps in key order in shared memory.
//   - Each lane gathers its own key's int8 codes through the page table
//     with 16-byte cp.async, K and V as two copy groups: the scores run
//     while V's codes land. The codes are dequantized where they are used:
//     K in the score loop, with the key scale applied after the dot
//     product (s = ks * (q . codes)); V as code * scale, the plain
//     version's rounding. K's 16-byte chunks are stored permuted within
//     the key's row (an XOR swizzle; a rotation at hd 96), so the lanes'
//     reads of their own keys hit no bank twice.
//   - Each block writes its rows' partial (m, l, acc) to f32 scratch that
//     the wrapper allocates; a second kernel merges the partials of each
//     row in span order (no atomics), so the output is bit-identical from
//     run to run and a row that sees nothing in any span gives exactly 0.
// The walk stops at the last key any row can see (pos[b, 0] + C), so stale
// table tails beyond it are never read; a table entry outside the pool is
// treated as masked. The TPU version's row padding to 8 and its 128-lane
// replicated m / l scratch are not carried over: C·G = 7·C rows work as
// they are. Tensor cores (for a bf16 pool) are left for later work.
// Head dims 32, 64, 96, 128 and 256 are built (32: glm4-9b's smoke config,
// one output dim a lane; 96: phi-3-vision's, each lane keeps 3 of a row's
// output dims). At 256 a block holds 8 x 8 f32
// accumulators a lane and needs about 109 KB of shared memory (two blocks
// an SM); the query rows of any group size (G 3 to 16 in the registered
// models) tile the same way, 8 of the C·G rows a block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPAN = 128;       // keys per block (split point spacing)
constexpr int NW = 4;           // warps per block
constexpr int KW = SPAN / NW;   // keys per warp (one per lane)
constexpr int RW = 8;           // query rows per block, in registers
constexpr int NT = 32 * NW;     // threads per block
constexpr int MT = 256;         // threads per merge block
constexpr float NEG = -1e30f;   // the reference's NEG_INF
static_assert(KW == 32, "a warp takes one key per lane");

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies; src_bytes 0 zero-fills without reading
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

// the keys rows of slot b can see at all: [0, n_keys)
__device__ __forceinline__ int slot_keys(const int32_t* pos, int b, int C,
                                         int n_blocks, int P) {
  return max(0, min(n_blocks * P, pos[b * C] + C));
}

// A key's row of K codes is HD / 16 chunks of 16 bytes; chunk c of key t is
// stored at chunk chunk_at(c, t) of the row, a permutation of the row's chunks
// chosen so that the 8 lanes of a quarter warp, each reading chunk c of its
// own key, hit 8 different 16-byte bank groups (of the 8 in 128 bytes). At
// hd 32 (2 chunks a key) four keys share 128 bytes: keys t .. t + 3 start
// in groups 2 t mod 8 (0, 2, 4, 6 for t % 8 < 4), keys t + 4 .. t + 7 in
// the same four, so c ^ (t / 4) % 2 moves the second four to the odd
// groups (1, 3, 5, 7) for either c. At hd 64 (4 chunks a key) two keys
// share 128 bytes, so it is c ^ (t / 2) % 4;
// at hd 128 and 256 (8 and 16 chunks) a key's row spans whole bank rows, so
// chunk c of every key falls in bank group c % 8 and it is c ^ t % 8. At hd
// 96 (6 chunks, not a power of two) an XOR would leave the row (5 ^ 2 = 7):
// there keys t and t + 4 start in the same bank group (6 t mod 8), and a
// rotation by one chunk for t / 4 odd, (c + (t / 4) % 2) % 6, parts them.
template <int HD>
__device__ __forceinline__ int chunk_at(int c, int t) {
  constexpr int CH = HD / 16;
  if constexpr (CH == 6) return (c + (t / 4) % 2) % CH;
  else if constexpr (CH >= 8) return c ^ (t % 8);
  else return c ^ ((t / (8 / CH)) % CH);
}

template <int HD>
constexpr size_t partial_smem() {
  return sizeof(float) * ((size_t)RW * HD + 2 * SPAN + NW * RW * KW +
                          2 * NW * RW + NW * RW * HD) +
         sizeof(int) * 2 * RW + 2 * (size_t)SPAN * HD;
}

template <int HD>
__global__ void __launch_bounds__(NT)
paged_partial_kernel(const float* __restrict__ q,
                     const int8_t* __restrict__ k_pool,
                     const float* __restrict__ ks,
                     const int8_t* __restrict__ v_pool,
                     const float* __restrict__ vs,
                     const int32_t* __restrict__ table,
                     const int32_t* __restrict__ pos,
                     const int32_t* __restrict__ rpos,
                     const uint8_t* __restrict__ amask,
                     float* __restrict__ part_ml, float* __restrict__ part_acc,
                     int B, int C, int Hkv, int G, int P, int n_blocks,
                     int num_pages, int window, float scale) {
  constexpr int CH = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // [RW][HD]
  float* Ksc = Qs + RW * HD;            // [SPAN] key scales
  float* Vsc = Ksc + SPAN;              // [SPAN] value scales
  float* Ps = Vsc + SPAN;               // [NW][RW][KW] probabilities
  float* Wm = Ps + NW * RW * KW;        // [NW][RW] each warp's max
  float* Wl = Wm + NW * RW;             // [NW][RW] each warp's sum
  float* Wacc = Wl + NW * RW;           // [NW][RW][HD] each warp's acc
  int* Rq = reinterpret_cast<int*>(Wacc + NW * RW * HD);  // [RW] query pos
  int* Rr = Rq + RW;                    // [RW] logical position
  int8_t* Kc = reinterpret_cast<int8_t*>(Rr + RW);        // [SPAN][HD]
  int8_t* Vc = Kc + SPAN * HD;          // [SPAN][HD]

  const int span = blockIdx.x;
  const int b = blockIdx.y / Hkv;
  const int h = blockIdx.y % Hkv;
  const int r0 = blockIdx.z * RW;       // the group's first row
  const int R = C * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int base = pos[b * C];
  const int n_keys = slot_keys(pos, b, C, n_blocks, P);
  const int k_begin = span * SPAN;
  if (k_begin >= n_keys) return;        // nothing of this slot here
  const int k_end = min(k_begin + SPAN, n_keys);

  int live = 0;
  if (tid < RW) {
    const int row = r0 + tid;
    int qp = -1, rp = -1;
    if (row < R) {
      qp = pos[b * C + row / G];
      rp = rpos[b * C + row / G];
    }
    Rq[tid] = qp;
    Rr[tid] = rp;
    live = qp >= 0;
  }
  if (!__syncthreads_or(live)) return;  // padding queries only

  // each lane gathers its own key's codes and scales through the page
  // table: K first, then V, as two copy groups
  const int key = warp * KW + lane;     // index in the span
  const int kp = k_begin + key;         // position in the slot
  bool ok = kp < k_end;
  long long prow = 0;
  if (ok) {
    const int phys = table[(size_t)b * n_blocks + kp / P];
    ok = phys >= 0 && phys < num_pages;
    prow = ((long long)phys * P + kp % P) * Hkv + h;
  }
  const long long src = ok ? prow : 0;
  const int nb = ok ? 16 : 0;
#pragma unroll
  for (int c = 0; c < CH; ++c)
    cp_async16(smem_u32(Kc + key * HD + chunk_at<HD>(c, key) * 16),
               k_pool + src * HD + c * 16, nb);
  cp_async4(smem_u32(Ksc + key), ks + src, ok ? 4 : 0);
  cp_async_commit();
#pragma unroll
  for (int c = 0; c < CH; ++c)
    cp_async16(smem_u32(Vc + key * HD + c * 16), v_pool + src * HD + c * 16, nb);
  cp_async4(smem_u32(Vsc + key), vs + src, ok ? 4 : 0);
  cp_async_commit();

  for (int i = tid; i < RW * HD / 4; i += NT) {
    const int r = i / (HD / 4), d4 = (i % (HD / 4)) * 4;
    const int row = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < R) {
      const int c = row / G, g = row % G;
      x = *reinterpret_cast<const float4*>(
          q + (((size_t)(b * C + c) * Hkv + h) * G + g) * HD + d4);
    }
    *reinterpret_cast<float4*>(Qs + r * HD + d4) = x;
  }
  __syncthreads();                      // Qs

  float m[RW], l[RW], acc[RW][HD / 32];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) acc[r][j] = 0.f;
  }
  float* Pw = Ps + warp * RW * KW;
  if (k_begin + warp * KW < k_end) {    // this warp has keys (uniform)
    // scores: lane = key; codes read as 16 bytes, converted where used
    cp_async_wait<1>();                 // this lane's K copies
    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int4 raw =
          *reinterpret_cast<const int4*>(Kc + key * HD + chunk_at<HD>(c, key) * 16);
      const int w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float kf[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          kf[e] = (float)(int8_t)((unsigned)w4[w] >> (8 * e));
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(Qs + r * HD + c * 16 + w * 4);
          s[r] = fmaf(qv.x, kf[0], s[r]);
          s[r] = fmaf(qv.y, kf[1], s[r]);
          s[r] = fmaf(qv.z, kf[2], s[r]);
          s[r] = fmaf(qv.w, kf[3], s[r]);
        }
      }
    }
    // visibility; the key scale applies after the dot product
    const float sk = Ksc[key];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int qp = Rq[r];
      bool vis = false;
      if (qp >= 0 && ok) {
        const int c = (r0 + r) / G;
        const bool committed = kp < base && (window == 0 || kp > Rr[r] - window);
        const int t = kp - base;
        bool in_span = t >= 0 && t < C;
        if (in_span)  // the ancestor mask, or by default causal in the chunk
          in_span = amask ? amask[((size_t)b * C + c) * C + t] != 0
                          : t <= c && pos[b * C + t] >= 0 &&
                                (window == 0 || t > c - window);
        vis = committed || in_span;
      }
      const float sc = vis ? sk * s[r] * scale : NEG;
      m[r] = warp_max(sc);
      const float p = vis ? expf(sc - m[r]) : 0.f;
      l[r] = warp_sum(p);
      Pw[r * KW + lane] = p;
    }
    cp_async_wait<0>();                 // this lane's V copies
    __syncwarp();                       // ... and every lane's, and Pw
    // acc += p @ V: lane owns dims lane + 32 j
#pragma unroll 2
    for (int kk = 0; kk < KW; kk += 4) {
      float vr[4][HD / 32];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = warp * KW + kk + e;
        const float sv = Vsc[t];
#pragma unroll
        for (int j = 0; j < HD / 32; ++j)
          vr[e][j] = (float)Vc[t * HD + lane + 32 * j] * sv;
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(Pw + r * KW + kk);
#pragma unroll
        for (int j = 0; j < HD / 32; ++j) {
          acc[r][j] = fmaf(p4.x, vr[0][j], acc[r][j]);
          acc[r][j] = fmaf(p4.y, vr[1][j], acc[r][j]);
          acc[r][j] = fmaf(p4.z, vr[2][j], acc[r][j]);
          acc[r][j] = fmaf(p4.w, vr[3][j], acc[r][j]);
        }
      }
    }
  } else {
    cp_async_wait<0>();
  }
  // the block's partial: its 4 warps (keys in order) merged in order
#pragma unroll
  for (int r = 0; r < RW; ++r) {
#pragma unroll
    for (int j = 0; j < HD / 32; ++j)
      Wacc[(warp * RW + r) * HD + lane + 32 * j] = acc[r][j];
    if (lane == 0) {
      Wm[warp * RW + r] = m[r];
      Wl[warp * RW + r] = l[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < RW * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int row = r0 + r;
    if (row >= R || Rq[r] < 0) continue;  // padding rows: the merge writes 0
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, Wm[w * RW + r]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(Wm[w * RW + r] - mx);
      sum = fmaf(Wl[w * RW + r], e, sum);
      a = fmaf(Wacc[(w * RW + r) * HD + d], e, a);
    }
    const size_t idx = (((size_t)span * B + b) * Hkv + h) * R + row;
    part_acc[idx * HD + d] = a;
    if (d == 0) {
      part_ml[2 * idx] = mx;
      part_ml[2 * idx + 1] = sum;
    }
  }
}

// One thread per output element: combine the row's span partials in span
// order, out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M).
template <int HD>
__global__ void __launch_bounds__(MT)
paged_merge_kernel(const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc,
                   const int32_t* __restrict__ pos, float* __restrict__ out,
                   int B, int C, int Hkv, int G, int P, int n_blocks) {
  const int R = C * G;
  const int i = blockIdx.x * MT + threadIdx.x;
  if (i >= R * HD) return;
  const int row = i / HD, d = i % HD;
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const int c = row / G, g = row % G;
  float* o = out + (((size_t)(b * C + c) * Hkv + h) * G + g) * HD + d;
  const int n_span = (slot_keys(pos, b, C, n_blocks, P) + SPAN - 1) / SPAN;
  if (pos[b * C + c] < 0 || n_span == 0) {
    *o = 0.f;
    return;
  }
  const size_t stride = (size_t)B * Hkv * R;      // between spans
  const size_t idx0 = ((size_t)b * Hkv + h) * R + row;
  float mx = NEG;
  for (int s = 0; s < n_span; ++s) mx = fmaxf(mx, part_ml[2 * (idx0 + s * stride)]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n_span; ++s) {
    const size_t idx = idx0 + s * stride;
    const float w = expf(part_ml[2 * idx] - mx);
    l = fmaf(part_ml[2 * idx + 1], w, l);
    a = fmaf(part_acc[idx * HD + d], w, a);
  }
  *o = a / (l == 0.f ? 1.f : l);
}

template <int HD>
int launch(const void* q, const void* k_pool, const void* ks,
           const void* v_pool, const void* vs, const void* table,
           const void* pos, const void* rpos, const void* amask, void* out,
           void* part_ml, void* part_acc, int B, int C, int Hkv, int G, int P,
           int n_blocks, int num_pages, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = partial_smem<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(paged_partial_kernel<HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    attr_set = true;
  }
  const int R = C * G;
  const int n_span = (n_blocks * P + SPAN - 1) / SPAN;
  dim3 grid(n_span, B * Hkv, (R + RW - 1) / RW);
  paged_partial_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k_pool),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v_pool),
      static_cast<const float*>(vs), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(rpos),
      static_cast<const uint8_t*>(amask), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), B, C, Hkv, G, P, n_blocks, num_pages,
      window, scale);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dim3 mgrid((R * HD + MT - 1) / MT, B * Hkv);
  paged_merge_kernel<HD><<<mgrid, MT, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<const int32_t*>(pos), static_cast<float*>(out), B, C, Hkv,
      G, P, n_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes): the partial pass, then the
// merge pass, on one stream. amask may be null (the default in-span rule). The caller has checked shapes, dtypes and
// contiguity, hd in {32, 64, 96, 128, 256} and the grid's limits, and passes f32
// scratch of ceil(n_blocks * P / 128) * B * Hkv * C * G rows: part_ml
// (m, l: 2 floats a row) and part_acc (hd floats a row). Returns
// cudaGetLastError().
extern "C" int paged_attention_chunk_f32(
    const void* q, const void* k_pool, const void* ks, const void* v_pool,
    const void* vs, const void* table, const void* pos, const void* rpos,
    const void* amask, void* out, void* part_ml, void* part_acc, int B, int C,
    int Hkv, int G, int HD, int P, int n_blocks, int num_pages, int window,
    float scale, int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HD == 32)
    return launch<32>(q, k_pool, ks, v_pool, vs, table, pos, rpos, amask, out,
                      part_ml, part_acc, B, C, Hkv, G, P, n_blocks, num_pages,
                      window, scale, s);
  if (HD == 64)
    return launch<64>(q, k_pool, ks, v_pool, vs, table, pos, rpos, amask, out,
                      part_ml, part_acc, B, C, Hkv, G, P, n_blocks, num_pages,
                      window, scale, s);
  if (HD == 96)
    return launch<96>(q, k_pool, ks, v_pool, vs, table, pos, rpos, amask, out,
                      part_ml, part_acc, B, C, Hkv, G, P, n_blocks, num_pages,
                      window, scale, s);
  if (HD == 128)
    return launch<128>(q, k_pool, ks, v_pool, vs, table, pos, rpos, amask, out,
                       part_ml, part_acc, B, C, Hkv, G, P, n_blocks, num_pages,
                       window, scale, s);
  if (HD == 256)
    return launch<256>(q, k_pool, ks, v_pool, vs, table, pos, rpos, amask, out,
                       part_ml, part_acc, B, C, Hkv, G, P, n_blocks, num_pages,
                       window, scale, s);
  return (int)cudaErrorInvalidValue;
}
