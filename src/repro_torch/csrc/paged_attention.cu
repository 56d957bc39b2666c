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
//   out[b, c, h, g, :] = softmax_t(q · k[t] * scale | visible) @ v[t]
// with an online softmax (f32 m / l / acc); a row that sees nothing gives
// exactly 0 (p is forced to 0 for masked keys and l == 0 flushes to 1), as
// in the reference `chunk_visibility_ref` / `paged_attention_chunk_ref`.
//
// What bounds it on this card: the bytes of the pages it reads (int8 codes
// plus f32 scale strips) against HBM — about 2*hd + 8 bytes per key and head
// — and, at this simple design, latency, since the grid is only B*Hkv
// blocks. What the design does about it: codes cross HBM as int8 and are
// dequantized into shared memory tile by tile (32 keys per tile, gathered
// through the page table, which the block reads itself); the query rows,
// running max / sum and accumulators stay in shared memory for the whole
// loop, so nothing but the output is written back. The loop stops at the
// last key any row can see (pos[b, 0] + C), so stale table tails beyond it
// are never read; a table entry outside the pool is treated as masked.
// Splitting the keys over more blocks (flash-decoding), tensor cores and
// asynchronous copies are left for later work. The TPU version's row
// padding to 8 and its 128-lane replicated m/l scratch are not carried
// over: C·G = 7·C rows work as they are.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KT = 32;          // keys per tile (one per lane)
constexpr int NT = 256;         // threads per block (8 warps)
constexpr float NEG = -1e30f;   // the reference's NEG_INF

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
paged_attn_kernel(const float* __restrict__ q, const int8_t* __restrict__ k_pool,
                  const float* __restrict__ ks, const int8_t* __restrict__ v_pool,
                  const float* __restrict__ vs, const int32_t* __restrict__ table,
                  const int32_t* __restrict__ pos, const int32_t* __restrict__ rpos,
                  const uint8_t* __restrict__ amask, float* __restrict__ out,
                  int C, int Hkv, int G, int P, int n_blocks, int num_pages,
                  int window, float scale) {
  extern __shared__ float smem[];
  const int R = C * G;
  float* Qs = smem;                    // [R][HD]
  float* Acc = Qs + R * HD;            // [R][HD]
  float* Ms = Acc + R * HD;            // [R]
  float* Ls = Ms + R;                  // [R]
  float* Ks = Ls + R;                  // [KT][HD + 1] (padded: no bank conflicts)
  float* Vs = Ks + KT * (HD + 1);      // [KT][HD]
  int* kok = reinterpret_cast<int*>(Vs + KT * HD);  // [KT] key readable

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < R * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int c = r / G, g = r % G;
    Qs[i] = q[(((size_t)(b * C + c) * Hkv + h) * G + g) * HD + d];
    Acc[i] = 0.f;
  }
  for (int i = tid; i < R; i += NT) {
    Ms[i] = NEG;
    Ls[i] = 0.f;
  }
  const int base = pos[b * C];
  // no row sees a key at or beyond base + C: in-span keys end there and
  // committed keys sit below base
  const int n_keys = max(0, min(n_blocks * P, base + C));
  __syncthreads();

  for (int t0 = 0; t0 < n_keys; t0 += KT) {
    // stage 32 keys: int8 codes -> f32 in shared memory, 4 codes per step
    for (int i = tid; i < KT * (HD / 4); i += NT) {
      const int kk = i / (HD / 4);
      const int d4 = (i % (HD / 4)) * 4;
      const int kp = t0 + kk;
      bool ok = kp < n_keys;
      int phys = 0;
      if (ok) {
        phys = table[(size_t)b * n_blocks + kp / P];
        ok = phys >= 0 && phys < num_pages;
      }
      float k4[4] = {0.f, 0.f, 0.f, 0.f}, v4[4] = {0.f, 0.f, 0.f, 0.f};
      if (ok) {
        const size_t row = ((size_t)phys * P + kp % P) * Hkv + h;
        const char4 kc = *reinterpret_cast<const char4*>(k_pool + row * HD + d4);
        const char4 vc = *reinterpret_cast<const char4*>(v_pool + row * HD + d4);
        const float sk = ks[row], sv = vs[row];
        k4[0] = (float)kc.x * sk; k4[1] = (float)kc.y * sk;
        k4[2] = (float)kc.z * sk; k4[3] = (float)kc.w * sk;
        v4[0] = (float)vc.x * sv; v4[1] = (float)vc.y * sv;
        v4[2] = (float)vc.z * sv; v4[3] = (float)vc.w * sv;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Ks[kk * (HD + 1) + d4 + e] = k4[e];
        Vs[kk * HD + d4 + e] = v4[e];
      }
      if (d4 == 0) kok[kk] = ok;
    }
    __syncthreads();

    // one warp per query row; lane = key of the tile
    for (int r = warp; r < R; r += NT / 32) {
      const int c = r / G;
      const int qp = pos[b * C + c];
      const int kp = t0 + lane;
      bool vis = false;
      if (qp >= 0 && kok[lane]) {
        const bool committed =
            kp < base && (window == 0 || kp > rpos[b * C + c] - window);
        const int t = kp - base;
        const bool in_span =
            t >= 0 && t < C && amask[((size_t)b * C + c) * C + t] != 0;
        vis = committed || in_span;
      }
      float s = NEG;
      if (vis) {
        float dot = 0.f;
        const float* qr = Qs + r * HD;
        const float* kr = Ks + lane * (HD + 1);
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float alpha = expf(m_old - m_new);
      const float p = vis ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      float a[HD / 32];
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) a[j] = Acc[r * HD + lane + 32 * j] * alpha;
#pragma unroll 8
      for (int kk = 0; kk < KT; ++kk) {
        const float pk = __shfl_sync(0xffffffffu, p, kk);
#pragma unroll
        for (int j = 0; j < HD / 32; ++j) a[j] = fmaf(pk, Vs[kk * HD + lane + 32 * j], a[j]);
      }
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) Acc[r * HD + lane + 32 * j] = a[j];
      __syncwarp();
      if (lane == 0) {
        Ms[r] = m_new;
        Ls[r] = Ls[r] * alpha + psum;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < R * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int c = r / G, g = r % G;
    const float l = Ls[r] == 0.f ? 1.f : Ls[r];
    out[(((size_t)(b * C + c) * Hkv + h) * G + g) * HD + d] = Acc[i] / l;
  }
}

template <int HD>
int launch(const void* q, const void* k_pool, const void* ks,
           const void* v_pool, const void* vs, const void* table,
           const void* pos, const void* rpos, const void* amask, void* out,
           int B, int C, int Hkv, int G, int P, int n_blocks, int num_pages,
           int window, float scale, cudaStream_t stream) {
  const int R = C * G;
  const size_t smem = sizeof(float) *
      ((size_t)2 * R * HD + 2 * R + KT * (HD + 1) + KT * HD + KT);
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(paged_attn_kernel<HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    attr_set = true;
  }
  dim3 grid(B, Hkv);
  paged_attn_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k_pool),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v_pool),
      static_cast<const float*>(vs), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(rpos),
      static_cast<const uint8_t*>(amask), static_cast<float*>(out),
      C, Hkv, G, P, n_blocks, num_pages, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). The caller has checked shapes,
// dtypes and contiguity, hd in {64, 128}, and that the dynamic shared
// memory (4 * (2*C*G*hd + 2*C*G + 32*(2*hd + 2)) bytes) fits in 227 KB.
// Returns cudaGetLastError().
extern "C" int paged_attention_chunk_f32(
    const void* q, const void* k_pool, const void* ks, const void* v_pool,
    const void* vs, const void* table, const void* pos, const void* rpos,
    const void* amask, void* out, int B, int C, int Hkv, int G, int HD, int P,
    int n_blocks, int num_pages, int window, float scale, int device,
    void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HD == 64)
    return launch<64>(q, k_pool, ks, v_pool, vs, table, pos, rpos, amask, out,
                      B, C, Hkv, G, P, n_blocks, num_pages, window, scale, s);
  if (HD == 128)
    return launch<128>(q, k_pool, ks, v_pool, vs, table, pos, rpos, amask, out,
                       B, C, Hkv, G, P, n_blocks, num_pages, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
