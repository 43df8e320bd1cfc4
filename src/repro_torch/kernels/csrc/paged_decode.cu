// Paged decode attention for Hopper (sm_90a), two entry points on one body.
//
// Replaces: src/repro/kernels/paged_attention.py::batched_paged_decode_attention
// (Pallas body _batched_kernel; entry batched_paged_decode_launch) and
// src/repro/kernels/paged_attention.py::paged_decode_attention (Pallas
// body _paged_kernel; entry paged_decode_launch). One decode token per
// sequence attends the shared page pool through its page table. The
// batched form folds the current token's K/V (k_new/v_new, not yet in
// the pool) in as a trailing virtual token, so the kernel never reads a
// page the same-step scatter writes, and trims the page loop to
// n_page_steps; the per-sequence form (kFused = false) attends the
// resident seq_len tokens only, over every page they fill. Optional
// logit softcap. Float32 scores, softmax and sums.
//
// What bounds it on this card: bytes. Each (sequence, kv head) streams
// its K/V once, seq_len * D * 2 values, and does 4 * group FLOPs per
// value read: far under the H100's ~295 FLOP/byte ridge. At the
// engine's shapes (8 sequences, 3 kv heads, D 64, a few hundred tokens)
// the whole call moves well under a megabyte, so launch latency, not
// bandwidth, is the floor.
//
// What the design does about it: one block per (sequence, kv head)
// walks that sequence's pages in a loop — the sequential page axis of
// the Pallas grid becomes a loop inside the block, with the online
// softmax state (m, l, acc) in shared memory. A block stages one
// 16-token K/V tile at a time in shared memory and all `group` query
// heads of the kv head share it (the GQA fold). The loop bound is
// min(n_page_steps, ceil(seq_len / page)) pages: no page-table entry
// past a sequence's end is ever read, not even to form an address, and
// an inactive slot (seq_len 0) reads no page at all. Simple and right
// first; splitting pages across blocks (flash-decoding), vector loads
// and tensor-core products are later work (a (B, Hk) grid fills 24 of
// the 132 SMs at the engine's shapes). In the per-sequence form a
// seq_len of 0 reads no page and writes zeros.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 16;  // tokens staged per step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,        // [B, H, D]
                            const T* __restrict__ kp,       // [n_pages, P, Hk, D]
                            const T* __restrict__ vp,
                            const int* __restrict__ page_table,  // [B, pps]
                            const int* __restrict__ seq_lens,    // [B]
                            const T* __restrict__ k_new,    // [B, Hk, D]
                            const T* __restrict__ v_new,
                            T* __restrict__ out,            // [B, H, D]
                            int H, int Hk, int D, int P, int pps,
                            int n_page_steps, float scale, float softcap) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int group = H / Hk;
  const int tid = threadIdx.x;
  const int DS = D + 1;  // padded K row stride: no bank conflicts in q.k

  extern __shared__ float smem[];
  float* qs = smem;                     // [group][D]  scaled query
  float* ks = qs + group * D;           // [kTile][DS]
  float* vs = ks + kTile * DS;          // [kTile][D]
  float* sc = vs + kTile * D;           // [group][kTile] scores, then p
  float* acc = sc + group * kTile;      // [group][D]
  float* m = acc + group * D;           // [group] running max
  float* l = m + group;                 // [group] running mass
  float* corr = l + group;              // [group] rescale of this step

  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    qs[i] = to_f32(q[((size_t)b * H + h * group + g) * D + d]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  const int seq_len = max(seq_lens[b], 0);
  const int steps = min(n_page_steps, (seq_len + P - 1) / P);
  const int kv_len = min(seq_len, steps * P);  // pool tokens attended
  const int total = kv_len + (kFused ? 1 : 0); // + the fused new token
  __syncthreads();

  for (int t0 = 0; t0 < total; t0 += kTile) {
    const int n = min(kTile, total - t0);
    for (int i = tid; i < n * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      const int tok = t0 + t;
      float kx, vx;
      if (!kFused || tok < kv_len) {
        const int page = page_table[(size_t)b * pps + tok / P];
        const size_t off = (((size_t)page * P + tok % P) * Hk + h) * D + d;
        kx = to_f32(kp[off]);
        vx = to_f32(vp[off]);
      } else {
        const size_t off = ((size_t)b * Hk + h) * D + d;
        kx = to_f32(k_new[off]);
        vx = to_f32(v_new[off]);
      }
      ks[t * DS + d] = kx;
      vs[t * D + d] = vx;
    }
    __syncthreads();

    for (int i = tid; i < group * n; i += kThreads) {
      const int g = i / n, t = i - g * n;
      const float* qr = qs + g * D;
      const float* kr = ks + t * DS;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      sc[g * kTile + t] = s;
    }
    __syncthreads();

    // online softmax: every tile holds >= 1 valid token, so m_new is finite
    for (int g = tid; g < group; g += kThreads) {
      float mx = -INFINITY;
      for (int t = 0; t < n; ++t) mx = fmaxf(mx, sc[g * kTile + t]);
      const float m_new = fmaxf(m[g], mx);
      float sum = 0.f;
      for (int t = 0; t < n; ++t) {
        const float p = expf(sc[g * kTile + t] - m_new);
        sc[g * kTile + t] = p;
        sum += p;
      }
      const float c = expf(m[g] - m_new);  // exp(-inf) = 0 on the first tile
      l[g] = l[g] * c + sum;
      m[g] = m_new;
      corr[g] = c;
    }
    __syncthreads();

    for (int i = tid; i < group * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      float a = acc[i] * corr[g];
      for (int t = 0; t < n; ++t) a = fmaf(sc[g * kTile + t], vs[t * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    const float mass = l[g] == 0.f ? 1.f : l[g];
    out[((size_t)b * H + h * group + g) * D + d] = from_f32<T>(acc[i] / mass);
  }
}

template <typename T, bool kFused>
int launch(const void* q, const void* kp, const void* vp, const void* page_table,
           const void* seq_lens, const void* k_new, const void* v_new, void* out,
           int B, int H, int Hk, int D, int P, int pps, int n_page_steps,
           float scale, float softcap, cudaStream_t stream) {
  const int group = H / Hk;
  const size_t smem = sizeof(float) *
      ((size_t)group * D + kTile * (D + 1) + kTile * D + group * kTile +
       (size_t)group * D + 3 * group);
  auto kernel = paged_decode_kernel<T, kFused>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, Hk);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)page_table,
      (const int*)seq_lens, (const T*)k_new, (const T*)v_new, (T*)out,
      H, Hk, D, P, pps, n_page_steps, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 means none.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int batched_paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* seq_lens, const void* k_new,
    const void* v_new, void* out, int B, int H, int Hk, int D, int page_size,
    int pages_per_seq, int n_page_steps, float scale, float softcap,
    int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, true>(q, k_pages, v_pages, page_table, seq_lens, k_new,
                               v_new, out, B, H, Hk, D, page_size, pages_per_seq,
                               n_page_steps, scale, softcap, s);
  return launch<__nv_bfloat16, true>(q, k_pages, v_pages, page_table, seq_lens,
                                     k_new, v_new, out, B, H, Hk, D, page_size,
                                     pages_per_seq, n_page_steps, scale, softcap, s);
}

// The per-sequence form: no fused token, the loop over every page the
// resident tokens fill. Same dtype and return conventions.
extern "C" int paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* seq_lens, void* out, int B, int H,
    int Hk, int D, int page_size, int pages_per_seq, float scale,
    float softcap, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, false>(q, k_pages, v_pages, page_table, seq_lens,
                                nullptr, nullptr, out, B, H, Hk, D, page_size,
                                pages_per_seq, pages_per_seq, scale, softcap, s);
  return launch<__nv_bfloat16, false>(q, k_pages, v_pages, page_table, seq_lens,
                                      nullptr, nullptr, out, B, H, Hk, D,
                                      page_size, pages_per_seq, pages_per_seq,
                                      scale, softcap, s);
}
