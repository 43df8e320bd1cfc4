// Fused chunked-prefill attention over the paged KV pool, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/chunked_prefill.py::chunked_prefill_attention
// (Pallas body _chunked_prefill_kernel). A [B, C] query slab, flattened
// per kv head into C * group rows (row r is chunk position r / group,
// q-head r % group of the kv head), attends every resident page of its
// sequence: the cached prefix, earlier chunks and the slab itself,
// which the caller scattered into the pool before the call. A score
// survives iff k_pos <= q_off + r / group, k_pos < kv_len and
// q_pos < kv_len; rows past kv_len come out as zeros. Optional logit
// softcap. Float32 scores, softmax and sums.
//
// What bounds it on this card: at the engine's shapes (C 128, 9 heads
// over 3 kv heads, D 64, a few hundred resident tokens) the causal
// product is a few tens of MFLOP against well under a megabyte of
// K/V: operations, not bytes, but so little of either that launch
// latency and the serial per-tile steps dominate.
//
// What the design does about it: one block per (sequence, kv head,
// tile of 32 rows). The sequential page axis of the Pallas grid becomes
// a loop inside the block over 16-token K/V tiles staged in shared
// memory, with the online-softmax state of its rows in shared memory.
// The loop stops at the row tile's causal frontier and at kv_len, so
// no page-table entry past either is ever read, not even to form an
// address, and tiles wholly above the frontier cost nothing. Rows that
// see no valid key keep zero mass and write zeros. Tensor-core tiles
// (wgmma) and TMA page loads are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;  // query rows per block
constexpr int kTile = 16;  // key tokens staged per step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunked_prefill_kernel(const T* __restrict__ q,         // [B, C, H, D]
                       const T* __restrict__ kp,        // [n_pages, P, Hk, D]
                       const T* __restrict__ vp,
                       const int* __restrict__ page_table,  // [B, pps]
                       const int* __restrict__ q_offsets,   // [B]
                       const int* __restrict__ kv_lens,     // [B]
                       T* __restrict__ out,             // [B, C, H, D]
                       int C, int H, int Hk, int D, int P, int pps,
                       float scale, float softcap) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int group = H / Hk;
  const int r0 = blockIdx.z * kRows;
  const int nr = min(kRows, C * group - r0);
  const int tid = threadIdx.x;
  const int DS = D + 1;  // padded K row stride

  extern __shared__ float smem[];
  float* qs = smem;                   // [kRows][D]  scaled queries
  float* ks = qs + kRows * D;         // [kTile][DS]
  float* vs = ks + kTile * DS;        // [kTile][D]
  float* sc = vs + kTile * D;         // [kRows][kTile] scores, then p
  float* acc = sc + kRows * kTile;    // [kRows][D]
  float* m = acc + kRows * D;         // [kRows]
  float* l = m + kRows;               // [kRows]
  float* corr = l + kRows;            // [kRows]

  const int q_off = q_offsets[b];
  const int kv_len = kv_lens[b];

  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = r0 + r;
    const int c = row / group, g = row - c * group;
    qs[i] = to_f32(q[(((size_t)b * C + c) * H + h * group + g) * D + d]) * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < nr; r += kThreads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  // causal frontier of this row tile, clipped to the resident tokens
  const int min_qpos = q_off + r0 / group;
  const int max_qpos = q_off + (r0 + nr - 1) / group;
  const int kv_end = min_qpos >= kv_len ? 0 : min(kv_len, max_qpos + 1);
  __syncthreads();

  for (int t0 = 0; t0 < kv_end; t0 += kTile) {
    const int n = min(kTile, kv_end - t0);
    for (int i = tid; i < n * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      const int tok = t0 + t;
      const int page = page_table[(size_t)b * pps + tok / P];
      const size_t off = (((size_t)page * P + tok % P) * Hk + h) * D + d;
      ks[t * DS + d] = to_f32(kp[off]);
      vs[t * D + d] = to_f32(vp[off]);
    }
    __syncthreads();

    for (int i = tid; i < nr * n; i += kThreads) {
      const int r = i / n, t = i - r * n;
      const int q_pos = q_off + (r0 + r) / group;
      const int k_pos = t0 + t;  // < kv_end <= kv_len
      float s = -INFINITY;
      if (k_pos <= q_pos && q_pos < kv_len) {
        const float* qr = qs + r * D;
        const float* kr = ks + t * DS;
        float acc_s = 0.f;
        for (int d = 0; d < D; ++d) acc_s = fmaf(qr[d], kr[d], acc_s);
        if (softcap > 0.f) acc_s = softcap * tanhf(acc_s / softcap);
        s = acc_s;
      }
      sc[r * kTile + t] = s;
    }
    __syncthreads();

    for (int r = tid; r < nr; r += kThreads) {
      float mx = -INFINITY;
      for (int t = 0; t < n; ++t) mx = fmaxf(mx, sc[r * kTile + t]);
      if (mx == -INFINITY) {  // no valid key for this row in this tile
        for (int t = 0; t < n; ++t) sc[r * kTile + t] = 0.f;
        corr[r] = 1.f;
        continue;
      }
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
      for (int t = 0; t < n; ++t) {
        const float p = expf(sc[r * kTile + t] - m_new);  // masked: exp(-inf) = 0
        sc[r * kTile + t] = p;
        sum += p;
      }
      const float c = expf(m[r] - m_new);
      l[r] = l[r] * c + sum;
      m[r] = m_new;
      corr[r] = c;
    }
    __syncthreads();

    for (int i = tid; i < nr * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      float a = acc[i] * corr[r];
      for (int t = 0; t < n; ++t) a = fmaf(sc[r * kTile + t], vs[t * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = r0 + r;
    const int c = row / group, g = row - c * group;
    const float mass = l[r] == 0.f ? 1.f : l[r];  // rows past kv_len -> zeros
    out[(((size_t)b * C + c) * H + h * group + g) * D + d] = from_f32<T>(acc[i] / mass);
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* page_table,
           const void* q_offsets, const void* kv_lens, void* out, int B, int C,
           int H, int Hk, int D, int P, int pps, float scale, float softcap,
           cudaStream_t stream) {
  const int group = H / Hk;
  const size_t smem = sizeof(float) *
      ((size_t)kRows * D + kTile * (D + 1) + kTile * D + kRows * kTile +
       (size_t)kRows * D + 3 * kRows);
  auto kernel = chunked_prefill_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, Hk, (C * group + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)page_table,
      (const int*)q_offsets, (const int*)kv_lens, (T*)out, C, H, Hk, D, P, pps,
      scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 means none.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int chunked_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* q_offsets, const void* kv_lens,
    void* out, int B, int C, int H, int Hk, int D, int page_size,
    int pages_per_seq, float scale, float softcap, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, page_table, q_offsets, kv_lens, out,
                         B, C, H, Hk, D, page_size, pages_per_seq, scale, softcap, s);
  return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, q_offsets, kv_lens,
                               out, B, C, H, Hk, D, page_size, pages_per_seq, scale,
                               softcap, s);
}
