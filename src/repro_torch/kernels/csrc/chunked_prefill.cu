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
// softcap. Float32 softmax and sums.
//
// What bounds it on this card: at the engine's shapes (C 128, 9 heads
// over 3 kv heads, D 64, bf16, up to a few hundred resident tokens) a
// call moves under a megabyte and needs a few tens of MFLOP: 0.1 us of
// bytes, 0.02-0.06 us of tensor-core work. It runs 18 blocks (3 kv
// heads x 6 row tiles), so launch latency and one block's serial chain
// of 64-key tiles (two passes over up to 4) set its time.
//
// bf16 (the engine's path): the tensor-core body of attention_mma.cuh.
// One block of 4 warps per (sequence, kv head, 64 rows), the heaviest
// row tiles launched first; two passes over 64-key K/V tiles (the row
// max, then exp, sums and P V) on mma.sync.m16n8k16 (bf16 in, f32
// sums, P as three bf16 parts), tiles double-buffered in shared memory
// by cp.async 16-byte copies, softmax state in registers. A 64-key tile
// spans several pages: each 16-byte copy finds its page in the table.
// The loop stops at the row tile's causal frontier and at kv_len, and a
// copy past them reads nothing, so no page-table entry at or past
// ceil(min(kv_len, frontier) / page) is read, not even to form an
// address. The mask runs only on tiles that cross the frontier or
// kv_len. mma.sync, not wgmma: a first tensor-core version; wgmma and a
// split key axis are later work.
//
// float32: the scalar body below (32 rows, 16-key tiles, f32 FMAs from
// shared memory), chosen by dtype in the entry point. Tensor cores
// would take f32 as TF32 (about three digits); the f32 callers are
// checks held to float32 rounding, and no bf16 path reaches it.

#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;  // query rows per block
constexpr int kTile = 16;  // key tokens staged per step

// the float32 body
__global__ void __launch_bounds__(kThreads)
chunked_prefill_f32_kernel(const float* __restrict__ q,     // [B, C, H, D]
                           const float* __restrict__ kp,    // [n_pages, P, Hk, D]
                           const float* __restrict__ vp,
                           const int* __restrict__ page_table,  // [B, pps]
                           const int* __restrict__ q_offsets,   // [B]
                           const int* __restrict__ kv_lens,     // [B]
                           float* __restrict__ out,         // [B, C, H, D]
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
    qs[i] = q[(((size_t)b * C + c) * H + h * group + g) * D + d] * scale;
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
      ks[t * DS + d] = kp[off];
      vs[t * D + d] = vp[off];
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
    out[(((size_t)b * C + c) * H + h * group + g) * D + d] = acc[i] / mass;
  }
}

// The bf16 body: the resident tokens up to the row tile's frontier,
// each key's row found through the page table.
struct PagedKV {
  const __nv_bfloat16 *k, *v;
  const int* table;  // this sequence's row of the page table
  int q_off, kv_len, kv_end, h, Hk, D, P;

  __device__ int n_tiles() const {
    return (kv_end + attn_mma::kKeys - 1) / attn_mma::kKeys;
  }
  __device__ void tile(int i, int& t0, int& end) const {
    t0 = i * attn_mma::kKeys;
    end = kv_end;
  }
  __device__ size_t offset(int key) const {  // key < kv_end
    return (((size_t)table[key / P] * P + key % P) * Hk + h) * D;
  }
  // keys < end visible at q_pos: [0, q_pos], none past kv_len
  __device__ void span(int q_pos, int end, int& pre, int& lo, int& hi) const {
    pre = 0;
    lo = 0;
    hi = q_pos < kv_len ? min(q_pos, end - 1) : -1;
  }
  __device__ bool full(int t0, int end, int q_min, int q_max) const {
    const int last = t0 + attn_mma::kKeys - 1;
    return last < end && last <= q_min && q_max < kv_len;
  }
};

template <int DP>
__global__ void __launch_bounds__(attn_mma::kThreads)
chunked_prefill_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ kp,
                            const __nv_bfloat16* __restrict__ vp,
                            const int* __restrict__ page_table,
                            const int* __restrict__ q_offsets,
                            const int* __restrict__ kv_lens,
                            __nv_bfloat16* __restrict__ out, int C, int H,
                            int Hk, int D, int P, int pps, float scale,
                            float softcap) {
  using attn_mma::kRows;
  const int b = blockIdx.x;
  const int group = H / Hk;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // heaviest first
  PagedKV src;
  src.k = kp;
  src.v = vp;
  src.table = page_table + (size_t)b * pps;
  src.q_off = q_offsets[b];
  src.kv_len = kv_lens[b];
  src.h = blockIdx.y;
  src.Hk = Hk;
  src.D = D;
  src.P = P;
  // causal frontier of this row tile, clipped to the resident tokens
  const int min_qpos = src.q_off + r0 / group;
  const int max_qpos = src.q_off + (min(r0 + kRows, C * group) - 1) / group;
  src.kv_end = min_qpos >= src.kv_len ? 0 : min(src.kv_len, max_qpos + 1);
  attn_mma::attend<DP>(src, q, out, C, H, D, group, b, src.h, r0, scale,
                       softcap);
}

template <int DP>
int launch_bf16(const void* q, const void* kp, const void* vp,
                const void* page_table, const void* q_offsets,
                const void* kv_lens, void* out, int B, int C, int H, int Hk,
                int D, int P, int pps, float scale, float softcap,
                cudaStream_t stream) {
  constexpr size_t smem = attn_mma::smem_bytes<DP>();
  auto kernel = chunked_prefill_bf16_kernel<DP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int group = H / Hk;
  dim3 grid(B, Hk, (C * group + attn_mma::kRows - 1) / attn_mma::kRows);
  kernel<<<grid, attn_mma::kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, (const int*)page_table, (const int*)q_offsets,
      (const int*)kv_lens, (__nv_bfloat16*)out, C, H, Hk, D, P, pps, scale,
      softcap);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* kp, const void* vp,
               const void* page_table, const void* q_offsets,
               const void* kv_lens, void* out, int B, int C, int H, int Hk,
               int D, int P, int pps, float scale, float softcap,
               cudaStream_t stream) {
  const int group = H / Hk;
  const size_t smem = sizeof(float) *
      ((size_t)kRows * D + kTile * (D + 1) + kTile * D + kRows * kTile +
       (size_t)kRows * D + 3 * kRows);
  auto kernel = chunked_prefill_f32_kernel;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, Hk, (C * group + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)kp, (const float*)vp,
      (const int*)page_table, (const int*)q_offsets, (const int*)kv_lens,
      (float*)out, C, H, Hk, D, P, pps, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (scalar body), 1 = bfloat16 (tensor cores); the
// bf16 pointers must be 16-byte aligned. softcap <= 0 means none.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int chunked_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* q_offsets, const void* kv_lens,
    void* out, int B, int C, int H, int Hk, int D, int page_size,
    int pages_per_seq, float scale, float softcap, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CHUNKED_PREFILL_ARGS                                                 \
  q, k_pages, v_pages, page_table, q_offsets, kv_lens, out, B, C, H, Hk, D, \
      page_size, pages_per_seq, scale, softcap, s
  if (dtype == 0) return launch_f32(CHUNKED_PREFILL_ARGS);
  switch (attn_mma::padded_width(D)) {
    case 32: return launch_bf16<32>(CHUNKED_PREFILL_ARGS);
    case 64: return launch_bf16<64>(CHUNKED_PREFILL_ARGS);
    case 96: return launch_bf16<96>(CHUNKED_PREFILL_ARGS);
    case 128: return launch_bf16<128>(CHUNKED_PREFILL_ARGS);
    default: return launch_bf16<256>(CHUNKED_PREFILL_ARGS);
  }
#undef CHUNKED_PREFILL_ARGS
}
