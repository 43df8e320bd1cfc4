// Dense GQA flash attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (Pallas body _flash_kernel). Queries [B, Lq, H, D] attend keys and
// values [B, Lk, Hk, D], queries aligned to the end of the keys (query
// i sits at position q_off + i, q_off = Lk - Lq; q_off < 0 when Lq > Lk,
// and then a causal row at a negative position sees no key: its block's
// key range [lo, hi) is empty or its mask drops every key). A score survives iff
//   (!causal || k_pos <= q_pos) && (window <= 0 || q_pos - k_pos < window)
// or k_pos < prefix_len (prefix-LM, OR'd in), and k_pos < Lk. The
// optional logit softcap c tanh(s / c) is applied to the scaled dot
// product; a masked score is -inf whatever the cap. Rows with no
// visible key come out as zeros. Float32 softmax and sums; output in
// the input dtype.
//
// What bounds it on this card: the dense trainer's call (batch 8 x 512
// tokens, 9 q heads over 3 kv heads, D 64, bf16, causal) moves 12.6 MB
// (3.8 us at 3.35 TB/s) and needs 2.4 GFLOP of causal products (2.4 us
// at the 989 TFLOP/s bf16 tensor-core peak): bytes by a little, both
// within a few microseconds. The kernel does 2.5x those products (Q K^T
// in both passes, P V in three parts) on mma.sync, and its blocks'
// serial tile chains and issue rate decide its time. The slot-ring engine's 64-token prefill
// (0.2 MB, 4.8 MFLOP, 9 blocks) is bound by launch latency and one
// block's chain of two tiles.
//
// bf16 (every main path): the tensor-core body of attention_mma.cuh.
// One block of 4 warps per (sequence, kv head, 64 rows of position x
// group), the heaviest row tiles launched first; two passes over 64-key
// K/V tiles (the row max, then exp, sums and P V) on mma.sync.m16n8k16
// (bf16 in, f32 sums, P as three bf16 parts), tiles double-buffered in
// shared memory by cp.async 16-byte copies, softmax state in registers.
// The loop visits only the keys some row of the tile can see: [0,
// prefix_len), then from the window's oldest visible key of the tile's
// first row up to the causal frontier of its last row; the mask runs
// only on tiles that cross one of those edges or Lk. mma.sync, not
// wgmma: a first tensor-core version; wgmma with TMA loads and a split
// key axis are later work.
//
// float32: the scalar body below (32 rows, 16-key tiles, f32 FMAs from
// shared memory), chosen by dtype in the entry point. Tensor cores
// would take f32 as TF32 (about three digits), and the f32 callers are
// checks held to float32 rounding (the dense trainer's float32 gate,
// the CPU parity of the plain version); no bf16 path reaches it.

#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;  // query rows (position x group) per block
constexpr int kTile = 16;  // key tokens staged per step

struct Mask {
  int causal, window, prefix_len, lk;
  __device__ __forceinline__ bool visible(int q_pos, int k_pos) const {
    if (k_pos >= lk) return false;
    if (k_pos < prefix_len) return true;
    if (causal && k_pos > q_pos) return false;
    if (window > 0 && q_pos - k_pos >= window) return false;
    return true;
  }
};

// the float32 body
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,   // [B, Lq, H, D]
                           const float* __restrict__ k,   // [B, Lk, Hk, D]
                           const float* __restrict__ v,
                           float* __restrict__ out,       // [B, Lq, H, D]
                           int Lq, int H, int Hk, int D, Mask mask,
                           float scale, float softcap) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int group = H / Hk;
  const int r0 = blockIdx.z * kRows;
  const int nr = min(kRows, Lq * group - r0);
  const int tid = threadIdx.x;
  const int DS = D + 1;  // padded K row stride: no bank conflicts in q.k
  const int Lk = mask.lk;
  const int q_off = Lk - Lq;

  extern __shared__ float smem[];
  float* qs = smem;                   // [kRows][D]  scaled queries
  float* ks = qs + kRows * D;         // [kTile][DS]
  float* vs = ks + kTile * DS;        // [kTile][D]
  float* sc = vs + kTile * D;         // [kRows][kTile] scores, then p
  float* acc = sc + kRows * kTile;    // [kRows][D]
  float* m = acc + kRows * D;         // [kRows]
  float* l = m + kRows;               // [kRows]
  float* corr = l + kRows;            // [kRows]

  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = r0 + r;
    const int qi = row / group, g = row - qi * group;
    qs[i] = q[(((size_t)b * Lq + qi) * H + h * group + g) * D + d] * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < nr; r += kThreads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  // keys any row of this tile can see: the prefix, then the window's
  // oldest visible key of the first row up to the last row's frontier
  const int min_qpos = q_off + r0 / group;
  const int max_qpos = q_off + (r0 + nr - 1) / group;
  const int pre_end = min(mask.prefix_len, Lk);
  const int lo = max(pre_end, mask.window > 0 ? min_qpos - mask.window + 1 : 0);
  const int hi = mask.causal ? min(Lk, max_qpos + 1) : Lk;
  __syncthreads();

  for (int seg = 0; seg < 2; ++seg) {
    const int seg_lo = seg == 0 ? 0 : lo;
    const int seg_hi = seg == 0 ? pre_end : hi;
    for (int t0 = seg_lo; t0 < seg_hi; t0 += kTile) {
      const int n = min(kTile, seg_hi - t0);
      for (int i = tid; i < n * D; i += kThreads) {
        const int t = i / D, d = i - t * D;
        const size_t off = (((size_t)b * Lk + t0 + t) * Hk + h) * D + d;
        ks[t * DS + d] = k[off];
        vs[t * D + d] = v[off];
      }
      __syncthreads();

      for (int i = tid; i < nr * n; i += kThreads) {
        const int r = i / n, t = i - r * n;
        const int q_pos = q_off + (r0 + r) / group;
        float s = -INFINITY;
        if (mask.visible(q_pos, t0 + t)) {
          const float* qr = qs + r * D;
          const float* kr = ks + t * DS;
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
          s = dot;
        }
        sc[r * kTile + t] = s;
      }
      __syncthreads();

      for (int r = tid; r < nr; r += kThreads) {
        float mx = -INFINITY;
        for (int t = 0; t < n; ++t) mx = fmaxf(mx, sc[r * kTile + t]);
        if (mx == -INFINITY) {  // no visible key for this row in this tile
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
        const float c = expf(m[r] - m_new);  // exp(-inf) = 0 on the first visible tile
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
  }

  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = r0 + r;
    const int qi = row / group, g = row - qi * group;
    const float mass = l[r] == 0.f ? 1.f : l[r];  // rows with no key -> zeros
    out[(((size_t)b * Lq + qi) * H + h * group + g) * D + d] = acc[i] / mass;
  }
}

// The bf16 body: keys a block visits, in two segments ([0, pre_end)
// and [main_lo, main_hi)), and the mask.
struct DenseKV {
  const __nv_bfloat16 *k, *v;
  int q_off, b, h, Lk, Hk, D, causal, window, prefix_len;
  int pre_end, main_lo, main_hi, n_pre, n_main;

  __device__ int n_tiles() const { return n_pre + n_main; }
  __device__ void tile(int i, int& t0, int& end) const {
    if (i < n_pre) {
      t0 = i * attn_mma::kKeys;
      end = pre_end;
    } else {
      t0 = main_lo + (i - n_pre) * attn_mma::kKeys;
      end = main_hi;
    }
  }
  __device__ size_t offset(int key) const {
    return (((size_t)b * Lk + key) * Hk + h) * D;
  }
  // keys < end visible at q_pos: [0, pre) (the prefix) and [lo, hi]
  __device__ void span(int q_pos, int end, int& pre, int& lo, int& hi) const {
    pre = min(prefix_len, end);
    lo = window > 0 ? q_pos - window + 1 : 0;
    hi = causal ? min(q_pos, end - 1) : end - 1;
  }
  __device__ bool full(int t0, int end, int q_min, int q_max) const {
    const int last = t0 + attn_mma::kKeys - 1;
    if (last >= end) return false;
    if (last < prefix_len) return true;
    if (causal && last > q_min) return false;
    return window <= 0 || q_max - t0 < window;
  }
};

template <int DP>
__global__ void __launch_bounds__(attn_mma::kThreads)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int Lq, int Lk,
                            int H, int Hk, int D, int causal, int window,
                            int prefix_len, float scale, float softcap) {
  using attn_mma::kKeys;
  using attn_mma::kRows;
  const int group = H / Hk;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // heaviest first
  const int n_rows = Lq * group;
  DenseKV src;
  src.k = k;
  src.v = v;
  src.q_off = Lk - Lq;
  src.b = blockIdx.x;
  src.h = blockIdx.y;
  src.Lk = Lk;
  src.Hk = Hk;
  src.D = D;
  src.causal = causal;
  src.window = window;
  src.prefix_len = prefix_len;
  // keys any row of this tile can see: the prefix, then the window's
  // oldest visible key of the first row up to the last row's frontier
  const int min_qpos = src.q_off + r0 / group;
  const int max_qpos = src.q_off + (min(r0 + kRows, n_rows) - 1) / group;
  src.pre_end = min(prefix_len, Lk);
  src.main_lo = max(src.pre_end, window > 0 ? min_qpos - window + 1 : 0);
  src.main_hi = causal ? min(Lk, max_qpos + 1) : Lk;
  src.n_pre = (src.pre_end + kKeys - 1) / kKeys;
  src.n_main = src.main_hi > src.main_lo
                   ? (src.main_hi - src.main_lo + kKeys - 1) / kKeys
                   : 0;
  attn_mma::attend<DP>(src, q, out, Lq, H, D, group, src.b, src.h, r0, scale,
                       softcap);
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int Lq, int Lk, int H, int Hk, int D, int causal, int window,
                int prefix_len, float scale, float softcap,
                cudaStream_t stream) {
  constexpr size_t smem = attn_mma::smem_bytes<DP>();
  auto kernel = flash_attention_bf16_kernel<DP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int group = H / Hk;
  dim3 grid(B, Hk, (Lq * group + attn_mma::kRows - 1) / attn_mma::kRows);
  kernel<<<grid, attn_mma::kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, Lq, Lk, H, Hk, D, causal,
      window, prefix_len, scale, softcap);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Lq, int Lk, int H, int Hk, int D, int causal, int window,
               int prefix_len, float scale, float softcap,
               cudaStream_t stream) {
  const int group = H / Hk;
  const size_t smem = sizeof(float) *
      ((size_t)kRows * D + kTile * (D + 1) + kTile * D + kRows * kTile +
       (size_t)kRows * D + 3 * kRows);
  auto kernel = flash_attention_f32_kernel;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Mask mask{causal, window, prefix_len, Lk};
  dim3 grid(B, Hk, (Lq * group + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Lq, H,
      Hk, D, mask, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (scalar body), 1 = bfloat16 (tensor cores); the
// bf16 pointers must be 16-byte aligned. window <= 0 means none;
// softcap <= 0 means none. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Lq,
    int Lk, int H, int Hk, int D, int causal, int window, int prefix_len,
    float scale, float softcap, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_ATTENTION_ARGS                                                \
  q, k, v, out, B, Lq, Lk, H, Hk, D, causal, window, prefix_len, scale, \
      softcap, s
  if (dtype == 0) return launch_f32(FLASH_ATTENTION_ARGS);
  switch (attn_mma::padded_width(D)) {
    case 32: return launch_bf16<32>(FLASH_ATTENTION_ARGS);
    case 64: return launch_bf16<64>(FLASH_ATTENTION_ARGS);
    case 96: return launch_bf16<96>(FLASH_ATTENTION_ARGS);
    case 128: return launch_bf16<128>(FLASH_ATTENTION_ARGS);
    default: return launch_bf16<256>(FLASH_ATTENTION_ARGS);
  }
#undef FLASH_ATTENTION_ARGS
}
