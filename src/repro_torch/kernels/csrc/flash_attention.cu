// Dense GQA flash attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (Pallas body _flash_kernel). Queries [B, Lq, H, D] attend keys and
// values [B, Lk, Hk, D], queries aligned to the end of the keys (query
// i sits at position q_off + i, q_off = Lk - Lq). A score survives iff
//   (!causal || k_pos <= q_pos) && (window <= 0 || q_pos - k_pos < window)
// or k_pos < prefix_len (prefix-LM, OR'd in), and k_pos < Lk. The
// optional logit softcap is applied to the dot product, and only a
// surviving score is formed at all, so a masked one is -inf and never
// passes through tanh. Rows with no visible key come out as zeros.
// Float32 scores, softmax and sums; output in the input dtype.
//
// What bounds it on this card: at the engine's prefill shape (one
// sequence, 256 tokens, 9 q heads over 3 kv heads, D 64, bf16, causal)
// the call reads and writes under a megabyte and does ~76 MFLOP of
// causal products: both bounds sit well under a microsecond, so the
// floor is launch latency and the serial per-tile steps of each block.
//
// What the design does about it: one block per (sequence, kv head,
// tile of 32 rows), where the rows are the kv head's query rows with
// the GQA group folded in (row r is query position r / group, q head
// r % group), so all q heads of a kv head share each staged K/V tile.
// The sequential kv axis of the Pallas grid becomes a loop inside the
// block over 16-token K/V tiles in shared memory, with each row's
// online-softmax state (m, l, acc) in shared memory. The loop visits
// only the keys some row of the tile can see: [0, prefix_len) and the
// window's oldest visible key of the tile's first row up to the causal
// frontier of its last row; keys wholly in the future or wholly
// expired cost nothing. Tensor-core tiles (wgmma), TMA loads and
// splitting the key axis across blocks are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;  // query rows (position x group) per block
constexpr int kTile = 16;  // key tokens staged per step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q,   // [B, Lq, H, D]
                       const T* __restrict__ k,   // [B, Lk, Hk, D]
                       const T* __restrict__ v,
                       T* __restrict__ out,       // [B, Lq, H, D]
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
    qs[i] = to_f32(q[(((size_t)b * Lq + qi) * H + h * group + g) * D + d]) * scale;
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
        ks[t * DS + d] = to_f32(k[off]);
        vs[t * D + d] = to_f32(v[off]);
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
    out[(((size_t)b * Lq + qi) * H + h * group + g) * D + d] = from_f32<T>(acc[i] / mass);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Lq, int Lk, int H, int Hk, int D, int causal, int window,
           int prefix_len, float scale, float softcap, cudaStream_t stream) {
  const int group = H / Hk;
  const size_t smem = sizeof(float) *
      ((size_t)kRows * D + kTile * (D + 1) + kTile * D + kRows * kTile +
       (size_t)kRows * D + 3 * kRows);
  auto kernel = flash_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Mask mask{causal, window, prefix_len, Lk};
  dim3 grid(B, Hk, (Lq * group + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Lq, H, Hk, D, mask,
      scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means none; softcap <= 0
// means none. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Lq,
    int Lk, int H, int Hk, int D, int causal, int window, int prefix_len,
    float scale, float softcap, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, Lq, Lk, H, Hk, D, causal, window,
                         prefix_len, scale, softcap, s);
  return launch<__nv_bfloat16>(q, k, v, out, B, Lq, Lk, H, Hk, D, causal,
                               window, prefix_len, scale, softcap, s);
}
