// Decode attention for Hopper (sm_90a): three entry points on one
// split-page (flash-decoding) body, two over the paged pool and one over
// the slot ring's contiguous cache.
//
// Replaces: src/repro/kernels/paged_attention.py::batched_paged_decode_attention
// (Pallas body _batched_kernel; entry batched_paged_decode_launch) and
// src/repro/kernels/paged_attention.py::paged_decode_attention (Pallas
// body _paged_kernel; entry paged_decode_launch). One decode token per
// sequence attends the shared page pool [n_pages, P, Hk, D] through its
// page table; each kv head serves its GQA group of query heads. The
// batched form (kFused) folds the current token's K/V (k_new/v_new, not
// yet in the pool) in as one more key, so the kernel never reads a page
// the same-step scatter writes, and trims the page loop to
// n_page_steps; the per-sequence form attends the resident seq_len
// tokens only (a seq_len of 0 gives zeros). Optional logit softcap.
// Float32 scores, softmax and sums; output in q's dtype.
//
// The slot form (kSlot, entry slot_decode_launch) replaces no TPU kernel:
// the JAX package's contiguous-cache decode
// (src/repro/kernels/ops.py::decode_attention) is plain jnp. It was
// added because the plain PyTorch version casts each layer's whole
// [B, S_ring, Hk, D] ring to float32 and attends every position of
// every lane. Here lane b's token t sits at b * b_stride + t * s_stride
// (a layer's view of the [L, B, S_ring, Hk, D] cache, read in place),
// and a lane attends [0, min(len, S_ring)) only: bf16 rows read once,
// trimmed to each lane's length, never copied. It is the per-sequence
// form with pages of one token and no table. It takes no window: a ring
// holds only the positions inside a model's window, so no caller masks
// one. A len of 0 gives zeros.
//
// What bounds it on this card: bytes, then latency. Each (sequence, kv
// head) streams its K/V once and does 4 * group FLOPs per value read,
// far under the H100's ~295 FLOP/byte ridge; with a GQA group of 3,
// tensor cores would waste 13 of their 16 rows, so none are used. At
// the engine's shapes (8 sequences, 3 kv heads, D 64, ~160 tokens) the
// call moves ~1 MB, a 0.3 us bound that no launch reaches: a chain of
// dependent memory trips (length, page id, K/V, partial, ticket,
// partials) sets its time, ~10 us. At 2,000 tokens the bound is 3.6 us
// and the kernel takes ~19 us (PERF.md): each block's few load-then-use
// steps are latency-bound at 3 blocks an SM. The slot ring of the
// h2o-danube cells (256 lanes, 8 kv heads of 80, up to 1,090 tokens) is
// 2,048 blocks of one split each, a few waves of 4 blocks an SM; there
// too the token loop's latency, not the bytes, sets the time (~30% of
// the byte bound, PERF.md).
//
// What the design does about it:
// * The page axis (the slot form: the token axis) is split across
//   blocks. The grid is (S, Hk x head chunks, B), S the number of
//   splits: block `split` takes pages [split * pages_per_split,
//   +pages_per_split) of its sequence, whole pages, up to
//   min(n_page_steps, ceil(seq_len / P)). The wrapper's split_plan
//   picks pages_per_split so the grid fills the SMs. A block past a
//   sequence's last page reads no table entry and writes an empty
//   partial (m = -inf, l = 0). The fused token belongs to split 0.
// * Inside a block, one group of LT = ceil_pow2(D / vec) lanes takes one
//   token (vec = 8 bf16 or 4 float32 values: 16-byte loads; lanes past
//   D are masked), so a warp takes 32 / LT tokens at once. Each lane
//   holds the 16-byte K and V vectors of kU tokens, and issues the next
//   kU tokens' loads before this step's math (register double buffer).
//   The group's scaled queries sit in registers; each partial dot is
//   reduced by __shfl_xor_sync inside the lane group, then softcap and
//   the online softmax run per query head in registers, and V is
//   accumulated per lane. The token loop has no __syncthreads(): each
//   lane group keeps its own (m, l, acc), merged by shuffles across the
//   warp and through shared memory across the 4 warps at the end.
// * The splits merge in the same launch. Each block writes its partial
//   (acc, m, l) in float32 to a scratch buffer [B, Hk, S, group, D + 2],
//   then takes a ticket (__threadfence, atomicAdd on a per-(sequence,
//   kv head, head chunk) counter). The last block to arrive reads the S
//   partials' (m, l) at once into shared memory, weighs them, sums the
//   accumulators in split order, normalises, writes out and resets the
//   counter to 0, so the counters stay zeroed between calls with no
//   memset. No float atomics: the output is the same bits on every run.
//   A merge whose mass is 0 writes zeros. With S = 1 a block writes out
//   directly.
// * Groups of 1-4 query heads are one block's; a group of 5-8 takes the
//   8-head body with its extra heads masked; larger groups are cut into
//   chunks of 8 across the grid's y axis (each chunk reads its K/V).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// A 16-byte vector of T as float32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 is the high half of a float32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// exp(x - m) with an empty state's m = -inf taken as 0, so an empty
// partial weighs 0 and never makes a NaN.
__device__ __forceinline__ float safe_max(float m) { return m == -INFINITY ? 0.f : m; }

// How a block finds its tokens' K/V rows: through the page table, with
// or without the fused token, or at a lane's stride in the slot ring.
enum class Addr { kPaged, kPagedFused, kSlot };

// The slot form's bf16 bodies of 3-4 query heads a block keep 2 tokens in
// flight per lane group, not 4: the registers that frees lets more
// blocks share an SM, which hides more of the token loop's dependent
// shuffles and exps (h2o-danube's cell shape on an H100: 192 -> 128
// registers, 2 -> 4 blocks an SM, 0.44 -> 0.30 ms a call). The paged
// forms keep their instantiations as they were.
template <typename T, Addr kAddr, int kG, int kNV>
constexpr bool kSlotNarrow = kAddr == Addr::kSlot && Vec<T>::kN == 8 &&
                             kNV == 1 && kG >= 3 && kG <= 4;

template <typename T, Addr kAddr, int kG, int kNV>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,           // [B, H, D]
                          const T* __restrict__ kp,          // [n_pages, P, Hk, D]
                          const T* __restrict__ vp,
                          const int* __restrict__ page_table,  // [B, pps]
                          const int* __restrict__ seq_lens,    // [B]
                          const T* __restrict__ k_new,       // [B, Hk, D]
                          const T* __restrict__ v_new,
                          T* __restrict__ out,               // [B, H, D]
                          float* __restrict__ partials,      // [B, Hk, S, group, D + 2]
                          int* __restrict__ tickets,         // [B, Hk x head chunks]
                          int H, int Hk, int D, int P, int pps, int n_page_steps,
                          int pages_per_split, int lt_log2, float scale,
                          float softcap, long long b_stride,
                          long long s_stride) {
  constexpr bool kFused = kAddr == Addr::kPagedFused;
  constexpr bool kSlot = kAddr == Addr::kSlot;
  constexpr int kVec = Vec<T>::kN;
  // tokens in flight per lane group: fewer where the queries and sums
  // already hold many registers
  constexpr int kU =
      kG * kNV * kVec > 32 || kSlotNarrow<T, kAddr, kG, kNV> ? 2 : 4;
  const int S = gridDim.x;
  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const int group = H / Hk;
  const int n_hc = (group + kG - 1) / kG;
  const int kvh = blockIdx.y / n_hc;
  const int g0 = (blockIdx.y - kvh * n_hc) * kG;
  const int ng = min(kG, group - g0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int LT = 1 << lt_log2;        // lanes per token
  const int lg = lane >> lt_log2;     // this lane's token slot in the warp
  const int li = lane & (LT - 1);     // this lane's place in the row
  const int tpw = 32 >> lt_log2;      // tokens a warp takes at once
  const int n_vec = D / kVec;         // 16-byte vectors per row

  // this split's tokens: whole pages, none past the sequence's last page
  // (the slot form: pages of one token)
  const int seq_len = max(seq_lens[b], 0);
  const int steps = min(n_page_steps, (seq_len + P - 1) / P);
  const int kv_len = min(seq_len, steps * P);
  const int t_begin = split * pages_per_split * P;
  const int n_pool = max(min(t_begin + pages_per_split * P, kv_len) - t_begin, 0);
  const int n_tok = n_pool + (kFused && split == 0 ? 1 : 0);

  float qr[kG][kNV][kVec];
  float acc[kG][kNV][kVec];
  float m[kG], l[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      const int vi = j * LT + li;
      uint4 r = make_uint4(0, 0, 0, 0);
      if (g < ng && vi < n_vec)
        r = __ldg(reinterpret_cast<const uint4*>(
            q + ((size_t)b * H + kvh * group + g0 + g) * D + vi * kVec));
      Vec<T>::unpack(r, qr[g][j]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        qr[g][j][e] *= scale;
        acc[g][j][e] = 0.f;
      }
    }
  }

  // K/V rows of the kU tokens a lane group takes at `base`, as raw
  // 16-byte vectors; a token past the split loads nothing
  const int stride = kWarps * tpw;  // tokens the block takes per u step
  auto load = [&](int base, uint4 (&kr)[kU][kNV], uint4 (&vr)[kU][kNV],
                  bool (&valid)[kU]) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + u * stride + warp * tpw + lg;
      valid[u] = i < n_tok;
      const T* krow = k_new;
      const T* vrow = v_new;
      if (valid[u]) {
        if constexpr (kSlot) {
          const size_t off = (size_t)b * b_stride +
                             (size_t)(t_begin + i) * s_stride + (size_t)kvh * D;
          krow = kp + off;
          vrow = vp + off;
        } else if (!kFused || i < n_pool) {
          const int tok = t_begin + i;
          const int page = __ldg(page_table + (size_t)b * pps + tok / P);
          const size_t off = (((size_t)page * P + tok % P) * Hk + kvh) * D;
          krow = kp + off;
          vrow = vp + off;
        } else {
          const size_t off = ((size_t)b * Hk + kvh) * D;
          krow = k_new + off;
          vrow = v_new + off;
        }
      }
#pragma unroll
      for (int j = 0; j < kNV; ++j) {
        const int vi = j * LT + li;
        kr[u][j] = vr[u][j] = make_uint4(0, 0, 0, 0);
        if (valid[u] && vi < n_vec) {
          kr[u][j] = __ldg(reinterpret_cast<const uint4*>(krow + vi * kVec));
          vr[u][j] = __ldg(reinterpret_cast<const uint4*>(vrow + vi * kVec));
        }
      }
    }
  };

  uint4 kr[kU][kNV], vr[kU][kNV];
  bool valid[kU];
  load(0, kr, vr, valid);
  for (int base = 0; base < n_tok; base += stride * kU) {
    // the next tokens' loads go out before this step's math
    uint4 kr_next[kU][kNV], vr_next[kU][kNV];
    bool valid_next[kU];
    load(base + stride * kU, kr_next, vr_next, valid_next);

    float s[kG][kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int g = 0; g < kG; ++g) s[g][u] = 0.f;
#pragma unroll
      for (int j = 0; j < kNV; ++j) {
        float kf[kVec];
        Vec<T>::unpack(kr[u][j], kf);
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int e = 0; e < kVec; ++e) s[g][u] = fmaf(qr[g][j][e], kf[e], s[g][u]);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        for (int off = 1; off < LT; off <<= 1)
          s[g][u] += __shfl_xor_sync(kFull, s[g][u], off);
        if (softcap > 0.f) s[g][u] = softcap * tanhf(s[g][u] / softcap);
        if (!valid[u]) s[g][u] = -INFINITY;
      }
    }

    // online softmax per query head, this lane group's state
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kU; ++u) mx = fmaxf(mx, s[g][u]);
      const float ms = safe_max(mx);
      const float c = expf(m[g] - ms);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        s[g][u] = expf(s[g][u] - ms);  // -inf (no token) -> 0
        sum += s[g][u];
      }
      l[g] = l[g] * c + sum;
      m[g] = mx;
#pragma unroll
      for (int j = 0; j < kNV; ++j)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][j][e] *= c;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int j = 0; j < kNV; ++j) {
        float vf[kVec];
        Vec<T>::unpack(vr[u][j], vf);
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[g][j][e] = fmaf(s[g][u], vf[e], acc[g][j][e]);
        kr[u][j] = kr_next[u][j];
        vr[u][j] = vr_next[u][j];
      }
      valid[u] = valid_next[u];
    }
  }

  // merge the warp's lane groups into lane group 0
  for (int off = LT; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float c1 = expf(m[g] - safe_max(mn)), c2 = expf(mo - safe_max(mn));
      l[g] = l[g] * c1 + lo * c2;
      m[g] = mn;
#pragma unroll
      for (int j = 0; j < kNV; ++j)
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float ao = __shfl_xor_sync(kFull, acc[g][j][e], off);
          acc[g][j][e] = acc[g][j][e] * c1 + ao * c2;
        }
    }
  }

  // then the warps, through shared memory: [kWarps][kG][D + 2]
  extern __shared__ float smem[];
  const int row = D + 2;
  if (lg == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float* w = smem + (warp * kG + g) * row;
#pragma unroll
      for (int j = 0; j < kNV; ++j) {
        const int vi = j * LT + li;
        if (vi < n_vec)
#pragma unroll
          for (int e = 0; e < kVec; ++e) w[vi * kVec + e] = acc[g][j][e];
      }
      if (li == 0) {
        w[D] = m[g];
        w[D + 1] = l[g];
      }
    }
  }
  __syncthreads();

  const size_t pair = (size_t)b * Hk + kvh;
  for (int idx = threadIdx.x; idx < ng * D; idx += kThreads) {
    const int g = idx / D, d = idx - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, smem[(w * kG + g) * row + D]);
    const float ms = safe_max(mx);
    float a = 0.f, mass = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* src = smem + (w * kG + g) * row;
      const float c = expf(src[D] - ms);
      a += src[d] * c;
      mass += src[D + 1] * c;
    }
    if (S == 1) {
      out[((size_t)b * H + kvh * group + g0 + g) * D + d] =
          from_f32<T>(mass > 0.f ? a / mass : 0.f);
    } else {
      float* part = partials + ((pair * S + split) * group + g0 + g) * row;
      part[d] = a;
      if (d == 0) {
        part[D] = mx;
        part[D + 1] = mass;
      }
    }
  }
  if (S == 1) return;

  // the last block of this (sequence, kv head, head chunk) merges
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (size_t)b * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each partial's weight exp(m_s - max) (0 for an empty one) and the
  // total mass per head, in split order, in shared memory: [S][kG] m
  // then weights, [S][kG] l, [kG] mass
  const size_t step = (size_t)group * row;  // one split further
  const float* part0 = partials + (pair * S * group + g0) * row;
  float* sm_w = smem;
  float* sm_l = smem + S * kG;
  float* sm_mass = sm_l + S * kG;
  for (int idx = threadIdx.x; idx < S * ng; idx += kThreads) {
    const int s = idx / ng, g = idx - s * ng;
    sm_w[s * kG + g] = __ldcg(part0 + s * step + g * row + D);
    sm_l[s * kG + g] = __ldcg(part0 + s * step + g * row + D + 1);
  }
  __syncthreads();
  if (threadIdx.x < ng) {
    const int g = threadIdx.x;
    float mx = -INFINITY;
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, sm_w[s * kG + g]);
    const float ms = safe_max(mx);
    float mass = 0.f;
    for (int s = 0; s < S; ++s) {
      const float ls = sm_l[s * kG + g];
      const float w = ls > 0.f ? expf(sm_w[s * kG + g] - ms) : 0.f;
      sm_w[s * kG + g] = w;
      mass += ls * w;
    }
    sm_mass[g] = mass;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ng * D; idx += kThreads) {
    const int g = idx / D, d = idx - g * D;
    const float* p = part0 + g * row + d;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) a += sm_w[s * kG + g] * __ldcg(p + s * step);
    const float mass = sm_mass[g];
    out[((size_t)b * H + kvh * group + g0 + g) * D + d] =
        from_f32<T>(mass > 0.f ? a / mass : 0.f);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

struct Args {
  const void *q, *kp, *vp, *page_table, *seq_lens, *k_new, *v_new;
  void *out, *partials, *tickets;
  int B, H, Hk, D, P, pps, n_page_steps, pages_per_split, n_splits;
  float scale, softcap;
  long long b_stride, s_stride;  // the slot form's; 0 for the pool
};

template <typename T, Addr kAddr, int kG, int kNV>
int launch(const Args& a, int lt_log2, cudaStream_t stream) {
  const int group = a.H / a.Hk;
  const int n_hc = (group + kG - 1) / kG;
  // the warps' states, then (in the merging block) the splits' weights
  const size_t smem = sizeof(float) * max(kWarps * kG * (a.D + 2),
                                          (2 * a.n_splits + 1) * kG);
  auto kernel = paged_decode_split_kernel<T, kAddr, kG, kNV>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(a.n_splits, a.Hk * n_hc, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)a.q, (const T*)a.kp, (const T*)a.vp, (const int*)a.page_table,
      (const int*)a.seq_lens, (const T*)a.k_new, (const T*)a.v_new, (T*)a.out,
      (float*)a.partials, (int*)a.tickets, a.H, a.Hk, a.D, a.P, a.pps,
      a.n_page_steps, a.pages_per_split, lt_log2, a.scale, a.softcap,
      a.b_stride, a.s_stride);
  return (int)cudaGetLastError();
}

template <typename T, Addr kAddr, int kNV>
int by_group(const Args& a, int lt_log2, cudaStream_t s) {
  switch (a.H / a.Hk) {
    case 1: return launch<T, kAddr, 1, kNV>(a, lt_log2, s);
    case 2: return launch<T, kAddr, 2, kNV>(a, lt_log2, s);
    case 3: return launch<T, kAddr, 3, kNV>(a, lt_log2, s);
    case 4: return launch<T, kAddr, 4, kNV>(a, lt_log2, s);
    default: return launch<T, kAddr, 8, kNV>(a, lt_log2, s);
  }
}

template <typename T, Addr kAddr>
int dispatch(const Args& a, cudaStream_t s) {
  const int n_splits_needed = (a.n_page_steps + a.pages_per_split - 1) /
                              max(a.pages_per_split, 1);
  if (a.D % 8 || a.D > 256 || a.D <= 0 || a.Hk <= 0 || a.H % a.Hk ||
      a.pages_per_split < 1 || a.n_page_steps < 1 ||
      a.n_splits != n_splits_needed || a.B > 65535 ||
      (a.n_splits > 1 && (a.partials == nullptr || a.tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  // slot rows start on 16 bytes when the base does (the wrapper's check)
  if (kAddr == Addr::kSlot &&
      (a.P != 1 || a.b_stride < 0 || a.s_stride < 0 ||
       a.b_stride % Vec<T>::kN || a.s_stride % Vec<T>::kN))
    return (int)cudaErrorInvalidValue;
  const int n_vec = a.D / Vec<T>::kN;
  int lt_log2 = 0;
  while ((1 << lt_log2) < n_vec && lt_log2 < 5) ++lt_log2;
  if constexpr (Vec<T>::kN == 4) {  // float32 rows past 128 values
    if (n_vec > 32) return by_group<T, kAddr, 2>(a, lt_log2, s);
  }
  return by_group<T, kAddr, 1>(a, lt_log2, s);
}

template <Addr kAddr>
int run(const Args& a, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float, kAddr>(a, s);
  return dispatch<__nv_bfloat16, kAddr>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 means none. The pages
// [0, n_page_steps) are cut into n_splits splits of pages_per_split
// (n_splits = ceil(n_page_steps / pages_per_split)). partials: float32
// scratch of B * Hk * n_splits * (H / Hk) * (D + 2) values; tickets:
// int32 counters, at least B * H, all 0 (the kernel leaves them 0).
// Both are unused when n_splits is 1. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int batched_paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* seq_lens, const void* k_new,
    const void* v_new, void* out, void* partials, void* tickets, int B, int H,
    int Hk, int D, int page_size, int pages_per_seq, int n_page_steps,
    int pages_per_split, int n_splits, float scale, float softcap, int dtype,
    void* stream) {
  const Args a{q, k_pages, v_pages, page_table, seq_lens, k_new, v_new,
               out, partials, tickets, B, H, Hk, D, page_size, pages_per_seq,
               n_page_steps, pages_per_split, n_splits, scale, softcap,
               0, 0};
  return run<Addr::kPagedFused>(a, dtype, stream);
}

// The per-sequence form: no fused token, the splits over every page of
// the table (n_page_steps = pages_per_seq). Same conventions.
extern "C" int paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* seq_lens, void* out, void* partials,
    void* tickets, int B, int H, int Hk, int D, int page_size,
    int pages_per_seq, int pages_per_split, int n_splits, float scale,
    float softcap, int dtype, void* stream) {
  const Args a{q, k_pages, v_pages, page_table, seq_lens, nullptr, nullptr,
               out, partials, tickets, B, H, Hk, D, page_size, pages_per_seq,
               pages_per_seq, pages_per_split, n_splits, scale, softcap,
               0, 0};
  return run<Addr::kPaged>(a, dtype, stream);
}

// The slot form: the contiguous cache k/v, lane b's token t at element
// b * b_stride + t * s_stride (+ kv head * D; each (Hk, D) row block
// contiguous, strides multiples of 16 bytes), cache_len[b] valid tokens
// of S. The splits of tokens_per_split tile [0, S), n_splits =
// ceil(S / tokens_per_split). A cache_len of 0 gives zeros. Same
// conventions otherwise.
extern "C" int slot_decode_launch(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* out, void* partials, void* tickets, int B, int H, int Hk, int D,
    int S, int tokens_per_split, int n_splits, long long b_stride,
    long long s_stride, float scale, float softcap, int dtype, void* stream) {
  const Args a{q, k, v, nullptr, cache_len, nullptr, nullptr, out, partials,
               tickets, B, H, Hk, D, 1, 0, S, tokens_per_split, n_splits,
               scale, softcap, b_stride, s_stride};
  return run<Addr::kSlot>(a, dtype, stream);
}
