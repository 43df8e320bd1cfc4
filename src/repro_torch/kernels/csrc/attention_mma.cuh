// Tensor-core tile body of the two bf16 prefill-attention kernels
// (flash_attention.cu and chunked_prefill.cu), for Hopper (sm_90a).
//
// One block of four warps owns 64 query rows of one (sequence, kv head):
// row r is query position r / group, q head r % group of the kv head, so
// the whole GQA group shares each staged K/V tile. Warp w owns rows
// 16w..16w+15 and keeps their softmax state (max, sum) and the f32
// output accumulator in the registers of the threads that hold the mma
// fragments: a thread holds two rows (lane / 4 and lane / 4 + 8).
//
// The block walks its 64-key tiles twice:
//   pass 1      S = Q K^T (mma.sync.m16n8k16, bf16 in, f32 sums; Q and
//               K fragments by ldmatrix from shared memory), S *= scale,
//               optional softcap c tanh(S / c), in f32, the mask; each
//               row's max, reduced over the quad by warp shuffles. Only
//               K is copied.
//   pass 2      S again, p = exp(s - max) in f32, the row sums, and
//               O += P V: P as three bf16 parts (hi = bf16(p), then
//               bf16 of what is left, twice), each fed from the S
//               registers as the A operand (the accumulator of two
//               8-key n-tiles is the A fragment of one 16-key k-step),
//               V fragments by ldmatrix.trans.
// The mask runs only on a tile that crosses a boundary of some row of
// the block, as three compares per score against each row's span of
// visible keys. A block of one tile (a short prompt) loads it once and
// keeps its scores for the second pass. The two passes, expf and the split P follow the plain
// version, which takes each row's max over its keys (512 at a time)
// before any exp and sums P V in float32. With P in one bf16 part (8
// bits) many bf16 outputs round the other way from the plain
// version's; with three parts few do. The full-width slot-ring check
// holds the model's logits through the kernel to those through the
// plain version at the level of one bf16 ulp, and the one-pass (online
// max) variants missed it by one ulp (PERF.md, PR 14).
// K/V tiles are double-buffered in shared memory and filled by cp.async
// 16-byte copies: the next tile's copies are in flight while the current
// tile is multiplied. A key past the tile's end is zero-filled (the copy
// reads no byte of it), so its V row is finite and its score is masked.
//
// Shared memory rows hold DP (D rounded up to a width instantiated by
// the caller) bf16 plus 8 of padding: a row stride of DP / 8 + 1 (odd)
// 16-byte units puts the eight rows an ldmatrix reads in eight distinct
// bank groups. Columns D..DP are zeros written once, so the k-depth 16
// of Q K^T reads zeros past D; k-steps and n-tiles wholly past D are
// skipped.
//
// A source (the caller's Src) says which keys a block visits and where
// they lie:
//   int q_off;                            position of query row 0
//   const __nv_bfloat16 *k, *v;
//   int n_tiles() const;
//   void tile(int i, int& t0, int& end);  tile i covers keys t0..t0+63,
//                                         of which those < end are valid
//   size_t offset(int key) const;         element offset of a key's row
//                                         in k and v (D contiguous)
//   void span(int q_pos, int end, int& pre, int& lo, int& hi);
//                                         the mask: of the keys < end,
//                                         those in [0, pre) and [lo, hi]
//                                         are visible at q_pos
//   bool full(int t0, int end, int q_min, int q_max);
//                                         every key of the tile is valid
//                                         and visible to every position
//                                         in [q_min, q_max]
// offset() is called only for keys < end, so a paged source reads no
// page-table entry past its last key.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace attn_mma {

constexpr int kRows = 64;     // query rows per block: 4 warps x 16
constexpr int kKeys = 64;     // keys per K/V tile
constexpr int kThreads = 128;
// P enters P V as three bf16 parts: part i is bf16 of what parts
// 0..i-1 left of it, so the parts hold all 24 bits of the f32 weight and
// every product is exact (see the note at the top)
constexpr int kParts = 3;

// dynamic shared memory of one block: Q, then K[2], V[2]
template <int DP>
constexpr size_t smem_bytes() {
  return (size_t)(kRows + 4 * kKeys) * (DP + 8) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 reads nothing and zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sum
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16 of (a, b) as a packed pair; a and b keep what it left over
__device__ __forceinline__ uint32_t take_bf16(float& a, float& b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  a -= f.x;
  b -= f.y;
  return *reinterpret_cast<uint32_t*>(&h);
}

// q and out are [B, L, H, D]; the block's rows are r0..r0+63 of the
// (b, kv head h) slab of L * group rows.
template <int DP, class Src>
__device__ __forceinline__ void attend(const Src& src,
                                       const __nv_bfloat16* __restrict__ q,
                                       __nv_bfloat16* __restrict__ out, int L,
                                       int H, int D, int group, int b, int h,
                                       int r0, float scale, float softcap) {
  constexpr int SD = DP + 8;        // row stride of every tile, elements
  constexpr int kUnits = DP / 8;    // 16-byte units in a padded row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kRows * SD;      // [2][kKeys][SD]
  __nv_bfloat16* sV = sK + 2 * kKeys * SD;  // [2][kKeys][SD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int units = D / 8;                  // 16-byte units of data
  const int n_rows = L * group;

  // zero the padding columns D..DP of Q and of both K/V buffers
  const int pad_units = kUnits - units;
  for (int i = tid; i < (kRows + 4 * kKeys) * pad_units; i += kThreads) {
    const int row = i / pad_units, u = units + i % pad_units;
    *reinterpret_cast<uint4*>(sQ + row * SD + u * 8) = make_uint4(0, 0, 0, 0);
  }
  // the Q tile; rows past the slab are zero-filled
  for (int i = tid; i < kRows * units; i += kThreads) {
    const int r = i / units, u = i - r * units;
    const int row = r0 + r;
    const __nv_bfloat16* from = q;
    int bytes = 0;
    if (row < n_rows) {
      const int p = row / group, g = row - p * group;
      from = q + (((size_t)b * L + p) * H + h * group + g) * D + u * 8;
      bytes = 16;
    }
    cp_async16(sQ + r * SD + u * 8, from, bytes);
  }
  cp_async_commit();

  auto load_tile = [&](int i, int buf, bool with_v) {
    int t0, end;
    src.tile(i, t0, end);
    __nv_bfloat16* dk = sK + buf * kKeys * SD;
    __nv_bfloat16* dv = sV + buf * kKeys * SD;
    for (int j = tid; j < kKeys * units; j += kThreads) {
      const int t = j / units, u = j - t * units;
      size_t off = 0;
      int bytes = 0;
      if (t0 + t < end) {
        off = src.offset(t0 + t) + u * 8;
        bytes = 16;
      }
      cp_async16(dk + t * SD + u * 8, src.k + off, bytes);
      if (with_v) cp_async16(dv + t * SD + u * 8, src.v + off, bytes);
    }
  };

  // positions of this thread's two rows, and the block's range
  const int g4 = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16 + g4;
  const int q_pos0 = src.q_off + (r0 + wrow) / group;
  const int q_pos1 = src.q_off + (r0 + wrow + 8) / group;
  const int q_min = src.q_off + r0 / group;
  const int q_max = src.q_off + (min(r0 + kRows, n_rows) - 1) / group;

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // ldmatrix lane addresses (see the fragment layouts of m16n8k16)
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;

  // S for one tile: Q K^T, scaled, capped, masked
  auto scores = [&](const __nv_bfloat16* tk, int tile,
                    float (&s)[kKeys / 8][4]) {
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      if (ks * 16 >= D) break;
      uint32_t a[4];
      ldmatrix_x4(a, sQ + a_row * SD + ks * 16 + a_col);
#pragma unroll
      for (int np = 0; np < kKeys / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, tk + (np * 16 + k_row) * SD + ks * 16 + k_col);
        mma_16816(s[2 * np], a, bk[0], bk[1]);
        mma_16816(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    int t0, end;
    src.tile(tile, t0, end);
    const bool full = src.full(t0, end, q_min, q_max);
    // the visible keys of each of this thread's rows, as offsets from
    // its first column t0 + 2 * t4: [0, pre) and [lo, hi]
    int pre[2], lo[2], hi[2];
    src.span(q_pos0, end, pre[0], lo[0], hi[0]);
    src.span(q_pos1, end, pre[1], lo[1], hi[1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      pre[r] -= t0 + 2 * t4;
      lo[r] -= t0 + 2 * t4;
      hi[r] -= t0 + 2 * t4;
    }
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const int c = n * 8 + (e & 1), r = e >> 1;
        if (!full && !(c < pre[r] || (c >= lo[r] && c <= hi[r])))
          x = -INFINITY;
        s[n][e] = x;
      }
    }
  };
  // each row's max over the tile, reduced over the quad
  auto take_max = [&](const float (&s)[kKeys / 8][4]) {
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
      m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, d));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, d));
    }
  };
  // weights exp(s - max), their sums, and O += P V
  auto accumulate = [&](const __nv_bfloat16* tv,
                        const float (&s)[kKeys / 8][4]) {
    // a row with no visible key keeps max -inf: subtract 0, so its
    // weights are exp(-inf) = 0 and its sums stay zero
    const float base0 = m0 == -INFINITY ? 0.f : m0;
    const float base1 = m1 == -INFINITY ? 0.f : m1;
    uint32_t pp[kParts][kKeys / 16][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      float p0 = expf(s[n][0] - base0), p1 = expf(s[n][1] - base0);
      float p2 = expf(s[n][2] - base1), p3 = expf(s[n][3] - base1);
      l0 += p0 + p1;
      l1 += p2 + p3;
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        pp[part][n / 2][(n & 1) * 2] = take_bf16(p0, p1);
        pp[part][n / 2][(n & 1) * 2 + 1] = take_bf16(p2, p3);
      }
    }
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) {
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        if (dp * 16 >= D) break;
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, tv + (j * 16 + v_row) * SD + dp * 16 + v_col);
#pragma unroll
        for (int part = kParts - 1; part >= 0; --part) {  // smallest first
          mma_16816(o[2 * dp], pp[part][j], bv[0], bv[1]);
          if (dp * 16 + 8 < D)
            mma_16816(o[2 * dp + 1], pp[part][j], bv[2], bv[3]);
        }
      }
    }
  };

  // two passes over the tiles: the first takes each row's max score,
  // the second its weights exp(s - max), their sums and P V. A block of
  // one tile loads it once and keeps its scores for the second pass.
  const int n_tiles = src.n_tiles();
  if (n_tiles > 0) load_tile(0, 0, n_tiles == 1);
  cp_async_commit();
  float s[kKeys / 8][4];
  if (n_tiles == 1) {
    cp_async_wait<0>();
    __syncthreads();
    scores(sK, 0, s);
    take_max(s);
    accumulate(sV, s);
  } else {
    for (int it = 0; it < 2 * n_tiles; ++it) {
      const int tile = it % n_tiles;
      if (it + 1 < 2 * n_tiles)
        load_tile((it + 1) % n_tiles, (it + 1) & 1, it + 1 >= n_tiles);
      cp_async_commit();
      cp_async_wait<1>();  // Q and tile it have landed
      __syncthreads();
      scores(sK + (it & 1) * kKeys * SD, tile, s);
      if (it < n_tiles)
        take_max(s);
      else
        accumulate(sV + (it & 1) * kKeys * SD, s);
      __syncthreads();  // every warp is done with this buffer
    }
  }

  // the sums over the quad; a row with no visible key writes zeros
#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  const float mass0 = l0 == 0.f ? 1.f : l0;  // o is 0 there
  const float mass1 = l1 == 0.f ? 1.f : l1;
  cp_async_wait<0>();
  __syncthreads();  // with no tile, the Q copies may still be landing
  // stage the warp's 16 output rows in its own rows of the Q tile, then
  // write them with 16-byte stores
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    if (n * 8 >= D) break;
    const int col = n * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(sQ + wrow * SD + col) =
        pack_bf16(o[n][0] / mass0, o[n][1] / mass0);
    *reinterpret_cast<uint32_t*>(sQ + (wrow + 8) * SD + col) =
        pack_bf16(o[n][2] / mass1, o[n][3] / mass1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * units; i += 32) {
    const int r = warp * 16 + i / units, u = i % units;
    const int row = r0 + r;
    if (row >= n_rows) continue;
    const int p = row / group, g = row - p * group;
    *reinterpret_cast<uint4*>(out + (((size_t)b * L + p) * H + h * group + g) * D +
                              u * 8) =
        *reinterpret_cast<const uint4*>(sQ + r * SD + u * 8);
  }
}

// The padded widths instantiated: D (a multiple of 8, <= 256) runs at
// the least of these that holds it.
inline int padded_width(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 96 ? 96 : D <= 128 ? 128 : 256;
}

}  // namespace attn_mma
