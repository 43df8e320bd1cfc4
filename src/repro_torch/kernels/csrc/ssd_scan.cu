// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (Pallas body
// _ssd_kernel). Inputs are pre-discretised: x [B, L, H, P] already
// dt-scaled, a [B, L, H] the per-step log decay (<= 0), b and c
// [B, L, G, N] shared by the H / G heads of a group (head h reads group
// h / (H / G)). The sequence runs in chunks of Q tokens (the last may be
// short) with a [P, N] float32 state carried from chunk to chunk:
//
//   acs   = inclusive cumsum of a over the chunk
//   y_i   = sum_{j <= i} (C_i . B_j) exp(acs_i - acs_j) x_j
//           + exp(acs_i) C_i . h_in^T          (h_in: state before the chunk)
//   h_out = exp(acs_last) h_in + sum_t exp(acs_last - acs_t) x_t B_t^T
//
// which is what ref.ssd_chunked computes (ref.ssd_chunked_pieces in the
// three stages below). Float32 inside; y in the input dtype.
//
// What bounds it on this card: at mamba2-2.7b's training shape (B 2,
// L 2048, H 80, P 64, N 128, G 1, Q 256, bf16) one call moves 86.6 MB
// (x, a, b, c in, y out once each): 0.0259 ms at 3.35 TB/s. The least
// products the function needs (the causal half of C B^T once per group,
// the causal scores times X per head, C . state and the state update)
// are 14.9 GFLOP: 0.015 ms at the bf16 tensor-core peak. So the floor
// is the bytes.
//
// What the design does about it: the chunk axis, sequential in the
// Pallas grid, is cut across blocks in the three stages of the Mamba-2
// paper's ssd_minimal, three launches (two when there is one chunk):
//
//   1. states  one block per (batch, chunk, head): the cumsum of a over
//              the chunk (written to the scratch lcs [B, nc, H, Q]) and
//              the chunk's local state
//              S = (x o w)^T B, w_t = exp(acs_last - acs_t), as one
//              (P x Q) (Q x N) product, written to the scratch
//              states [B, nc - 1, H, P, N] (the last chunk's is unused);
//   2. pass    per (batch, head, 4 state elements) the only sequential
//              part, nc - 1 steps: h = exp(acs_last) h + S, written in
//              place, so slot c holds the state after chunk c (for bf16
//              as its three bf16 parts: two packed in the float32's
//              place, the third in a bf16 plane after the states);
//   3. scan    one block per (batch, chunk, heads, 64-row tile), the
//              row tiles with the most keys first: exp(acs_i) C . h_in^T,
//              then the key tiles up to the causal frontier, C . B^T
//              formed once for the block's heads (two when the group has
//              an even number, at P <= 64) and, per head, decay-masked
//              and multiplied by X.
//
// bf16 (the trainer's type): every product runs on tensor cores,
// mma.sync.m16n8k16 bf16 -> f32 with ldmatrix operands and cp.async
// copies (the helpers of attention_mma.cuh). C, B and X are exact in
// bf16. A float32 operand (x o w in stage 1, the carried state and the
// decayed scores in stage 3) enters as three bf16 parts, each bf16 of
// what the parts before it left, three products each: all 24 bits of
// it, so the sums are the float32 plain version's up to the order of
// the sums. (With two parts, 16 bits, more bf16 outputs round the other
// way from the plain version's.) N is
// padded with zeros to 16 in shared memory and ragged rows are zero-
// filled; every exponent is clamped at 0. float32 runs the same three
// stages with float32 FMAs on CUDA cores (on no main path; its gate
// needs float32 products). No float atomics: two calls on the same
// inputs give the same bits.

#include "attention_mma.cuh"

namespace {

using attn_mma::cp_async16;
using attn_mma::cp_async_commit;
using attn_mma::cp_async_wait;
using attn_mma::ldmatrix_x4;
using attn_mma::ldmatrix_x4_trans;
using attn_mma::mma_16816;
using attn_mma::pack_bf16;
using attn_mma::smem_u32;
using attn_mma::take_bf16;
using bf16 = __nv_bfloat16;

constexpr int kScanRun = 1024;  // steps of a staged at once for the cumsum
constexpr int kTile = 64;       // rows of a tile (tokens, or query rows)
constexpr int kMmaThreads = 128;
constexpr int kF32Threads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// exp of a log decay, clamped at 0 (expf, not exp2f of a scaled value:
// at the trainer's decays |acs| reaches hundreds, and an ulp of a scaled
// cumsum moves every decay)
__device__ __forceinline__ float decay(float z) { return expf(fminf(z, 0.f)); }

// 8- and 4-byte global -> shared copies; src_bytes 0 reads nothing and
// zero-fills
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1) : "r"(smem_u32(p)) : "memory");
}

// (a, b) as kParts packed bf16 pairs: part k is bf16 of what parts
// 0..k-1 left, so three parts hold all 24 bits of a float32 and every
// product with a bf16 operand is exact
constexpr int kParts = 3;
__device__ __forceinline__ void split(float a, float b, uint32_t (&part)[kParts]) {
#pragma unroll
  for (int k = 0; k < kParts - 1; ++k) part[k] = take_bf16(a, b);
  part[kParts - 1] = pack_bf16(a, b);
}

// acc += sum_k a[k] b: the parts, smallest first, summed into a zeroed
// fragment (the tensor cores truncate their float32 sums, so each
// truncating chain is three products long) and added to acc rounded.
__device__ __forceinline__ void mma_parts(float (&acc)[4],
                                          const uint32_t (&a)[kParts][4],
                                          uint32_t b0, uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = kParts - 1; k >= 0; --k) mma_16816(t, a[k], b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// out[i] = a[0] + ... + a[i] for i < q, a strided by `stride`, summed in
// order as the plain version's cumsum is: the block stages runs of
// kScanRun steps in shared `buf` and one thread adds them up (a few
// hundred adds from shared memory; an order of its own, such as a
// parallel scan, moves every decay by an ulp of |acs|). Called by every
// thread; ends with a barrier (out may be global).
template <int NT, typename T>
__device__ void chunk_cumsum(const T* __restrict__ a, size_t stride,
                             float* __restrict__ out, int q, float* buf) {
  float run = 0.f;
  for (int i0 = 0; i0 < q; i0 += kScanRun) {
    const int n = min(kScanRun, q - i0);
    for (int i = threadIdx.x; i < n; i += NT) buf[i] = to_f32(a[(size_t)(i0 + i) * stride]);
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 0; i < n; ++i) {
        run += buf[i];
        buf[i] = run;
      }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += NT) out[i0 + i] = buf[i];
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// stage 1, bf16: chunk states on tensor cores
// ---------------------------------------------------------------------------

// Output tile [P, N]: P / 16 row strips of 16 by N / 8 column tiles of
// 8. Strips go to warps round-robin (two a warp at P 128); where there
// are fewer than four strips, the warps of a strip share its column
// tiles, every Wp-th one. Each thread keeps at most 64 sums.
template <int P>
struct StateTiles {
  static constexpr int kStrips = P / 16;
  static constexpr int kPar = kStrips < 4 ? kStrips : 4;  // strips at once
  static constexpr int kSW = kStrips / kPar;              // strips a warp
  static constexpr int kWp = 4 / kPar;                    // warps a strip
  static constexpr int kNTMax = (8192 / P < 256 ? 8192 / P : 256) / 8;
  static constexpr int kNTW = (kNTMax + kWp - 1) / kWp;   // column tiles a warp
};

// grid (B * nc, H); 128 threads. S_c = sum_t exp(l_last - l_t) x_t b_t^T
// (l the cumsum of a) for every chunk but the last, and l for every chunk.
template <int P>
__global__ void __launch_bounds__(kMmaThreads)
ssd_states_bf16(const bf16* __restrict__ x, const bf16* __restrict__ a,
                const bf16* __restrict__ bm, float* __restrict__ states,
                float* __restrict__ lcs, int L, int H, int G, int N, int Q,
                int nc) {
  using TT = StateTiles<P>;
  constexpr int SX = P + 8;                 // row stride of the x o w tiles
  const int bb = blockIdx.x / nc, c = blockIdx.x % nc, h = blockIdx.y;
  const int g = h / (H / G);
  const int c0 = c * Q, q = min(Q, L - c0);
  const int NP = (N + 15) & ~15, SN = NP + 8, NT = NP / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sXw = reinterpret_cast<bf16*>(smem_raw);   // [kParts][kTile][SX] x o w
  bf16* sXr = sXw + kParts * kTile * SX;           // [2][kTile][P]       x as read
  bf16* sB = sXr + 2 * kTile * P;                  // [2][kTile][SN]
  float* sLw = reinterpret_cast<float*>(sB + 2 * kTile * SN);  // [2][kTile]
  __shared__ float scan_buf[kScanRun];

  float* lb = lcs + (((size_t)bb * nc + c) * H + h) * Q;
  chunk_cumsum<kMmaThreads>(a + ((size_t)bb * L + c0) * H + h, (size_t)H, lb,
                            q, scan_buf);
  if (c == nc - 1) return;                  // q == Q from here
  const float llast = lb[q - 1];

  float acc[TT::kSW][TT::kNTW][4];
#pragma unroll
  for (int s = 0; s < TT::kSW; ++s)
#pragma unroll
    for (int j = 0; j < TT::kNTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;

  // copy token rows t0.. of b, x and l into buffer buf; rows past the
  // chunk and columns past N are zero-filled
  const int nu = NP / 4;                    // 8-byte units of a b row
  auto stage = [&](int t0, int buf) {
    bf16* db = sB + buf * kTile * SN;
    for (int i = tid; i < kTile * nu; i += kMmaThreads) {
      const int t = i / nu, u = i - t * nu;
      const bool ok = t0 + t < q && 4 * u < N;
      const bf16* src = bm + (((size_t)bb * L + c0 + t0 + t) * G + g) * N + 4 * u;
      cp_async8(db + t * SN + 4 * u, ok ? src : bm, ok ? 8 : 0);
    }
    bf16* dx = sXr + buf * kTile * P;
    for (int i = tid; i < kTile * (P / 8); i += kMmaThreads) {
      const int t = i / (P / 8), u = i - t * (P / 8);
      const bool ok = t0 + t < q;
      const bf16* src = x + (((size_t)bb * L + c0 + t0 + t) * H + h) * P + 8 * u;
      cp_async16(dx + t * P + 8 * u, ok ? src : x, ok ? 16 : 0);
    }
    if (tid < kTile) {
      const bool ok = t0 + tid < q;
      cp_async4(sLw + buf * kTile + tid, ok ? lb + t0 + tid : lb, ok ? 4 : 0);
    }
    cp_async_commit();
  };

  stage(0, 0);
  for (int t0 = 0, buf = 0; t0 < q; t0 += kTile, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();              // tile ready; the last tile's readers done
    if (t0 + kTile < q) stage(t0 + kTile, buf ^ 1);
    const bf16* xr = sXr + buf * kTile * P;
    const float* lw = sLw + buf * kTile;
    for (int i = tid; i < kTile * (P / 8); i += kMmaThreads) {
      const int t = i / (P / 8), u = i - t * (P / 8);
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + t * P + 8 * u);
      const float w = decay(llast - lw[t]);
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
      uint32_t pw[kParts][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t pk[kParts];
        split(__bfloat162float(v[2 * k]) * w, __bfloat162float(v[2 * k + 1]) * w, pk);
#pragma unroll
        for (int s = 0; s < kParts; ++s) pw[s][k] = pk[s];
      }
#pragma unroll
      for (int s = 0; s < kParts; ++s)
        *reinterpret_cast<uint4*>(sXw + (s * kTile + t) * SX + 8 * u) =
            make_uint4(pw[s][0], pw[s][1], pw[s][2], pw[s][3]);
    }
    __syncthreads();
    const bf16* bt = sB + buf * kTile * SN;

#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t af[TT::kSW][kParts][4];
#pragma unroll
      for (int s = 0; s < TT::kSW; ++s) {
        const int ms = warp % TT::kPar + TT::kPar * s;
        const int off = (16 * ks + ((lane >> 4) << 3) + (lane & 7)) * SX +
                        ms * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int k = 0; k < kParts; ++k)
          ldmatrix_x4_trans(af[s][k], sXw + k * kTile * SX + off);
      }
#pragma unroll
      for (int j = 0; j < TT::kNTW; ++j) {
        const int nt = warp / TT::kPar + TT::kWp * j;
        if (nt < NT) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, bt + (16 * ks + ((lane >> 3) & 1) * 8 +
                                          (lane & 7)) * SN + nt * 8);
#pragma unroll
          for (int s = 0; s < TT::kSW; ++s) mma_parts(acc[s][j], af[s], b0, b1);
        }
      }
    }
  }

  float* out = states + (((size_t)bb * (nc - 1) + c) * H + h) * P * N;
  const int gr = lane >> 2, gc = 2 * (lane & 3);
#pragma unroll
  for (int s = 0; s < TT::kSW; ++s) {
    const int p = (warp % TT::kPar + TT::kPar * s) * 16 + gr;
#pragma unroll
    for (int j = 0; j < TT::kNTW; ++j) {
      const int n = (warp / TT::kPar + TT::kWp * j) * 8 + gc;
      if (n < N) {
        *reinterpret_cast<float2*>(out + (size_t)p * N + n) =
            make_float2(acc[s][j][0], acc[s][j][1]);
        *reinterpret_cast<float2*>(out + (size_t)(p + 8) * N + n) =
            make_float2(acc[s][j][2], acc[s][j][3]);
      }
    }
  }
}

template <int P>
size_t states_bf16_smem(int N) {
  const int NP = (N + 15) & ~15;
  return sizeof(bf16) * ((size_t)kParts * kTile * (P + 8) + (size_t)2 * kTile * P +
                         (size_t)2 * kTile * (NP + 8)) +
         sizeof(float) * 2 * kTile;
}

// ---------------------------------------------------------------------------
// stage 2: the state pass
// ---------------------------------------------------------------------------

// grid (ceil(P N / 4 / 256), H, B); 256 threads, 4 state elements each.
// Slot c of states (c < nc - 1) holds S_c and becomes the state after
// chunk c: h = exp(l_last(c)) h + S_c. kPack stores it in the three
// bf16 parts stage 3 multiplies on tensor cores: parts 0 and 1 as one
// packed word in place of the float32 (low half part 0), part 2 in the
// same place of `third` [B, nc - 1, H, P, N].
template <bool kPack>
__global__ void __launch_bounds__(kF32Threads)
ssd_state_pass(float* __restrict__ states, bf16* __restrict__ third,
               const float* __restrict__ lcs, int H, int PN, int Q, int nc) {
  const int e4 = blockIdx.x * kF32Threads + threadIdx.x;
  const int h = blockIdx.y, bb = blockIdx.z;
  if (4 * e4 >= PN) return;
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc - 1; ++c) {
    const size_t slab = (((size_t)bb * (nc - 1) + c) * H + h) * PN;
    float4* slot = reinterpret_cast<float4*>(states + slab) + e4;
    const float4 s = *slot;
    const float keep = decay(lcs[(((size_t)bb * nc + c) * H + h) * Q + Q - 1]);
    hv.x = fmaf(keep, hv.x, s.x);
    hv.y = fmaf(keep, hv.y, s.y);
    hv.z = fmaf(keep, hv.z, s.z);
    hv.w = fmaf(keep, hv.w, s.w);
    if (kPack) {
      uint32_t pa[kParts], pb[kParts];
      split(hv.x, hv.y, pa);
      split(hv.z, hv.w, pb);
      *reinterpret_cast<uint4*>(slot) = make_uint4(
          __byte_perm(pa[0], pa[1], 0x5410), __byte_perm(pa[0], pa[1], 0x7632),
          __byte_perm(pb[0], pb[1], 0x5410), __byte_perm(pb[0], pb[1], 0x7632));
      *reinterpret_cast<uint2*>(third + slab + 4 * e4) = make_uint2(pa[2], pb[2]);
    } else {
      *slot = hv;
    }
  }
}

// ---------------------------------------------------------------------------
// stage 3, bf16: the chunk scan on tensor cores
// ---------------------------------------------------------------------------

// Shared memory of one block, in bf16 elements: the C row tile, then a
// region that first holds the carried state of one head at a time (its
// parts 0 and 1 as packed words, then part 2) and then the B key tile
// and the HB heads' X key tiles; then the key tiles' l, in float32.
template <int P, int HB>
struct ScanSmem {
  int SN, c_elems, h_elems, b_elems, x_elems, region;
  __host__ __device__ explicit ScanSmem(int N) {
    const int NP = (N + 15) & ~15;
    SN = NP + 8;
    c_elems = kTile * SN;
    h_elems = P * SN;                       // words of one head's h_in
    b_elems = kTile * SN;
    x_elems = kTile * (P + 8);
    const int inter = 3 * h_elems;          // the words, then part 2
    const int keys = b_elems + HB * x_elems;
    region = inter > keys ? inter : keys;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(bf16) * ((size_t)c_elems + region) +
           sizeof(float) * HB * kTile;
  }
};

// grid (B * nc, H / HB, ceil(Q / 64)); 128 threads. Warp w owns rows
// 16w..16w+15 of the block's 64-row tile of chunk c, for HB heads of one
// group; z runs backwards so the row tiles with the most keys go first.
template <int P, int HB>
__global__ void __launch_bounds__(kMmaThreads)
ssd_scan_bf16(const bf16* __restrict__ x, const bf16* __restrict__ bm,
              const bf16* __restrict__ cm, const uint32_t* __restrict__ hin,
              const bf16* __restrict__ hin3, const float* __restrict__ lcs,
              bf16* __restrict__ y, int L,
              int H, int G, int N, int Q, int nc) {
  constexpr int NPT = P / 8;                // column tiles of y
  constexpr int SX = P + 8;
  const int bb = blockIdx.x / nc, c = blockIdx.x % nc, h0 = blockIdx.y * HB;
  const int rt = gridDim.z - 1 - blockIdx.z;
  const int c0 = c * Q, q = min(Q, L - c0), r0 = rt * kTile;
  if (r0 >= q) return;
  const int g = h0 / (H / G);
  const ScanSmem<P, HB> sm(N);
  const int SN = sm.SN, NP = SN - 8, nu = NP / 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gc = 2 * (lane & 3);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);
  bf16* region = sC + sm.c_elems;
  float* sLk = reinterpret_cast<float*>(region + sm.region);  // [HB][kTile]

  const float* lb[HB];
#pragma unroll
  for (int hh = 0; hh < HB; ++hh)
    lb[hh] = lcs + (((size_t)bb * nc + c) * H + h0 + hh) * Q;
  const size_t brow = (size_t)G * N;
  const bf16* cg = cm + ((size_t)bb * L + c0) * brow + (size_t)g * N;
  const bf16* bg = bm + ((size_t)bb * L + c0) * brow + (size_t)g * N;

  // the C row tile; rows past the chunk and columns past N are zeros
  for (int i = tid; i < kTile * nu; i += kMmaThreads) {
    const int r = i / nu, u = i - r * nu;
    const bool ok = r0 + r < q && 4 * u < N;
    cp_async8(sC + r * SN + 4 * u, ok ? cg + (size_t)(r0 + r) * brow + 4 * u : cm,
              ok ? 8 : 0);
  }
  cp_async_commit();

  const int ia = r0 + 16 * warp + gr, ib = ia + 8;   // this thread's rows
  float la[HB], lbr[HB];
#pragma unroll
  for (int hh = 0; hh < HB; ++hh) {
    la[hh] = ia < q ? lb[hh][ia] : 0.f;
    lbr[hh] = ib < q ? lb[hh][ib] : 0.f;
  }

  float acc[HB][NPT][4];
#pragma unroll
  for (int hh = 0; hh < HB; ++hh)
#pragma unroll
    for (int j = 0; j < NPT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hh][j][e] = 0.f;

  // inter-chunk term: exp(l_i) C_i . h_in^T, h_in in three bf16 parts.
  // Parts 0 and 1 come as packed words [P][N]: over a k-depth of 16 that
  // doubles each state column, a word is the B fragment of two k and the
  // C value of that column, duplicated, the A fragment; so the words are
  // copied as they are. Part 2 [P][N] is an ordinary B operand.
  if (c > 0) {
    uint32_t* dh = reinterpret_cast<uint32_t*>(region);
    bf16* d3 = region + 2 * sm.h_elems;
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {       // one head's state at a time
      if (hh > 0) __syncthreads();          // the last head's readers are done
      const size_t slab = (((size_t)bb * (nc - 1) + c - 1) * H + h0 + hh) * (size_t)(P * N);
      for (int i = tid; i < P * nu; i += kMmaThreads) {
        const int p = i / nu, u = i - p * nu;
        const bool ok = 4 * u < N;
        const size_t off = slab + (size_t)p * N + 4 * u;
        cp_async16(dh + p * SN + 4 * u, ok ? hin + off : hin, ok ? 16 : 0);
        cp_async8(d3 + p * SN + 4 * u, ok ? hin3 + off : hin3, ok ? 8 : 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int ks = 0; ks < NP / 16; ++ks) {
        uint32_t ca[4];
        ldmatrix_x4(ca, sC + (16 * warp + (lane & 15)) * SN + 16 * ks + (lane >> 4) * 8);
        // columns 16 ks + gc, + 1 (d0) and 16 ks + 8 + gc, + 1 (d1), each
        // value twice
        const uint32_t d0[4] = {__byte_perm(ca[0], 0, 0x1010), __byte_perm(ca[1], 0, 0x1010),
                                __byte_perm(ca[0], 0, 0x3232), __byte_perm(ca[1], 0, 0x3232)};
        const uint32_t d1[4] = {__byte_perm(ca[2], 0, 0x1010), __byte_perm(ca[3], 0, 0x1010),
                                __byte_perm(ca[2], 0, 0x3232), __byte_perm(ca[3], 0, 0x3232)};
#pragma unroll
        for (int pp = 0; pp < P / 16; ++pp) {
          uint32_t b3[4];
          ldmatrix_x4(b3, d3 + (pp * 16 + ((lane >> 4) << 3) + (lane & 7)) * SN +
                              16 * ks + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = 2 * pp + half;
            const uint32_t* row = dh + (j * 8 + gr) * SN + 16 * ks + gc;
            const uint2 w0 = *reinterpret_cast<const uint2*>(row);
            const uint2 w1 = *reinterpret_cast<const uint2*>(row + 8);
            // part 2, then parts 0 and 1, into a zeroed fragment (see mma_parts)
            float t[4] = {0.f, 0.f, 0.f, 0.f};
            mma_16816(t, ca, b3[2 * half], b3[2 * half + 1]);
            mma_16816(t, d0, w0.x, w0.y);
            mma_16816(t, d1, w1.x, w1.y);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[hh][j][e] += t[e];
          }
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      const float da = decay(la[hh]), db = decay(lbr[hh]);
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        acc[hh][j][0] *= da;
        acc[hh][j][1] *= da;
        acc[hh][j][2] *= db;
        acc[hh][j][3] *= db;
      }
    }
    __syncthreads();                        // the region is reused below
  }

  // intra-chunk term over the key tiles up to the causal frontier
  bf16* sB = region;
  auto sX = [&](int hh) { return region + sm.b_elems + hh * sm.x_elems; };
  auto load_keys = [&](int kt) {
    const int t0 = kt * kTile;
    for (int i = tid; i < kTile * nu; i += kMmaThreads) {
      const int t = i / nu, u = i - t * nu;
      const bool ok = t0 + t < q && 4 * u < N;
      cp_async8(sB + t * SN + 4 * u,
                ok ? bg + (size_t)(t0 + t) * brow + 4 * u : bm, ok ? 8 : 0);
    }
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
      for (int i = tid; i < kTile * (P / 8); i += kMmaThreads) {
        const int t = i / (P / 8), u = i - t * (P / 8);
        const bool ok = t0 + t < q;
        cp_async16(sX(hh) + t * SX + 8 * u,
                   ok ? x + (((size_t)bb * L + c0 + t0 + t) * H + h0 + hh) * P + 8 * u
                      : x,
                   ok ? 16 : 0);
      }
    for (int i = tid; i < HB * kTile; i += kMmaThreads) {
      const int hh = i / kTile, t = i - hh * kTile;
      const bool ok = t0 + t < q;
      const float* src = lcs + (((size_t)bb * nc + c) * H + h0 + hh) * Q + t0 + t;
      cp_async4(sLk + hh * kTile + t, ok ? src : lcs, ok ? 4 : 0);
    }
    cp_async_commit();
  };

  for (int kt = 0; kt <= rt; ++kt) {
    load_keys(kt);
    cp_async_wait<0>();
    __syncthreads();
    const bool diag = kt == rt;
    const int jn_end = diag ? 2 * warp + 2 : kTile / 8;   // key column tiles

    // C . B^T for the warp's 16 rows, once for the block's heads
    float cb[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[j][e] = 0.f;
    for (int ks = 0; ks < NP / 16; ++ks) {
      uint32_t ca[4];
      ldmatrix_x4(ca, sC + (16 * warp + (lane & 15)) * SN + 16 * ks + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < kTile / 16; ++jp) {
        if (2 * jp < jn_end) {
          uint32_t bk[4];
          ldmatrix_x4(bk, sB + (jp * 16 + ((lane >> 4) << 3) + (lane & 7)) * SN +
                              16 * ks + ((lane >> 3) & 1) * 8);
          mma_16816(cb[2 * jp], ca, bk[0], bk[1]);
          mma_16816(cb[2 * jp + 1], ca, bk[2], bk[3]);
        }
      }
    }

    const int kbase = kt * kTile;
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      const float* lk = sLk + hh * kTile;
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        if (2 * ks < jn_end) {
          uint32_t af[kParts][4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int jn = 2 * ks + half;
            const int j0 = jn * 8 + gc;
            const float l0 = lk[j0], l1 = lk[j0 + 1];
            const int k0 = kbase + j0;
            float s0 = cb[jn][0] * decay(la[hh] - l0);
            float s1 = cb[jn][1] * decay(la[hh] - l1);
            float s2 = cb[jn][2] * decay(lbr[hh] - l0);
            float s3 = cb[jn][3] * decay(lbr[hh] - l1);
            if (diag) {
              if (k0 > ia) s0 = 0.f;
              if (k0 + 1 > ia) s1 = 0.f;
              if (k0 > ib) s2 = 0.f;
              if (k0 + 1 > ib) s3 = 0.f;
            }
            uint32_t pa[kParts], pb[kParts];
            split(s0, s1, pa);
            split(s2, s3, pb);
#pragma unroll
            for (int k = 0; k < kParts; ++k) {
              af[k][2 * half] = pa[k];
              af[k][2 * half + 1] = pb[k];
            }
          }
#pragma unroll
          for (int pp = 0; pp < P / 16; ++pp) {
            uint32_t bx[4];
            ldmatrix_x4_trans(bx, sX(hh) + (16 * ks + (lane & 15)) * SX +
                                      pp * 16 + (lane >> 4) * 8);
            mma_parts(acc[hh][2 * pp], af, bx[0], bx[1]);
            mma_parts(acc[hh][2 * pp + 1], af, bx[2], bx[3]);
          }
        }
      }
    }
    __syncthreads();                        // the tile is refilled next
  }

#pragma unroll
  for (int hh = 0; hh < HB; ++hh) {
    bf16* ya = y + (((size_t)bb * L + c0 + ia) * H + h0 + hh) * P + gc;
    bf16* yb = ya + (size_t)8 * H * P;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      if (ia < q)
        *reinterpret_cast<uint32_t*>(ya + j * 8) = pack_bf16(acc[hh][j][0], acc[hh][j][1]);
      if (ib < q)
        *reinterpret_cast<uint32_t*>(yb + j * 8) = pack_bf16(acc[hh][j][2], acc[hh][j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// stages 1 and 3, float32: the same stages with FMAs on CUDA cores
// ---------------------------------------------------------------------------

constexpr int kKeys32 = 32;    // key rows of a float32 key tile

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// grid (B * nc, H); 256 threads. Thread owns state rows 4 pg .. 4 pg + 3
// and columns sn0 + j kTG, j < 8 (P N <= 8192).
template <int P>
__global__ void __launch_bounds__(kF32Threads)
ssd_states_f32(const float* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ bm, float* __restrict__ states,
               float* __restrict__ lcs, int L, int H, int G, int N, int Q,
               int nc) {
  constexpr int kPG = P / 4, kTG = kF32Threads / kPG, kMaxJ = 8;
  const int bb = blockIdx.x / nc, c = blockIdx.x % nc, h = blockIdx.y;
  const int g = h / (H / G);
  const int c0 = c * Q, q = min(Q, L - c0);
  const int tid = threadIdx.x, NS = N + 4;
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);   // [kKeys32][NS]
  float* xs = bs + kKeys32 * NS;                 // [kKeys32][P]  x o w
  __shared__ float scan_buf[kScanRun];

  float* lb = lcs + (((size_t)bb * nc + c) * H + h) * Q;
  chunk_cumsum<kF32Threads>(a + ((size_t)bb * L + c0) * H + h, (size_t)H, lb,
                            q, scan_buf);
  if (c == nc - 1) return;
  const float llast = lb[q - 1];
  const int pg = tid / kTG, sn0 = tid % kTG, nj = (N + kTG - 1) / kTG;
  float acc[4][kMaxJ];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) acc[u][j] = 0.f;

  for (int t0 = 0; t0 < q; t0 += kKeys32) {
    const int tn = min(kKeys32, q - t0);
    __syncthreads();
    for (int i = tid; i < kKeys32 * N; i += kF32Threads) {
      const int t = i / N, n = i - t * N;
      bs[t * NS + n] = t < tn ? bm[(((size_t)bb * L + c0 + t0 + t) * G + g) * N + n] : 0.f;
    }
    for (int i = tid; i < kKeys32 * P; i += kF32Threads) {
      const int t = i / P, p = i - t * P;
      xs[i] = t < tn ? x[(((size_t)bb * L + c0 + t0 + t) * H + h) * P + p] *
                           decay(llast - lb[t0 + t])
                     : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < kKeys32; ++t) {
      const float4 x4 = ld4(xs + t * P + 4 * pg);
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int n = sn0 + j * kTG;
        if (j < nj && n < N) {
          const float bv = bs[t * NS + n];
          acc[0][j] = fmaf(x4.x, bv, acc[0][j]);
          acc[1][j] = fmaf(x4.y, bv, acc[1][j]);
          acc[2][j] = fmaf(x4.z, bv, acc[2][j]);
          acc[3][j] = fmaf(x4.w, bv, acc[3][j]);
        }
      }
    }
  }
  float* out = states + (((size_t)bb * (nc - 1) + c) * H + h) * P * N;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int n = sn0 + j * kTG;
      if (j < nj && n < N) out[(size_t)(4 * pg + u) * N + n] = acc[u][j];
    }
}

template <int P>
size_t states_f32_smem(int N) {
  return sizeof(float) * (size_t)kKeys32 * (N + 4 + P);
}

// grid (B * nc, H, ceil(Q / 64)), z backwards; 256 threads. A 64-row
// tile: y column yp, rows yr0 + k kYStep in registers; the decay-masked
// scores of a 32-key tile in shared memory.
template <int P>
__global__ void __launch_bounds__(kF32Threads)
ssd_scan_f32(const float* __restrict__ x, const float* __restrict__ bm,
             const float* __restrict__ cm, const float* __restrict__ hin,
             const float* __restrict__ lcs, float* __restrict__ y, int L,
             int H, int G, int N, int Q, int nc) {
  constexpr int kYStep = kF32Threads / P, kNY = kTile / kYStep;
  const int bb = blockIdx.x / nc, c = blockIdx.x % nc, h = blockIdx.y;
  const int rt = gridDim.z - 1 - blockIdx.z;
  const int c0 = c * Q, q = min(Q, L - c0), r0 = rt * kTile;
  if (r0 >= q) return;
  const int rn = min(kTile, q - r0);
  const int g = h / (H / G);
  const int tid = threadIdx.x, NS = N + 4;
  extern __shared__ float4 smem4[];
  float* lr = reinterpret_cast<float*>(smem4);  // [kTile]   row l
  float* lk = lr + kTile;                       // [kKeys32] key l
  float* hs = lk + kKeys32;                     // [P][NS]   h_in
  float* cs = hs + P * NS;                      // [kTile][N]
  float* bs = cs + kTile * N;                   // [kKeys32][NS]
  float* xs = bs + kKeys32 * NS;                // [kKeys32][P]
  float* sc = xs + kKeys32 * P;                 // [kTile][kKeys32]

  const float* lb = lcs + (((size_t)bb * nc + c) * H + h) * Q;
  const size_t brow = (size_t)G * N, xrow = (size_t)H * P;
  const float* cg = cm + ((size_t)bb * L + c0) * brow + (size_t)g * N;
  const float* bg = bm + ((size_t)bb * L + c0) * brow + (size_t)g * N;
  const float* xb = x + ((size_t)bb * L + c0) * xrow + (size_t)h * P;
  for (int i = tid; i < kTile * N; i += kF32Threads) {
    const int r = i / N, n = i - r * N;
    cs[i] = r < rn ? cg[(size_t)(r0 + r) * brow + n] : 0.f;
  }
  for (int i = tid; i < kTile; i += kF32Threads) lr[i] = i < rn ? lb[r0 + i] : 0.f;
  if (c > 0) {
    const float* src = hin + (((size_t)bb * (nc - 1) + c - 1) * H + h) * (size_t)(P * N);
    for (int i = tid; i < P * N; i += kF32Threads) {
      const int p = i / N, n = i - p * N;
      hs[p * NS + n] = src[i];
    }
  }
  __syncthreads();

  const int yp = tid % P, yr0 = tid / P;
  float yacc[kNY];
#pragma unroll
  for (int k = 0; k < kNY; ++k) yacc[k] = 0.f;
  if (c > 0) {
    for (int n = 0; n < N; n += 4) {
      const float4 s4 = ld4(hs + yp * NS + n);
#pragma unroll
      for (int k = 0; k < kNY; ++k) {
        const float4 c4 = ld4(cs + (yr0 + k * kYStep) * N + n);
        yacc[k] = fmaf(c4.x, s4.x, yacc[k]);
        yacc[k] = fmaf(c4.y, s4.y, yacc[k]);
        yacc[k] = fmaf(c4.z, s4.z, yacc[k]);
        yacc[k] = fmaf(c4.w, s4.w, yacc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kNY; ++k) yacc[k] *= decay(lr[yr0 + k * kYStep]);
  }

  const int s_t = tid % kKeys32, sr0 = tid / kKeys32;
  const int t_end = r0 + rn;
  for (int t0 = 0; t0 < t_end; t0 += kKeys32) {
    const int tn = min(kKeys32, t_end - t0);
    for (int i = tid; i < kKeys32 * N; i += kF32Threads) {
      const int t = i / N, n = i - t * N;
      bs[t * NS + n] = t < tn ? bg[(size_t)(t0 + t) * brow + n] : 0.f;
    }
    for (int i = tid; i < kKeys32 * P; i += kF32Threads) {
      const int t = i / P, p = i - t * P;
      xs[i] = t < tn ? xb[(size_t)(t0 + t) * xrow + p] : 0.f;
    }
    if (tid < kKeys32) lk[tid] = tid < tn ? lb[t0 + tid] : 0.f;
    __syncthreads();
    {  // scores C_i . B_j, decayed where j <= i, else 0
      float sacc[kTile / 8];
#pragma unroll
      for (int k = 0; k < kTile / 8; ++k) sacc[k] = 0.f;
      for (int n = 0; n < N; n += 4) {
        const float4 b4 = ld4(bs + s_t * NS + n);
#pragma unroll
        for (int k = 0; k < kTile / 8; ++k) {
          const float4 c4 = ld4(cs + (sr0 + 8 * k) * N + n);
          sacc[k] = fmaf(c4.x, b4.x, sacc[k]);
          sacc[k] = fmaf(c4.y, b4.y, sacc[k]);
          sacc[k] = fmaf(c4.z, b4.z, sacc[k]);
          sacc[k] = fmaf(c4.w, b4.w, sacc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kTile / 8; ++k) {
        const int r = sr0 + 8 * k;
        sc[r * kKeys32 + s_t] = (r < rn && t0 + s_t <= r0 + r)
                                    ? sacc[k] * decay(lr[r] - lk[s_t]) : 0.f;
      }
    }
    __syncthreads();
    for (int t = 0; t < kKeys32; t += 4) {
      const float x0 = xs[(t + 0) * P + yp], x1 = xs[(t + 1) * P + yp];
      const float x2 = xs[(t + 2) * P + yp], x3 = xs[(t + 3) * P + yp];
#pragma unroll
      for (int k = 0; k < kNY; ++k) {
        const float4 s4 = ld4(sc + (yr0 + k * kYStep) * kKeys32 + t);
        yacc[k] = fmaf(s4.x, x0, yacc[k]);
        yacc[k] = fmaf(s4.y, x1, yacc[k]);
        yacc[k] = fmaf(s4.z, x2, yacc[k]);
        yacc[k] = fmaf(s4.w, x3, yacc[k]);
      }
    }
    __syncthreads();
  }
  float* yb = y + ((size_t)bb * L + c0 + r0) * xrow + (size_t)h * P;
#pragma unroll
  for (int k = 0; k < kNY; ++k) {
    const int r = yr0 + k * kYStep;
    if (r < rn) yb[(size_t)r * xrow + yp] = yacc[k];
  }
}

template <int P>
size_t scan_f32_smem(int N) {
  return sizeof(float) * ((size_t)kTile + kKeys32 + (size_t)P * (N + 4) +
                          (size_t)kTile * N + (size_t)kKeys32 * (N + 4) +
                          (size_t)kKeys32 * P + (size_t)kTile * kKeys32);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename... KArgs, typename... Args>
int run(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem,
        cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

template <int P, int HB>
int scan_bf16(const bf16* x, const bf16* b, const bf16* c, const float* states,
              const float* lcs, bf16* y, int B, int L, int H, int G, int N,
              int Q, int nc, cudaStream_t s) {
  dim3 grid(B * nc, H / HB, (Q + kTile - 1) / kTile);
  return run(ssd_scan_bf16<P, HB>, grid, kMmaThreads, ScanSmem<P, HB>(N).bytes(),
             s, x, b, c, reinterpret_cast<const uint32_t*>(states),
             reinterpret_cast<const bf16*>(states + (size_t)B * (nc - 1) * H * P * N),
             lcs, y, L, H, G, N, Q, nc);
}

template <int P>
int launch_bf16(const bf16* x, const bf16* a, const bf16* b, const bf16* c,
                bf16* y, float* states, float* lcs, int B, int L, int H, int G,
                int N, int Q, cudaStream_t s) {
  const int nc = (L + Q - 1) / Q;
  int err = run(ssd_states_bf16<P>, dim3(B * nc, H), kMmaThreads,
                states_bf16_smem<P>(N), s, x, a, b, states, lcs, L, H, G, N, Q, nc);
  if (err) return err;
  if (nc > 1) {
    dim3 grid((P * N / 4 + kF32Threads - 1) / kF32Threads, H, B);
    err = run(ssd_state_pass<true>, grid, kF32Threads, 0, s, states,
              reinterpret_cast<bf16*>(states + (size_t)B * (nc - 1) * H * P * N),
              (const float*)lcs, H, P * N, Q, nc);
    if (err) return err;
  }
  if (P <= 64 && (H / G) % 2 == 0)
    return scan_bf16<P, (P <= 64 ? 2 : 1)>(x, b, c, states, lcs, y, B, L, H, G,
                                           N, Q, nc, s);
  return scan_bf16<P, 1>(x, b, c, states, lcs, y, B, L, H, G, N, Q, nc, s);
}

template <int P>
int launch_f32(const float* x, const float* a, const float* b, const float* c,
               float* y, float* states, float* lcs, int B, int L, int H, int G,
               int N, int Q, cudaStream_t s) {
  const int nc = (L + Q - 1) / Q;
  int err = run(ssd_states_f32<P>, dim3(B * nc, H), kF32Threads,
                states_f32_smem<P>(N), s, x, a, b, states, lcs, L, H, G, N, Q, nc);
  if (err) return err;
  if (nc > 1) {
    dim3 grid((P * N / 4 + kF32Threads - 1) / kF32Threads, H, B);
    err = run(ssd_state_pass<false>, grid, kF32Threads, 0, s, states,
              (bf16*)nullptr, (const float*)lcs, H, P * N, Q, nc);
    if (err) return err;
  }
  dim3 grid(B * nc, H, (Q + kTile - 1) / kTile);
  return run(ssd_scan_f32<P>, grid, kF32Threads, scan_f32_smem<P>(N), s, x, b,
             c, (const float*)states, (const float*)lcs, y, L, H, G, N, Q, nc);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all of x, a, b, c and y). P one of
// 16, 32, 64, 128; N a multiple of 4, at most 256, P * N <= 8192;
// 1 <= Q <= L; H a multiple of G. Scratch from the caller: states,
// B (nc - 1) H P N floats and then as many bf16 (unused when
// nc = ceil(L / Q) is 1), and lcs, B nc H Q floats. Launches 3 kernels (2 when nc is 1) on the stream and
// returns the first cudaGetLastError() that is not 0 (0 = launched).
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* b,
                               const void* c, void* y, void* states, void* lcs,
                               int B, int L, int H, int G, int P, int N, int Q,
                               int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* st = (float*)states;
  float* l = (float*)lcs;
  if (dtype == 1) {
#define SSD_BF16(PP) launch_bf16<PP>((const bf16*)x, (const bf16*)a, \
    (const bf16*)b, (const bf16*)c, (bf16*)y, st, l, B, L, H, G, N, Q, s)
    switch (P) {
      case 16: return SSD_BF16(16);
      case 32: return SSD_BF16(32);
      case 64: return SSD_BF16(64);
      case 128: return SSD_BF16(128);
    }
#undef SSD_BF16
  } else {
#define SSD_F32(PP) launch_f32<PP>((const float*)x, (const float*)a, \
    (const float*)b, (const float*)c, (float*)y, st, l, B, L, H, G, N, Q, s)
    switch (P) {
      case 16: return SSD_F32(16);
      case 32: return SSD_F32(32);
      case 64: return SSD_F32(64);
      case 128: return SSD_F32(128);
    }
#undef SSD_F32
  }
  return (int)cudaErrorInvalidValue;
}
