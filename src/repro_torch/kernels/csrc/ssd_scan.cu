// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (Pallas body
// _ssd_kernel). Inputs are pre-discretised: x [B, L, H, P] already
// dt-scaled, a [B, L, H] the per-step log decay (<= 0), b and c
// [B, L, G, N] shared by the H / G heads of a group (head h reads group
// h / (H / G)). Per (b, h) the sequence runs in chunks of Q tokens with
// a [P, N] float32 state carried from chunk to chunk:
//
//   acs   = inclusive cumsum of a over the chunk
//   y_i   = sum_{j <= i} (C_i . B_j) exp(acs_i - acs_j) x_j
//           + exp(acs_i) C_i . state^T            (state from before the chunk)
//   state = exp(acs_last) state + sum_i exp(acs_last - acs_i) x_i B_i^T
//
// which is what ref.ssd_chunked computes. Any L: a short last chunk is
// the zero-padded chunk of ssd_chunked without its padding (pad tokens
// have x = 0 and a = 0, so they add nothing). Every exponent is of a
// number <= 0: the cumsum is taken in order, so acs is non-increasing,
// and a decay is formed only for j <= i. Float32 inside; output in the
// input dtype.
//
// What bounds it on this card: at mamba2-2.7b's training shape (B 2,
// L 2048, H 80, P 64, N 128, G 1, Q 256, bf16) one call moves 86.5 MB
// (x, a, b, c in, y out once each): 0.026 ms at 3.35 TB/s. The least
// products the function needs (the causal half of C B^T once per group,
// the causal scores times X per head, C.state and the state update)
// are 14.9 GFLOP: 0.015 ms at the bf16 tensor-core peak. So the floor
// is the bytes. (The Pallas algorithm's count, full Q x Q scores for
// every head, is 42.9 GFLOP.) This design forms C B^T again for every
// head of the group, and on CUDA cores.
//
// What the design does about it, simply: one block of 256 threads per
// (b, h), looping over the chunks in order, the Pallas grid's
// sequential chunk axis turned into a loop, with the [P, N] state in
// shared memory. A chunk is done in row tiles of 64 queries; each row
// tile first adds exp(acs_i) C_i . state^T, then walks the 32-token key
// tiles up to its causal frontier, forming the decay-masked scores
// (C B^T o L) in shared memory and adding them times X. After the last
// row tile (and a barrier) the state takes the chunk's update. All
// products are float32 FMAs on CUDA cores from shared memory (about
// 100 KB a block, two blocks an SM); each thread keeps a register tile
// of outputs and reads its operands as float4s, one shared load to
// about three FMAs. At batch 2 the grid is 160 blocks on 132 SMs.
// Splitting the chunk axis across blocks (ssd_minimal's states-then-
// scan form), sharing C B^T across the heads of a group, and tensor
// cores (wgmma) are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // query rows of a chunk per row tile
constexpr int kKeys = 32;   // key rows of a chunk per key tile
constexpr int kMaxJ = 8;    // state columns per thread: P * N <= 8192

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// P (a template parameter: 16, 32, 64 or 128) and N (a multiple of 4,
// at most 256, P * N <= 8192) are checked by the wrapper.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const T* __restrict__ x,   // [B, L, H, P]
                const T* __restrict__ a,   // [B, L, H]
                const T* __restrict__ bm,  // [B, L, G, N]
                const T* __restrict__ cm,  // [B, L, G, N]
                T* __restrict__ y,         // [B, L, H, P]
                int L, int H, int G, int N, int Q) {
  constexpr int kYStep = kThreads / P;     // rows between a thread's y rows
  constexpr int kNY = kRows / kYStep;      // y rows per thread (P / 4)
  constexpr int kPG = P / 4;               // state row groups of 4
  constexpr int kTG = kThreads / kPG;      // threads per state row group
  const int h = blockIdx.x;
  const int bb = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int NS = N + 4;  // row stride of the state and the B tile: float4-aligned, no bank conflicts
  const int Qp = (Q + 3) & ~3;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* acs = smem;                     // [Qp]
  float* st = acs + Qp;                  // [P][NS]   carried state
  float* cs = st + P * NS;               // [kRows][N] C row tile
  float* bs = cs + kRows * N;            // [kKeys][NS] B key tile
  float* xs = bs + kKeys * NS;           // [kKeys][P] X key tile
  float* sc = xs + kKeys * P;            // [kRows][kKeys] masked scores

  for (int i = tid; i < P * NS; i += kThreads) st[i] = 0.f;

  // y: column yp, rows yr0 + k * kYStep
  const int yp = tid % P;
  const int yr0 = tid / P;
  // scores: key column st_t, rows sr0 + 8 k
  const int s_t = tid % kKeys;
  const int sr0 = tid / kKeys;
  // state: rows 4 * pg .. 4 * pg + 3, columns sn0 + j * kTG
  const int pg = tid / kTG;
  const int sn0 = tid % kTG;
  const int nj = (N + kTG - 1) / kTG;

  const size_t xrow = (size_t)H * P;     // stride of one token in x / y
  const size_t brow = (size_t)G * N;     // stride of one token in b / c
  const T* xb = x + (size_t)bb * L * xrow + (size_t)h * P;
  const T* ab = a + (size_t)bb * L * H + h;
  const T* bgb = bm + (size_t)bb * L * brow + (size_t)g * N;
  const T* cgb = cm + (size_t)bb * L * brow + (size_t)g * N;
  T* yb = y + (size_t)bb * L * xrow + (size_t)h * P;

  // stage key rows [t0, t0 + tn) of B and X (X times w when scale): rows
  // past tn are zero, so a whole tile can be read
  auto stage_keys = [&](int c0, int t0, int tn, bool scale, float last) {
    for (int i = tid; i < kKeys * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      bs[t * NS + n] = t < tn ? to_f32(bgb[(size_t)(c0 + t0 + t) * brow + n]) : 0.f;
    }
    for (int i = tid; i < kKeys * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      float v = 0.f;
      if (t < tn) {
        v = to_f32(xb[(size_t)(c0 + t0 + t) * xrow + p]);
        if (scale) v *= expf(last - acs[t0 + t]);
      }
      xs[i] = v;
    }
  };

  for (int c0 = 0; c0 < L; c0 += Q) {
    const int q = min(Q, L - c0);
    for (int i = tid; i < q; i += kThreads) acs[i] = to_f32(ab[(size_t)(c0 + i) * H]);
    __syncthreads();
    if (tid == 0) {  // in order: acs is non-increasing, so no positive exponent
      float run = 0.f;
      for (int i = 0; i < q; ++i) {
        run += acs[i];
        acs[i] = run;
      }
    }
    __syncthreads();

    for (int r0 = 0; r0 < q; r0 += kRows) {
      const int rn = min(kRows, q - r0);
      for (int i = tid; i < kRows * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        cs[i] = r < rn ? to_f32(cgb[(size_t)(c0 + r0 + r) * brow + n]) : 0.f;
      }
      __syncthreads();

      // inter-chunk term: exp(acs_i) * C_i . state^T
      float yacc[kNY];
#pragma unroll
      for (int k = 0; k < kNY; ++k) yacc[k] = 0.f;
      for (int n = 0; n < N; n += 4) {
        const float4 s4 = ld4(st + yp * NS + n);
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
      for (int k = 0; k < kNY; ++k) {
        const int r = yr0 + k * kYStep;
        if (r < rn) yacc[k] *= expf(acs[r0 + r]);
      }

      // intra-chunk term over the key tiles up to the causal frontier
      const int t_end = r0 + rn;
      for (int t0 = 0; t0 < t_end; t0 += kKeys) {
        stage_keys(c0, t0, min(kKeys, t_end - t0), false, 0.f);
        __syncthreads();

        {  // scores: C_i . B_j, decayed where j <= i, else 0
          float sacc[kRows / 8];
#pragma unroll
          for (int k = 0; k < kRows / 8; ++k) sacc[k] = 0.f;
          for (int n = 0; n < N; n += 4) {
            const float4 b4 = ld4(bs + s_t * NS + n);
#pragma unroll
            for (int k = 0; k < kRows / 8; ++k) {
              const float4 c4 = ld4(cs + (sr0 + 8 * k) * N + n);
              sacc[k] = fmaf(c4.x, b4.x, sacc[k]);
              sacc[k] = fmaf(c4.y, b4.y, sacc[k]);
              sacc[k] = fmaf(c4.z, b4.z, sacc[k]);
              sacc[k] = fmaf(c4.w, b4.w, sacc[k]);
            }
          }
#pragma unroll
          for (int k = 0; k < kRows / 8; ++k) {
            const int r = sr0 + 8 * k;
            const int i = r0 + r, j = t0 + s_t;
            // a decay only where j <= i (< q): its exponent is <= 0
            sc[r * kKeys + s_t] = (r < rn && j <= i)
                                      ? sacc[k] * expf(acs[i] - acs[j]) : 0.f;
          }
        }
        __syncthreads();

        for (int t = 0; t < kKeys; t += 4) {
          const float x0 = xs[(t + 0) * P + yp], x1 = xs[(t + 1) * P + yp];
          const float x2 = xs[(t + 2) * P + yp], x3 = xs[(t + 3) * P + yp];
#pragma unroll
          for (int k = 0; k < kNY; ++k) {
            const float4 s4 = ld4(sc + (yr0 + k * kYStep) * kKeys + t);
            yacc[k] = fmaf(s4.x, x0, yacc[k]);
            yacc[k] = fmaf(s4.y, x1, yacc[k]);
            yacc[k] = fmaf(s4.z, x2, yacc[k]);
            yacc[k] = fmaf(s4.w, x3, yacc[k]);
          }
        }
        __syncthreads();
      }

#pragma unroll
      for (int k = 0; k < kNY; ++k) {
        const int r = yr0 + k * kYStep;
        if (r < rn) yb[(size_t)(c0 + r0 + r) * xrow + yp] = from_f32<T>(yacc[k]);
      }
    }

    // state update: exp(acs_last) state + sum_t exp(acs_last - acs_t) x_t b_t^T
    const float last = acs[q - 1];
    const float keep = expf(last);
    float sacc[4][kMaxJ];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int n = sn0 + j * kTG;
        sacc[u][j] = (j < nj && n < N) ? keep * st[(4 * pg + u) * NS + n] : 0.f;
      }
    for (int t0 = 0; t0 < q; t0 += kKeys) {
      __syncthreads();  // the previous tile's readers are done
      stage_keys(c0, t0, min(kKeys, q - t0), true, last);
      __syncthreads();
      for (int t = 0; t < kKeys; ++t) {
        const float4 x4 = ld4(xs + t * P + 4 * pg);
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          const int n = sn0 + j * kTG;
          if (j < nj && n < N) {
            const float bv = bs[t * NS + n];
            sacc[0][j] = fmaf(x4.x, bv, sacc[0][j]);
            sacc[1][j] = fmaf(x4.y, bv, sacc[1][j]);
            sacc[2][j] = fmaf(x4.z, bv, sacc[2][j]);
            sacc[3][j] = fmaf(x4.w, bv, sacc[3][j]);
          }
        }
      }
    }
    __syncthreads();  // every reader of the old state is done
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int n = sn0 + j * kTG;
        if (j < nj && n < N) st[(4 * pg + u) * NS + n] = sacc[u][j];
      }
    __syncthreads();
  }
}

template <typename T, int P>
int launch_p(const void* x, const void* a, const void* b, const void* c,
             void* y, int B, int L, int H, int G, int N, int Q,
             cudaStream_t stream) {
  const int Qp = (Q + 3) & ~3;
  const size_t smem = sizeof(float) *
      ((size_t)Qp + (size_t)P * (N + 4) + (size_t)kRows * N +
       (size_t)kKeys * (N + 4) + (size_t)kKeys * P + (size_t)kRows * kKeys);
  auto kernel = ssd_scan_kernel<T, P>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)a, (const T*)b, (const T*)c, (T*)y, L, H, G, N, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c, void* y,
           int B, int L, int H, int G, int P, int N, int Q, cudaStream_t s) {
  switch (P) {
    case 16: return launch_p<T, 16>(x, a, b, c, y, B, L, H, G, N, Q, s);
    case 32: return launch_p<T, 32>(x, a, b, c, y, B, L, H, G, N, Q, s);
    case 64: return launch_p<T, 64>(x, a, b, c, y, B, L, H, G, N, Q, s);
    case 128: return launch_p<T, 128>(x, a, b, c, y, B, L, H, G, N, Q, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all of x, a, b, c and y). P one of
// 16, 32, 64, 128; N a multiple of 4, at most 256, P * N <= 8192;
// 1 <= Q <= L. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* b,
                               const void* c, void* y, int B, int L, int H,
                               int G, int P, int N, int Q, int dtype,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, a, b, c, y, B, L, H, G, P, N, Q, s);
  return launch<__nv_bfloat16>(x, a, b, c, y, B, L, H, G, P, N, Q, s);
}
