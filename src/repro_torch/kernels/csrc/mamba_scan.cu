// Chunked SSD (Mamba2) scan forward for Hopper (compiled for sm_90a).
//
// Replaces the Pallas TPU kernel `_mamba_kernel` / `mamba_scan` in
// src/repro/kernels/mamba_scan.py (pallas_call at :99).  It computes what
// that kernel computes, in f32 except for the running sum cum, which is f64:
//   inputs x [B,S,H,P], dt [B,S,H] f32, A [H] f32, Bm and Cm [B,S,N] (one
//   B/C group); output y [B,S,H,P] in x's dtype, no final state.
//   Per chunk of Q steps, with a = dt * A and cum = inclusive cumsum(a):
//     y_t  = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s    (intra)
//          + exp(cum_t) C_t . h                                     (inter)
//     h   <- exp(cum_Q) h + sum_s exp(cum_Q - cum_s) dt_s x_s (x) B_s
//   with h [P,N] carried from chunk to chunk, zero at the start.
//
// Design.  The TPU kernel walks the chunks as the sequential innermost grid
// axis and keeps h in VMEM scratch.  Here one thread block owns one (batch,
// head) pair and loops over its chunks itself, with h in shared memory
// (16 KB at P = N = 64), so no state crosses blocks: B*H blocks (896 at
// zamba2-7b's eval shape, B 8, H 112) fill the 132 SMs.  Per chunk the block
// stages x, B and C in shared memory as f32, scans a = dt*A in one warp, and
// builds the Q x Q weight 16 rows at a time (never whole), each row tile
// feeding its 16 rows of y at once.  The causal mask sits inside the
// exponent: exp(cum_t - cum_s) is evaluated only for s <= t, as the TPU
// kernel's where(mask, diff, -inf) does, since for s > t it overflows.  cum
// and its differences are taken in f64 and rounded to f32 before exp(): under
// strong decay |cum| reaches hundreds within a chunk, and an f32 difference
// of two such sums keeps too few digits of the small cum_t - cum_s that
// matters (PERF.md has the measured error of the all-f32 form).  A
// ragged last chunk is zero-filled (dt = 0 and x = 0 add nothing) and its
// rows past S are not stored, so any S works with any chunk.  x, B and C are
// read through their strides (unit stride in the last dimension), so the
// model's split of the in-projection is read in place.  Products are f32 FMA
// loops with 2 x 4 register tiles: right and simple first; tensor cores,
// sharing C B^T across the heads of a group, and TMA are later work.
//
// Bound.  At zamba2-7b's eval shape (B 8, S 512, H 112, P = N = 64, chunk
// 128, bf16 x/B/C, f32 dt) the function moves 120.3 MB (x in and y out are
// 58.7 MB each), 0.036 ms at 3.35 TB/s; its least arithmetic is 15.1 GFLOP,
// 0.015 ms at the bf16 peak.  So its floor is the memory bound.  This
// version is bound instead by its f32 FMA loops and shared-memory reads,
// with one 256-thread block per SM (126,208 bytes of shared memory there);
// PERF.md has its measured time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DIM = 128;                      // largest P, N and chunk
constexpr int TILE_ROWS = 16;                     // rows of the Q x Q weight at a time
constexpr int ROWS_PER_WARP = TILE_ROWS / WARPS;  // 2
constexpr int LANE_COLS = MAX_DIM / 32;           // columns per lane: col = lane + 32 j
constexpr int SMEM_LIMIT = 232448;                // dynamic shared memory a block may use
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// floats of shared memory for chunk Q, head dim P and state dim N
// (cum's Q doubles count as 2 Q floats)
size_t smem_floats(int Q, int P, int N) {
  return (size_t)Q * P + 2 * (size_t)Q * (N + 1) + (size_t)P * (N + 1) +
         (size_t)TILE_ROWS * Q + 4 * (size_t)Q;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, T* __restrict__ y, int S, int H, int P, int N,
                  int Q, long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
                  long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
                  long long c_sb, long long c_ss) {
  const int NP = N + 1;  // padded pitch: 32 lanes read 32 rows of B, C or h at one column
  extern __shared__ double smem[];
  double* cum = smem;                                 // [Q]  f64, first for its alignment
  float* xs = reinterpret_cast<float*>(cum + Q);      // [Q][P]
  float* bs = xs + Q * P;           // [Q][NP]
  float* cs = bs + Q * NP;          // [Q][NP]
  float* hs = cs + Q * NP;          // [P][NP]  the carried state
  float* ws = hs + P * NP;          // [TILE_ROWS][Q]  one row tile of the weight
  float* dts = ws + TILE_ROWS * Q;  // [Q]
  float* wst = dts + Q;             // [Q]  exp(cum_Q - cum_s) dt_s

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a_h = A[h];
  const T* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* bb = Bm + b * b_sb;
  const T* cb = Cm + b * c_sb;
  const long long y_ss = (long long)H * P;  // y is contiguous [B,S,H,P]
  T* yb = y + (long long)b * S * y_ss + (long long)h * P;

  for (int i = tid; i < P * NP; i += THREADS) hs[i] = 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * Q;
    const int nv = min(Q, S - c0);  // valid rows of this chunk
    __syncthreads();  // the previous chunk's reads of xs, bs and wst are done
    for (int i = tid; i < Q * P; i += THREADS) {
      const int r = i / P, col = i % P;
      xs[i] = r < nv ? to_f32(xb[(c0 + r) * x_ss + col]) : 0.f;
    }
    for (int i = tid; i < Q * N; i += THREADS) {
      const int r = i / N, col = i % N;
      bs[r * NP + col] = r < nv ? to_f32(bb[(c0 + r) * b_ss + col]) : 0.f;
      cs[r * NP + col] = r < nv ? to_f32(cb[(c0 + r) * c_ss + col]) : 0.f;
    }
    for (int i = tid; i < Q; i += THREADS) dts[i] = i < nv ? dtb[(c0 + i) * dt_ss] : 0.f;
    __syncthreads();

    if (warp == 0) {
      // inclusive cumsum of a = dt * A (each a in f32, summed in f64): lane l
      // owns E consecutive steps
      const int E = (Q + 31) / 32, s0 = lane * E;
      double run = 0.0;
      for (int e = 0; e < E && s0 + e < Q; ++e) run += (double)(dts[s0 + e] * a_h);
      double incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const double up = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += up;
      }
      double acc = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) acc = 0.0;
      for (int e = 0; e < E && s0 + e < Q; ++e) {
        acc += (double)(dts[s0 + e] * a_h);
        cum[s0 + e] = acc;
      }
    }
    __syncthreads();
    // rows past nv have dt = 0, so cum[Q-1] is the chunk's total decay
    const double a_total = cum[Q - 1];
    for (int i = tid; i < Q; i += THREADS) wst[i] = expf((float)(a_total - cum[i])) * dts[i];

    for (int r0 = 0; r0 < nv; r0 += TILE_ROWS) {
      // causal: columns past the tile's last row carry no weight
      const int s_end = min(Q, r0 + TILE_ROWS);
      // weight rows t = r0 + warp*2 + i, columns s = lane + 32 j:
      //   W[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t, else 0
      {
        int t[ROWS_PER_WARP];
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) t[i] = min(r0 + warp * ROWS_PER_WARP + i, Q - 1);
        float acc[ROWS_PER_WARP][LANE_COLS];
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
          for (int j = 0; j < LANE_COLS; ++j) acc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[ROWS_PER_WARP];
#pragma unroll
          for (int i = 0; i < ROWS_PER_WARP; ++i) cv[i] = cs[t[i] * NP + n];
#pragma unroll
          for (int j = 0; j < LANE_COLS; ++j) {
            if (32 * j >= s_end) break;  // the same for the whole warp
            const float bv = bs[min(lane + 32 * j, Q - 1) * NP + n];
#pragma unroll
            for (int i = 0; i < ROWS_PER_WARP; ++i) acc[i][j] = fmaf(cv[i], bv, acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
          const int row = r0 + warp * ROWS_PER_WARP + i;
#pragma unroll
          for (int j = 0; j < LANE_COLS; ++j) {
            const int s = lane + 32 * j;
            if (s >= s_end) continue;
            // the mask inside the exponent: exp() is never taken for s > t
            ws[(warp * ROWS_PER_WARP + i) * Q + s] =
                (row < Q && s <= row) ? acc[i][j] * expf((float)(cum[row] - cum[s])) * dts[s] : 0.f;
          }
        }
      }
      __syncthreads();  // the row tile of W is complete

      // y rows t = r0 + warp*2 + i, columns p = lane + 32 k
      {
        int t[ROWS_PER_WARP];
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) t[i] = min(r0 + warp * ROWS_PER_WARP + i, Q - 1);
        float yi[ROWS_PER_WARP][LANE_COLS], yo[ROWS_PER_WARP][LANE_COLS];
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
          for (int k = 0; k < LANE_COLS; ++k) yi[i][k] = yo[i][k] = 0.f;
        for (int s = 0; s < s_end; ++s) {
          float wv[ROWS_PER_WARP];
#pragma unroll
          for (int i = 0; i < ROWS_PER_WARP; ++i) wv[i] = ws[(warp * ROWS_PER_WARP + i) * Q + s];
#pragma unroll
          for (int k = 0; k < LANE_COLS; ++k) {
            if (32 * k >= P) break;
            const float xv = xs[s * P + min(lane + 32 * k, P - 1)];
#pragma unroll
            for (int i = 0; i < ROWS_PER_WARP; ++i) yi[i][k] = fmaf(wv[i], xv, yi[i][k]);
          }
        }
        for (int n = 0; n < N; ++n) {
          float cv[ROWS_PER_WARP];
#pragma unroll
          for (int i = 0; i < ROWS_PER_WARP; ++i) cv[i] = cs[t[i] * NP + n];
#pragma unroll
          for (int k = 0; k < LANE_COLS; ++k) {
            if (32 * k >= P) break;
            const float hv = hs[min(lane + 32 * k, P - 1) * NP + n];
#pragma unroll
            for (int i = 0; i < ROWS_PER_WARP; ++i) yo[i][k] = fmaf(cv[i], hv, yo[i][k]);
          }
        }
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
          const int row = r0 + warp * ROWS_PER_WARP + i;
          if (row >= nv) continue;
          const float decay_in = expf((float)cum[row]);
#pragma unroll
          for (int k = 0; k < LANE_COLS; ++k) {
            const int p = lane + 32 * k;
            if (p < P) yb[(c0 + row) * y_ss + p] = from_f32<T>(yi[i][k] + decay_in * yo[i][k]);
          }
        }
      }
      __syncthreads();  // ws is rewritten by the next row tile; hs is read no more
    }

    if (c == n_chunks - 1) break;  // no final state is returned
    // state: h[p][n] = exp(a_total) h[p][n] + sum_s wst[s] x[s][p] B[s][n], with
    // p = p0 + warp*2 + i and n = lane + 32 k; each thread updates only its own entries
    const float decay = expf((float)a_total);
    for (int p0 = 0; p0 < P; p0 += TILE_ROWS) {
      int p[ROWS_PER_WARP];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) p[i] = p0 + warp * ROWS_PER_WARP + i;
      float acc[ROWS_PER_WARP][LANE_COLS];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
        for (int k = 0; k < LANE_COLS; ++k) acc[i][k] = 0.f;
      for (int s = 0; s < nv; ++s) {
        const float w = wst[s];
        float uv[ROWS_PER_WARP];
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) uv[i] = w * xs[s * P + min(p[i], P - 1)];
#pragma unroll
        for (int k = 0; k < LANE_COLS; ++k) {
          if (32 * k >= N) break;
          const float bv = bs[s * NP + min(lane + 32 * k, N - 1)];
#pragma unroll
          for (int i = 0; i < ROWS_PER_WARP; ++i) acc[i][k] = fmaf(uv[i], bv, acc[i][k]);
        }
      }
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        if (p[i] >= P) continue;
#pragma unroll
        for (int k = 0; k < LANE_COLS; ++k) {
          const int n = lane + 32 * k;
          if (n < N) hs[p[i] * NP + n] = decay * hs[p[i] * NP + n] + acc[i][k];
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, int B, int S, int H, int P, int N, int Q,
                   const long long* st, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Q, P, N);
  if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mamba_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mamba_scan_kernel<T><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y), S, H, P, N, Q,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
  return cudaGetLastError();
}

}  // namespace

// x [B,S,H,P], Bm/Cm [B,S,N] in `dtype` (0 = float32, 1 = bfloat16) with unit
// stride in the last dimension; dt [B,S,H] and A [H] float32; y [B,S,H,P]
// contiguous in `dtype`.  Strides are in elements: x (batch, seq, head),
// dt (batch, seq, head), Bm (batch, seq), Cm (batch, seq).  1 <= P, N, chunk
// <= 128.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); it never synchronises.
extern "C" int mamba_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, void* y, int B, int S, int H, int P, int N,
                              int chunk, long long x_sb, long long x_ss, long long x_sh,
                              long long dt_sb, long long dt_ss, long long dt_sh,
                              long long b_sb, long long b_ss, long long c_sb, long long c_ss,
                              int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || chunk <= 0 || P > MAX_DIM ||
      N > MAX_DIM || chunk > MAX_DIM || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long st[10] = {x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, dt, A, Bm, Cm, y, B, S, H, P, N, chunk, st, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, B, S, H, P, N, chunk, st, s);
  return (int)cudaErrorInvalidValue;
}
