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
// Both routes.  The TPU kernel walks the chunks as the sequential innermost
// grid axis and keeps h in VMEM scratch.  Here one thread block owns one
// (batch, head) pair and loops over its chunks itself, with h in shared
// memory, so no state crosses blocks: B*H blocks (896 at zamba2-7b's eval
// shape, B 8, H 112) fill the 132 SMs.  The causal mask sits inside the
// exponent: exp(cum_t - cum_s) is used only for s <= t, as the TPU kernel's
// where(mask, diff, -inf) does, since for s > t it overflows.  cum is summed
// in f64 and its differences rounded to f32 before exp(): under strong decay
// |cum| reaches hundreds within a chunk, and an f32 difference of two such
// sums keeps too few digits of the small cum_t - cum_s that matters (PERF.md
// has the measured error of the all-f32 form).  A ragged last chunk is
// zero-filled (dt = 0 and x = 0 add nothing) and its rows past S are not
// stored, so any S works with any chunk.  x, B and C are read through their
// strides (unit stride in the last dimension), so the model's split of the
// conv output is read in place.  kernels/mamba_scan.py:route picks the route
// from dtypes, shapes, strides and alignment.
//
// bf16, tensor cores (P, N and chunk multiples of 16; 16-byte aligned rows;
// every zamba2 shape).  512 threads a block.  x, B and C are staged in bf16
// by cp.async, 16 bytes a copy, in two stages: chunk c + 1 lands while chunk
// c computes.  Rows are padded by 16 bytes, so the eight rows an ldmatrix
// reads hit eight bank groups.  All four products run on mma.sync m16n8k16
// (bf16 in, f32 sums): warp w owns rows 16 (w % 8) .. +15 of the chunk and
// 32 of P's columns; it takes C . h^T (inter), then for each 16-column block
// j <= its row tile S = C_t . B_s^T, builds W = S exp(cum_t - cum_s) dt_s in
// registers from the score fragments (the m16n8 accumulator is the A layout)
// and adds W x_s; blocks above the diagonal are skipped.  The state update
// h = exp(cum_Q) h + (x o w_state)^T B runs in 16 x 16 tiles of h that warps
// take from a shared counter as they finish their rows of y, so the warps of
// short row tiles do most of it.  h is carried in f32.  Rounding W, the h
// operand or x o w_state to bf16 once costs up to five times the bf16
// tolerance (tests/test_torch_kernel_routes.py emulates it), so each is
// split into bf16 hi + lo, two products each, and sums to about f32
// precision; C and B are bf16 inputs and exact.  cum_t - cum_s is taken from
// f32 hi + lo pairs of cum, which keeps the f64 difference's precision
// without f64 arithmetic a weight, and exp() is ex2.approx.  Shared memory:
// 151,040 bytes at P = N = 64, chunk 128 (two 55 KB stages, h in f32 and
// bf16 hi + lo, cum): one block of 16 warps an SM.  ptxas: 122 registers, no
// spills.
//
// f32, and bf16 the tensor-core route does not take: FMA.  256 threads a
// block; x, B and C staged in shared memory as f32 (rows padded to N + 1);
// a = dt*A scanned in one warp; the Q x Q weight built 16 rows at a time
// (never whole), each row tile feeding its 16 rows of y at once; f32 FMA
// loops with 2 x 4 register tiles.  TF32 cannot hold the reference's f32
// tolerance of 2e-5.
//
// Bound.  At zamba2-7b's eval shape (B 8, S 512, H 112, P = N = 64, chunk
// 128, bf16 x/B/C, f32 dt) the function moves 120.3 MB (x in and y out are
// 58.7 MB each), 0.036 ms at 3.35 TB/s; its least arithmetic is 15.1 GFLOP,
// 0.015 ms at the bf16 peak.  So its floor is the memory bound.  The
// tensor-core route runs at about 13 % of it, bound by the latency of its
// per-warp product chains with one block an SM and the serial phases of a
// chunk (cumsum, the barriers); the FMA route by its f32 FMA loops.  PERF.md
// has the measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

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

// Inclusive cumsum of a = dt * A over the chunk's Q steps, by one warp: each
// a in f32, summed in f64; lane l owns E consecutive steps.
__device__ void chunk_cumsum(double* cum, const float* dts, float a_h, int Q, int lane) {
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

  // chunks by their first row: a chunk count would be one more value to keep
  // live across the loop (ptxas kept it in local memory)
  for (int c0 = 0; c0 < S; c0 += Q) {
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

    if (warp == 0) chunk_cumsum(cum, dts, a_h, Q, lane);
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

    if (c0 + Q >= S) break;  // no final state is returned
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

// ------------------------------------------------------- bf16, tensor cores
constexpr int TC_THREADS = 512;
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int ROW_TILES = MAX_DIM / 16;             // 16-row tiles of a chunk of 128
constexpr int COL_GROUPS = TC_WARPS / ROW_TILES;    // warps sharing a row tile
constexpr int COL_BLOCKS = MAX_DIM / 32 / COL_GROUPS;  // 32-column blocks of y a warp at most
constexpr float LOG2E = 1.4426950408889634f;
// bf16 of padding a row (16 bytes): rows lie 16 bytes apart mod 128, so the
// eight rows an ldmatrix reads hit eight different bank groups
constexpr int PAD = 8;

// bytes of one stage: x [Q][P+8], B and C [Q][N+8] in bf16, dt [Q] in f32
__host__ __device__ size_t tc_stage_bytes(int Q, int P, int N) {
  return 2 * (size_t)Q * (P + PAD) + 4 * (size_t)Q * (N + PAD) + 4 * (size_t)Q;
}

// bytes of shared memory of the tensor-core route (kernels/mamba_scan.py:
// smem_bytes): two stages, h [P][N+8] in f32 and its bf16 hi and lo halves
// [2][P][N+8], cum [Q] in f64, cum again as f32 hi and lo [2][Q], and the
// state weights [Q] in f32
size_t tc_smem_bytes(int Q, int P, int N) {
  return 2 * tc_stage_bytes(Q, P, N) + 8 * (size_t)P * (N + PAD) + 20 * (size_t)Q;
}

// bf16 hi and lo halves of two floats, packed
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = ptx::pack_bf16(a, b);
  const float2 r = ptx::unpack_bf16(hi);
  lo = ptx::pack_bf16(a - r.x, b - r.y);
}

// W (bf16 hi + lo) from the 16 x 16 score block s_acc of rows t_lo, t_lo + 8
// and columns s0 + 8 i + {0, 1}: W = S exp(cum_t - cum_s) dt_s for s <= t,
// else 0, in the A fragment order of the W x product.  cum is taken as f32
// hi + lo pairs: (hi_t - hi_s) + (lo_t - lo_s) keeps the difference to f32
// precision, as the f64 difference rounded once would, under any |cum|.
__device__ __forceinline__ void weight_fragments(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                                 const float (&s_acc)[2][4], const float* cum_hi,
                                                 const float* cum_lo, const float* dts, int s0,
                                                 int t_lo, const float (&ct_hi)[2],
                                                 const float (&ct_lo)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float w[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = s0 + 8 * i + e;
        const float d = (ct_hi[half] - cum_hi[s]) + (ct_lo[half] - cum_lo[s]);
        // the mask inside the exponent: exp() of a positive difference is never used
        w[e] = s <= t_lo + 8 * half
                   ? s_acc[i][2 * half + e] * ptx::exp2_approx(d * LOG2E) * dts[s]
                   : 0.f;
      }
      split_bf16(w[0], w[1], hi[2 * i + half], lo[2 * i + half]);
    }
  }
}

__global__ void __launch_bounds__(TC_THREADS, 1)
mamba_scan_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                     const __nv_bfloat16* __restrict__ Cm, __nv_bfloat16* __restrict__ y, int S,
                     int H, int P, int N, int Q, long long x_sb, long long x_ss, long long x_sh,
                     long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
                     long long b_ss, long long c_sb, long long c_ss) {
  __shared__ int next_task;  // the next 16 x 16 tile of the state update to take
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int XP = P + PAD, NP = N + PAD;  // row pitches in elements
  float* hs = reinterpret_cast<float*>(smem_raw);            // [P][NP] the carried state, f32
  __nv_bfloat16* h_hi = reinterpret_cast<__nv_bfloat16*>(hs + P * NP);  // [P][NP] its bf16
  __nv_bfloat16* h_lo = h_hi + P * NP;                       // [P][NP] and the rest, bf16
  double* cum = reinterpret_cast<double*>(h_lo + P * NP);    // [Q]
  float* cum_hi = reinterpret_cast<float*>(cum + Q);         // [Q] cum rounded to f32
  float* cum_lo = cum_hi + Q;                                // [Q] cum - cum_hi
  float* wst = cum_lo + Q;                                   // [Q] exp(cum_Q - cum_s) dt_s
  char* stages = reinterpret_cast<char*>(wst + Q);
  const size_t stage_bytes = tc_stage_bytes(Q, P, N);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a_h = A[h];
  const __nv_bfloat16* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const __nv_bfloat16* bb = Bm + b * b_sb;
  const __nv_bfloat16* cb = Cm + b * c_sb;
  const long long y_ss = (long long)H * P;  // y is contiguous [B,S,H,P]
  __nv_bfloat16* yb = y + (long long)b * S * y_ss + (long long)h * P;

  // chunk c into stage st by cp.async: 16 bytes a copy, rows past S zero-filled
  auto load_chunk = [&](int c, int st) {
    const int c0 = c * Q, nv = min(Q, S - c0);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stages + st * stage_bytes);
    __nv_bfloat16* bs = xs + Q * XP;
    __nv_bfloat16* cs = bs + Q * NP;
    float* dts = reinterpret_cast<float*>(cs + Q * NP);
    const int xch = P / 8, nch = N / 8;
    for (int i = tid; i < Q * xch; i += TC_THREADS) {
      const int r = i / xch, ch = 8 * (i % xch);
      const int row = c0 + (r < nv ? r : 0);
      ptx::cp_async_16(xs + r * XP + ch, xb + row * x_ss + ch, r < nv ? 16 : 0);
    }
    for (int i = tid; i < Q * nch; i += TC_THREADS) {
      const int r = i / nch, ch = 8 * (i % nch);
      const int row = c0 + (r < nv ? r : 0);
      ptx::cp_async_16(bs + r * NP + ch, bb + row * b_ss + ch, r < nv ? 16 : 0);
      ptx::cp_async_16(cs + r * NP + ch, cb + row * c_ss + ch, r < nv ? 16 : 0);
    }
    for (int i = tid; i < Q; i += TC_THREADS)
      ptx::cp_async_4(dts + i, dtb + (c0 + (i < nv ? i : 0)) * dt_ss, i < nv ? 4 : 0);
    ptx::cp_async_commit();
  };

  for (int i = tid; i < P * NP; i += TC_THREADS) {
    hs[i] = 0.f;
    h_hi[i] = h_lo[i] = __float2bfloat16(0.f);
  }
  const int n_chunks = (S + Q - 1) / Q;
  const int QT = Q / 16;
  // this warp's 16 rows of y (row tile r) and its 32-column blocks p0
  const int r = warp % ROW_TILES;
  const int t_lo = 16 * r + g;  // this thread's rows t_lo and t_lo + 8
  int p0s[COL_BLOCKS];
#pragma unroll
  for (int cb = 0; cb < COL_BLOCKS; ++cb) p0s[cb] = 32 * (warp / ROW_TILES + COL_GROUPS * cb);
  load_chunk(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    const int c0 = c * Q, nv = min(Q, S - c0);
    // the other stage was last read in chunk c - 1, before its closing barrier
    if (c + 1 < n_chunks) {
      load_chunk(c + 1, st ^ 1);
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();  // chunk c has landed, for every thread's copies
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(stages + st * stage_bytes);
    const __nv_bfloat16* bs = xs + Q * XP;
    const __nv_bfloat16* cs = bs + Q * NP;
    const float* dts = reinterpret_cast<const float*>(cs + Q * NP);

    if (warp == 0) chunk_cumsum(cum, dts, a_h, Q, lane);
    __syncthreads();
    // rows past nv have dt = 0, so cum[Q-1] is the chunk's total decay
    const double a_total = cum[Q - 1];
    for (int i = tid; i < Q; i += TC_THREADS) {
      wst[i] = expf((float)(a_total - cum[i])) * dts[i];
      cum_hi[i] = (float)cum[i];
      cum_lo[i] = (float)(cum[i] - (double)cum_hi[i]);
    }
    if (tid == 0) next_task = 0;

    // inter: acc = exp(cum_t) C_t . h^T over n, with h as its bf16 hi + lo
    float acc[COL_BLOCKS][4][4];
#pragma unroll
    for (int cb = 0; cb < COL_BLOCKS; ++cb)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[cb][nt][e] = 0.f;
    const __nv_bfloat16* c_row = cs + (16 * r + lane % 16) * NP + (lane / 16) * 8;
    if (r < QT) {
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t a[4];
        ptx::ldmatrix_x4(a, c_row + 16 * kk);
#pragma unroll
        for (int cb = 0; cb < COL_BLOCKS; ++cb)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            if (p0s[cb] + 16 * np >= P) break;
            const int off = (p0s[cb] + 16 * np + (lane / 16) * 8 + lane % 8) * NP + 16 * kk +
                            ((lane / 8) % 2) * 8;
            uint32_t hf[4], lf[4];
            ptx::ldmatrix_x4(hf, h_hi + off);
            ptx::ldmatrix_x4(lf, h_lo + off);
            ptx::mma_m16n8k16(acc[cb][2 * np], a, hf[0], hf[1]);
            ptx::mma_m16n8k16(acc[cb][2 * np], a, lf[0], lf[1]);
            ptx::mma_m16n8k16(acc[cb][2 * np + 1], a, hf[2], hf[3]);
            ptx::mma_m16n8k16(acc[cb][2 * np + 1], a, lf[2], lf[3]);
          }
      }
      const float in_lo = expf((float)cum[t_lo]), in_hi = expf((float)cum[t_lo + 8]);
#pragma unroll
      for (int cb = 0; cb < COL_BLOCKS; ++cb)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc[cb][nt][0] *= in_lo;
          acc[cb][nt][1] *= in_lo;
          acc[cb][nt][2] *= in_hi;
          acc[cb][nt][3] *= in_hi;
        }
    }
    __syncthreads();  // h is read no more in this chunk: the state update may write it

    // intra: the 16-column blocks j <= r of the causal weight, each S = C B^T
    // (bf16 inputs, exact), W in registers, then W x
    if (r < QT) {
      const float ct_hi[2] = {cum_hi[t_lo], cum_hi[t_lo + 8]};
      const float ct_lo[2] = {cum_lo[t_lo], cum_lo[t_lo + 8]};
      for (int j = 0; j <= r; ++j) {
        float s_acc[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s_acc[i][e] = 0.f;
        const __nv_bfloat16* b_row =
            bs + (16 * j + (lane / 16) * 8 + lane % 8) * NP + ((lane / 8) % 2) * 8;
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t a[4], bf[4];
          ptx::ldmatrix_x4(a, c_row + 16 * kk);
          ptx::ldmatrix_x4(bf, b_row + 16 * kk);
          ptx::mma_m16n8k16(s_acc[0], a, bf[0], bf[1]);
          ptx::mma_m16n8k16(s_acc[1], a, bf[2], bf[3]);
        }
        uint32_t w_hi[4], w_lo[4];
        weight_fragments(w_hi, w_lo, s_acc, cum_hi, cum_lo, dts, 16 * j + 2 * t4, t_lo, ct_hi,
                         ct_lo);
        const __nv_bfloat16* x_row =
            xs + (16 * j + ((lane / 8) % 2) * 8 + lane % 8) * XP + (lane / 16) * 8;
#pragma unroll
        for (int cb = 0; cb < COL_BLOCKS; ++cb)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            if (p0s[cb] + 16 * np >= P) break;
            uint32_t xf[4];
            ptx::ldmatrix_x4_trans(xf, x_row + p0s[cb] + 16 * np);
            ptx::mma_m16n8k16(acc[cb][2 * np], w_hi, xf[0], xf[1]);
            ptx::mma_m16n8k16(acc[cb][2 * np], w_lo, xf[0], xf[1]);
            ptx::mma_m16n8k16(acc[cb][2 * np + 1], w_hi, xf[2], xf[3]);
            ptx::mma_m16n8k16(acc[cb][2 * np + 1], w_lo, xf[2], xf[3]);
          }
      }
#pragma unroll
      for (int cb = 0; cb < COL_BLOCKS; ++cb)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (p0s[cb] + 8 * nt >= P) break;
          const int p = p0s[cb] + 8 * nt + 2 * t4;
          if (t_lo < nv)
            *reinterpret_cast<uint32_t*>(yb + (c0 + t_lo) * y_ss + p) =
                ptx::pack_bf16(acc[cb][nt][0], acc[cb][nt][1]);
          if (t_lo + 8 < nv)
            *reinterpret_cast<uint32_t*>(yb + (c0 + t_lo + 8) * y_ss + p) =
                ptx::pack_bf16(acc[cb][nt][2], acc[cb][nt][3]);
        }
    }

    // state (not after the last chunk: no final state is returned):
    // h = exp(a_total) h + (x o w_state)^T B over the chunk's rows, in 16 x 16
    // tiles of h, which the warps take from a shared counter as they finish
    // their rows of y; x o w_state is split into bf16 hi + lo
    const float decay = expf((float)a_total);
    const int n_blocks = N / 16, n_tasks = c + 1 < n_chunks ? (P / 16) * n_blocks : 0;
    while (true) {
      int task = 0;
      if (lane == 0) task = atomicAdd(&next_task, 1);
      task = __shfl_sync(FULL, task, 0);
      if (task >= n_tasks) break;
      const int q0 = 16 * (task / n_blocks), n0 = 16 * (task % n_blocks);
      float hacc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[i][e] = 0.f;
      for (int ks = 0; ks < QT; ++ks) {
        // A = (x o w)^T (rows p, columns s) from x [s][p], transposed
        uint32_t xa[4], a_hi[4], a_lo[4], bf[4];
        ptx::ldmatrix_x4_trans(
            xa, xs + (16 * ks + (lane / 16) * 8 + lane % 8) * XP + q0 + ((lane / 8) % 2) * 8);
        const int s0 = 16 * ks + 2 * t4;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = ptx::unpack_bf16(xa[q]);
          const int s = s0 + 8 * (q / 2);  // a0, a1: columns 2t, 2t+1; a2, a3: 2t+8, 2t+9
          split_bf16(v.x * wst[s], v.y * wst[s + 1], a_hi[q], a_lo[q]);
        }
        ptx::ldmatrix_x4_trans(
            bf, bs + (16 * ks + ((lane / 8) % 2) * 8 + lane % 8) * NP + n0 + (lane / 16) * 8);
        ptx::mma_m16n8k16(hacc[0], a_hi, bf[0], bf[1]);
        ptx::mma_m16n8k16(hacc[0], a_lo, bf[0], bf[1]);
        ptx::mma_m16n8k16(hacc[1], a_hi, bf[2], bf[3]);
        ptx::mma_m16n8k16(hacc[1], a_lo, bf[2], bf[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int at = (q0 + g + 8 * half) * NP + n0 + 8 * i + 2 * t4;
          float2* hp = reinterpret_cast<float2*>(hs + at);
          const float2 hn = make_float2(fmaf(decay, hp->x, hacc[i][2 * half]),
                                        fmaf(decay, hp->y, hacc[i][2 * half + 1]));
          *hp = hn;
          split_bf16(hn.x, hn.y, *reinterpret_cast<uint32_t*>(h_hi + at),
                     *reinterpret_cast<uint32_t*>(h_lo + at));
        }
    }
    __syncthreads();  // h is complete, and this stage is free for chunk c + 2
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

cudaError_t launch_tc(const void* x, const void* dt, const void* A, const void* Bm,
                      const void* Cm, void* y, int B, int S, int H, int P, int N, int Q,
                      const long long* st, cudaStream_t stream) {
  // cp.async copies 16-byte pieces of x, B and C rows: bases and row strides
  // (x: batch, seq, head; B, C: batch, seq) must be multiples of 16 bytes
  const bool aligned = aligned16(x) && aligned16(Bm) && aligned16(Cm) && st[0] % 8 == 0 &&
                       st[1] % 8 == 0 && st[2] % 8 == 0 && st[6] % 8 == 0 && st[7] % 8 == 0 &&
                       st[8] % 8 == 0 && st[9] % 8 == 0;
  if (P % 16 || N % 16 || Q % 16 || !aligned) return cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes(Q, P, N);
  if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mamba_scan_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mamba_scan_tc_kernel<<<B * H, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<__nv_bfloat16*>(y), S, H, P, N, Q,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
  return cudaGetLastError();
}

}  // namespace

// x [B,S,H,P], Bm/Cm [B,S,N] in `dtype` (0 = float32, 1 = bfloat16) with unit
// stride in the last dimension; dt [B,S,H] and A [H] float32; y [B,S,H,P]
// contiguous in `dtype`.  Strides are in elements: x (batch, seq, head),
// dt (batch, seq, head), Bm (batch, seq), Cm (batch, seq).  1 <= P, N, chunk
// <= 128.  `route` (kernels/mamba_scan.py:route picks it): 0 the FMA kernel,
// 1 the bf16 tensor-core kernel (P, N and chunk multiples of 16; 16-byte
// aligned bases and row strides).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
extern "C" int mamba_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, void* y, int B, int S, int H, int P, int N,
                              int chunk, long long x_sb, long long x_ss, long long x_sh,
                              long long dt_sb, long long dt_ss, long long dt_sh,
                              long long b_sb, long long b_ss, long long c_sb, long long c_ss,
                              int dtype, int route, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || chunk <= 0 || P > MAX_DIM ||
      N > MAX_DIM || chunk > MAX_DIM || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long st[10] = {x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return dtype == 1 ? (int)launch_tc(x, dt, A, Bm, Cm, y, B, S, H, P, N, chunk, st, s)
                      : (int)cudaErrorInvalidValue;
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(x, dt, A, Bm, Cm, y, B, S, H, P, N, chunk, st, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, B, S, H, P, N, chunk, st, s);
  return (int)cudaErrorInvalidValue;
}
