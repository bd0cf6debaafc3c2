// Grouped matmul of the MoE expert FFN for Hopper (sm_90a):
//
//     out[e] = x[e] @ w[e % Ew]      x [E,C,D], w [Ew,D,F] -> out [E,C,F]
//
// Replaces the Pallas TPU kernel `gmm` (repro/kernels/moe_gmm.py:46, body
// `_gmm_kernel`).  Inputs are read as stored, the product is summed in f32 and
// the output is written once in x's dtype.  x and w are both f32 or both bf16,
// contiguous.
//
// What bounds it.  At mixtral-8x7b's eval shape (x [16,640,4096], w
// [8,4096,14336], bf16) the product is 1.2 TFLOP against 1.3 GB of traffic:
// about 900 operations a byte, far above the card's ~295, so the tensor cores
// bound it (1.2 ms at 989 TFLOP/s).  At the decode shape (x [8,8,4096]) the
// same 0.94 GB of weights meet 8 rows each: 8 operations a byte, so the bytes
// of w bound it (0.28 ms at 3.35 TB/s).
//
// What the design does about it.  The TPU kernel carries an f32 accumulator
// in VMEM across a sequential D grid axis; blocks here run in parallel, so
// each block owns one 64x64 output tile of one e and loops over D itself,
// with nothing crossing blocks.  Tiles of x and w are staged in shared memory,
// zero-filled past the ragged edges of C, D and F (no block-size constraint,
// unlike the TPU kernel's), with rows padded against bank conflicts; stores are
// masked.  bf16 runs on the tensor cores through wmma (16x16x16 bf16
// fragments, f32 accumulators; four warps, each a 32x32 quarter of the tile),
// loading 16 bytes a thread where D and F are multiples of 8.  f32 runs on
// FMA register micro-tiles (4x4 a thread) with no TF32, each 32-deep slice of
// D summed apart and then added to the total, which keeps the f32 rounding
// near cuBLAS's.  Every block is independent and the grid is large (35,840
// blocks at the eval shape, 1,792 at decode), which fills the card, and at
// decode each slab of w is read by one block column only once.  There is no
// pipelining of loads against math yet (no cp.async, TMA or wgmma): a block
// waits on each tile it stages, so the kernel runs well under both bounds and
// leans on occupancy (27 KB of shared memory, up to 8 blocks an SM) to hide
// the waits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows of C per block
constexpr int BN = 64;   // columns of F per block
constexpr int BK = 32;   // depth of D staged at a time

// ----------------------------------------------------------------- bf16, wmma
constexpr int TC_THREADS = 128;  // 4 warps in a 2x2 grid of 32x32 quarters
constexpr int A_LD = BK + 8;     // bf16 elements a row of the x tile (80 bytes)
constexpr int B_LD = BN + 8;     // bf16 elements a row of the w tile (144 bytes)
constexpr int C_LD = BN + 4;     // floats a row of the output tile

template <bool VEC>
__global__ void __launch_bounds__(TC_THREADS)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ out, int C, int D, int F, int Ew) {
  using namespace nvcuda;
  // wmma needs 32-byte aligned tile pointers: every row offset used below is a
  // multiple of 16 rows, so 16 * A_LD * 2, 16 * B_LD * 2 and 16 * C_LD * 4 bytes
  __shared__ __align__(32) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(32) float Cs[BM * C_LD];

  const int f0 = blockIdx.x * BN;
  const int c0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const __nv_bfloat16* xe = x + (size_t)e * C * D;
  const __nv_bfloat16* we = w + (size_t)(e % Ew) * D * F;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < D; k0 += BK) {
    if (VEC) {
      // 8 bf16 (16 bytes) a load; D % 8 == 0 and F % 8 == 0, so a chunk of 8
      // lies wholly inside or wholly outside the matrix
      for (int i = tid; i < BM * BK / 8; i += TC_THREADS) {
        const int r = i / (BK / 8), ch = (i % (BK / 8)) * 8;
        const int c = c0 + r, d = k0 + ch;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (c < C && d < D) v = *reinterpret_cast<const uint4*>(xe + (size_t)c * D + d);
        *reinterpret_cast<uint4*>(As + r * A_LD + ch) = v;
      }
      for (int i = tid; i < BK * BN / 8; i += TC_THREADS) {
        const int r = i / (BN / 8), ch = (i % (BN / 8)) * 8;
        const int d = k0 + r, f = f0 + ch;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (d < D && f < F) v = *reinterpret_cast<const uint4*>(we + (size_t)d * F + f);
        *reinterpret_cast<uint4*>(Bs + r * B_LD + ch) = v;
      }
    } else {
      for (int i = tid; i < BM * BK; i += TC_THREADS) {
        const int r = i / BK, k = i % BK;
        const int c = c0 + r, d = k0 + k;
        As[r * A_LD + k] = (c < C && d < D) ? xe[(size_t)c * D + d] : zero;
      }
      for (int i = tid; i < BK * BN; i += TC_THREADS) {
        const int r = i / BN, n = i % BN;
        const int d = k0 + r, f = f0 + n;
        Bs[r * B_LD + n] = (d < D && f < F) ? we[(size_t)d * F + f] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn + 16 * j, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * C_LD + wn + 16 * j, acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  __nv_bfloat16* oe = out + (size_t)e * C * F;
  for (int i = tid; i < BM * BN; i += TC_THREADS) {
    const int r = i / BN, n = i % BN;
    const int c = c0 + r, f = f0 + n;
    if (c < C && f < F) oe[(size_t)c * F + f] = __float2bfloat16(Cs[r * C_LD + n]);
  }
}

// ------------------------------------------------------------------ f32, FMA
constexpr int FMA_THREADS = 256;  // 16 x 16 threads, each 4 x 4 outputs

__global__ void __launch_bounds__(FMA_THREADS)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int C, int D, int F, int Ew) {
  // x tile transposed (As[k][m]): a warp stores one row's 32 k to 32 banks
  // (stride BM + 1); reads below are broadcasts or 16 consecutive words
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 4];

  const int f0 = blockIdx.x * BN;
  const int c0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const float* xe = x + (size_t)e * C * D;
  const float* we = w + (size_t)(e % Ew) * D * F;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // outputs (ty + 16 i, tx + 16 j)

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int i = tid; i < BM * BK; i += FMA_THREADS) {
      const int r = i / BK, k = i % BK;
      const int c = c0 + r, d = k0 + k;
      As[k][r] = (c < C && d < D) ? xe[(size_t)c * D + d] : 0.0f;
    }
    for (int i = tid; i < BK * BN; i += FMA_THREADS) {
      const int k = i / BN, n = i % BN;
      const int d = k0 + k, f = f0 + n;
      Bs[k][n] = (d < D && f < F) ? we[(size_t)d * F + f] : 0.0f;
    }
    __syncthreads();
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

  float* oe = out + (size_t)e * C * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx + 16 * j;
      if (c < C && f < F) oe[(size_t)c * F + f] = acc[i][j];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns the CUDA error of the launch (0 = ok).
extern "C" int gmm_fwd(const void* x, const void* w, void* out, int E, int C, int D, int F,
                       int Ew, int dtype, void* stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  if (E < 1 || Ew < 1 || C < 1 || D < 1 || F < 1 || grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (D % 8 == 0 && F % 8 == 0 && aligned16(x) && aligned16(w))
      gmm_bf16_kernel<true><<<grid, TC_THREADS, 0, s>>>(xb, wb, ob, C, D, F, Ew);
    else
      gmm_bf16_kernel<false><<<grid, TC_THREADS, 0, s>>>(xb, wb, ob, C, D, F, Ew);
  } else if (dtype == 0) {
    gmm_f32_kernel<<<grid, FMA_THREADS, 0, s>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(w),
                                               static_cast<float*>(out), C, D, F, Ew);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
