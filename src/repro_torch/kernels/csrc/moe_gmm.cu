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
// The TPU kernel carries an f32 accumulator in VMEM across a sequential D
// grid axis; blocks here run in parallel, so each block owns one output tile
// of one e and loops over D itself, with nothing crossing blocks.  The caller
// picks one of three routes by shape (kernels/moe_gmm.py:route):
//
// bf16, TMA + wgmma (D % 8 == 0, F % 8 == 0, 16-byte aligned bases; every
// model shape).  A 128 x 256 output tile a block, 64-deep D steps, and three
// warpgroups: one thread of the first issues TMA copies of the x tile (128 x
// 64, 16 KB) and the w tile (64 x 256 as four 64-column slabs, 32 KB) into a
// ring of four stages of 128-byte-swizzled shared memory, each stage's bytes
// counted on a "full" mbarrier; the other two each own 64 rows and run wgmma
// m64n256k16 with both operands read from shared memory through descriptors
// (x k-major, w n-major), one k step's products in flight while the next
// stage is waited on, and release a stage on its "empty" mbarrier once the
// products that read it are done.  The producer gives its registers to the
// consumers (setmaxnreg 40 / 232): each consumer thread holds 128 f32 sums.
// TMA fills rows of C and columns of D and F past the tensor with zeros, so
// ragged edges need no branch; stores are masked.  Blocks are ordered so that
// the C tiles and the groups e, e + Ew, ... that read one w tile run next to
// each other, and w is read from device memory about once.  Where C is below
// 128 (decode), the x box is C rows rounded up to 8, not 128 rows of which
// most are zeros, and a consumer whose rows all lie past C only passes the
// stages on: w's bytes bound that shape, and the copies of x no longer
// compete with them.  ptxas: 168 registers at launch (the launch bound of
// one 384-thread block an SM), no spills; 197,632 bytes of dynamic shared
// memory.  A persistent grid (one block an SM walking the tiles, its
// producer running ahead across tiles) and 128-column tiles were both
// slower on the card (PERF.md).
//
// bf16, wmma (any other shape: D or F not a multiple of 8, or a base off 16
// bytes).  The first design: a 64 x 64 tile a block staged element by
// element, zero-filled past C, D and F, and nvcuda::wmma 16x16x16 fragments.
//
// f32, FMA (TF32 cannot hold the reference's 2e-5).  4 x 4 register
// micro-tiles a thread, each 32-deep slice of D summed apart and then added to
// the total, which keeps the f32 rounding near cuBLAS's.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int BM = 64;   // rows of C per block
constexpr int BN = 64;   // columns of F per block
constexpr int BK = 32;   // depth of D staged at a time

// ----------------------------------------------------------------- bf16, wmma
constexpr int TC_THREADS = 128;  // 4 warps in a 2x2 grid of 32x32 quarters
constexpr int A_LD = BK + 8;     // bf16 elements a row of the x tile (80 bytes)
constexpr int B_LD = BN + 8;     // bf16 elements a row of the w tile (144 bytes)
constexpr int C_LD = BN + 4;     // floats a row of the output tile

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

// ------------------------------------------------------------ bf16, TMA + wgmma
constexpr int TMA_BM = 128;       // rows of C a block: two m64 consumers
constexpr int TMA_BN = 256;       // columns of F a block: one n256 wgmma
constexpr int TMA_BK = 64;        // depth of D a stage: one 128-byte row
constexpr int STAGES = 4;
constexpr int TMA_THREADS = 384;  // producer warpgroup + two consumers
constexpr int A_BYTES = TMA_BM * TMA_BK * 2;     // the x tile, 16 KB
constexpr int SLAB_BYTES = TMA_BK * 64 * 2;      // 64 rows of D x 64 columns of F, 8 KB
constexpr int STAGE_BYTES = A_BYTES + TMA_BN / 64 * SLAB_BYTES;
constexpr int TMA_SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment to the swizzle atom

__global__ void __launch_bounds__(TMA_THREADS, 1)
gmm_tma_kernel(__nv_bfloat16* __restrict__ out, int E, int C, int D, int F, int Ew, int m_tiles,
               int n_tiles, int reps, int x_rows, const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap w_map) {
  __shared__ __align__(8) uint64_t full[STAGES];   // a stage's tiles have landed
  __shared__ __align__(8) uint64_t empty[STAGES];  // both consumers are done with a stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw) + (1024 - ptx::smem_addr(smem_raw) % 1024) % 1024;

  // C tiles fastest, then the groups e = s, s + Ew, ... of one slab, then F
  // tiles, then slabs: the blocks that read one w tile run together
  int idx = blockIdx.x;
  const int m = idx % m_tiles;
  idx /= m_tiles;
  const int r = idx % reps;
  idx /= reps;
  const int n = idx % n_tiles;
  const int s = idx / n_tiles;
  const int e = s + r * Ew;
  if (e >= E) return;  // the last slabs' spare groups when Ew does not divide E
  const int c0 = m * TMA_BM, f0 = n * TMA_BN;
  const int k_tiles = (D + TMA_BK - 1) / TMA_BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      ptx::mbar_init(&full[i], 1);
      ptx::mbar_init(&empty[i], 2);
    }
    ptx::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    ptx::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int st = kt % STAGES;
        // a fresh barrier counts as having completed the phase before its
        // first, so the first round's waits pass at once
        ptx::mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
        char* a = smem + st * STAGE_BYTES;
        ptx::mbar_expect_tx(&full[st], x_rows * 128 + STAGE_BYTES - A_BYTES);
        ptx::tma_load_3d(a, &x_map, kt * TMA_BK, c0, e, &full[st]);
#pragma unroll
        for (int slab = 0; slab < TMA_BN / 64; ++slab)
          ptx::tma_load_3d(a + A_BYTES + slab * SLAB_BYTES, &w_map, f0 + 64 * slab,
                           kt * TMA_BK, s, &full[st]);
      }
    }
  } else {
    ptx::setmaxnreg_inc<232>();
    const int rows = (wg - 1) * 64;  // this consumer's rows of the tile
    if (c0 + rows >= C) {
      // all its rows lie past C (small C, as in decode): it only passes the
      // stages on
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int st = kt % STAGES;
        ptx::mbar_wait(&full[st], (kt / STAGES) & 1);
        if (threadIdx.x % 128 == 0) ptx::mbar_arrive(&empty[st]);
      }
      return;
    }
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int st = kt % STAGES;
      ptx::mbar_wait(&full[st], (kt / STAGES) & 1);
      const char* a = smem + st * STAGE_BYTES;
      ptx::fence_regs(acc);
      ptx::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TMA_BK / 16; ++kk)
        // x: 128-byte rows, 16 k (32 bytes) a step, 8-row groups 1024 bytes
        // apart; w: n-major, 16 rows (2048 bytes) a step, slabs SLAB_BYTES apart
        ptx::wgmma_ss_m64n256k16<1>(acc, ptx::wgmma_desc(a + rows * 128 + 32 * kk, 16, 1024, 1),
                                    ptx::wgmma_desc(a + A_BYTES + 2048 * kk, SLAB_BYTES, 1024, 1),
                                    1);
      ptx::wgmma_commit();
      ptx::fence_regs(acc);
      // the previous stage's products are done: give it back to the producer
      ptx::wgmma_wait<1>();
      if (kt > 0 && threadIdx.x % 128 == 0) ptx::mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    ptx::wgmma_wait<0>();
    ptx::fence_regs(acc);

    // acc[4i .. 4i+3]: rows g and g + 8 of the warp's 16, columns 8i + 2t, +1
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int r0 = c0 + rows + 16 * warp + lane / 4;
    const int col0 = f0 + 2 * (lane % 4);
    __nv_bfloat16* oe = out + (size_t)e * C * F;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= C) continue;
      __nv_bfloat16* orow = oe + (size_t)row * F;
#pragma unroll
      for (int i = 0; i < TMA_BN / 8; ++i) {
        const int col = col0 + 8 * i;  // F is even: the pair lies wholly inside or outside
        if (col < F)
          *reinterpret_cast<uint32_t*>(orow + col) =
              ptx::pack_bf16(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
      }
    }
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

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (found == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
    if (err != cudaSuccess) return err;
    if (ptr == nullptr || status != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    found = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = found;
  return cudaSuccess;
}

// The TMA map of a bf16 [n2, n1, n0] tensor (n0 contiguous) with a box of
// 64 x rows x 1 and the 128-byte swizzle; reads outside the tensor give zeros.
cudaError_t map_3d(CUtensorMap* map, EncodeTiled encode, const void* p, int n0, int n1, int n2,
                   int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2};
  const cuuint64_t strides[2] = {(cuuint64_t)n0 * 2, (cuuint64_t)n0 * n1 * 2};  // bytes
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // zeros outside
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_tma(const void* x, const void* w, void* out, int E, int C, int D, int F,
                       int Ew, cudaStream_t s) {
  if (D % 8 != 0 || F % 8 != 0 || !aligned16(x) || !aligned16(w))
    return cudaErrorInvalidValue;  // TMA's global strides and bases are 16-byte multiples
  const int m_tiles = (C + TMA_BM - 1) / TMA_BM, n_tiles = (F + TMA_BN - 1) / TMA_BN;
  const int reps = (E + Ew - 1) / Ew;
  const long long blocks = (long long)m_tiles * reps * n_tiles * Ew;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap x_map, w_map;
  // the x box: the tile's 128 rows, or C rounded up to 8 where C is smaller,
  // which saves copying rows of zeros; rows past the box in shared memory
  // feed only outputs past C, which are not stored
  const int x_rows = C < TMA_BM ? (C + 7) / 8 * 8 : TMA_BM;
  if ((err = map_3d(&x_map, encode, x, D, C, E, x_rows)) != cudaSuccess) return err;
  if ((err = map_3d(&w_map, encode, w, F, D, Ew, TMA_BK)) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gmm_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TMA_SMEM);
  if (err != cudaSuccess) return err;
  gmm_tma_kernel<<<(unsigned)blocks, TMA_THREADS, TMA_SMEM, s>>>(
      static_cast<__nv_bfloat16*>(out), E, C, D, F, Ew, m_tiles, n_tiles, reps, x_rows, x_map,
      w_map);
  return cudaGetLastError();
}

}  // namespace

// route: 0 f32 FMA, 1 bf16 wmma, 2 bf16 TMA + wgmma (kernels/moe_gmm.py:route
// picks it; the TMA route needs D % 8 == 0, F % 8 == 0 and 16-byte aligned x
// and w).  Returns the CUDA error of the launch (0 = ok).
extern "C" int gmm_fwd(const void* x, const void* w, void* out, int E, int C, int D, int F,
                       int Ew, int route, void* stream) {
  if (E < 1 || Ew < 1 || C < 1 || D < 1 || F < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2) return (int)launch_tma(x, w, out, E, C, D, F, Ew, s);
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  if (route == 1) {
    gmm_bf16_kernel<<<grid, TC_THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                static_cast<const __nv_bfloat16*>(w),
                                                static_cast<__nv_bfloat16*>(out), C, D, F, Ew);
  } else if (route == 0) {
    gmm_f32_kernel<<<grid, FMA_THREADS, 0, s>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(w),
                                               static_cast<float*>(out), C, D, F, Ew);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
