// Flash attention forward for Hopper (compiled for sm_90a): blocked
// online-softmax grouped-query attention.
//
// Replaces the Pallas TPU kernel `_attn_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py (pallas_call at :160).  It computes
// what that kernel computes:
//   q [B,S,H,D], k/v [B,T,K,D]; kv head = q head / (H/K);
//   s = (q . k) * 1/sqrt(D), then softcap * tanh(s / softcap) if softcap > 0;
//   mask: causal (k_pos <= q_pos) and window (q_pos - k_pos < window), with
//   q and k positions both counted from 0 (so S < T works);
//   fp32 running max m, sum l and accumulator; p of masked entries is 0, even
//   in a row that is masked throughout (its output is 0);
//   out = acc / max(l, 1e-30), in q's dtype.
//
// Bound.  At the serving slice's prefill shape (B 8, S = T = 512, H 16, K 8,
// D 128, bf16, causal) q/k/v/o are 50.3 MB, 15.0 us at 3.35 TB/s; the causal
// products are 8.6 GFLOP, 8.7 us at 989 TFLOP/s.  So the memory bounds it.
//
// bf16 design: FlashAttention-2's blocking on Hopper's asynchronous units.
// One block, one warpgroup (4 warps), owns one (batch, q head) and one
// 64-row q tile; each warp owns 16 query rows.  The grid puts the q tile on
// its slow axis, last tile first, so the heavy causal tiles start first.  The
// block walks the 64-row K/V tiles that causality and the window leave, from
// the last one down:
//  - Loads: thread 0 issues TMA copies (cp.async.bulk.tensor, ptx.cuh) of the
//    Q tile and of K/V tiles into two bf16 stages of shared memory; an
//    mbarrier a stage counts their bytes.  Tile j-1 is in flight while tile j
//    is multiplied, one __syncthreads a tile.  The maps' 128/64/32-byte
//    swizzle is the layout wgmma reads conflict-free, and TMA fills rows past
//    S or T with zeros, so ragged edges need no branch.
//  - Tensor cores: S = Q K^T and O += P V are wgmma m64nNk16 bf16 products
//    with f32 accumulators, A from registers and B read from shared memory
//    through descriptors (K k-major, V transposed).  Q is loaded once into
//    registers (ldmatrix) as A fragments.
//  - Softmax stays in registers: the score tile S, the running max and sum
//    per row (a row's 64 scores are spread over the 4 lanes of a quad, which
//    reduce the max with __shfl_xor_sync; the sum stays per lane until the
//    end).  The exponent is ex2.approx with log2(e) folded into the scale.
//    The causal, window and ragged-T mask is applied only to tiles that cross
//    a boundary for the warp's rows; interior tiles take none.  A masked score
//    is -inf and the running max of a row that has seen only masked scores is
//    taken as 0, so every masked p is exactly 0.
//  - P never leaves registers: the f32 score fragments are rounded to bf16
//    and are the A fragments of the PV product.  This rounds P to bf16 where
//    the TPU kernel keeps it f32 (repro/kernels/flash_attention.py:87-91), as
//    the port's own attend_xla does (models/attention.py:77-78); the row sum l
//    is taken from the unrounded p.  On the card the kernel stays within one
//    bf16 step of the output of attention_ref (PERF.md).
//  - The output tile is written through shared memory, in 16-byte stores.
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): 0.038 ms at the shape
// above, 40 % of its bound, against SDPA's 0.033 ms; the first design (fp32
// FMA loops) took 0.72 ms.  Each block's load of Q and its first K/V tile
// and its store of O take most of it, and the two blocks an SM do not
// overlap them with the products and the softmax
// (python3 chip_smoke.py --flash-ablation; PERF.md).
//
// f32 design.  TF32 tensor cores cannot hold the reference's f32 tolerance
// of 2e-5, so f32 keeps the first design: one 256-thread block per (b*H + h,
// 64-row q tile), K/V tiles staged in shared memory as f32, products as fp32
// FMA loops on a 16 x 16 thread grid (4 query rows and 4 key columns a
// thread), P through shared memory.
//
// Training (flash_attention_fwd_lse, flash_attention_bwd): causal
// self-attention and its gradient for the `xla` route's training step
// (models/attention.py attend).  They replace no Pallas kernel: the
// reference's `xla` route is einsum attention that XLA fuses, and its
// gradient is jax.grad through it; the Pallas kernel has no backward.  The
// forward is the bf16 kernel above with LSE on (serving's instantiation has
// it off, its code unchanged).  The backward is described at "bf16 backward"
// below.  Bound at internlm2-1.8b's training shape (B 8, S = T = 2048, H 16,
// K 8, D 128): 2.69e8 causal pairs; the forward's two products 1.37e11 FLOP,
// 0.139 ms at 989 TFLOP/s (its 201 MB 0.060 ms at 3.35 TB/s); the backward's
// five (S again, dP, dV, dQ, dK) 3.44e11 FLOP, 0.347 ms (403 MB, 0.120 ms).
// Both are bound by operations.  The backward issues seven, dQ and dK twice
// (dS as hi + lo, below): 4.81e11 FLOP on the tensor cores.
//
// The pair is templated on the q.k width DQK and v's DV, instantiated at
// (64, 64), (128, 128) and (192, 128).  The last is latent attention's
// (models/attention.py apply_mla: 128 nope + 64 rope for q.k, 128 for v), a
// shape no TPU kernel has (the JAX package has no MLA); FlashAttention-3 added
// the same head-dim pair for DeepSeek-V3.  The scale is 1/sqrt(DQK).  Bound at
// moonlight's training shape (B 16, S = T = 2048, H = K 16): 2.10e6 causal
// pairs a head; the forward's 2 (DQK + DV) FLOP a pair and head, 3.44e11 FLOP,
// 0.348 ms at 989 TFLOP/s (its 671 MB 0.200 ms); the backward's 2 (3 DQK + 2
// DV), 8.94e11 FLOP, 0.904 ms (1.21 GB, 0.361 ms): bound by operations.  What
// the 192-wide tiles change is the budgets.  The forward keeps 64-row tiles:
// two stages of K (24 KB) and V (16 KB) are 81 KB, two blocks an SM, and Q's
// 12 A fragments take 48 registers.  The backward's dK/dV block holds dK (64
// x 192) and dV (64 x 128) in f32, 160 registers a thread, and with 64-row
// streamed Q and dO tiles its shared memory (121 KB) would leave one block an
// SM.  So at DQK 192 both backward kernels stream 32-row tiles (NB below): the
// S and dP fragments halve (16 registers each; ptxas gives dK/dV 218
// registers, no spill) and each block takes 81 KB, two blocks an SM, as at D
// 128.  And L2: with K = H = 16 at B 16, the blocks of one q-tile index over
// every head (the default grid order, heads on the fast axis) stream 335 MB of
// K and V, far past the 50 MB L2, so each q tile read them from HBM again: the
// forward took 1.92 ms.  At (192, 128) the tiles run on the grid's fast axis
// (tiles_fast), the blocks in flight are all the tiles of a few heads, and
// their K and V (or Q and dO) stay in L2: forward 0.79 ms, backward 3.19 ms
// (from 4.17), H100 80GB HBM3 at 700 W.  (64, 64) and (128, 128) keep the
// default order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------- bf16, wgmma
constexpr int TC_THREADS = 128;  // one warpgroup: 4 warps, 16 q rows each
constexpr int TC_BM = 64;        // q rows a block: one m64 wgmma
constexpr int TC_BN = 64;        // kv rows a tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A staged tile: ROWS rows (64, or the backward's 32-row streamed tiles) of D
// bf16, cut into slabs of RB-byte rows, RB the largest of 128, 64 and 32 that
// divides a row's 2 D bytes (D 16: 32; D 32, 96: 64; D 48, 80, 112: 32; D 64,
// 128, 192: 128), so that every slab is one whole swizzle atom wide.  The
// slabs' 16-byte chunks are swizzled as TMA writes them with the map's swizzle
// mode and as wgmma reads them.
template <int D, int ROWS = TC_BN>
struct TcTile {
  static_assert(D % 16 == 0 && D >= 16 && D <= 192, "head dims 16..192, multiples of 16");
  static constexpr int RB = 2 * D % 128 == 0 ? 128 : 2 * D % 64 == 0 ? 64 : 32;
  static constexpr int SLABS = 2 * D / RB;
  static constexpr int SWZ = RB == 128 ? 3 : RB == 64 ? 2 : 1;  // row bits XORed into the chunk
  static constexpr int SWIZZLE = 4 - SWZ;  // wgmma_desc's mode: 1 for 128 B rows, 3 for 32 B
  static constexpr int SLAB = ROWS * RB;                            // bytes of a slab
  static constexpr int BYTES = ROWS * D * 2;
  static constexpr int PITCH = D + 8;  // bf16 elements a row of the staged O tile
};

// Byte offset of (row r, column c) in a staged tile, c a multiple of 8: the
// 16-byte chunk index is XORed with row bits (Swizzle<SWZ,4,3>).
template <int D>
__device__ __forceinline__ int tile_off(int r, int c) {
  using TT = TcTile<D>;
  const int chunk = c / 8, per_row = TT::RB / 16;
  const int lin = (chunk / per_row) * TT::SLAB + r * TT::RB + (chunk % per_row) * 16;
  return lin ^ (((lin >> 7) & ((1 << TT::SWZ) - 1)) << 4);
}

// Copies rows `row` .. `row` + ROWS - 1 of head `head` of batch `b` as a tile
// at `dst`, one TMA box a slab; rows past the tensor's end arrive as zeros.
template <int D, int ROWS = TC_BN>
__device__ __forceinline__ void tma_tile(char* dst, const CUtensorMap* map, int head, int row,
                                         int b, uint64_t* bar) {
  using TT = TcTile<D, ROWS>;
#pragma unroll
  for (int slab = 0; slab < TT::SLABS; ++slab)
    ptx::tma_load_4d(dst + slab * TT::SLAB, map, slab * TT::RB / 2, head, row, b, bar);
}

// The descriptor of columns 16 kk .. 16 kk + 15 of a staged tile's rows, read
// k-major (each row one row of the product's A, or one column of its B).
template <int D, int ROWS = TC_BN>
__device__ __forceinline__ uint64_t kmajor_desc(const char* tile, int kk) {
  using TT = TcTile<D, ROWS>;
  return ptx::wgmma_desc(tile + (32 * kk / TT::RB) * TT::SLAB + 32 * kk % TT::RB, 16, 8 * TT::RB,
                         TT::SWIZZLE);
}

// A block's place on the grid: its row of heads (b H + h, or b K + kh) and
// its tile.  By default the heads run on the grid's fast axis and the tiles on
// its slow one; with tiles_fast the other way round, so that the blocks in
// flight at once are all the tiles of a few heads, and the tiles they stream
// (K and V, or Q and dO) stay in L2 between them.
struct GridPos {
  int heads, tile, tiles;
};

__device__ __forceinline__ GridPos grid_pos(int tiles_fast) {
  return tiles_fast ? GridPos{(int)blockIdx.y, (int)blockIdx.x, (int)gridDim.x}
                    : GridPos{(int)blockIdx.x, (int)blockIdx.y, (int)gridDim.y};
}

dim3 grid_of(int heads, int tiles, int tiles_fast) {
  return tiles_fast ? dim3(tiles, heads) : dim3(heads, tiles);
}

// S (64 x 64) = Q K^T over D, K read k-major from the staged tile.
template <int D>
__device__ __forceinline__ void qk_wgmma(float (&s)[32], const uint32_t (&qf)[D / 16][4],
                                         const char* k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ptx::wgmma_m64n64k16<0>(s, qf[kk], kmajor_desc<D>(k_tile, kk), kk > 0);
}

// The warpgroup's 64 x 16 KT f32 fragment, rounded to bf16, as the A
// fragments of a product over its 16 KT columns, 16 a step (ptx.cuh: two D
// column tiles side by side are one A fragment).
template <int KT>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[KT][4], const float (&s)[2 * KT][4]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    a[kk][0] = ptx::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = ptx::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = ptx::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = ptx::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// O (64 x D) += P (64 x 16) V (16 x D), V read n-major (transposed) from the
// staged tile of ROWS rows at its row `k0`.  D 128 runs as one m64n128k16
// across its two 128-byte slabs, D 192 as one m64n192k16 across its three.
// At D 64 a single transposed m64n64k16 beside the k-major m64n64k16 of S gave
// wrong sums on the card (two kv tiles or more), so its one slab runs as two
// n32 halves.  Every other D runs one product a slab, m64n{RB/2}k16 (n32 at
// RB 64, n16 at RB 32), its descriptor at the slab's base, so that no
// transposed product spans more than one swizzle atom.
template <int D, int ROWS = TC_BN>
__device__ __forceinline__ void pv_wgmma(float (&acc)[D / 2], const uint32_t (&pf)[4],
                                         const char* v_tile, int k0) {
  using TT = TcTile<D, ROWS>;
  const char* v_rows = v_tile + k0 * TT::RB;
  if constexpr (D == 192) {
    ptx::wgmma_m64n192k16<1>(acc, pf, ptx::wgmma_desc(v_rows, TT::SLAB, 8 * TT::RB, TT::SWIZZLE),
                             1);
  } else if constexpr (D == 128) {
    ptx::wgmma_m64n128k16<1>(acc, pf, ptx::wgmma_desc(v_rows, TT::SLAB, 8 * TT::RB, TT::SWIZZLE),
                             1);
  } else if constexpr (D == 64) {
    const uint64_t desc = ptx::wgmma_desc(v_rows, TT::SLAB, 8 * TT::RB, TT::SWIZZLE);
    ptx::wgmma_m64n32k16<1>(*reinterpret_cast<float(*)[16]>(&acc[0]), pf, desc, 1);
    ptx::wgmma_m64n32k16<1>(*reinterpret_cast<float(*)[16]>(&acc[16]), pf, desc + (64 >> 4), 1);
  } else {
    static_assert(TT::RB < 128, "a 128-byte slab's D has its own product above");
    constexpr int PART = TT::RB / 4;  // accumulator floats a slab: RB / 2 columns
#pragma unroll
    for (int slab = 0; slab < TT::SLABS; ++slab) {
      const uint64_t desc =
          ptx::wgmma_desc(v_rows + slab * TT::SLAB, TT::SLAB, 8 * TT::RB, TT::SWIZZLE);
      float(&part)[PART] = *reinterpret_cast<float(*)[PART]>(&acc[slab * PART]);
      if constexpr (TT::RB == 64)
        ptx::wgmma_m64n32k16<1>(part, pf, desc, 1);
      else
        ptx::wgmma_m64n16k16<1>(part, pf, desc, 1);
    }
  }
}

// 2 blocks (8 warps) an SM: at 3, D 128 would be held to 168 registers and spill.
// D is the q.k width and DV v's (serving's instantiations have DV = D).
// LSE: also store each row's log-sum-exp of its scaled scores (natural log,
// f32, [B, H, S]) for the backward; serving's instantiation has it off.
template <int D, int DV, bool LSE>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_attention_bf16_kernel(__nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
                            int T_len, int H, int K, int causal, int window, float softcap,
                            float sm_scale, int tiles_fast,
                            const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map) {
  using TT = TcTile<D>;
  using TV = TcTile<DV>;
  constexpr int KD = D / 16;     // 16-deep steps over D
  constexpr int NT = TC_BN / 8;  // 8-wide score column tiles
  constexpr int STAGE = TT::BYTES + TV::BYTES;
  static_assert(TC_BM * TV::PITCH * 2 <= STAGE, "the O tile is staged in one stage");
  __shared__ __align__(8) uint64_t landed[2];  // stage s's tiles have landed
  extern __shared__ __align__(16) unsigned char smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw) + (1024 - ptx::smem_addr(smem_raw) % 1024) % 1024;
  // stage s: K tile at smem + s STAGE, V tile right after it

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const GridPos pos = grid_pos(tiles_fast);
  const int b = pos.heads / H, h = pos.heads % H;
  const int kh = h / (H / K);
  const int q0 = (pos.tiles - 1 - pos.tile) * TC_BM;  // heavy causal tiles first

  // the kv tiles with an unmasked pair for some row of this q tile
  const int q_last = min(q0 + TC_BM, S) - 1;
  int j_hi = (T_len - 1) / TC_BN;
  if (causal) j_hi = min(j_hi, q_last / TC_BN);
  int j_lo = 0;
  if (window > 0 && q0 - window - TC_BN + 1 >= 0) j_lo = (q0 - window - TC_BN + 1) / TC_BN + 1;

  // thread 0 issues every copy: Q through stage 1, the first K/V tile into
  // stage 0, each stage's arrival counted on its barrier
  if (tid == 0) {
    ptx::mbar_init(&landed[0], 1);
    ptx::mbar_init(&landed[1], 1);
    ptx::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    ptx::mbar_expect_tx(&landed[1], TT::BYTES);
    tma_tile<D>(smem + STAGE, &q_map, h, q0, b, &landed[1]);
    if (j_lo <= j_hi) {
      ptx::mbar_expect_tx(&landed[0], STAGE);
      tma_tile<D>(smem, &k_map, kh, j_hi * TC_BN, b, &landed[0]);
      tma_tile<DV>(smem + TT::BYTES, &v_map, kh, j_hi * TC_BN, b, &landed[0]);
    }
  }
  ptx::mbar_wait(&landed[1], 0);  // Q has landed

  // this warp's 16 q rows as A fragments: matrices rows +0-7 / cols +0,
  // rows +8-15 / +0, rows +0-7 / +8, rows +8-15 / +8
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ptx::ldmatrix_x4(qf[kk], smem + STAGE +
                                 tile_off<D>(warp * 16 + lane % 16, kk * 16 + (lane / 16) * 8));

  float acc[DV / 8][4];  // O: 16 rows x DV a warp, 8-wide column tiles
  float(&acc_flat)[DV / 2] = *reinterpret_cast<float(*)[DV / 2]>(&acc[0][0]);
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc_flat[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of the warp's 16
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums

  // without softcap the scale folds into the exponent; with it, it is applied
  // inside the tanh and the exponent takes log2(e) alone
  const float scale_log2 = softcap > 0.f ? LOG2E : sm_scale * LOG2E;
  const int wq0 = q0 + warp * 16;   // the warp's first q row
  const int row0 = wq0 + lane / 4;  // this lane's rows: row0, row0 + 8

  int stage = 0;
  for (int j = j_hi; j >= j_lo; --j, stage ^= 1) {
    // stage 1 completed once for Q, so its i-th tile (i = j_hi - j odd) completes
    // phase ((i + 1) / 2) & 1; stage 0's (i even) phase (i / 2) & 1
    ptx::mbar_wait(&landed[stage], ((j_hi - j + stage) >> 1) & 1);  // tile j has landed
    __syncthreads();  // nobody reads the other stage (or Q) any more
    if (j > j_lo && tid == 0) {
      char* nxt = smem + (stage ^ 1) * STAGE;
      ptx::mbar_expect_tx(&landed[stage ^ 1], STAGE);
      tma_tile<D>(nxt, &k_map, kh, (j - 1) * TC_BN, b, &landed[stage ^ 1]);
      tma_tile<DV>(nxt + TT::BYTES, &v_map, kh, (j - 1) * TC_BN, b, &landed[stage ^ 1]);
    }
    const char* ks = smem + stage * STAGE;
    const char* vs = ks + TT::BYTES;
    const int k0 = j * TC_BN;

    // S = Q K^T: 64 x 64, the warp's 16 rows in its fragments
    float s[NT][4];
    float(&s_flat)[4 * NT] = *reinterpret_cast<float(*)[4 * NT]>(&s[0][0]);
    ptx::wgmma_fence();
    qk_wgmma<D>(s_flat, qf, ks);
    ptx::wgmma_commit();
    ptx::wgmma_wait<0>();
    ptx::fence_regs(s_flat);

    if (softcap > 0.f) {
      const float inv = sm_scale / softcap;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = softcap * tanhf(s[nt][e] * inv);
    }

    // mask only a tile that crosses the ragged T edge, the diagonal or the
    // window's edge for some row of this warp
    const bool edge = k0 + TC_BN > T_len || (causal && k0 + TC_BN - 1 > wq0) ||
                      (window > 0 && wq0 + 15 - k0 >= window);
    if (edge) {
      // column c of the tile (key k0 + c) is kept for row i when lo[i] <= c <= hi[i]
      const int c0 = 2 * (lane % 4);
      int lo[2], hi[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rel = row0 + 8 * i - k0;
        hi[i] = min(T_len - k0 - 1, causal ? rel : TC_BN);
        lo[i] = window > 0 ? rel - window + 1 : 0;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + nt * 8 + (e & 1);
          if (c < lo[e >> 1] || c > hi[e >> 1]) s[nt][e] = -INFINITY;
        }
    }

    // online softmax; entries 2i, 2i+1 of each fragment belong to row i
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with only masked scores so far keeps max -inf; taking it as 0
      // makes every exp2(-inf - 0) exactly 0 instead of exp2(-inf + inf)
      const float m_scaled = mx == -INFINITY ? 0.f : mx * scale_log2;
      const float alpha = ptx::exp2_approx(m[i] * scale_log2 - m_scaled);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[nt][e] = ptx::exp2_approx(fmaf(s[nt][e], scale_log2, -m_scaled));
          sum += s[nt][e];
        }
      l[i] = alpha * l[i] + sum;
#pragma unroll
      for (int dt = 0; dt < DV / 8; ++dt) {
        acc[dt][2 * i] *= alpha;
        acc[dt][2 * i + 1] *= alpha;
      }
    }

    // O += P V, P as bf16 A fragments straight from the score fragments
    uint32_t pf[TC_BN / 16][4];
    to_a_frags(pf, s);
    ptx::fence_regs(acc_flat);
    ptx::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BN / 16; ++kk) pv_wgmma<DV>(acc_flat, pf[kk], vs, 16 * kk);
    ptx::wgmma_commit();
    ptx::wgmma_wait<0>();
    ptx::fence_regs(acc_flat);
  }

  // out = acc / max(l, 1e-30), staged through stage 0 in padded rows and
  // stored 16 bytes a thread
  __syncthreads();  // every warp is done with the last stage
  __nv_bfloat16* o_tile = reinterpret_cast<__nv_bfloat16*>(smem);
  constexpr int PITCH = TV::PITCH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int r = warp * 16 + lane / 4 + 8 * i;
    if constexpr (LSE) {
      // p = 2^(s scale_log2 - m_scaled), summed to `sum`: the log-sum-exp of
      // the scaled scores is (m_scaled + log2(sum)) ln 2
      if (lane % 4 == 0 && q0 + r < S)
        lse[((long)b * H + h) * S + q0 + r] =
            ((m[i] == -INFINITY ? 0.f : m[i] * scale_log2) + log2f(fmaxf(sum, 1e-30f))) * LN2;
    }
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt)
      *reinterpret_cast<uint32_t*>(o_tile + r * PITCH + dt * 8 + 2 * (lane % 4)) =
          ptx::pack_bf16(acc[dt][2 * i] * inv, acc[dt][2 * i + 1] * inv);
  }
  __syncthreads();
  constexpr int CHUNKS = DV / 8;
  __nv_bfloat16* ob = o + ((long)b * S + q0) * H * DV + (long)h * DV;
  for (int c = tid; c < TC_BM * CHUNKS; c += TC_THREADS) {
    const int r = c / CHUNKS, col = 8 * (c % CHUNKS);
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(ob + (long)r * H * DV + col) =
          *reinterpret_cast<const uint4*>(o_tile + r * PITCH + col);
  }
}

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

// The TMA map of x [B, rows, heads, D] bf16: a box is one slab (RB bytes of
// d) of one head over ROWS rows, swizzled as TcTile<D, ROWS> lays it out.
template <int D, int ROWS = TC_BN>
cudaError_t tile_map(CUtensorMap* map, EncodeTiled encode, const void* x, int B, int rows,
                     int heads) {
  using TT = TcTile<D, ROWS>;
  const CUtensorMapSwizzle swizzle = TT::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : TT::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};  // bytes, dims 1..3
  const cuuint32_t box[4] = {TT::RB / 2, 1, ROWS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // zeros outside
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int DV = D, bool LSE = false>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int T_len, int H, int K, int causal, int window, float softcap,
                        cudaStream_t stream, float* lse = nullptr, int tiles_fast = 0) {
  // TMA and the 16-byte output stores need 16-byte aligned rows
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return cudaErrorMisalignedAddress;
  EncodeTiled encode;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err;
  if ((err = encode_tiled(&encode)) != cudaSuccess ||
      (err = tile_map<D>(&q_map, encode, q, B, S, H)) != cudaSuccess ||
      (err = tile_map<D>(&k_map, encode, k, B, T_len, K)) != cudaSuccess ||
      (err = tile_map<DV>(&v_map, encode, v, B, T_len, K)) != cudaSuccess)
    return err;
  // two stages of K and V (Q and O pass through them); 1 KB to align the
  // tiles to the swizzle atoms
  const size_t smem = 2 * (TcTile<D>::BYTES + TcTile<DV>::BYTES) + 1024;
  err = cudaFuncSetAttribute(flash_attention_bf16_kernel<D, DV, LSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float sm_scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid = grid_of(B * H, (S + TC_BM - 1) / TC_BM, tiles_fast);
  flash_attention_bf16_kernel<D, DV, LSE><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<__nv_bfloat16*>(o), lse, S, T_len, H, K, causal, window, softcap, sm_scale,
      tiles_fast, q_map, k_map, v_map);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16 backward, wgmma
//
// The gradient of causal self-attention (S = T, positions from 0, no window
// or softcap) from the forward's per-row log-sum-exp L, FlashAttention-2's
// way: P = exp(Q K^T / sqrt(DQK) - L) is recomputed tile by tile, never
// stored.  With Delta = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),
//   dQ = dS K / sqrt(DQK),  dK = dS^T Q / sqrt(DQK),
// GQA's G = H / K query heads of a kv head summed into its dK and dV.
// Three launches: Delta (one pass over O and dO); dK/dV, a block per (batch,
// kv head, 64-row kv tile) walking the NB-row q tiles at or below the
// diagonal for each of the G heads, dK and dV in f32 registers; dQ, a block
// per (batch, q head, 64-row q tile) walking the NB-row kv tiles at or left
// of the diagonal, S and dP recomputed.  NB is 64, or 32 at DQK 192 (the
// budgets at the top of the file).  No atomics: every gradient is summed in
// one block, in the same order on every run.  Products are wgmma bf16 with
// f32 accumulators (S^T = K Q^T, dP^T = V dO^T, S and dP with both operands
// in shared memory; dV, dK, dQ with P or dS from registers).  P is rounded to
// bf16 as the operand of dV, as the forward rounds it for PV.  dP and dS are
// formed in f32, and dS enters dQ and dK as hi + lo, both bf16 (two products
// each): about 16 of f32's 24 mantissa bits, where the reference's dS K and
// dS^T Q are f32 products (its q and k upcast).  Tiles arrive by TMA as in
// the forward, the dK/dV block's Q and dO tiles and the dQ block's K and V
// tiles in two stages, the next in flight while one is multiplied.

// C (64 x NB) = A B^T over D, A a 64-row and B an NB-row staged tile, both
// read k-major.
template <int D, int NB>
__device__ __forceinline__ void abt_wgmma(float (&c)[NB / 2], const char* a_tile,
                                          const char* b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (NB == 64)
      ptx::wgmma_ss_m64n64k16<0>(c, kmajor_desc<D>(a_tile, kk), kmajor_desc<D, NB>(b_tile, kk),
                                 kk > 0);
    else
      ptx::wgmma_ss_m64n32k16<0>(c, kmajor_desc<D>(a_tile, kk), kmajor_desc<D, NB>(b_tile, kk),
                                 kk > 0);
  }
}

// Rows r0 .. r0 + 63 (those below `rows`) of head `head` of x [B, rows,
// heads, D] bf16: the warpgroup's 64 x D f32 fragment times `scale`, staged
// through `stage` in padded rows and stored 16 bytes a thread.  Every thread
// calls it; nobody may still read `stage`'s first 64 (D + 8) bf16.
template <int D>
__device__ __forceinline__ void store_tile(__nv_bfloat16* x, const float (&acc)[D / 8][4],
                                           float scale, char* stage, int b, int r0, int rows,
                                           int heads, int head) {
  constexpr int PITCH = TcTile<D>::PITCH, CHUNKS = D / 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(stage);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + lane / 4 + 8 * i;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(tile + r * PITCH + dt * 8 + 2 * (lane % 4)) =
          ptx::pack_bf16(acc[dt][2 * i] * scale, acc[dt][2 * i + 1] * scale);
  }
  __syncthreads();
  __nv_bfloat16* xb = x + ((long)b * rows + r0) * heads * D + (long)head * D;
  for (int c = tid; c < TC_BM * CHUNKS; c += TC_THREADS) {
    const int r = c / CHUNKS, col = 8 * (c % CHUNKS);
    if (r0 + r < rows)
      *reinterpret_cast<uint4*>(xb + (long)r * heads * D + col) =
          *reinterpret_cast<const uint4*>(tile + r * PITCH + col);
  }
}

// The warpgroup's 64 x 16 KT f32 fragment as two bf16 A fragments, hi its
// rounding and lo the rounding of what hi dropped (exact in f32): hi + lo
// keeps about 16 mantissa bits.  `s` is left holding the remainders.
template <int KT>
__device__ __forceinline__ void to_a_frags_split(uint32_t (&hi)[KT][4], uint32_t (&lo)[KT][4],
                                                 float (&s)[2 * KT][4]) {
  to_a_frags(hi, s);
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 h = ptx::unpack_bf16(hi[kk][i]);  // a[kk][i] packs s[2 kk + i / 2][2 (i % 2) ..]
      s[2 * kk + i / 2][2 * (i % 2)] -= h.x;
      s[2 * kk + i / 2][2 * (i % 2) + 1] -= h.y;
    }
  to_a_frags(lo, s);
}

// delta [B, H, S] = rowsum(dO o O) in f32, D / 8 threads (16 bytes each) a row
// of o and dout [B, S, H, D].
template <int D>
__global__ void flash_attention_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                                                 const __nv_bfloat16* __restrict__ dout,
                                                 float* __restrict__ delta, int S, int H,
                                                 long rows) {
  constexpr int LANES = D / 8;
  static_assert(32 % LANES == 0, "a row's threads within one warp");
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  const int part = threadIdx.x % LANES;
  float sum = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * D + part * 8);
    const uint4 c = *reinterpret_cast<const uint4*>(dout + row * D + part * 8);
    const uint32_t* aw = reinterpret_cast<const uint32_t*>(&a);
    const uint32_t* cw = reinterpret_cast<const uint32_t*>(&c);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 x = ptx::unpack_bf16(aw[w]), y = ptx::unpack_bf16(cw[w]);
      sum = fmaf(x.x, y.x, fmaf(x.y, y.y, sum));
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && part == 0) {
    const long bs = row / H;  // row = (b S + s) H + h
    delta[((bs / S) * H + row % H) * S + bs % S] = sum;
  }
}

// dK and dV of one 64-row kv tile of one kv head.  Shared memory: the K and V
// tiles, then two stages of an NB-row Q and dO tile; each stage's NB L and NB
// Delta arrive by cp.async beside its TMA copies.
template <int DQK, int DV, int NB>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_attention_bwd_dkdv_kernel(__nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                int S, int H, int K, float sm_scale, int tiles_fast,
                                const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap do_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map) {
  using TQ = TcTile<DQK, NB>;  // a streamed Q tile
  using TO = TcTile<DV, NB>;   // a streamed dO tile
  constexpr int NT = NB / 8, STAGE = TQ::BYTES + TO::BYTES;
  __shared__ __align__(8) uint64_t landed[3];  // K and V; stage 0; stage 1
  __shared__ __align__(16) float rowstat[2][2][NB];  // stage s: L, Delta of its q rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw) + (1024 - ptx::smem_addr(smem_raw) % 1024) % 1024;
  const char* k_tile = smem;
  const char* v_tile = smem + TcTile<DQK>::BYTES;
  char* stages = smem + TcTile<DQK>::BYTES + TcTile<DV>::BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const GridPos pos = grid_pos(tiles_fast);
  const int b = pos.heads / K, kh = pos.heads % K, G = H / K;
  const int j = pos.tile;  // the kv tile: the heavy low tiles start first
  const int kv0 = j * TC_BN;
  const int first = kv0 / NB;                           // the q tile that holds row kv0
  const int per_head = (S + NB - 1) / NB - first;       // q tiles first .. the last
  const int n_it = G * per_head;                        // (head, q tile) pairs
  const float scale_log2 = sm_scale * LOG2E;

  // iteration it: query head kh G + it / per_head, q tile first + it % per_head
  const CUtensorMap* qm = &q_map;
  const CUtensorMap* dom = &do_map;
  auto head_of = [&](int it) { return kh * G + it / per_head; };
  auto q0_of = [&](int it) { return (first + it % per_head) * NB; };
  auto issue = [&](int it, int st) {  // thread 0: the Q and dO tiles into stage st
    char* dst = stages + st * STAGE;
    ptx::mbar_expect_tx(&landed[1 + st], STAGE);
    tma_tile<DQK, NB>(dst, qm, head_of(it), q0_of(it), b, &landed[1 + st]);
    tma_tile<DV, NB>(dst + TQ::BYTES, dom, head_of(it), q0_of(it), b, &landed[1 + st]);
  };
  auto stats = [&](int it, int st) {  // threads below 2 NB: one L (tid < NB) or one Delta
    if (tid < 2 * NB) {
      const int r = tid % NB, q = q0_of(it) + r;
      const float* src = (tid < NB ? lse : delta) + ((long)b * H + head_of(it)) * S;
      ptx::cp_async_4(&rowstat[st][tid / NB][r], q < S ? src + q : src, q < S ? 4 : 0);
    }
    ptx::cp_async_commit();
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) ptx::mbar_init(&landed[i], 1);
    ptx::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    ptx::mbar_expect_tx(&landed[0], TcTile<DQK>::BYTES + TcTile<DV>::BYTES);
    tma_tile<DQK>(smem, &k_map, kh, kv0, b, &landed[0]);
    tma_tile<DV>(smem + TcTile<DQK>::BYTES, &v_map, kh, kv0, b, &landed[0]);
    issue(0, 0);
  }
  stats(0, 0);

  float dk_acc[DQK / 8][4], dv_acc[DV / 8][4];
  float(&dk_flat)[DQK / 2] = *reinterpret_cast<float(*)[DQK / 2]>(&dk_acc[0][0]);
  float(&dv_flat)[DV / 2] = *reinterpret_cast<float(*)[DV / 2]>(&dv_acc[0][0]);
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) dk_flat[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv_flat[i] = 0.f;
  const int c0 = 2 * (lane % 4);           // this lane's first q column of a tile
  const int r0 = warp * 16 + lane / 4;     // this lane's kv rows: r0, r0 + 8
  ptx::mbar_wait(&landed[0], 0);

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    ptx::mbar_wait(&landed[1 + st], (it >> 1) & 1);  // the st-th use of stage st
    ptx::cp_async_wait<0>();
    __syncthreads();  // this stage's L and Delta are visible; the other stage is free
    if (it + 1 < n_it) {
      if (tid == 0) issue(it + 1, st ^ 1);
      stats(it + 1, st ^ 1);
    }
    const char* q_tile = stages + st * STAGE;
    const char* do_tile = q_tile + TQ::BYTES;
    const float* l_row = rowstat[st][0];
    const float* d_row = rowstat[st][1];
    // the q tile's first row past the kv tile's: a kv row r past q column c
    // (r > off + c) is masked, which only a tile with off < 63 has
    const int off = q0_of(it) - kv0;
    const bool diag = off < TC_BN - 1;

    // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x NB q columns
    float s[NT][4], dp[NT][4];
    float(&s_flat)[4 * NT] = *reinterpret_cast<float(*)[4 * NT]>(&s[0][0]);
    float(&dp_flat)[4 * NT] = *reinterpret_cast<float(*)[4 * NT]>(&dp[0][0]);
    ptx::wgmma_fence();
    abt_wgmma<DQK, NB>(s_flat, k_tile, q_tile);
    ptx::wgmma_commit();
    abt_wgmma<DV, NB>(dp_flat, v_tile, do_tile);
    ptx::wgmma_commit();
    ptx::wgmma_wait<1>();
    ptx::fence_regs(s_flat);

    // P^T = 2^(S^T scale log2(e) - L log2(e)), masked past the diagonal (q
    // rows past S read Q, dO, L and Delta as zeros, so their dS and their dV
    // terms are 0)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 l = *reinterpret_cast<const float2*>(l_row + nt * 8 + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            ptx::exp2_approx(fmaf(s[nt][e], scale_log2, -(e & 1 ? l.y : l.x) * LOG2E));
        s[nt][e] = diag && r0 + 8 * (e >> 1) > off + nt * 8 + c0 + (e & 1) ? 0.f : p;
      }
    }
    uint32_t pf[NB / 16][4];
    to_a_frags(pf, s);

    ptx::wgmma_wait<0>();
    ptx::fence_regs(dp_flat);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 d = *reinterpret_cast<const float2*>(d_row + nt * 8 + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - (e & 1 ? d.y : d.x));
    }
    uint32_t ds_hi[NB / 16][4], ds_lo[NB / 16][4];
    to_a_frags_split(ds_hi, ds_lo, dp);

    // dV += P^T dO, dK += dS^T Q (hi, then lo): dO and Q read n-major, as V
    // in the forward
    ptx::fence_regs(dv_flat);
    ptx::fence_regs(dk_flat);
    ptx::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NB / 16; ++kk) pv_wgmma<DV, NB>(dv_flat, pf[kk], do_tile, 16 * kk);
#pragma unroll
    for (int kk = 0; kk < NB / 16; ++kk) pv_wgmma<DQK, NB>(dk_flat, ds_hi[kk], q_tile, 16 * kk);
#pragma unroll
    for (int kk = 0; kk < NB / 16; ++kk) pv_wgmma<DQK, NB>(dk_flat, ds_lo[kk], q_tile, 16 * kk);
    ptx::wgmma_commit();
    ptx::wgmma_wait<0>();
    ptx::fence_regs(dv_flat);
    ptx::fence_regs(dk_flat);
  }

  // nothing reads shared memory any more: the last iteration issued no copy
  // and every product has ended; dK and dV are staged through it from its start
  store_tile<DQK>(dk, dk_acc, sm_scale, smem, b, kv0, S, K, kh);
  store_tile<DV>(dv, dv_acc, 1.f, smem, b, kv0, S, K, kh);
}

// dQ of one 64-row q tile of one q head.  Shared memory: the Q and dO tiles,
// then two stages of an NB-row K and V tile.
template <int DQK, int DV, int NB>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_attention_bwd_dq_kernel(__nv_bfloat16* __restrict__ dq, const float* __restrict__ lse,
                              const float* __restrict__ delta, int S, int H, int K,
                              float sm_scale, int tiles_fast,
                              const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map) {
  using TK = TcTile<DQK, NB>;  // a streamed K tile
  using TV = TcTile<DV, NB>;   // a streamed V tile
  constexpr int NT = NB / 8, STAGE = TK::BYTES + TV::BYTES;
  __shared__ __align__(8) uint64_t landed[3];  // Q and dO; stage 0; stage 1
  extern __shared__ __align__(16) unsigned char smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw) + (1024 - ptx::smem_addr(smem_raw) % 1024) % 1024;
  const char* q_tile = smem;
  const char* do_tile = smem + TcTile<DQK>::BYTES;
  char* stages = smem + TcTile<DQK>::BYTES + TcTile<DV>::BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const GridPos pos = grid_pos(tiles_fast);
  const int b = pos.heads / H, h = pos.heads % H;
  const int kh = h / (H / K);
  const int q0 = (pos.tiles - 1 - pos.tile) * TC_BM;  // heavy causal tiles first
  const int j_hi = (min(q0 + TC_BM, S) - 1) / NB;     // the diagonal's kv tile
  const float scale_log2 = sm_scale * LOG2E;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) ptx::mbar_init(&landed[i], 1);
    ptx::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    ptx::mbar_expect_tx(&landed[0], TcTile<DQK>::BYTES + TcTile<DV>::BYTES);
    tma_tile<DQK>(smem, &q_map, h, q0, b, &landed[0]);
    tma_tile<DV>(smem + TcTile<DQK>::BYTES, &do_map, h, q0, b, &landed[0]);
    ptx::mbar_expect_tx(&landed[1], STAGE);
    tma_tile<DQK, NB>(stages, &k_map, kh, j_hi * NB, b, &landed[1]);
    tma_tile<DV, NB>(stages + TK::BYTES, &v_map, kh, j_hi * NB, b, &landed[1]);
  }

  const int wq0 = q0 + warp * 16;   // the warp's first q row
  const int row0 = wq0 + lane / 4;  // this lane's rows: row0, row0 + 8
  const int c0 = 2 * (lane % 4);
  float l2[2], dl[2];  // L log2(e) and Delta of this lane's rows (0 past S)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long at = ((long)b * H + h) * S + row0 + 8 * i;
    const bool in = row0 + 8 * i < S;
    l2[i] = in ? lse[at] * LOG2E : 0.f;
    dl[i] = in ? delta[at] : 0.f;
  }
  float acc[DQK / 8][4];
  float(&acc_flat)[DQK / 2] = *reinterpret_cast<float(*)[DQK / 2]>(&acc[0][0]);
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc_flat[i] = 0.f;
  ptx::mbar_wait(&landed[0], 0);

  int stage = 0;
  for (int j = j_hi; j >= 0; --j, stage ^= 1) {
    ptx::mbar_wait(&landed[1 + stage], ((j_hi - j) >> 1) & 1);
    __syncthreads();  // nobody reads the other stage any more
    if (j > 0 && tid == 0) {
      char* nxt = stages + (stage ^ 1) * STAGE;
      ptx::mbar_expect_tx(&landed[1 + (stage ^ 1)], STAGE);
      tma_tile<DQK, NB>(nxt, &k_map, kh, (j - 1) * NB, b, &landed[1 + (stage ^ 1)]);
      tma_tile<DV, NB>(nxt + TK::BYTES, &v_map, kh, (j - 1) * NB, b, &landed[1 + (stage ^ 1)]);
    }
    const char* k_tile = stages + stage * STAGE;
    const char* v_tile = k_tile + TK::BYTES;
    const int k0 = j * NB;

    // S = Q K^T and dP = dO V^T: 64 q rows x NB kv columns
    float s[NT][4], dp[NT][4];
    float(&s_flat)[4 * NT] = *reinterpret_cast<float(*)[4 * NT]>(&s[0][0]);
    float(&dp_flat)[4 * NT] = *reinterpret_cast<float(*)[4 * NT]>(&dp[0][0]);
    ptx::wgmma_fence();
    abt_wgmma<DQK, NB>(s_flat, q_tile, k_tile);
    ptx::wgmma_commit();
    abt_wgmma<DV, NB>(dp_flat, do_tile, v_tile);
    ptx::wgmma_commit();
    ptx::wgmma_wait<1>();
    ptx::fence_regs(s_flat);

    // P; a tile that crosses the diagonal for some row of this warp masks the
    // keys past each row (keys past T = S among them)
    const bool diag = k0 + NB - 1 > wq0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ptx::exp2_approx(fmaf(s[nt][e], scale_log2, -l2[e >> 1]));
        s[nt][e] = diag && k0 + nt * 8 + c0 + (e & 1) > row0 + 8 * (e >> 1) ? 0.f : p;
      }

    ptx::wgmma_wait<0>();
    ptx::fence_regs(dp_flat);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - dl[e >> 1]);
    uint32_t ds_hi[NB / 16][4], ds_lo[NB / 16][4];
    to_a_frags_split(ds_hi, ds_lo, dp);

    // dQ += dS K (hi, then lo), K read n-major as V in the forward
    ptx::fence_regs(acc_flat);
    ptx::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NB / 16; ++kk) pv_wgmma<DQK, NB>(acc_flat, ds_hi[kk], k_tile, 16 * kk);
#pragma unroll
    for (int kk = 0; kk < NB / 16; ++kk) pv_wgmma<DQK, NB>(acc_flat, ds_lo[kk], k_tile, 16 * kk);
    ptx::wgmma_commit();
    ptx::wgmma_wait<0>();
    ptx::fence_regs(acc_flat);
  }

  // nothing reads shared memory any more: the last iteration issued no copy
  // and every product has ended; dQ is staged through it from its start
  store_tile<DQK>(dq, acc, sm_scale, smem, b, q0, S, H, h);
}

template <int DQK, int DV, int NB>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int S, int H, int K, cudaStream_t stream,
                       int tiles_fast) {
  // TMA and the 16-byte loads and stores need 16-byte aligned rows
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) % 16)
    return cudaErrorMisalignedAddress;
  EncodeTiled encode;
  // 64-row boxes for each block's own tiles, NB-row boxes for the streamed ones
  CUtensorMap q_map, do_map, k_map, v_map, q_nb, do_nb, k_nb, v_nb;
  cudaError_t err;
  if ((err = encode_tiled(&encode)) != cudaSuccess ||
      (err = tile_map<DQK>(&q_map, encode, q, B, S, H)) != cudaSuccess ||
      (err = tile_map<DV>(&do_map, encode, dout, B, S, H)) != cudaSuccess ||
      (err = tile_map<DQK>(&k_map, encode, k, B, S, K)) != cudaSuccess ||
      (err = tile_map<DV>(&v_map, encode, v, B, S, K)) != cudaSuccess ||
      (err = tile_map<DQK, NB>(&q_nb, encode, q, B, S, H)) != cudaSuccess ||
      (err = tile_map<DV, NB>(&do_nb, encode, dout, B, S, H)) != cudaSuccess ||
      (err = tile_map<DQK, NB>(&k_nb, encode, k, B, S, K)) != cudaSuccess ||
      (err = tile_map<DV, NB>(&v_nb, encode, v, B, S, K)) != cudaSuccess)
    return err;
  const long rows = (long)B * S * H;
  constexpr int DELTA_THREADS = 256;
  flash_attention_bwd_delta_kernel<DV>
      <<<(unsigned)((rows * (DV / 8) + DELTA_THREADS - 1) / DELTA_THREADS), DELTA_THREADS, 0,
         stream>>>(static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
                   delta, S, H, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // each kernel: its own 64-row tiles, then two stages of NB-row ones
  const size_t smem = (TcTile<DQK>::BYTES + TcTile<DV>::BYTES) +
                      2 * (TcTile<DQK, NB>::BYTES + TcTile<DV, NB>::BYTES) + 1024;
  if ((err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<DQK, DV, NB>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<DQK, DV, NB>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return err;
  const float sm_scale = (float)(1.0 / sqrt((double)DQK));
  const int tiles = (S + TC_BM - 1) / TC_BM;
  flash_attention_bwd_dkdv_kernel<DQK, DV, NB>
      <<<grid_of(B * K, tiles, tiles_fast), TC_THREADS, smem, stream>>>(
          static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), lse, delta, S, H, K,
          sm_scale, tiles_fast, q_nb, do_nb, k_map, v_map);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_attention_bwd_dq_kernel<DQK, DV, NB>
      <<<grid_of(B * H, tiles, tiles_fast), TC_THREADS, smem, stream>>>(
          static_cast<__nv_bfloat16*>(dq), lse, delta, S, H, K, sm_scale, tiles_fast, q_map,
          do_map, k_nb, v_nb);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ f32, FMA
constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS = 256;            // a 16 x 16 thread grid
constexpr int ROWS = BLOCK_Q / 16;      // query rows per thread
constexpr int COLS = BLOCK_K / 16;      // key columns per thread
constexpr int P_PITCH = BLOCK_K + 4;    // keeps P's writes and reads conflict-free

// Reductions over the 16 lanes that hold one query row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copies a 64-row tile of D elements per row (global row stride `stride`)
// into shared memory with row pitch `pitch`.  Rows at or past `valid` (the
// ragged edge) are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const float* src, long stride,
                                          int valid) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * pitch + c] = r < valid ? src[r * stride + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int S, int T_len,
                           int H, int K, int causal, int window, float softcap,
                           float sm_scale) {
  constexpr int KP = D + 1;   // padded pitch: 16 lanes read 16 K rows at one column
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [BLOCK_Q][KP]
  float* ks = qs + BLOCK_Q * KP;     // [BLOCK_K][KP]
  float* vs = ks + BLOCK_K * KP;     // [BLOCK_K][D]
  float* ps = vs + BLOCK_K * D;      // [BLOCK_Q][P_PITCH]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / (H / K);
  const int q0 = blockIdx.x * BLOCK_Q;
  const long q_stride = (long)H * D;   // elements between consecutive positions
  const long kv_stride = (long)K * D;
  const float* qb = q + ((long)b * S + q0) * q_stride + (long)h * D;
  const float* kb = k + (long)b * T_len * kv_stride + (long)kh * D;
  const float* vb = v + (long)b * T_len * kv_stride + (long)kh * D;
  float* ob = o + ((long)b * S + q0) * q_stride + (long)h * D;

  load_tile<D>(qs, KP, qb, q_stride, S - q0);

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = (T_len + BLOCK_K - 1) / BLOCK_K;
  for (int jk = 0; jk < n_kv; ++jk) {
    const int k0 = jk * BLOCK_K;
    // skip tiles that are entirely masked; every later tile is too when causal
    if (causal && k0 > q0 + BLOCK_Q - 1) break;
    if (window > 0 && q0 - (k0 + BLOCK_K - 1) >= window) continue;

    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<D>(ks, KP, kb + k0 * kv_stride, kv_stride, T_len - k0);
    load_tile<D>(vs, D, vb + k0 * kv_stride, kv_stride, T_len - k0);
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = qs[(ty * ROWS + i) * KP + d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = ks[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = ty * ROWS + i;
      const int q_pos = q0 + r;
      bool ok[COLS];
      float m_cur = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        float x = s[i][j] * sm_scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        ok[j] = k_pos < T_len && (!causal || k_pos <= q_pos) &&
                (window <= 0 || q_pos - k_pos < window);
        s[i][j] = ok[j] ? x : NEG_INF;
        m_cur = fmaxf(m_cur, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(m_cur));
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        // a fully masked row would get exp(NEG_INF - NEG_INF) = 1; zero it
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[r * P_PITCH + tx + 16 * j] = p;
        p_sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(p_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P is complete

#pragma unroll 8
    for (int kk = 0; kk < BLOCK_K; ++kk) {
      float pv[ROWS], vv[DC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = ps[(ty * ROWS + i) * P_PITCH + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = ty * ROWS + i;
    if (q0 + r >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) ob[r * q_stride + tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S,
                       int T_len, int H, int K, int causal, int window, float softcap,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * 64 * (D + 1) + BLOCK_K * D + BLOCK_Q * P_PITCH);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float sm_scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((S + BLOCK_Q - 1) / BLOCK_Q, B * H);
  flash_attention_f32_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, T_len, H, K, causal, window, softcap, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o, int B,
                   int S, int T_len, int H, int K, int causal, int window, float softcap,
                   cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, B, S, T_len, H, K, causal, window, softcap, stream);
  return launch_bf16<D>(q, k, v, o, B, S, T_len, H, K, causal, window, softcap, stream);
}

}  // namespace

// q [B,S,H,D], k/v [B,T,K,D], o [B,S,H,D], all contiguous on one device.
// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window;
// softcap <= 0 means no softcap.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int T_len, int H, int K, int D, int causal,
                                   int window, float softcap, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0 || B * H > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch<16>(dtype, q, k, v, o, B, S, T_len, H, K, causal, window, softcap, st);
    case 32: return (int)launch<32>(dtype, q, k, v, o, B, S, T_len, H, K, causal, window, softcap, st);
    case 48: return (int)launch<48>(dtype, q, k, v, o, B, S, T_len, H, K, causal, window, softcap, st);
    case 64: return (int)launch<64>(dtype, q, k, v, o, B, S, T_len, H, K, causal, window, softcap, st);
    case 80: return (int)launch<80>(dtype, q, k, v, o, B, S, T_len, H, K, causal, window, softcap, st);
    case 96: return (int)launch<96>(dtype, q, k, v, o, B, S, T_len, H, K, causal, window, softcap, st);
    case 112: return (int)launch<112>(dtype, q, k, v, o, B, S, T_len, H, K, causal, window, softcap, st);
    case 128: return (int)launch<128>(dtype, q, k, v, o, B, S, T_len, H, K, causal, window, softcap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Training's causal self-attention: S = T, positions from 0, no window or
// softcap, bf16; (D, DV), the q.k and v widths, (64, 64), (128, 128) or
// (192, 128).  q [B,S,H,D], k [B,S,K,D], v [B,S,K,DV].  The forward writes o
// [B,S,H,DV] and lse [B,H,S] f32, each row's log-sum-exp of its scaled scores
// (natural log).
extern "C" int flash_attention_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int B, int S, int H, int K, int D, int DV,
                                       void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // (192, 128) is latent attention's, whose K = H heads would overflow L2
  // with every head's K and V in flight: its tiles run on the fast axis
  if (D == 64 && DV == 64)
    return (int)launch_bf16<64, 64, true>(q, k, v, o, B, S, S, H, K, 1, 0, 0.f, st, lse);
  if (D == 128 && DV == 128)
    return (int)launch_bf16<128, 128, true>(q, k, v, o, B, S, S, H, K, 1, 0, 0.f, st, lse);
  if (D == 192 && DV == 128)
    return (int)launch_bf16<192, 128, true>(q, k, v, o, B, S, S, H, K, 1, 0, 0.f, st, lse, 1);
  return (int)cudaErrorInvalidValue;
}

// Its gradient: dq [B,S,H,D], dk [B,S,K,D] and dv [B,S,K,DV] in bf16 from
// dout [B,S,H,DV] and the forward's o and lse; delta [B,H,S] f32 is scratch.
// Three launches on `stream`; returns cudaGetLastError() and never
// synchronises.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int S, int H, int K, int D, int DV,
                                   void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64 && DV == 64)
    return (int)launch_bwd<64, 64, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, K, st,
                                       0);
  if (D == 128 && DV == 128)
    return (int)launch_bwd<128, 128, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, K,
                                         st, 0);
  if (D == 192 && DV == 128)
    return (int)launch_bwd<192, 128, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, K,
                                         st, 1);
  return (int)cudaErrorInvalidValue;
}
