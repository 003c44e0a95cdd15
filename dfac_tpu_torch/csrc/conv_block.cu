// Fused CNN2D conv block for Hopper (sm_90a):
//   3x3 SAME conv (BN folded) + bias + ReLU [+ floor-mode (2,1) avg pool]
//
// Replaces: dfac_tpu/ops/pallas/conv_block.py  _kernel (:56, launched by
// fused_conv_block :98-139) and _kernel_v2 (:142, launched by
// fused_conv_block_v2 :181-221, chained by cnn2d_fused_scores :239-252).
// Both Pallas kernels compute the same function; they differ only in how
// they fetch the halo under Mosaic's limits. One kernel here covers both.
//
// Layout: x (B, H, W, Cin) NHWC, w (3, 3, Cin, Cout) HWIO, b (Cout,) f32,
// out (B, H/2 or H, W, Cout) in x's dtype. f32 accumulation; bias, ReLU
// and the pool in f32, then one cast (the Pallas epilogue). With an odd H
// the last conv row is dropped after the conv, so it still served as the
// halo of the row before it.
//
// What bounds it on the card, at the serving shapes (B = 128, W = 180,
// 1 -> 32 -> 64 -> 128 channels; 989 TFLOP/s bf16, 3.35 TB/s):
//  * block 3 (64 -> 128, no pool): 272 GFLOP, 0.275 ms on the tensor cores,
//    against 708 MB in and out, 0.211 ms: operations.
//  * block 2 (32 -> 64, pool): 136 GFLOP, 0.137 ms, against 472 MB, 0.141
//    ms: bytes and operations within 3% of each other.
//  * block 1 (1 -> 32, pool): 236 MB written and 15 MB read, 0.075 ms:
//    bytes. Its 4.25 GFLOP would take 0.063 ms on the CUDA cores at their
//    peak, so on the CUDA cores the arithmetic competes with the loads and
//    stores for the schedulers' instruction slots; on the tensor cores it
//    takes none of them.
//
// Design:
//  * Cin = 32 / 64 in bf16 (blocks 2 and 3), conv_block_tc: implicit GEMM
//    (M = output pixels, N = Cout, K = 9 taps x Cin) on wgmma, the
//    instruction that reaches the card's bf16 rate.
//    - Persistent blocks (one per SM at block 3, two at block 2) hold the
//      folded weights in shared memory for their whole life, stored once
//      in the layout wgmma's B descriptor reads: K-major rows (tap, cout)
//      of Cin bf16. Cin = 64 rows are 128 B and take the 128-byte swizzle
//      (SBO 1,024 B; a k16 step moves the start address by 32 B). Cin = 32
//      rows are 64 B and take the 64-byte swizzle (SBO 512 B) rather than
//      the interleaved layout: one addressing rule and one fill serve both
//      blocks, and 8 rows of one 16-byte chunk still fall on 8 distinct
//      bank quads.
//    - Each warpgroup walks tiles of its own, 2 conv rows x 32 columns (64
//      pixels, wgmma's M), in a grid-stride loop, through a ring of its own
//      halo tiles (4 x 34 pixels, rows padded by 8 bf16; two stages at
//      block 3, three at block 2) filled by cp.async, 16 bytes a copy, SAME
//      padding from the copy's zero fill. It issues the copies of the tile
//      S - 1 ahead once the first tap's wgmmas are in flight, and syncs
//      on a named barrier of its 128 threads. Warpgroup 1 starts when
//      warpgroup 0 is half through its first tile; past that the two never
//      wait on each other, so one's epilogue, copies and barrier overlap
//      the other's wgmmas. At the tensor cores' peak a m64nCout k16 would
//      read 96 (block 3) or 128 (block 2) of shared memory's 128 B a clock:
//      2 KB of A by ldmatrix and Cout x 32 B of B.
//    - The tap shift (dy, dx) starts each tap's A window at any pixel, off
//      the 8-row pattern an A descriptor's swizzle is laid out on (only its
//      base-offset field could express that; untried). So A comes from
//      registers, by ldmatrix.x4 over the padded tile (conflict-free), and
//      each warpgroup issues one wgmma m64nCout k16 per k16 step, the A
//      registers double-buffered across taps (commit a tap, wait for the
//      tap before it).
//    - A warp's 16 M rows are 8 columns of conv row 0, then the same 8 of
//      row 1, so a thread's two accumulator rows are both conv rows of one
//      column and the pool happens in registers; the pre-pool tensor never
//      reaches device memory. A thread's results are bf16 pairs of 4
//      channel octets; a 4 x 4 transpose over its quad (two shuffles) gives
//      each lane a whole octet, so the output leaves in 16-byte stores that
//      fill whole sectors, 4x fewer than pair stores.
//  * Block 1 in bf16 (Cin = 1, Cout = 32, pooled), conv_block_cin1_tc: both
//    conv rows of a pooled pixel as one mma.sync m16n8k16 product, M =
//    pooled pixels, K = 16, N = 64, so that the CUDA cores only load, pool
//    and store, and the kernel can run at the speed of its output write.
//    - Pooled pixel (b, ho, col) needs conv rows 2ho and 2ho + 1, which
//      read only the 4 x 3 input window of rows 2ho - 1 .. 2ho + 2 and
//      columns col - 1 .. col + 1 (zero outside the image). A row is the
//      window: k = 4 * row + col (k % 4 == 3 is zero), so each A register
//      holds two horizontal neighbours or one value and a zero. B columns
//      0-31 are conv row 2ho's channels, 32-63 conv row 2ho + 1's, whose
//      taps sit one window row lower; within a conv row, column 8j + m
//      carries channel 8 (m / 2) + 2j + m % 2, so the accumulators of lane
//      q are channels 8q .. 8q + 7 of its pixel. The map is
//      ops/conv_block.py's CIN1_TC_K and CIN1_TC_N (a CPU test computes
//      the block through it). B and the bias are scaled by 0.5 (exact:
//      0.5 relu(a) = relu(0.5 a)), so the pool is one add; bf16 x bf16
//      products are exact in f32, so only the summation order differs from
//      the plain version.
//    - Each warp walks tiles of 16 consecutive pooled pixels of the flat
//      output (b, ho, col), four at a time (their loads in flight
//      together), in a grid-stride loop: the output is one array in that
//      order, so a tile is 1 KB of it wherever it falls, and no column tile
//      is ragged. B (16 registers) and the bias stay in registers for the
//      kernel's life; the accumulators start at the bias (mma's C operand).
//      n-tiles j and j + 4 hold the same channel pair of the same pixel for
//      the two conv rows, so the pool needs no shuffle, and each lane
//      stores 8 channels of a pixel in one 16-byte store (a warp's store:
//      512 contiguous bytes) without a transpose.
//    - The input (15 MB at the serving shape) stays in L2; a lane loads its
//      6 window values with 16-bit loads (rows of odd W leave no alignment
//      for wider ones). The flat index is decoded by multiply and shift.
//  * f32 mode (predict --fast's default), exact f32 products (FFMA) on the
//    CUDA cores, no TF32. Bound by operations at 67 TFLOP/s: blocks 2 / 3
//    136 / 272 GFLOP, 2.03 / 4.06 ms, against 0.28 / 0.42 ms of bytes;
//    block 1 by its 472 MB write, 0.15 ms (its 4.25 GFLOP take 0.06 ms).
//    - Blocks 2 and 3 (Cin = 32 / 64), conv_block_f32: a register-tiled
//      implicit GEMM, 2 conv rows x 9 columns x 4 channels per thread, the
//      three dx taps sharing one loaded row window, halo tiles of channel
//      quads by one tensor copy (TMA), the weights streamed by bulk copies
//      (below).
//    - Block 1 (Cin = 1, Cout = 32, pooled), conv_block_cin1_f32: a lane
//      computes 4 channels of two adjacent pooled pixels from their shared
//      4 x 4 window, so a warp's store covers whole 128-byte pixels.
//  * Cin = 1 otherwise (unpooled, other Cout), conv_block_cin1: one thread
//    per output pixel computes all of its channels from 12 inputs held in
//    registers on the CUDA cores and writes them as 16-byte vectors.
//  * Other channel counts: a direct kernel on the CUDA cores, one output
//    value per thread, same epilogue; correct, not fast, and on no path of
//    the model. 32-bit indices: a launch covers fewer than 2^31 outputs, so
//    a larger batch takes several launches (one utterance's outputs must
//    stay below 2^31).
//  * SAME zero padding on both edges of H and W; W = 180 is not a multiple
//    of the bf16 kernel's 32-column tile, so its last tile masks its
//    columns; it is 5 of the f32 kernel's 36-column tiles.

#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled: the encoder is fetched at run time, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace dfac;

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;     // 2 warpgroups, each walking tiles of its own
constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int TW = 32;           // output columns per tile: 2 conv rows x 32 = one warpgroup's 64 pixels
constexpr int IN_ROWS = 4;       // 2 conv rows + halo
constexpr int IN_COLS = TW + 2;
constexpr int PAD = 8;           // bf16 per tile pixel row: conflict-free ldmatrix rows

template <int CIN>
__host__ __device__ constexpr int tile_stride() { return CIN + PAD; }  // tile pixel stride (bf16)

template <int CIN, int COUT>
struct TcCfg {
  // halo tiles in each warpgroup's cp.async ring: two at block 3 (one block
  // per SM), three at block 2 (two blocks per SM), as many as fit
  static constexpr int STAGES = COUT == 128 ? 2 : 3;
  static constexpr int XS = tile_stride<CIN>();
  static constexpr int ROW_B = CIN * 2;   // weight row (tap, cout): Cin bf16, 64 or 128 bytes
  static constexpr int KSTEPS = CIN / 16;  // wgmma k16 steps per tap
  static constexpr int NACC = COUT / 2;    // f32 accumulators per thread: 64 x Cout per warpgroup
  static constexpr size_t W_BYTES = size_t(9) * COUT * ROW_B;
  static constexpr size_t X_BYTES = size_t(IN_ROWS) * IN_COLS * XS * 2;  // one stage
  static constexpr size_t ALIGN = 1024;  // the 128-byte swizzle repeats every 1024 bytes
  static constexpr size_t SMEM = ALIGN + W_BYTES + 2 * STAGES * X_BYTES + COUT * sizeof(float);
  static_assert(CIN == 32 || CIN == 64, "64- or 128-byte weight rows");
  static_assert(COUT == 64 || COUT == 128, "wgmma m64n64 or m64n128");
  static_assert(X_BYTES % 16 == 0, "16-byte aligned stages");
  static_assert(SMEM <= 232448, "227 KB of shared memory per block");
  static_assert((9 * CIN * COUT) % (8 * THREADS) == 0, "weights in batches of 8 per thread");
};

// wgmma B descriptor of the weights: rows of Cin bf16, swizzled as w_off lays them.
template <int CIN>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) { return b_desc_kmajor<CIN * 2>(addr); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The 4 lanes q of a quad hold x_m = in[q][m], m = 0..3; lane q gets
// out[q][m] = in[m][q] (a 4 x 4 transpose: two shuffle rounds, lane bit 0
// then bit 1).
__device__ __forceinline__ uint4 quad_transpose(uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3, int q) {
  const bool q1 = q & 1, q2 = q & 2;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, q1 ? x0 : x1, 1);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, q1 ? x2 : x3, 1);
  const uint32_t y0 = q1 ? r0 : x0, y1 = q1 ? x1 : r0, y2 = q1 ? r1 : x2, y3 = q1 ? x3 : r1;
  r0 = __shfl_xor_sync(0xffffffffu, q2 ? y0 : y2, 2);
  r1 = __shfl_xor_sync(0xffffffffu, q2 ? y1 : y3, 2);
  return q2 ? make_uint4(r0, r1, y2, y3) : make_uint4(y0, y1, r0, r1);
}

// A warpgroup (lane wt of 128) issues the copies of one halo tile (IN_ROWS x
// IN_COLS pixels, Cin each) into a stage; pixels outside the image (SAME
// padding) are zero-filled.
template <int CIN>
__device__ __forceinline__ void load_tile(uint32_t stage, const bf16* __restrict__ x, int tile, int h, int width,
                                          int row_tiles, int col_tiles, int wt) {
  constexpr int VEC = CIN / 8;
  const int cb = tile % col_tiles, rest = tile / col_tiles;
  const int p = rest % row_tiles, b = rest / row_tiles;
  const int y0 = 2 * p - 1, x0 = cb * TW - 1;
  for (int i = wt; i < IN_ROWS * IN_COLS * VEC; i += WG_THREADS) {
    const int v = i % VEC, pix = i / VEC;
    const int ic = pix % IN_COLS, ir = pix / IN_COLS;
    const int y = y0 + ir, xc = x0 + ic;
    const bool in = y >= 0 && y < h && xc >= 0 && xc < width;
    const bf16* src = in ? x + ((size_t(b) * h + y) * width + xc) * CIN + v * 8 : x;
    cp_async16(stage + uint32_t((pix * tile_stride<CIN>() + v * 8) * 2), src, in ? 16 : 0);
  }
}

template <int CIN, int COUT, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
conv_block_tc(const bf16* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ bias,
              bf16* __restrict__ out, int batch, int h, int width, int pool) {
  using C = TcCfg<CIN, COUT>;
  constexpr int S = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((C::ALIGN - (smem_u32(smem_raw) & (C::ALIGN - 1))) & (C::ALIGN - 1));
  unsigned char* sW = smem;                                         // [tap * COUT + cout][cin], swizzled
  const uint32_t sW_u32 = smem_u32(sW);
  float* sBias = reinterpret_cast<float*>(smem + C::W_BYTES + 2 * S * C::X_BYTES);

  // Warpgroup wg walks tiles 2 * block + wg + k * (2 * grid) through a ring
  // of its own (S x [row][col][cin + PAD]).
  const int wg = threadIdx.x / WG_THREADS, wt = threadIdx.x % WG_THREADS;
  const uint32_t ring = smem_u32(smem + C::W_BYTES) + wg * S * uint32_t(C::X_BYTES);
  const int h_out = pool ? h / 2 : h;
  const int row_tiles = pool ? h / 2 : (h + 1) / 2;
  const int col_tiles = (width + TW - 1) / TW;
  const int n_tiles = batch * row_tiles * col_tiles;  // < 2^31, checked at launch
  const int first = 2 * blockIdx.x + wg, step = 2 * gridDim.x;
  // the first S - 1 tiles' copies fly while the weights are stored; one group per tile
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    const int tile = first + k * step;
    if (tile < n_tiles) load_tile<CIN>(ring + k * uint32_t(C::X_BYTES), x, tile, h, width, row_tiles, col_tiles, wt);
    cp_async_commit();
  }

  // folded weights, once per block, 8 loads in flight per thread:
  // w[tap][ci][co] goes to row (tap, co), element ci
  for (int i0 = threadIdx.x; i0 < 9 * CIN * COUT; i0 += 8 * THREADS) {
    bf16 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = w[i0 + u * THREADS];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * THREADS;
      const int co = i % COUT, ci = (i / COUT) % CIN, t = i / (COUT * CIN);
      *reinterpret_cast<bf16*>(sW + w_off<CIN>(t * COUT + co, ci / 8) + (ci % 8) * 2) = v[u];
    }
  }
  for (int i = threadIdx.x; i < COUT; i += THREADS) sBias[i] = bias[i];
  // the weights' ordinary stores, before wgmma (the async proxy) reads them
  fence_proxy_async();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int px0 = (warp & 3) * 8;  // this warp's 8 columns of the tile
  // A: warp M row i is conv row i / 8 at column px0 + i % 8. ldmatrix.x4 lane l
  // addresses row l % 8 of matrix l / 8: (rows 0-7, k 0-7), (rows 8-15, k 0-7),
  // (rows 0-7, k 8-15), (rows 8-15, k 8-15), the m16k16 fragment's order.
  const int lq = lane >> 3, lr = lane & 7;
  const uint32_t a_lane = uint32_t((((lq & 1) * IN_COLS + px0 + lr) * C::XS + 8 * (lq >> 1)) * 2);

  // Warpgroup 1 starts once warpgroup 0 is half way through its first tile,
  // so that the two run out of phase and one's epilogue, copies and
  // barrier fall in the other's wgmmas, not beside them.
  bool lead = wg == 0;  // warpgroup 0 has yet to release warpgroup 1
  if (wg == 1) stagger_wait();
  if (lead && first >= n_tiles) {
    stagger_release();
    lead = false;
  }
  int s = 0;  // this tile's stage
  for (int tile = first; tile < n_tiles; tile += step, s = s + 1 == S ? 0 : s + 1) {
    cp_async_wait<S - 2>();
    wg_barrier(wg);  // this tile's stage is in; the warpgroup is done with the stage it read last
    const uint32_t sX = ring + s * uint32_t(C::X_BYTES);

    float acc[C::NACC];
#pragma unroll
    for (int i = 0; i < C::NACC; ++i) acc[i] = 0.f;
    uint32_t a[2][C::KSTEPS][4];  // A registers of two taps: one in flight, one loading
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const uint32_t a_tap = sX + a_lane + uint32_t(((t / 3) * IN_COLS + t % 3) * C::XS * 2);
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) ldsm_x4(a_tap + kk * 32, a[t & 1][kk]);
      fence_regs(acc);
      wgmma_fence();  // the A registers just written, before wgmma reads them
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        const uint64_t desc = b_desc<CIN>(sW_u32 + uint32_t((t * COUT) * C::ROW_B + kk * 32));
        if constexpr (COUT == 64) wgmma_n64(acc, a[t & 1][kk], desc);
        else wgmma_n128(acc, a[t & 1][kk], desc);
      }
      wgmma_commit();
      if (t == 0) {  // the ring's next copies, issued while the tensor cores work
        const int ahead = tile + (S - 1) * step;
        const int fill = s == 0 ? S - 1 : s - 1;  // the stage the previous tile read
        if (ahead < n_tiles)
          load_tile<CIN>(ring + fill * uint32_t(C::X_BYTES), x, ahead, h, width, row_tiles, col_tiles, wt);
        cp_async_commit();
      }
      if (t == 4 && lead) {
        stagger_release();
        lead = false;
      }
      wgmma_wait<1>();  // the tap before is done: its A registers are free
      if (t > 0) fence_regs(a[(t + 1) & 1]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: + bias, ReLU, pool the two rows in f32, one cast. acc[4j..4j+1]
    // is conv row 0 and acc[4j+2..4j+3] conv row 1, channels 8j + 2tq, +1. A
    // quad then trades its bf16 pairs so that each lane stores 16 bytes: 8
    // channels of one pixel.
    constexpr int NJ = COUT / 8;
    uint32_t packed[2][NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = 8 * j + 2 * tq;
      const float b0 = sBias[n], b1 = sBias[n + 1];
      const float u0 = fmaxf(acc[4 * j] + b0, 0.f), u1 = fmaxf(acc[4 * j + 1] + b1, 0.f);
      const float l0 = fmaxf(acc[4 * j + 2] + b0, 0.f), l1 = fmaxf(acc[4 * j + 3] + b1, 0.f);
      packed[0][j] = pool ? pack_bf16((u0 + l0) * 0.5f, (u1 + l1) * 0.5f) : pack_bf16(u0, u1);
      packed[1][j] = pack_bf16(l0, l1);
    }
    const int cb = tile % col_tiles, rest = tile / col_tiles;
    const int p = rest % row_tiles, b = rest / row_tiles;
    const int col = cb * TW + px0 + gid;
    const int rows = pool ? 1 : (2 * p + 1 < h ? 2 : 1);
    bf16* o = out + ((size_t(b) * h_out + (pool ? p : 2 * p)) * width + col) * COUT;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r >= rows) break;
#pragma unroll
      for (int g = 0; g < NJ / 4; ++g) {
        const uint4 v = quad_transpose(packed[r][4 * g], packed[r][4 * g + 1], packed[r][4 * g + 2],
                                       packed[r][4 * g + 3], tq);
        if (col < width) *reinterpret_cast<uint4*>(o + size_t(r) * width * COUT + 8 * (4 * g + tq)) = v;
      }
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// Direct conv on the CUDA cores: one output value per thread, channels of
// one pixel on neighbouring threads (x reads broadcast, w reads coalesced).
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_block_direct(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                  T* __restrict__ out, int batch, int h, int width, int c_in, int c_out, int pool) {
  const int h_out = pool ? h / 2 : h;
  const long long total = (long long)batch * h_out * width * c_out;  // < 2^31: the launch splits the batch
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total; i += (long long)gridDim.x * THREADS) {
    // 32-bit index arithmetic: a 64-bit division is a call
    const int co = int(i) % c_out;
    int r = int(i) / c_out;
    const int col = r % width;
    r /= width;
    const int ho = r % h_out;
    const int b = r / h_out;
    const int rows = pool ? 2 : 1, y0 = pool ? 2 * ho : ho;
    float res = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      float acc = 0.f;
      for (int dy = 0; dy < 3; ++dy) {
        const int y = y0 + rr + dy - 1;
        if (y < 0 || y >= h) continue;
        for (int dx = 0; dx < 3; ++dx) {
          const int xc = col + dx - 1;
          if (xc < 0 || xc >= width) continue;
          const T* xp = x + ((size_t(b) * h + y) * width + xc) * c_in;
          const T* wp = w + size_t(dy * 3 + dx) * c_in * c_out + co;
#pragma unroll 2  // ptxas spills the loop state of the bf16 instance at the default unroll (and at 4, or 1)
          for (int ci = 0; ci < c_in; ++ci) acc = fmaf(to_f32(xp[ci]), to_f32(wp[size_t(ci) * c_out]), acc);
        }
      }
      res += fmaxf(acc + bias[co], 0.f);
    }
    out[i] = from_f32<T>(pool ? res * 0.5f : res);
  }
}

// Cin = 1 (K = 9) outside block 1's bf16 shape: one thread per output pixel
// computes all its channels, 8 at a time, from 12 input values held in
// registers, and writes them as 16-byte vectors.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_block_cin1(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                T* __restrict__ out, int batch, int h, int width, int c_out, int pool) {
  extern __shared__ float s_wb[];  // [9][c_out] taps, then [c_out] bias
  for (int i = threadIdx.x; i < 9 * c_out; i += THREADS) s_wb[i] = to_f32(w[i]);
  for (int i = threadIdx.x; i < c_out; i += THREADS) s_wb[9 * c_out + i] = bias[i];
  __syncthreads();
  const int h_out = pool ? h / 2 : h;
  const int rows = pool ? 2 : 1;
  const long long total = (long long)batch * h_out * width;
  for (long long pix = (long long)blockIdx.x * THREADS + threadIdx.x; pix < total;
       pix += (long long)gridDim.x * THREADS) {
    const int col = int(pix % width);
    const long long r = pix / width;
    const int ho = int(r % h_out), b = int(r / h_out);
    const int y0 = pool ? 2 * ho : ho;
    float xv[4][3];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int y = y0 - 1 + i;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int xc = col - 1 + j;
        xv[i][j] = (i < rows + 2 && y >= 0 && y < h && xc >= 0 && xc < width)
                       ? to_f32(x[(size_t(b) * h + y) * width + xc]) : 0.f;
      }
    }
    T* o = out + pix * c_out;
    for (int c0 = 0; c0 < c_out; c0 += 8) {
      float res[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) res[e] = 0.f;
      for (int rr = 0; rr < rows; ++rr) {
        float acc[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float v = xv[rr + t / 3][t % 3];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = fmaf(v, s_wb[t * c_out + c0 + e], acc[e]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) res[e] += fmaxf(acc[e] + s_wb[9 * c_out + c0 + e], 0.f);
      }
      if (pool) {
#pragma unroll
        for (int e = 0; e < 8; ++e) res[e] *= 0.5f;
      }
      if constexpr (sizeof(T) == 2) {
        uint4 v;
        __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) p2[e] = __floats2bfloat162_rn(res[2 * e], res[2 * e + 1]);
        *reinterpret_cast<uint4*>(o + c0) = v;
      } else {
        *reinterpret_cast<float4*>(o + c0) = make_float4(res[0], res[1], res[2], res[3]);
        *reinterpret_cast<float4*>(o + c0 + 4) = make_float4(res[4], res[5], res[6], res[7]);
      }
    }
  }
}

// n / d for 0 <= n < 2^31 by one multiply and shift (Granlund-Montgomery):
// m = ceil(2^(31 + l) / d) with 2^l >= d, q = (n * m) >> (31 + l).
struct Divisor {
  uint32_t d, m, shift;
};

Divisor make_divisor(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  return {d, uint32_t(((1ull << (31 + l)) + d - 1) / d), 31 + l};
}

__device__ __forceinline__ uint32_t div_by(uint32_t n, const Divisor& v) {
  return uint32_t((uint64_t(n) * v.m) >> v.shift);
}

constexpr int C1_THREADS = 256;
constexpr int C1_COUT = 32;
constexpr int C1_TILES = 4;  // 16-pixel tiles per warp and loop trip: their loads in flight together

// Block 1 in bf16 (Cin = 1, Cout = 32, pooled) on the tensor cores: one
// mma.sync m16n8k16 product per 16 pooled pixels and 8 output columns, K =
// the 4 x 3 input window (k = 4 * row + col), N = 64 = two conv rows x 32
// channels, column 8j + m of a conv row carrying channel 8 (m / 2) + 2j + m
// % 2 (ops/conv_block.py CIN1_TC_K, CIN1_TC_N). B and the bias carry the
// pool's 0.5. Fragment layout (PTX m16n8k16): lane (g, q) = (lane / 4,
// lane % 4) holds A rows g and g + 8 at k = 2q, 2q + 1 and 2q + 8, 2q + 9, B
// column g at the same k, and accumulators of rows g, g + 8 at columns 2q,
// 2q + 1.
__global__ void __launch_bounds__(C1_THREADS, 2)
conv_block_cin1_tc(const bf16* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ bias,
                   bf16* __restrict__ out, int h, int width, int pixels, Divisor div_w, Divisor div_ho) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  // B: this lane's column g of n-tile j is conv row j / 4, channel 8 (g / 2)
  // + 2 (j % 4) + g % 2; its k pair of register e is window row q / 2 + 2e,
  // columns 2 (q % 2) and + 1 (column 3 is zero). Conv row r's tap dy sits at
  // window row dy + r.
  uint32_t bw[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int conv_row = j >> 2, ch = 8 * (g >> 1) + 2 * (j & 3) + (g & 1);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int dy = (q >> 1) + 2 * e - conv_row, dx = 2 * (q & 1);
      const bool tap = dy >= 0 && dy < 3;
      const float lo = tap ? 0.5f * __bfloat162float(w[(dy * 3 + dx) * C1_COUT + ch]) : 0.f;
      const float hi = tap && dx == 0 ? 0.5f * __bfloat162float(w[(dy * 3 + 1) * C1_COUT + ch]) : 0.f;
      bw[j][e] = pack_bf16(lo, hi);  // exact: half a bf16 is a bf16
    }
  }
  float bs[4][2];  // 0.5 * bias of this lane's columns of n-tile jj: channels 8q + 2jj, + 1
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    bs[jj][0] = 0.5f * bias[8 * q + 2 * jj];
    bs[jj][1] = 0.5f * bias[8 * q + 2 * jj + 1];
  }

  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const int h_out = h / 2;
  // this lane's first window value: column col - 1 (even q, with col beside
  // it) or col + 1 (odd q, with the zero column beside it)
  const int dcol = (q & 1) ? 1 : -1;
  const bool pair = !(q & 1);
  const int tiles = (pixels + 15) / 16;
  const int step = gridDim.x * (C1_THREADS / 32) * C1_TILES;
  for (int t0 = (blockIdx.x * (C1_THREADS / 32) + (threadIdx.x >> 5)) * C1_TILES; t0 < tiles; t0 += step) {
    uint32_t a[C1_TILES][4];  // tile t0 + u: A rows g (pixel 16 (t0 + u) + g) and g + 8
#pragma unroll
    for (int u = 0; u < C1_TILES; ++u) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * (t0 + u) + g + 8 * half;
        const uint32_t r = div_by(uint32_t(p), div_w);
        const int col = p - int(r) * width;
        const uint32_t b = div_by(r, div_ho);
        const int ho = int(r) - int(b) * h_out;
        const int y0 = 2 * ho - 1 + (q >> 1);  // window row q / 2; the second register's is y0 + 2
        const bool in = p < pixels;
        const bool c_ok = in && ((q & 1) ? col + 1 < width : col > 0);
        const bool y0_ok = y0 >= 0, y1_ok = y0 + 2 < h;
        const unsigned short* row = xs + (ptrdiff_t(b) * h + y0) * width + col;
        const unsigned short v00 = c_ok && y0_ok ? __ldg(row + dcol) : 0;
        const unsigned short v01 = pair && in && y0_ok ? __ldg(row) : 0;
        const unsigned short v10 = c_ok && y1_ok ? __ldg(row + 2 * width + dcol) : 0;
        const unsigned short v11 = pair && in && y1_ok ? __ldg(row + 2 * width) : 0;
        a[u][half] = uint32_t(v00) | (uint32_t(v01) << 16);
        a[u][2 + half] = uint32_t(v10) | (uint32_t(v11) << 16);
      }
    }
#pragma unroll
    for (int u = 0; u < C1_TILES; ++u) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_bf16_bias(acc[j], a[u], bw[j][0], bw[j][1], bs[j & 3][0], bs[j & 3][1]);
      // pool: acc[jj] (conv row 2ho) + acc[jj + 4] (conv row 2ho + 1), after
      // the ReLU; accumulator rows g and g + 8 are the two pixels, and n-tile
      // jj's columns are channels 8q + 2jj, + 1
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          v[jj] = pack_bf16(fmaxf(acc[jj][2 * half], 0.f) + fmaxf(acc[jj + 4][2 * half], 0.f),
                            fmaxf(acc[jj][2 * half + 1], 0.f) + fmaxf(acc[jj + 4][2 * half + 1], 0.f));
        const int p = 16 * (t0 + u) + g + 8 * half;
        if (p < pixels) *reinterpret_cast<uint4*>(out + size_t(p) * C1_COUT + 8 * q) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// ---- f32 mode, blocks 2 and 3 --------------------------------------------------
//
// conv_block_f32<Cin, Cout>: an implicit GEMM (M = conv output pixels, N =
// Cout, K = 9 taps x Cin) with exact f32 products (FFMA) on the CUDA cores.
// Layout and geometry: ops/conv_block.py's F32_* constants and f32_tile_geometry
// (a CPU test walks them).
namespace f32t {
constexpr int THREADS = 256;
constexpr int COLS = 9;        // conv output columns per thread
constexpr int CH = 4;          // output channels per thread (one 16-byte vector)
constexpr int XG = 4;          // column groups per tile (a warp's lanes / 8)
constexpr int TW = XG * COLS;  // 36 columns per tile: W = 180 is 5 whole tiles
constexpr int QP = TW + 2;     // 16-byte slots per halo row of one channel quad
constexpr int KC = 32;         // input channels per weight slab
constexpr int WSTAGES = 2;     // weight slabs in the ring
}  // namespace f32t

template <int CIN, int COUT>
struct F32Cfg {
  static constexpr int CG = COUT / f32t::CH;                  // channel groups: 16 or 32
  static constexpr int RP = f32t::THREADS / (CG * f32t::XG);  // conv row pairs per tile: 4 or 2
  static constexpr int IN_ROWS = 2 * RP + 2;                  // halo rows
  static constexpr int NQ = CIN / 4;                          // channel quads
  static constexpr int NCH = CIN / f32t::KC;                  // Cin chunks
  static constexpr int NSLAB = 3 * NCH;                       // weight slabs (dy, chunk) per tile
  static constexpr int SLAB = 3 * f32t::KC * COUT;            // floats: [dx][ci][cout]
  static constexpr int XSTAGE = IN_ROWS * NQ * f32t::QP * 4;  // floats: [row][quad][column][4]
  static constexpr size_t BAR_OFF = size_t(2 * XSTAGE + f32t::WSTAGES * SLAB) * sizeof(float);
  static constexpr size_t SMEM = BAR_OFF + 8 * (f32t::WSTAGES + 2);  // + full mbarriers: weight stages, halo stages
  static_assert(RP >= 1 && CG * f32t::XG * RP == f32t::THREADS, "one 2 x 9 x 4 register tile per thread");
  static_assert(CG % 8 == 0 && f32t::XG * 8 == 32, "a warp: 4 column groups x 8 channel groups");
  static_assert(CIN % f32t::KC == 0 && f32t::KC % 4 == 0, "whole channel quads per slab");
  static_assert(SMEM <= 232448, "227 KB of shared memory per block");
};

// Blocks 2 and 3 in f32. Each thread holds 2 conv rows x 9 columns x 4
// channels (72 accumulators). Per (dy, channel quad, conv row) it loads its
// 11-pixel input row (columns c - 1 .. c + 9, 4 channels each: 11 LDS.128)
// and per channel three 4-channel weight vectors (one per dx), then runs
// 4 x 3 x 36 FFMA: 23 loads per 432 FFMA, since the three dx taps reuse one
// row window. The halo tile holds channel quads ([row][quad][column][4
// channels]), so a warp's 4 column groups (9 columns apart) read 4 distinct
// bank quads; one tensor copy (TMA) per tile fills it straight from NHWC,
// x seen as (4 channels, column, quad, row, utterance), its zero fill the
// SAME padding. A warp is 4 column groups x 8 channel groups: its weight
// loads read 128 contiguous bytes. 36-column tiles divide the serving
// width, W = 180, so no column is computed in vain there. The weights
// stream through a 2-slab ring of bulk copies, slab (dy, ci chunk) =
// [dx][32 ci][Cout], the whole tensor once per tile (from L2; at block 3 it
// is 295 KB, more than a block may hold); the block barrier of each step
// frees the slab read the step before, and at a tile's first step the
// halo stage of the tile before, into which the next tile's halo goes.
// Thread 0 issues every copy; full mbarriers say when each has landed.
// Persistent blocks, one per SM, walk tiles of 2 * RP conv rows x 36
// columns x Cout in a grid-stride loop. Each output sums its 9 * Cin
// products in a fixed order (slab, ci, dx), so a second call repeats bit
// for bit. Measured on an H100 (PERF.md, section 6): 64-column tiles (6.7% of
// the columns in vain at W = 180), a channel-planar halo filled by 4-byte
// cp.async, a halo by 16-byte cp.async, and producer warps spinning on
// mbarriers were each slower.
template <int CIN, int COUT>
__global__ void __launch_bounds__(f32t::THREADS, 1)
conv_block_f32(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ w, const float* __restrict__ bias,
               float* __restrict__ out, int batch, int h, int width, int pool) {
  using namespace f32t;
  using C = F32Cfg<CIN, COUT>;
  extern __shared__ __align__(128) float smf[];
  float* sX = smf;                   // 2 halo stages
  float* sW = smf + 2 * C::XSTAGE;   // WSTAGES weight slabs
  const uint32_t sX_u32 = smem_u32(sX), sW_u32 = smem_u32(sW);
  const uint32_t full = smem_u32(reinterpret_cast<unsigned char*>(smf) + C::BAR_OFF);  // + 8 * stage
  const uint32_t hfull = full + 8 * WSTAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warp -> (channel block of 8 groups, row pair); lane -> (column group, channel group)
  const int chg = (warp % (C::CG / 8)) * 8 + (lane & 7);
  const int rp = warp / (C::CG / 8);
  const int colg = lane >> 3;

  const int h_out = pool ? h / 2 : h;
  const int pairs = pool ? h / 2 : (h + 1) / 2;
  const int row_tiles = (pairs + C::RP - 1) / C::RP;
  const int col_tiles = (width + f32t::TW - 1) / f32t::TW;
  const int n_tiles = batch * row_tiles * col_tiles;  // < 2^31, checked at launch
  const int my_tiles = int(blockIdx.x) < n_tiles ? (n_tiles - 1 - int(blockIdx.x)) / int(gridDim.x) + 1 : 0;
  const int steps = my_tiles * C::NSLAB;

  // the halo of tile `tile` into stage `st`: one tensor copy (thread 0),
  // zeros where it reaches past the image
  auto load_halo = [&](int st, int tile) {
    const int ct = tile % col_tiles, r2 = tile / col_tiles;
    const int rt = r2 % row_tiles, b = r2 / row_tiles;
    const int y0 = 2 * C::RP * rt - 1, x0 = ct * f32t::TW - 1;
    mbar_arrive_expect_tx(hfull + 8 * st, C::XSTAGE * 4);
    tma_load_5d(sX_u32 + uint32_t(st * C::XSTAGE * 4), &xmap, 0, x0, 0, y0, b, hfull + 8 * st);
  };
  // weight slab of ring step g, (dy, chunk) = divmod(g % NSLAB, NCH): three
  // bulk copies of [32 ci][Cout], one per dx (thread 0)
  auto load_slab = [&](int g) {
    const int s = g % C::NSLAB, dy = s / C::NCH, chunk = s % C::NCH, st = g % WSTAGES;
    constexpr uint32_t DX_BYTES = KC * COUT * 4;
    mbar_arrive_expect_tx(full + 8 * st, 3 * DX_BYTES);
    for (int dx = 0; dx < 3; ++dx)
      bulk_g2s(sW_u32 + uint32_t(st * C::SLAB * 4) + dx * DX_BYTES,
               w + (size_t(dy * 3 + dx) * CIN + chunk * KC) * COUT, DX_BYTES, full + 8 * st);
  };

  if (tid == 0) {
    for (int i = 0; i < WSTAGES + 2; ++i) mbar_init(full + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < WSTAGES - 1 && k < steps; ++k) load_slab(k);
    if (my_tiles > 0) load_halo(0, blockIdx.x);
  }
  const float4 bv = *reinterpret_cast<const float4*>(bias + 4 * chg);

  int g = 0;  // ring step
  for (int k = 0; k < my_tiles; ++k) {
    const int tile = blockIdx.x + k * gridDim.x;
    float acc[2][COLS][CH];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c)
#pragma unroll
        for (int e = 0; e < CH; ++e) acc[r][c][e] = 0.f;

    for (int s = 0; s < C::NSLAB; ++s, ++g) {
      if (s == 0) mbar_wait(hfull + 8 * (k & 1), uint32_t((k >> 1) & 1));  // tile k's halo is in
      // every thread is done with step g - 1's slab (and at s = 0 with tile k - 1's halo stage)
      __syncthreads();
      if (tid == 0 && g + WSTAGES - 1 < steps) load_slab(g + WSTAGES - 1);
      if (tid == 0 && s == 0 && k + 1 < my_tiles) load_halo((k + 1) & 1, tile + gridDim.x);  // a tile ahead
      const int st = g % WSTAGES;
      mbar_wait(full + 8 * st, uint32_t((g / WSTAGES) & 1));  // step g's slab is in
      const int dy = s / C::NCH, chunk = s % C::NCH;
      // halo row 2 rp + r + dy holds conv row 2 rp + r's tap dy; column j = 9 colg + c + dx
      const float4* xs = reinterpret_cast<const float4*>(sX + (k & 1) * C::XSTAGE) +
                         ((2 * rp + dy) * C::NQ + chunk * (KC / 4)) * QP + COLS * colg;
      const float* ws = sW + st * C::SLAB + CH * chg;
#pragma unroll
      for (int qq = 0; qq < KC / 4; ++qq) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float4 xv[COLS + 2];
#pragma unroll
          for (int t = 0; t < COLS + 2; ++t) xv[t] = xs[(r * C::NQ + qq) * QP + t];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float wv[3][CH];
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float4 t = *reinterpret_cast<const float4*>(ws + (dx * KC + 4 * qq + u) * COUT);
              wv[dx][0] = t.x, wv[dx][1] = t.y, wv[dx][2] = t.z, wv[dx][3] = t.w;
            }
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
#pragma unroll
              for (int c = 0; c < COLS; ++c) {
                const float4 v = xv[c + dx];
                const float xu = u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
#pragma unroll
                for (int e = 0; e < CH; ++e) acc[r][c][e] = fmaf(xu, wv[dx][e], acc[r][c][e]);
              }
          }
        }
      }
    }

    // epilogue: + bias, ReLU, [pool the two rows], 16-byte stores (a warp's
    // store: 4 runs of 128 contiguous bytes)
    const int ct = tile % col_tiles, r2 = tile / col_tiles;
    const int rt = r2 % row_tiles, b = r2 / row_tiles;
    const int pair = rt * C::RP + rp, col0 = ct * f32t::TW + COLS * colg;
    const float bb[CH] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int orow = pool ? pair : 2 * pair + r;
      if ((pool && (r > 0 || pair >= h_out)) || (!pool && orow >= h)) continue;
      float* o = out + ((size_t(b) * h_out + orow) * width + col0) * COUT + CH * chg;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        float v[CH];
#pragma unroll
        for (int e = 0; e < CH; ++e) {
          const float u = fmaxf(acc[0][c][e] + bb[e], 0.f), l = fmaxf(acc[1][c][e] + bb[e], 0.f);
          v[e] = pool ? (u + l) * 0.5f : (r ? l : u);
        }
        if (col0 + c < width) *reinterpret_cast<float4*>(o + size_t(c) * COUT) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// ---- f32 mode, block 1 (Cin = 1, Cout = 32, pooled) ---------------------------
constexpr int C1F_THREADS = 256;
constexpr int C1F_GROUPS = 4;  // 4-unit groups per warp and loop trip: their loads in flight together

// A unit is two horizontally adjacent pooled pixels (b, ho, 2 cp) and (b,
// ho, 2 cp + 1) (the second masked past the row's end); lane l computes
// channels 4 (l % 8) .. + 3 of unit 4 gi + l / 8, from the units' shared 4 x
// 4 input window (rows 2ho - 1 .. 2ho + 2, columns 2cp - 1 .. 2cp + 2; the 8
// lanes of a unit load the same 16 values, from L1), so a warp's two
// 16-byte stores per group each cover 4 whole 128-byte pixels. A lane's 36
// weights and 4 biases stay in registers; the sums start at the bias and
// take the taps in the plain version's order, 2 x 2 x 9 x 4 FFMA a unit.
__global__ void __launch_bounds__(C1F_THREADS)
conv_block_cin1_f32(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                    float* __restrict__ out, int h, int width, int units, Divisor div_pw, Divisor div_ho) {
  const int lane = threadIdx.x & 31, q = lane & 7, ul = lane >> 3;
  float wr[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float4 v = *reinterpret_cast<const float4*>(w + t * C1_COUT + 4 * q);
    wr[t][0] = v.x, wr[t][1] = v.y, wr[t][2] = v.z, wr[t][3] = v.w;
  }
  const float4 bq = *reinterpret_cast<const float4*>(bias + 4 * q);
  const float bb[4] = {bq.x, bq.y, bq.z, bq.w};
  const int h_out = h / 2, pw = int(div_pw.d);
  const int groups = (units + 3) / 4;
  const int step = gridDim.x * (C1F_THREADS / 32) * C1F_GROUPS;
  for (int g0 = (blockIdx.x * (C1F_THREADS / 32) + (threadIdx.x >> 5)) * C1F_GROUPS; g0 < groups; g0 += step) {
    float win[C1F_GROUPS][4][4];
    int pix[C1F_GROUPS], col[C1F_GROUPS];
#pragma unroll
    for (int u = 0; u < C1F_GROUPS; ++u) {
      const int unit = 4 * (g0 + u) + ul;
      const uint32_t r = div_by(uint32_t(unit), div_pw);  // (b, ho)
      col[u] = 2 * (unit - int(r) * pw);
      const uint32_t b = div_by(r, div_ho);
      const int ho = int(r) - int(b) * h_out;
      pix[u] = unit < units ? int(r) * width + col[u] : -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int y = 2 * ho - 1 + i;
        const float* row = x + (ptrdiff_t(b) * h + y) * width + col[u];
        const bool y_ok = pix[u] >= 0 && y >= 0 && y < h;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int xc = col[u] - 1 + j;
          win[u][i][j] = y_ok && xc >= 0 && xc < width ? __ldg(row + j - 1) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < C1F_GROUPS; ++u) {
      float v[2][4];  // [pixel][channel]
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int px = 0; px < 2; ++px) {
          float a0 = bb[e], a1 = bb[e];  // conv rows 2ho, 2ho + 1
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            a0 = fmaf(win[u][t / 3][t % 3 + px], wr[t][e], a0);
            a1 = fmaf(win[u][t / 3 + 1][t % 3 + px], wr[t][e], a1);
          }
          v[px][e] = (fmaxf(a0, 0.f) + fmaxf(a1, 0.f)) * 0.5f;
        }
      }
      if (pix[u] >= 0) {
        float* o = out + size_t(pix[u]) * C1_COUT + 4 * q;
        *reinterpret_cast<float4*>(o) = make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
        if (col[u] + 1 < width)
          *reinterpret_cast<float4*>(o + C1_COUT) = make_float4(v[1][0], v[1][1], v[1][2], v[1][3]);
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int CIN, int COUT, int MIN_BLOCKS>
cudaError_t launch_tc(const void* x, const void* w, const float* b, void* out, int batch, int h, int width,
                      int pool, cudaStream_t s) {
  using C = TcCfg<CIN, COUT>;
  auto kern = conv_block_tc<CIN, COUT, MIN_BLOCKS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, C::SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // persistent: as many blocks as fit at once, two warpgroups each walking tiles
  const long long row_tiles = pool ? h / 2 : (h + 1) / 2;
  const long long tiles = (long long)batch * row_tiles * ((width + TW - 1) / TW);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long pairs = (tiles + 1) / 2;
  const int grid = int(pairs < (long long)per_sm * sm_count() ? pairs : (long long)per_sm * sm_count());
  kern<<<grid, THREADS, C::SMEM, s>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w), b,
                                       static_cast<bf16*>(out), batch, h, width, pool);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_direct(const void* x, const void* w, const float* b, void* out, int batch, int h, int width,
                          int c_in, int c_out, int pool, cudaStream_t s) {
  const int h_out = pool ? h / 2 : h;
  const long long per_utt = (long long)h_out * width * c_out;
  if (per_utt > 0x7fffffffLL) return cudaErrorInvalidValue;  // output indices stay in int
  // one launch per run of utterances whose outputs number < 2^31
  const int run = int(0x7fffffffLL / per_utt < batch ? 0x7fffffffLL / per_utt : batch);
  for (int b0 = 0; b0 < batch; b0 += run) {
    const int nb = batch - b0 < run ? batch - b0 : run;
    const long long want = (nb * per_utt + THREADS - 1) / THREADS, cap = (long long)sm_count() * 32;
    conv_block_direct<T><<<int(want < cap ? want : cap), THREADS, 0, s>>>(
        static_cast<const T*>(x) + size_t(b0) * h * width * c_in, static_cast<const T*>(w), b,
        static_cast<T*>(out) + size_t(b0) * per_utt, nb, h, width, c_in, c_out, pool);
  }
  return cudaSuccess;
}

cudaError_t launch_cin1_tc(const void* x, const void* w, const float* b, void* out, int batch, int h, int width,
                          cudaStream_t s) {
  const long long pixels = (long long)batch * (h / 2) * width;
  if (pixels > 0x7fffffffLL - 16 * C1_TILES) return cudaErrorInvalidValue;  // pixel indices stay in int
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_block_cin1_tc, C1_THREADS, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // persistent: as many blocks as fit at once, each warp walking C1_TILES 16-pixel tiles a trip
  constexpr int per_block = 16 * C1_TILES * (C1_THREADS / 32);
  const long long blocks = (pixels + per_block - 1) / per_block;
  const long long cap = (long long)per_sm * sm_count();
  conv_block_cin1_tc<<<int(blocks < cap ? blocks : cap), C1_THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), b, static_cast<bf16*>(out), h, width, int(pixels),
      make_divisor(uint32_t(width)), make_divisor(uint32_t(h / 2)));
  return cudaSuccess;
}

template <int CIN, int COUT>
cudaError_t launch_f32(const void* x, const void* w, const float* b, void* out, int batch, int h, int width, int pool,
                       cudaStream_t s) {
  using C = F32Cfg<CIN, COUT>;
  auto kern = conv_block_f32<CIN, COUT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (err != cudaSuccess) return err;
  const long long pairs = pool ? h / 2 : (h + 1) / 2;
  const long long tiles = (long long)batch * ((pairs + C::RP - 1) / C::RP) * ((width + f32t::TW - 1) / f32t::TW);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // persistent: one block per SM (its shared memory allows no second)
  const int grid = int(tiles < sm_count() ? tiles : sm_count());
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &q);
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return err != cudaSuccess ? err : cudaErrorNotSupported;
  }
  // x as (4 channels, column, quad, row, utterance), so that a box of (4, 38
  // columns, every quad, the halo rows, 1) lands as [row][quad][column][4];
  // the quad's stride (16 B) is below the column's, which a tensor map takes.
  // Its parts outside x are zero-filled: the SAME padding.
  CUtensorMap map;
  const cuuint64_t dims[5] = {4, cuuint64_t(width), CIN / 4, cuuint64_t(h), cuuint64_t(batch)};
  const cuuint64_t strides[4] = {CIN * 4, 16, cuuint64_t(width) * CIN * 4, cuuint64_t(h) * width * CIN * 4};
  const cuuint32_t box[5] = {4, f32t::QP, CIN / 4, C::IN_ROWS, 1}, unit[5] = {1, 1, 1, 1, 1};
  CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(x), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  kern<<<grid, f32t::THREADS, C::SMEM, s>>>(map, static_cast<const float*>(w), b, static_cast<float*>(out), batch, h,
                                            width, pool);
  return cudaSuccess;
}

cudaError_t launch_cin1_f32(const void* x, const void* w, const float* b, void* out, int batch, int h, int width,
                            cudaStream_t s) {
  const long long units = (long long)batch * (h / 2) * ((width + 1) / 2);
  if ((long long)batch * (h / 2) * width > 0x7fffffffLL || units > 0x7fffffffLL - 4 * C1F_GROUPS)
    return cudaErrorInvalidValue;  // pixel and unit indices stay in int
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_block_cin1_f32, C1F_THREADS, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // persistent: as many blocks as fit at once, each warp walking C1F_GROUPS 4-unit groups a trip
  constexpr int per_block = 4 * C1F_GROUPS * (C1F_THREADS / 32);
  const long long blocks = (units + per_block - 1) / per_block;
  const long long cap = (long long)per_sm * sm_count();
  conv_block_cin1_f32<<<int(blocks < cap ? blocks : cap), C1F_THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), b, static_cast<float*>(out), h, width,
      int(units), make_divisor(uint32_t((width + 1) / 2)), make_divisor(uint32_t(h / 2)));
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_cin1(const void* x, const void* w, const float* b, void* out, int batch, int h, int width,
                        int c_out, int pool, cudaStream_t s) {
  const size_t smem = size_t(10) * c_out * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const long long pixels = (long long)batch * (pool ? h / 2 : h) * width;
  const long long want = (pixels + THREADS - 1) / THREADS, cap = (long long)sm_count() * 16;
  conv_block_cin1<T><<<int(want < cap ? want : cap), THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), b, static_cast<T*>(out), batch, h, width, c_out, pool);
  return cudaSuccess;
}

}  // namespace

// x (B, H, W, Cin) bf16 or f32 NHWC; w (3, 3, Cin, Cout) in x's dtype; b (Cout,)
// f32; out (B, H/2 or H, W, Cout) in x's dtype. Launches on `stream`, does not
// synchronise; returns cudaGetLastError().
extern "C" int dfac_conv_block(const void* x, const void* w, const float* b, void* out, int batch, int h,
                               int width, int c_in, int c_out, int pool, int bf16_mode, void* stream) {
  if (batch <= 0 || h <= 0 || width <= 0 || c_in <= 0 || c_out <= 0 || (pool && h < 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (bf16_mode && c_in == 32 && c_out == 64) {
    err = launch_tc<32, 64, 2>(x, w, b, out, batch, h, width, pool, s);
  } else if (bf16_mode && c_in == 64 && c_out == 128) {
    err = launch_tc<64, 128, 1>(x, w, b, out, batch, h, width, pool, s);
  } else if (bf16_mode && c_in == 1 && c_out == C1_COUT && pool) {
    err = launch_cin1_tc(x, w, b, out, batch, h, width, s);
  } else if (!bf16_mode && c_in == 32 && c_out == 64) {
    err = launch_f32<32, 64>(x, w, b, out, batch, h, width, pool, s);
  } else if (!bf16_mode && c_in == 64 && c_out == 128) {
    err = launch_f32<64, 128>(x, w, b, out, batch, h, width, pool, s);
  } else if (!bf16_mode && c_in == 1 && c_out == C1_COUT && pool) {
    err = launch_cin1_f32(x, w, b, out, batch, h, width, s);
  } else if (c_in == 1 && c_out % 8 == 0) {
    err = bf16_mode ? launch_cin1<bf16>(x, w, b, out, batch, h, width, c_out, pool, s)
                    : launch_cin1<float>(x, w, b, out, batch, h, width, c_out, pool, s);
  } else if (bf16_mode) {
    err = launch_direct<bf16>(x, w, b, out, batch, h, width, c_in, c_out, pool, s);
  } else {
    err = launch_direct<float>(x, w, b, out, batch, h, width, c_in, c_out, pool, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of the kernel dfac_conv_block picks for
// these channel counts, in bytes (0: the direct kernel and, for Cin = 1,
// Cout = 32, block 1's pooled kernels use none).
extern "C" int dfac_conv_block_smem(int c_in, int c_out, int bf16_mode) {
  if (bf16_mode && c_in == 32 && c_out == 64) return int(TcCfg<32, 64>::SMEM);
  if (bf16_mode && c_in == 64 && c_out == 128) return int(TcCfg<64, 128>::SMEM);
  if (!bf16_mode && c_in == 32 && c_out == 64) return int(F32Cfg<32, 64>::SMEM);
  if (!bf16_mode && c_in == 64 && c_out == 128) return int(F32Cfg<64, 128>::SMEM);
  if (c_in == 1 && c_out == C1_COUT) return 0;  // pooled (block 1): registers only
  if (c_in == 1 && c_out % 8 == 0) return 10 * c_out * int(sizeof(float));
  return 0;
}

extern "C" const char* dfac_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
