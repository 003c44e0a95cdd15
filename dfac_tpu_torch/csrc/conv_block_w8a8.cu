// w8a8 CNN2D chain for Hopper (sm_90a): block 1 as one fused int8-epilogue
// kernel, and blocks 2 and 3 as int8 x int8 -> int32 3x3 SAME convs on wgmma
// with the folded-BN dequant, bias and ReLU in one epilogue.
//
// Replaces no Pallas kernel: the JAX package runs the whole chain through
// XLA (dfac_tpu/models/fast_infer_int8.py:169-209, _w8a8_chain: block 1 an
// f32-accumulated conv and its epilogue, blocks 2 and 3
// jax.lax.conv_general_dilated(..., preferred_element_type=jnp.int32), the
// head's jnp.mean over time). No PyTorch convolution takes int8 on CUDA, and
// a patch matrix through torch._int_mm would write 9x the activation and
// could not fuse the epilogue, so each block is a kernel of its own.
//
// conv_block_w8a8 (blocks 2 and 3). x (B, H, W, Cin) int8 NHWC; wt (9, Cout,
// Cin) int8, the HWIO kernel with each tap's rows transposed to (cout, cin)
// by the wrapper, so that a row of K is contiguous; deq, b (Cout,) f32.
// h = relu(acc * deq + b), then one of three modes:
//  * pooled (block 2): q = min(rne(h * inv_s), 127) as int8, then the int8
//    time pool (q0 + q1 + 1) >> 1 of conv rows 2p and 2p + 1 -> out (B, H /
//    2, W, Cout) int8 (an odd last conv row is dropped after the conv, so it
//    still served as the halo of the row before it);
//  * f32: h -> out (B, H, W, Cout) f32;
//  * mean (block 3, the head's time mean): hm = (sum over t = 0, 1, ..., H -
//    1 of h, in that order, f32) * float32(1 / H) -> out (B, W, Cout) f32.
//    A warpgroup owns every row of its column strip of one utterance and
//    sums in registers, so no float atomics: a second call is bit for bit the
//    first.
// The epilogue multiplies and adds with __fmul_rn / __fadd_rn, so that nvcc
// cannot contract it into an FMA, and quantizes with __float2int_rn (round
// half to even): with those the kernel equals its plain version
// (ops/conv_block_w8a8.py::reference_conv_block_w8a8) bit for bit.
//
// What bounds it on the card, at the serving shapes (B = 128, W = 180;
// 1,979 TOP/s dense int8 on the tensor cores, 3.35 TB/s):
//  * block 2 (32 -> 64, 160 -> 80 rows): 136 GOP, 0.069 ms, against 118 MB
//    read and 118 MB written, 0.070 ms: bytes and operations even;
//  * block 3 in the mean mode (64 -> 128, 80 rows): 272 GOP, 0.137 ms,
//    against 118 MB read and 11.8 MB written, 0.039 ms: operations. (Its
//    f32 mode writes 943 MB, 0.317 ms: bytes.)
//
// Design, after conv_block.cu's conv_block_tc (the bf16 blocks):
//  * implicit GEMM, M = output pixels, N = Cout, K = 9 taps x Cin, on
//    wgmma m64nCout k32 s8 x s8 -> s32, the instruction that reaches the
//    card's int8 rate. Persistent blocks (two per SM at block 2, one at
//    block 3) hold every weight in shared memory for their life, stored once
//    in the layout the B descriptor reads: K-major rows (tap, cout) 64 bytes
//    apart in the 64-byte swizzle (hopper.cuh's w_off<32>, the bf16 Cin = 32
//    layout; Cin = 64 fills a row, Cin = 32 its first half), a k32 step 32
//    bytes along the row.
//  * Each of a block's two warpgroups walks tiles of its own, 2 conv rows x
//    32 columns (64 pixels, wgmma's M), in a grid-stride loop through a
//    4-stage ring of halo tiles (4 x 34 pixels, Cin + 16 bytes a pixel so
//    that ldmatrix's 8 rows fall on 8 bank quads), filled by cp.async 16
//    bytes a copy (SAME padding from the copy's zero fill). It issues the
//    copies of the tile 3 ahead once its wgmmas are in flight. Warpgroup 1
//    starts when warpgroup 0 has issued its first tile's wgmmas. In the mean
//    mode a warpgroup's unit is a column strip of an utterance, walked row
//    pair by row pair. Tile numbers decode by multiply and shift.
//  * Tap shifts start each tap's A window at any pixel, off the swizzle
//    pattern an A descriptor reads, so A comes from registers: ldmatrix.x4
//    (the m16k32 s8 fragment is the m16k16 bf16 one byte for byte). All 9
//    taps' A registers load at once (36 or 72 registers), then the tile's 9
//    or 18 wgmmas go out as one group; a tap-by-tap double buffer (two taps
//    in flight) was slower on the card.
//  * The wgmmas do not overlap the CUDA-core work on the card: a ping-pong
//    between the two warpgroups and a split of the channels into two halves
//    (one half's epilogue beside the other's wgmmas) were both slower. What
//    is left is the epilogue's arithmetic and the per-tile instructions
//    (PERF.md, section 6).
//  * A warp's 16 M rows are 8 columns of conv row 0, then the same 8 of row
//    1, so a thread holds both rows of its pixel: the pool and the time sum
//    happen in registers. In the pooled mode a quad trades its code pairs
//    (a 4 x 4 transpose, two shuffles, then byte permutes) so that each
//    lane stores 16 contiguous channels: 16-byte stores.
//
// block1_w8a8 (block 1, Cin = 1, Cout = 32, pooled). x (B, T, F) in the
// compute dtype with any element strides (the chain passes the stored (B,
// F, T) batch as a transposed view), w (9, 32) f32 holding values of the
// compute dtype, b (32,) f32; out (B, T / 2, F, 32) int8 NHWC. Per pooled
// pixel (b, p, f) and channel c: the conv rows y(2p), y(2p + 1) (3x3 SAME,
// products and sums in f32, the bias added after the sum, as JAX does),
// q = min(rne(relu(y + b) * inv_s), 127) for each row, then (q0 + q1 + 1)
// >> 1. The pool comes after the quantization, so K2's trick of folding the
// pool's 0.5 into B and the bias does not apply. Bound at the serving shape
// (B = 128, 321 x 180): 29.6 MB f32 (14.8 MB bf16) read, 118 MB written,
// 0.044 ms (0.040 bf16), against 4.26 GFLOP, 0.064 ms on the CUDA cores.
//  * f32 (block1_w8a8_f32), on the design of conv_block.cu's
//    conv_block_cin1_f32: a lane computes 4 channels of two adjacent pooled
//    pixels from their shared 4 x 4 window. Each conv row sums its 9 taps in
//    order (dy, dx) with separately rounded products and sums (__fmul_rn,
//    __fadd_rn): the plain version's order, bit for bit.
//  * bf16 (block1_w8a8_tc), on the design of conv_block_cin1_tc: both conv
//    rows of 16 pooled pixels as one mma.sync m16n8k16 product a channel
//    octet, K = the 4 x 3 window, N = 2 conv rows x 32 channels
//    (ops/conv_block.py's CIN1_TC_K and CIN1_TC_N), accumulators from zero.
//    bf16 x bf16 products are exact in f32; the tensor core sums them in its
//    own order, so a code may move by one where y * inv_s sits on a
//    rounding boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using dfac::b_desc_kmajor;
using dfac::cp_async16;
using dfac::cp_async_commit;
using dfac::cp_async_wait;
using dfac::fence_proxy_async;
using dfac::fence_regs;
using dfac::ldsm_x4;
using dfac::mma_bf16_bias;
using dfac::smem_u32;
using dfac::stagger_release;
using dfac::stagger_wait;
using dfac::w_off;
using dfac::wg_barrier;
using dfac::wgmma_commit;
using dfac::wgmma_fence;
using dfac::wgmma_s8_n128;
using dfac::wgmma_s8_n64;
using dfac::wgmma_wait;

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;     // 2 warpgroups, each walking tiles of its own
constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int TW = 32;           // tile columns: 2 conv rows x 32 = one warpgroup's 64 pixels
constexpr int IN_ROWS = 4;       // 2 conv rows + halo
constexpr int IN_COLS = TW + 2;
constexpr int STAGES = 4;        // halo tiles in each warpgroup's ring

enum Mode : int { F32 = 0, POOLED = 1, MEAN = 2 };

template <int CIN, int COUT>
struct W8Cfg {
  static_assert(CIN == 32 || CIN == 64, "C_in 32 or 64: one or two k32 steps a tap");
  static_assert(COUT == 64 || COUT == 128, "wgmma m64n64 or m64n128");
  static constexpr int PS = CIN + 16;    // halo pixel stride, bytes
  static constexpr int ROW_B = 64;       // weight row (tap, cout) stride, bytes: the 64-byte swizzle
  static constexpr int KSTEPS = CIN / 32;  // wgmma k32 steps a tap
  static constexpr int NACC = COUT / 2;    // s32 accumulators a thread: 64 x Cout a warpgroup
  static constexpr int NJ = COUT / 8;      // n8 column groups
  static constexpr int X_BYTES = IN_ROWS * IN_COLS * PS;  // one stage
  static constexpr int W_BYTES = 9 * COUT * ROW_B;
  static constexpr int ALIGN = 1024;  // the swizzle pattern repeats every 512 bytes
  static constexpr int SMEM = ALIGN + W_BYTES + 2 * STAGES * X_BYTES + 2 * COUT * 4;  // + deq and b
  static constexpr int MIN_BLOCKS = COUT == 64 ? 2 : 1;
  static_assert(X_BYTES % 16 == 0, "16-byte aligned stages");
  static_assert(SMEM <= 232448, "227 KB of shared memory per block");
};

// relu(acc * deq + b), rounded as two separate f32 operations
__device__ __forceinline__ float dequant(int acc, float deq, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), deq), b), 0.0f);
}

__device__ __forceinline__ int quant(float h, float inv_s) { return min(__float2int_rn(__fmul_rn(h, inv_s)), 127); }

// The 4 lanes q of a quad hold x_m = in[q][m], m = 0..3; lane q gets
// out[q][m] = in[m][q] (two shuffle rounds, lane bit 0 then bit 1).
__device__ __forceinline__ uint4 quad_transpose(uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3, int q) {
  const bool q1 = q & 1, q2 = q & 2;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, q1 ? x0 : x1, 1);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, q1 ? x2 : x3, 1);
  const uint32_t y0 = q1 ? r0 : x0, y1 = q1 ? x1 : r0, y2 = q1 ? r1 : x2, y3 = q1 ? x3 : r1;
  r0 = __shfl_xor_sync(0xffffffffu, q2 ? y0 : y2, 2);
  r1 = __shfl_xor_sync(0xffffffffu, q2 ? y1 : y3, 2);
  return q2 ? make_uint4(r0, r1, y2, y3) : make_uint4(y0, y1, r0, r1);
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

// Tiles are numbered (b, column strip, row pair), the row pair fastest. A
// warpgroup's unit is `per` consecutive tiles: every row pair of a strip in
// the mean mode, one tile otherwise.
struct Geo {
  int h, w, row_tiles, col_tiles, units, per;
  float inv_t;       // float32(1 / h), the mean mode's scale
  Divisor rows, cols;  // by row_tiles, col_tiles
};

struct TilePos {
  int b, cb, pr;  // utterance, column strip, row pair
};

__device__ __forceinline__ TilePos tile_pos(int tile, const Geo& g) {
  const int rest = int(div_by(uint32_t(tile), g.rows));
  const int b = int(div_by(uint32_t(rest), g.cols));
  return {b, rest - b * g.col_tiles, tile - rest * g.row_tiles};
}

// A warpgroup (lane wt of 128) issues the copies of one halo tile (IN_ROWS x
// IN_COLS pixels, Cin bytes each) into a stage; pixels outside the image are
// zero-filled.
template <int CIN>
__device__ __forceinline__ void load_tile(uint32_t stage, const int8_t* __restrict__ x, int tile, const Geo& g, int wt) {
  constexpr int VEC = CIN / 16;
  const TilePos t = tile_pos(tile, g);
  const int b = t.b, y0 = 2 * t.pr - 1, x0 = t.cb * TW - 1;
  for (int i = wt; i < IN_ROWS * IN_COLS * VEC; i += WG_THREADS) {
    const int v = i % VEC, pix = i / VEC;
    const int ic = pix % IN_COLS, ir = pix / IN_COLS;
    const int y = y0 + ir, xc = x0 + ic;
    const bool in = y >= 0 && y < g.h && xc >= 0 && xc < g.w;
    const int8_t* src = in ? x + ((size_t(b) * g.h + y) * g.w + xc) * CIN + v * 16 : x;
    cp_async16(stage + uint32_t(pix * (CIN + 16) + v * 16), src, in ? 16 : 0);
  }
}

template <int CIN, int COUT, int MODE>
__global__ void __launch_bounds__(THREADS, W8Cfg<CIN, COUT>::MIN_BLOCKS)
    conv_block_w8a8(const int8_t* __restrict__ x, const int8_t* __restrict__ wt, const float* __restrict__ deq,
                    const float* __restrict__ bias, float inv_s, void* __restrict__ out, Geo g) {
  using C = W8Cfg<CIN, COUT>;
  constexpr int S = STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((C::ALIGN - (smem_u32(smem_raw) & (C::ALIGN - 1))) & (C::ALIGN - 1));
  const uint32_t sW = smem_u32(smem);  // [tap * COUT + cout][cin], swizzled
  float* s_deq = reinterpret_cast<float*>(smem + C::W_BYTES + 2 * S * C::X_BYTES);
  float* s_b = s_deq + COUT;

  // Warpgroup wg walks units 2 * block + wg + k * (2 * grid) through a ring of its own.
  const int wg = threadIdx.x / WG_THREADS, wt_lane = threadIdx.x % WG_THREADS;
  const uint32_t ring = sW + C::W_BYTES + wg * S * C::X_BYTES;
  const int step = 2 * gridDim.x;
  // (u, p): this tile, unit u's row tile p; (ua, pa): the tile whose copies go next
  int u = 2 * blockIdx.x + wg, p = 0, ua = u, pa = 0;
  auto advance = [&](int& uu, int& pp) {
    if (++pp == g.per) {
      pp = 0;
      uu += step;
    }
  };
  // the first S - 1 tiles' copies fly while the weights are stored; one group per tile
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (ua < g.units) load_tile<CIN>(ring + k * C::X_BYTES, x, ua * g.per + pa, g, wt_lane);
    cp_async_commit();
    advance(ua, pa);
  }

  // every weight, once per block: 16-byte chunk c of row (tap, cout) r to its swizzled place
  constexpr int CHUNKS = CIN / 16;
  for (int i = threadIdx.x; i < 9 * COUT * CHUNKS; i += THREADS)
    *reinterpret_cast<uint4*>(smem + w_off<32>(i / CHUNKS, i % CHUNKS)) = __ldg(reinterpret_cast<const uint4*>(wt) + i);
  for (int i = threadIdx.x; i < COUT; i += THREADS) {
    s_deq[i] = deq[i];
    s_b[i] = bias[i];
  }
  // the weights' ordinary stores, before wgmma (the async proxy) reads them
  fence_proxy_async();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;  // warp within the warpgroup
  const int gid = lane >> 2, tq = lane & 3;
  const int px0 = warp * 8;  // this warp's 8 columns of the tile
  // A: warp M row i is conv row i / 8 at column px0 + i % 8. ldmatrix.x4 lane l
  // addresses row l % 8 of matrix l / 8: (rows 0-7, k 0-15), (rows 8-15, k
  // 0-15), (rows 0-7, k 16-31), (rows 8-15, k 16-31), the m16k32 fragment's order.
  const int lq = lane >> 3, lr = lane & 7;
  const uint32_t a_lane = uint32_t(((lq & 1) * IN_COLS + px0 + lr) * C::PS + 16 * (lq >> 1));

  bool lead = wg == 0;  // warpgroup 0 has yet to release warpgroup 1
  if (wg == 1) stagger_wait();
  if (lead && u >= g.units) {
    stagger_release();
    lead = false;
  }
  float sum[MODE == MEAN ? COUT / 4 : 1];  // the mean mode's running sums: channels 8j + 2tq + e at [2j + e]
  int s = 0;  // this tile's stage
  for (; u < g.units; advance(u, p), s = s + 1 == S ? 0 : s + 1) {
    cp_async_wait<S - 2>();
    wg_barrier(wg);  // this tile's stage is in; the warpgroup is done with the stage it read last
    const uint32_t sX = ring + s * C::X_BYTES;

    int acc[C::NACC];
#pragma unroll
    for (int i = 0; i < C::NACC; ++i) acc[i] = 0;
    uint32_t a[9][C::KSTEPS][4];  // every tap's A registers: their loads in flight together
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const uint32_t a_tap = sX + a_lane + uint32_t(((t / 3) * IN_COLS + t % 3) * C::PS);
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) ldsm_x4(a_tap + kk * 32, a[t][kk]);
    }
    fence_regs(acc);
    wgmma_fence();  // the A registers just written, before wgmma reads them
#pragma unroll
    for (int t = 0; t < 9; ++t) {
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        const uint64_t desc = b_desc_kmajor<C::ROW_B>(sW + uint32_t(t * COUT * C::ROW_B + kk * 32));
        if constexpr (COUT == 64) wgmma_s8_n64(acc, a[t][kk], desc);
        else wgmma_s8_n128(acc, a[t][kk], desc);
      }
    }
    wgmma_commit();
    {  // the ring's next copies, issued while the tensor cores work
      const int fill = s == 0 ? S - 1 : s - 1;  // the stage the previous tile read
      if (ua < g.units) load_tile<CIN>(ring + fill * C::X_BYTES, x, ua * g.per + pa, g, wt_lane);
      cp_async_commit();
      advance(ua, pa);
    }
    if (lead) {
      stagger_release();
      lead = false;
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int t = 0; t < 9; ++t) fence_regs(a[t]);

    // epilogue: acc[4j + e] is conv row 0 and acc[4j + 2 + e] conv row 1 of
    // column col, channel 8j + 2tq + e
    const int tile = u * g.per + p;
    const TilePos tp = tile_pos(tile, g);
    const int pr = tp.pr, b = tp.b;
    const int col = tp.cb * TW + px0 + gid;
    if constexpr (MODE == POOLED) {
      // word k: the pooled codes of channels 16k + 2tq, + 1 (bytes 0, 1) and 16k + 8 + 2tq, + 1 (bytes 2, 3)
      uint32_t words[C::NJ / 2];
#pragma unroll
      for (int k = 0; k < C::NJ / 2; ++k) {
        uint32_t v = 0;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * k + half;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = 8 * j + 2 * tq + e;
            const float d = s_deq[co], bb = s_b[co];
            const int q0 = quant(dequant(acc[4 * j + e], d, bb), inv_s);
            const int q1 = quant(dequant(acc[4 * j + 2 + e], d, bb), inv_s);
            v |= (uint32_t((q0 + q1 + 1) >> 1) & 0xffu) << (8 * (2 * half + e));
          }
        }
        words[k] = v;
      }
      // lane tq gets word 4G + tq of each lane m (channels 2m, 2m + 1 and 8 + 2m, 9 + 2m of 16-channel
      // group 4G + tq) and permutes the bytes into channel order: one 16-byte store
      int8_t* o = static_cast<int8_t*>(out) + ((size_t(b) * (g.h / 2) + pr) * g.w + col) * COUT;
#pragma unroll
      for (int G = 0; G < C::NJ / 8; ++G) {
        const uint4 r = quad_transpose(words[4 * G], words[4 * G + 1], words[4 * G + 2], words[4 * G + 3], tq);
        const uint4 v = make_uint4(__byte_perm(r.x, r.y, 0x5410), __byte_perm(r.z, r.w, 0x5410),
                                   __byte_perm(r.x, r.y, 0x7632), __byte_perm(r.z, r.w, 0x7632));
        if (col < g.w) *reinterpret_cast<uint4*>(o + 16 * (4 * G + tq)) = v;
      }
    } else if constexpr (MODE == F32) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 2 * pr + r;
        if (row >= g.h || col >= g.w) break;
        float* o = static_cast<float*>(out) + ((size_t(b) * g.h + row) * g.w + col) * COUT;
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) {
          const int co = 8 * j + 2 * tq;
          float2 v;
          v.x = dequant(acc[4 * j + 2 * r], s_deq[co], s_b[co]);
          v.y = dequant(acc[4 * j + 2 * r + 1], s_deq[co + 1], s_b[co + 1]);
          *reinterpret_cast<float2*>(o + co) = v;
        }
      }
    } else {
      if (p == 0) {
#pragma unroll
        for (int i = 0; i < COUT / 4; ++i) sum[i] = 0.f;
      }
      const bool lower = 2 * pr + 1 < g.h;  // an odd H's last tile has no conv row 2pr + 1
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = 8 * j + 2 * tq + e;
          const float d = s_deq[co], bb = s_b[co];
          sum[2 * j + e] = __fadd_rn(sum[2 * j + e], dequant(acc[4 * j + e], d, bb));
          if (lower) sum[2 * j + e] = __fadd_rn(sum[2 * j + e], dequant(acc[4 * j + 2 + e], d, bb));
        }
      }
      if (p == g.per - 1 && col < g.w) {
        float* o = static_cast<float*>(out) + (size_t(b) * g.w + col) * COUT;
#pragma unroll
        for (int j = 0; j < C::NJ; ++j)
          *reinterpret_cast<float2*>(o + 8 * j + 2 * tq) =
              make_float2(__fmul_rn(sum[2 * j], g.inv_t), __fmul_rn(sum[2 * j + 1], g.inv_t));
      }
    }
  }
  cp_async_wait<0>();
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

template <int CIN, int COUT, int MODE>
cudaError_t launch_mode(const void* x, const void* wt, const float* deq, const float* b, float inv_s, void* out,
                        int batch, int h, int w, cudaStream_t s) {
  using C = W8Cfg<CIN, COUT>;
  auto kern = conv_block_w8a8<CIN, COUT, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, C::SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  Geo g;
  g.h = h;
  g.w = w;
  g.row_tiles = MODE == POOLED ? h / 2 : (h + 1) / 2;
  g.col_tiles = (w + TW - 1) / TW;
  const long long tiles = (long long)batch * g.row_tiles * g.col_tiles;
  // tile numbers, and the walk's unit numbers one ring ahead of the last, stay in int
  if (tiles + 2LL * STAGES * THREADS * sm_count() > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (tiles == 0) return cudaSuccess;
  g.per = MODE == MEAN ? g.row_tiles : 1;
  g.units = int(tiles / g.per);
  g.inv_t = float(1.0 / h);
  g.rows = make_divisor(uint32_t(g.row_tiles));
  g.cols = make_divisor(uint32_t(g.col_tiles));
  // persistent: as many blocks as fit at once, two warpgroups each walking units
  const long long pairs = (g.units + 1) / 2, cap = (long long)per_sm * sm_count();
  kern<<<int(pairs < cap ? pairs : cap), THREADS, C::SMEM, s>>>(static_cast<const int8_t*>(x),
                                                                  static_cast<const int8_t*>(wt), deq, b, inv_s, out, g);
  return cudaSuccess;
}

template <int CIN, int COUT>
cudaError_t launch(const void* x, const void* wt, const float* deq, const float* b, float inv_s, int mode, void* out,
                   int batch, int h, int w, cudaStream_t s) {
  if (mode == POOLED) return launch_mode<CIN, COUT, POOLED>(x, wt, deq, b, inv_s, out, batch, h, w, s);
  if (mode == MEAN) return launch_mode<CIN, COUT, MEAN>(x, wt, deq, b, inv_s, out, batch, h, w, s);
  if (mode == F32) return launch_mode<CIN, COUT, F32>(x, wt, deq, b, inv_s, out, batch, h, w, s);
  return cudaErrorInvalidValue;
}

// ---- block 1 (Cin = 1, Cout = 32, pooled) ---------------------------------------

constexpr int B1_COUT = 32;
constexpr int B1_THREADS = 256;
constexpr int B1_GROUPS = 4;  // f32: 4-unit groups per warp and loop trip, their loads in flight together
constexpr int B1_TILES = 4;   // bf16: 16-pixel tiles per warp and loop trip, likewise

// x's element strides: utterance, time row, feature column
struct Strides {
  long long b, t, f;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The pooled code of one channel from its two conv rows' sums.
__device__ __forceinline__ uint32_t pooled_code(float y0, float y1, float b, float inv_s) {
  const int q0 = quant(fmaxf(__fadd_rn(y0, b), 0.f), inv_s);
  const int q1 = quant(fmaxf(__fadd_rn(y1, b), 0.f), inv_s);
  return uint32_t((q0 + q1 + 1) >> 1) & 0xffu;
}

// A unit is two horizontally adjacent pooled pixels (b, ho, 2 cp) and (b, ho,
// 2 cp + 1) (the second masked past the row's end); lane l computes channels
// 4 (l % 8) .. + 3 of unit 4 gi + l / 8 from the units' shared 4 x 4 window
// (rows 2ho - 1 .. 2ho + 2, columns 2cp - 1 .. 2cp + 2; the 8 lanes of a unit
// load the same 16 values, from L1), and stores each pixel's 4 codes as one
// word: a unit's 8 lanes write its two 32-byte pixels whole. A lane's 36
// weights and 4 biases stay in registers.
__global__ void __launch_bounds__(B1_THREADS)
    block1_w8a8_f32(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                    float inv_s, int8_t* __restrict__ out, int h, int width, Strides st, int units, Divisor div_pw,
                    Divisor div_ho) {
  const int lane = threadIdx.x & 31, q = lane & 7, ul = lane >> 3;
  float wr[9][4], bb[4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) wr[t][e] = w[t * B1_COUT + 4 * q + e];
#pragma unroll
  for (int e = 0; e < 4; ++e) bb[e] = bias[4 * q + e];
  const int h_out = h / 2, pw = int(div_pw.d);
  const int groups = (units + 3) / 4;
  const int step = gridDim.x * (B1_THREADS / 32) * B1_GROUPS;
  for (int g0 = (blockIdx.x * (B1_THREADS / 32) + (threadIdx.x >> 5)) * B1_GROUPS; g0 < groups; g0 += step) {
    float win[B1_GROUPS][4][4];
    int pix[B1_GROUPS], col[B1_GROUPS];
#pragma unroll
    for (int u = 0; u < B1_GROUPS; ++u) {
      const int unit = 4 * (g0 + u) + ul;
      const uint32_t r = div_by(uint32_t(unit), div_pw);  // (b, ho)
      col[u] = 2 * (unit - int(r) * pw);
      const uint32_t b = div_by(r, div_ho);
      const int ho = int(r) - int(b) * h_out;
      pix[u] = unit < units ? int(r) * width + col[u] : -1;
      const float* img = x + ptrdiff_t(b) * st.b;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int y = 2 * ho - 1 + i;
        const bool y_ok = pix[u] >= 0 && y >= 0 && y < h;
        const float* row = img + ptrdiff_t(y) * st.t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int xc = col[u] - 1 + j;
          win[u][i][j] = y_ok && xc >= 0 && xc < width ? __ldg(row + ptrdiff_t(xc) * st.f) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < B1_GROUPS; ++u) {
      uint32_t pk[2] = {0u, 0u};  // [pixel]: channels 4q .. 4q + 3, a byte each
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int px = 0; px < 2; ++px) {
          // conv rows 2ho (window rows 0-2) and 2ho + 1 (1-3), taps in order (dy, dx)
          float a0 = __fmul_rn(win[u][0][px], wr[0][e]), a1 = __fmul_rn(win[u][1][px], wr[0][e]);
#pragma unroll
          for (int t = 1; t < 9; ++t) {
            a0 = __fadd_rn(a0, __fmul_rn(win[u][t / 3][t % 3 + px], wr[t][e]));
            a1 = __fadd_rn(a1, __fmul_rn(win[u][t / 3 + 1][t % 3 + px], wr[t][e]));
          }
          pk[px] |= pooled_code(a0, a1, bb[e], inv_s) << (8 * e);
        }
      }
      if (pix[u] >= 0) {
        int8_t* o = out + size_t(pix[u]) * B1_COUT + 4 * q;
        *reinterpret_cast<uint32_t*>(o) = pk[0];
        if (col[u] + 1 < width) *reinterpret_cast<uint32_t*>(o + B1_COUT) = pk[1];
      }
    }
  }
}

// One mma.sync m16n8k16 product per 16 pooled pixels and 8 output columns, K
// = the 4 x 3 input window (k = 4 * row + col), N = 64 = two conv rows x 32
// channels, column 8j + m of a conv row carrying channel 8 (m / 2) + 2j + m %
// 2 (ops/conv_block.py CIN1_TC_K, CIN1_TC_N). Fragment layout (PTX
// m16n8k16): lane (g, q) = (lane / 4, lane % 4) holds A rows g and g + 8 at k
// = 2q, 2q + 1 and 2q + 8, 2q + 9, B column g at the same k, and accumulators
// of rows g, g + 8 at columns 2q, 2q + 1: channels 8q .. 8q + 7 of two pixels,
// which it stores as 8 bytes each (a quad writes a 32-byte pixel whole).
__global__ void __launch_bounds__(B1_THREADS, 2)
    block1_w8a8_tc(const bf16* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                   float inv_s, int8_t* __restrict__ out, int h, int width, Strides st, int pixels, Divisor div_w,
                   Divisor div_ho) {
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
      const float lo = tap ? w[(dy * 3 + dx) * B1_COUT + ch] : 0.f;
      const float hi = tap && dx == 0 ? w[(dy * 3 + 1) * B1_COUT + ch] : 0.f;
      bw[j][e] = pack_bf16(lo, hi);  // exact: w holds bf16 values
    }
  }
  float bs[4][2];  // the bias of this lane's columns of n-tile jj: channels 8q + 2jj, + 1
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    bs[jj][0] = bias[8 * q + 2 * jj];
    bs[jj][1] = bias[8 * q + 2 * jj + 1];
  }

  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const int h_out = h / 2;
  // this lane's first window value: column col - 1 (even q, with col beside
  // it) or col + 1 (odd q, with the zero column beside it)
  const ptrdiff_t dcol = ((q & 1) ? 1 : -1) * ptrdiff_t(st.f);
  const bool pair = !(q & 1);
  const int tiles = (pixels + 15) / 16;
  const int step = gridDim.x * (B1_THREADS / 32) * B1_TILES;
  for (int t0 = (blockIdx.x * (B1_THREADS / 32) + (threadIdx.x >> 5)) * B1_TILES; t0 < tiles; t0 += step) {
    uint32_t a[B1_TILES][4];  // tile t0 + u: A rows g (pixel 16 (t0 + u) + g) and g + 8
#pragma unroll
    for (int u = 0; u < B1_TILES; ++u) {
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
        const unsigned short* at = xs + ptrdiff_t(b) * st.b + ptrdiff_t(y0) * st.t + ptrdiff_t(col) * st.f;
        const unsigned short v00 = c_ok && y0_ok ? __ldg(at + dcol) : 0;
        const unsigned short v01 = pair && in && y0_ok ? __ldg(at) : 0;
        const unsigned short v10 = c_ok && y1_ok ? __ldg(at + 2 * st.t + dcol) : 0;
        const unsigned short v11 = pair && in && y1_ok ? __ldg(at + 2 * st.t) : 0;
        a[u][half] = uint32_t(v00) | (uint32_t(v01) << 16);
        a[u][2 + half] = uint32_t(v10) | (uint32_t(v11) << 16);
      }
    }
#pragma unroll
    for (int u = 0; u < B1_TILES; ++u) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_bf16_bias(acc[j], a[u], bw[j][0], bw[j][1], 0.f, 0.f);
      // n-tiles jj (conv row 2ho) and jj + 4 (conv row 2ho + 1) hold channels 8q + 2jj, + 1 of both
      // pixels: accumulator rows g and g + 8
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t v[2] = {0u, 0u};  // channels 8q .. 8q + 3, 8q + 4 .. 8q + 7
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[jj >> 1] |= pooled_code(acc[jj][2 * half + e], acc[jj + 4][2 * half + e], bs[jj][e], inv_s)
                          << (8 * (2 * (jj & 1) + e));
        const int p = 16 * (t0 + u) + g + 8 * half;
        if (p < pixels) *reinterpret_cast<uint2*>(out + size_t(p) * B1_COUT + 8 * q) = make_uint2(v[0], v[1]);
      }
    }
  }
}

cudaError_t launch_block1(const void* x, const float* w, const float* b, float inv_s, void* out, int batch, int h,
                          int width, Strides st, int bf16_mode, cudaStream_t s) {
  const long long pixels = (long long)batch * (h / 2) * width;
  if (pixels == 0) return cudaSuccess;
  if (pixels > 0x7fffffffLL - 64 * B1_TILES) return cudaErrorInvalidValue;  // pixel and unit indices stay in int
  int per_sm = 0;
  cudaError_t err;
  if (bf16_mode) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block1_w8a8_tc, B1_THREADS, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    // persistent: as many blocks as fit at once, each warp walking B1_TILES 16-pixel tiles a trip
    constexpr int per_block = 16 * B1_TILES * (B1_THREADS / 32);
    const long long blocks = (pixels + per_block - 1) / per_block, cap = (long long)per_sm * sm_count();
    block1_w8a8_tc<<<int(blocks < cap ? blocks : cap), B1_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), w, b, inv_s, static_cast<int8_t*>(out), h, width, st, int(pixels),
        make_divisor(uint32_t(width)), make_divisor(uint32_t(h / 2)));
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block1_w8a8_f32, B1_THREADS, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long units = (long long)batch * (h / 2) * ((width + 1) / 2);
    // persistent: as many blocks as fit at once, each warp walking B1_GROUPS 4-unit groups a trip
    constexpr int per_block = 4 * B1_GROUPS * (B1_THREADS / 32);
    const long long blocks = (units + per_block - 1) / per_block, cap = (long long)per_sm * sm_count();
    block1_w8a8_f32<<<int(blocks < cap ? blocks : cap), B1_THREADS, 0, s>>>(
        static_cast<const float*>(x), w, b, inv_s, static_cast<int8_t*>(out), h, width, st, int(units),
        make_divisor(uint32_t((width + 1) / 2)), make_divisor(uint32_t(h / 2)));
  }
  return cudaSuccess;
}

}  // namespace

// x (B, H, W, c_in) int8, wt (9, c_out, c_in) int8, deq and b (c_out,) f32; mode 1 (pooled): out (B, H / 2, W,
// c_out) int8; mode 0 (f32): out (B, H, W, c_out) f32; mode 2 (mean): out (B, W, c_out) f32. (c_in, c_out) is
// (32, 64) or (64, 128): blocks 2 and 3.
extern "C" int dfac_conv_block_w8a8(const void* x, const void* wt, const float* deq, const float* b, float inv_s,
                                    int mode, void* out, int batch, int h, int width, int c_in, int c_out,
                                    void* stream) {
  if (batch < 0 || h < 0 || width < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (c_in == 32 && c_out == 64) {
    err = launch<32, 64>(x, wt, deq, b, inv_s, mode, out, batch, h, width, s);
  } else if (c_in == 64 && c_out == 128) {
    err = launch<64, 128>(x, wt, deq, b, inv_s, mode, out, batch, h, width, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block, bytes (0 for a shape the kernel does not take).
extern "C" int dfac_conv_block_w8a8_smem(int c_in, int c_out) {
  if (c_in == 32 && c_out == 64) return W8Cfg<32, 64>::SMEM;
  if (c_in == 64 && c_out == 128) return W8Cfg<64, 128>::SMEM;
  return 0;
}

// x (B, H, W) f32 or bf16 at element strides (sb, st, sf), w (9, 32) f32 holding values of x's dtype, b (32,)
// f32 -> out (B, H / 2, W, 32) int8.
extern "C" int dfac_block1_w8a8(const void* x, const float* w, const float* b, float inv_s, void* out, int batch,
                                int h, int width, long long sb, long long st, long long sf, int bf16_mode,
                                void* stream) {
  if (batch < 0 || h < 0 || width < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_block1(x, w, b, inv_s, out, batch, h, width, Strides{sb, st, sf}, bf16_mode,
                                        static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
