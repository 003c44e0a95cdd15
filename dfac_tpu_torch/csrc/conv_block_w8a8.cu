// w8a8 CNN2D conv block for Hopper (sm_90a): int8 x int8 -> int32 3x3 SAME
// conv with the folded-BN dequant, bias and ReLU in one epilogue.
//
// Replaces no Pallas kernel: the JAX package runs these convolutions through
// XLA (jax.lax.conv_general_dilated(..., preferred_element_type=jnp.int32),
// dfac_tpu/models/fast_infer_int8.py:188-201, blocks 2 and 3 of _w8a8_chain).
// No PyTorch convolution takes int8 on CUDA, and a patch matrix through
// torch._int_mm would write 9x the activation and could not fuse the
// epilogue, so the block is a kernel of its own.
//
// Layout: x (B, H, W, Cin) int8 NHWC; wt (9, Cout, Cin) int8, the HWIO
// kernel with each tap's rows transposed to (cout, cin) by the wrapper, so
// that a row of K is contiguous; deq, b (Cout,) f32. Two modes:
//  * quantized (block 2): h = relu(acc * deq + b), q = min(rne(h * inv_s),
//    127) as int8, then the int8 time pool (q0 + q1 + 1) >> 1 of conv rows
//    2p and 2p + 1 -> out (B, H / 2, W, Cout) int8 (an odd last conv row is
//    dropped after the conv, so it still served as the halo of the row
//    before it);
//  * f32 (block 3): relu(acc * deq + b) -> out (B, H, W, Cout) f32.
// The epilogue multiplies and adds with __fmul_rn / __fadd_rn, so that nvcc
// cannot contract it into an FMA, and quantizes with __float2int_rn (round
// half to even): with those the kernel equals its plain version
// (ops/conv_block_w8a8.py::reference_conv_block_w8a8) bit for bit.
//
// What bounds it on the card, at the serving shapes (B = 128, W = 180;
// 1,979 TOP/s dense int8 on the tensor cores, 3.35 TB/s):
//  * block 2 (32 -> 64, 160 -> 80 rows): 136 GOP, 0.069 ms, against 118 MB
//    read and 118 MB written, 0.070 ms: bytes and operations even;
//  * block 3 (64 -> 128, 80 rows): 272 GOP, 0.137 ms, against 118 MB read
//    and 943 MB of f32 written, 0.317 ms: bytes.
//
// Design (a first kernel: right and simple, on mma.sync; wgmma and TMA are
// later work):
//  * implicit GEMM, M = output pixels, N = Cout, K = 9 taps x Cin, on
//    mma.sync m16n8k32 s8 x s8 -> s32. A m16 tile is 8 columns of a pair of
//    conv rows (rows 0-7 the upper row, 8-15 the lower), so a thread holds
//    both rows of its pixel's pool pair in its accumulators (c0/c2, c1/c3)
//    and pools in registers.
//  * 256 threads, one block per SM, persistent: the block keeps every
//    weight in shared memory for its life ((9, Cout) rows of Cin bytes,
//    padded by 16 bytes) and walks tiles of 2 * RP conv rows x 64 columns
//    in a grid-stride loop through two halo buffers ((2 RP + 2) x 66
//    pixels, Cin + 16 bytes a pixel), the next tile's halo copied by
//    cp.async (16 bytes a copy, SAME padding from the copy's zero fill)
//    while the current one computes.
//  * each warp computes 4 m16 tiles x 64 channels (128 int32 accumulators
//    a thread); per k32 step it loads A by 4 ldmatrix.x4 and B by 4, for 32
//    mma. The 16-byte padding of a pixel (48 or 80 bytes) and of a weight
//    row puts the 8 rows of every ldmatrix phase on 8 distinct bank quads.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using dfac::cp_async16;
using dfac::cp_async_commit;
using dfac::cp_async_wait;
using dfac::ldsm_x4;
using dfac::smem_u32;

constexpr int W8_THREADS = 256;
constexpr int W8_TW = 64;  // tile columns: 8 groups of 8
constexpr int W8_MT = 4;   // m16 tiles a warp
constexpr int W8_NT = 8;   // n8 tiles a warp: 64 output channels

template <int CIN, int COUT>
struct W8Cfg {
  static_assert(CIN % 32 == 0 && COUT % 64 == 0, "Cin a multiple of 32, Cout of 64");
  static constexpr int PS = CIN + 16;        // halo pixel stride, bytes
  static constexpr int WS = CIN + 16;        // weight row stride, bytes
  static constexpr int WN = COUT / 64;       // warps across N
  static constexpr int WM = 8 / WN;          // warps across M
  static constexpr int RP = WM * W8_MT / 8;  // conv row pairs a tile
  static constexpr int HALO_ROWS = 2 * RP + 2;
  static constexpr int HALO_COLS = W8_TW + 2;
  static constexpr int HALO_BYTES = HALO_ROWS * HALO_COLS * PS;
  static constexpr int W_BYTES = 9 * COUT * WS;
  static constexpr int SMEM = W_BYTES + 2 * HALO_BYTES + 2 * COUT * 4;  // + deq and b
  static constexpr int KC = CIN / 32;        // k32 steps a tap
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// relu(acc * deq + b), rounded as two separate f32 operations
__device__ __forceinline__ float dequant(int acc, float deq, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), deq), b), 0.0f);
}

__device__ __forceinline__ int quant(float h, float inv_s) { return min(__float2int_rn(__fmul_rn(h, inv_s)), 127); }

struct Geo {
  int batch, h, w, row_tiles, col_tiles, tiles;
};

template <int CIN, int COUT>
__device__ __forceinline__ void copy_halo(const int8_t* __restrict__ x, uint32_t dst, const Geo& g, int tile) {
  using C = W8Cfg<CIN, COUT>;
  constexpr int PARTS = CIN / 16;
  const int per_img = g.row_tiles * g.col_tiles;
  const int b = tile / per_img, rem = tile % per_img;
  const int row0 = (rem / g.col_tiles) * 2 * C::RP, col0 = (rem % g.col_tiles) * W8_TW;
  for (int i = threadIdx.x; i < C::HALO_ROWS * C::HALO_COLS * PARTS; i += W8_THREADS) {
    const int pix = i / PARTS, part = i % PARTS;
    const int hr = pix / C::HALO_COLS, hc = pix % C::HALO_COLS;
    const int row = row0 - 1 + hr, col = col0 - 1 + hc;
    const bool in = row >= 0 && row < g.h && col >= 0 && col < g.w;
    const int8_t* src = in ? x + ((size_t(b) * g.h + row) * g.w + col) * CIN + part * 16 : x;
    cp_async16(dst + pix * C::PS + part * 16, src, in ? 16 : 0);
  }
}

template <int CIN, int COUT, bool QUANT>
__global__ void __launch_bounds__(W8_THREADS, 1)
    conv_block_w8a8(const int8_t* __restrict__ x, const int8_t* __restrict__ wt, const float* __restrict__ deq,
                    const float* __restrict__ bias, float inv_s, void* __restrict__ out, Geo g) {
  using C = W8Cfg<CIN, COUT>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s_w = smem_u32(smem);
  const uint32_t s_halo = s_w + C::W_BYTES;
  float* s_deq = reinterpret_cast<float*>(smem + C::W_BYTES + 2 * C::HALO_BYTES);
  float* s_b = s_deq + COUT;

  // every weight, once; then the first tile's halo
  for (int i = threadIdx.x; i < 9 * COUT * (CIN / 16); i += W8_THREADS) {
    const int row = i / (CIN / 16), part = i % (CIN / 16);
    cp_async16(s_w + row * C::WS + part * 16, wt + size_t(row) * CIN + part * 16, 16);
  }
  for (int i = threadIdx.x; i < COUT; i += W8_THREADS) {
    s_deq[i] = deq[i];
    s_b[i] = bias[i];
  }
  if (blockIdx.x < g.tiles) copy_halo<CIN, COUT>(x, s_halo, g, blockIdx.x);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp % C::WN, wm = warp / C::WN;
  const int rp = wm * W8_MT / 8, cg0 = wm * W8_MT % 8;  // the warp's row pair and first column group
  const int q = lane >> 3, r = lane & 7;                // ldmatrix: matrix and row this lane addresses
  const int gid = lane >> 2, tig = lane & 3;            // mma: group and thread in group
  // A: rows 0-7 of a m16 tile the upper conv row, 8-15 the lower; matrices 2 and 3 the upper 16 bytes of K
  const uint32_t a_lane = ((2 * rp + (q & 1)) * C::HALO_COLS + cg0 * 8 + r) * C::PS + (q >> 1) * 16;
  // B: matrices 0 and 1 the K halves of n-tile 2j, 2 and 3 those of n-tile 2j + 1
  const uint32_t b_lane = (wn * 64 + (q >> 1) * 8 + r) * C::WS + (q & 1) * 16;
  const int per_img = g.row_tiles * g.col_tiles;

  int buf = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < g.tiles) copy_halo<CIN, COUT>(x, s_halo + (buf ^ 1) * C::HALO_BYTES, g, next);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's halo (and, the first time, the weights) landed
    __syncthreads();

    int acc[W8_MT][W8_NT][4];
#pragma unroll
    for (int i = 0; i < W8_MT; ++i)
#pragma unroll
      for (int j = 0; j < W8_NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    const uint32_t a_base = s_halo + buf * C::HALO_BYTES + a_lane;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t a_tap = a_base + ((tap / 3) * C::HALO_COLS + tap % 3) * C::PS;
      const uint32_t b_tap = s_w + tap * COUT * C::WS + b_lane;
#pragma unroll
      for (int kc = 0; kc < C::KC; ++kc) {
        uint32_t a[W8_MT][4];
#pragma unroll
        for (int i = 0; i < W8_MT; ++i) ldsm_x4(a_tap + i * 8 * C::PS + kc * 32, a[i]);
#pragma unroll
        for (int j = 0; j < W8_NT / 2; ++j) {
          uint32_t bq[4];
          ldsm_x4(b_tap + j * 16 * C::WS + kc * 32, bq);
#pragma unroll
          for (int i = 0; i < W8_MT; ++i) {
            mma_s8(acc[i][2 * j], a[i], bq[0], bq[1]);
            mma_s8(acc[i][2 * j + 1], a[i], bq[2], bq[3]);
          }
        }
      }
    }

    // epilogue: thread (gid, tig) holds, for m-tile i and n-tile j, pixel column cg * 8 + gid of the
    // upper (e = 0, 1) and lower (e = 2, 3) conv row, channels co and co + 1
    const int b = tile / per_img, rem = tile % per_img;
    const int pair0 = (rem / g.col_tiles) * C::RP + rp, col0 = (rem % g.col_tiles) * W8_TW;
#pragma unroll
    for (int i = 0; i < W8_MT; ++i) {
      const int col = col0 + (cg0 + i) * 8 + gid;
      if (col >= g.w) continue;
      if (QUANT) {
        if (pair0 >= g.h / 2) continue;
        uint16_t* o = reinterpret_cast<uint16_t*>(static_cast<int8_t*>(out) +
                                                  ((size_t(b) * (g.h / 2) + pair0) * g.w + col) * COUT);
#pragma unroll
        for (int j = 0; j < W8_NT; ++j) {
          const int co = wn * 64 + j * 8 + 2 * tig;
          int p2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d = s_deq[co + e], bb = s_b[co + e];
            const int q0 = quant(dequant(acc[i][j][e], d, bb), inv_s);
            const int q1 = quant(dequant(acc[i][j][e + 2], d, bb), inv_s);
            p2[e] = (q0 + q1 + 1) >> 1;
          }
          o[co / 2] = uint16_t((p2[0] & 0xff) | ((p2[1] & 0xff) << 8));
        }
      } else {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 2 * pair0 + half;
          if (row >= g.h) continue;
          float* o = static_cast<float*>(out) + ((size_t(b) * g.h + row) * g.w + col) * COUT;
#pragma unroll
          for (int j = 0; j < W8_NT; ++j) {
            const int co = wn * 64 + j * 8 + 2 * tig;
            float2 v;
            v.x = dequant(acc[i][j][2 * half], s_deq[co], s_b[co]);
            v.y = dequant(acc[i][j][2 * half + 1], s_deq[co + 1], s_b[co + 1]);
            *reinterpret_cast<float2*>(o + co) = v;
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this halo before the next copy into it
    buf ^= 1;
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

template <int CIN, int COUT>
cudaError_t launch(const void* x, const void* wt, const float* deq, const float* b, float inv_s, int quantized,
                   void* out, int batch, int h, int w, cudaStream_t s) {
  using C = W8Cfg<CIN, COUT>;
  Geo g;
  g.batch = batch;
  g.h = h;
  g.w = w;
  const int pairs = quantized ? h / 2 : (h + 1) / 2;
  g.row_tiles = (pairs + C::RP - 1) / C::RP;
  g.col_tiles = (w + W8_TW - 1) / W8_TW;
  const long long tiles = (long long)batch * g.row_tiles * g.col_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  g.tiles = int(tiles);
  if (g.tiles == 0) return cudaSuccess;
  auto kernel = quantized ? conv_block_w8a8<CIN, COUT, true> : conv_block_w8a8<CIN, COUT, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int grid = g.tiles < sm_count() ? g.tiles : sm_count();
  kernel<<<grid, W8_THREADS, C::SMEM, s>>>(static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt), deq, b,
                                           inv_s, out, g);
  return cudaSuccess;
}

}  // namespace

// x (B, H, W, c_in) int8, wt (9, c_out, c_in) int8, deq and b (c_out,) f32; quantized: out (B, H / 2, W,
// c_out) int8, else (B, H, W, c_out) f32. (c_in, c_out) is (32, 64) or (64, 128): blocks 2 and 3.
extern "C" int dfac_conv_block_w8a8(const void* x, const void* wt, const float* deq, const float* b, float inv_s,
                                    int quantized, void* out, int batch, int h, int width, int c_in, int c_out,
                                    void* stream) {
  if (batch < 0 || h < 0 || width < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (c_in == 32 && c_out == 64) {
    err = launch<32, 64>(x, wt, deq, b, inv_s, quantized, out, batch, h, width, s);
  } else if (c_in == 64 && c_out == 128) {
    err = launch<64, 128>(x, wt, deq, b, inv_s, quantized, out, batch, h, width, s);
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
