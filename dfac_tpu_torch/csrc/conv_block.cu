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
// What bounds it on the card: at the serving shapes (B=128, W=180,
// 1->32->64->128 channels) a block does 9 * Cin FLOP pairs per output
// value against 2 bytes in and 2 (or 1 after the pool) bytes out; for
// Cin = 32/64 that is ~300-600 FLOP/byte, near the H100's bf16 ridge, so
// both the tensor cores and the ~0.5 GB of activations per block and batch
// matter. Block 1 (Cin = 1, K = 9) is bound by its output write alone.
//
// Design:
//  * Cin = 32 / 64 in bf16 (blocks 2 and 3): implicit GEMM on the tensor
//    cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). M = output
//    pixels, N = Cout, K = 9 * Cin taken tap by tap. A block keeps all
//    folded weights in shared memory for its whole life and walks over
//    tiles of 2 conv rows x 64 columns (a grid-stride loop), so weights are
//    read from device memory once per block, not once per tile. The two
//    conv rows of a tile are exactly one pooled row: each warp holds the
//    accumulators of both rows for the same pixels and channels, and the
//    pool happens in registers, so the pre-pool tensor never reaches
//    device memory. Shared-memory rows pad by 8 bf16, which makes every
//    32-bit fragment load conflict-free.
//  * Cin = 1 (block 1, K = 9, bf16 or f32): one thread per output pixel
//    computes all of its channels from 12 inputs held in registers and
//    writes them as 16-byte vectors; the tensor cores would idle at K = 9.
//  * Everything else (f32 blocks 2-3, other channel counts): a direct
//    kernel on the CUDA cores, one output value per thread, same epilogue.
//    Correct, not fast: the serving path does not take it.
//  * SAME zero padding on both edges of H and W; W = 180 is not a multiple
//    of the 64-column tile, so the last tile masks its columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps: 4 column groups x 2 halves of Cout
constexpr int TW = 64;        // output columns per tile
constexpr int IN_ROWS = 4;    // 2 conv rows + halo
constexpr int IN_COLS = TW + 2;
constexpr int PAD = 8;        // bf16 per smem row: conflict-free fragment loads

template <int CIN, int COUT>
struct MmaCfg {
  static constexpr int XS = CIN + PAD;  // smem pixel stride (bf16)
  static constexpr int WS = CIN + PAD;  // smem weight row stride, rows = (tap, cout)
  static constexpr int WN = COUT / 2;   // output channels per warp
  static constexpr int NFRAG = WN / 8;  // n8 fragments per warp
  static constexpr size_t W_BYTES = size_t(9) * COUT * WS * 2;
  static constexpr size_t X_BYTES = size_t(IN_ROWS) * IN_COLS * XS * 2;
  static constexpr size_t SMEM = W_BYTES + X_BYTES + COUT * sizeof(float);
  static_assert(CIN % 16 == 0 && COUT % 16 == 0, "mma tiles");
  static_assert(W_BYTES % 16 == 0 && X_BYTES % 16 == 0, "16-byte aligned sections");
  static_assert(SMEM <= 232448, "227 KB of shared memory per block");
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A (16x16 bf16, row) * B (16x8 bf16, col) + D, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(THREADS)
conv_block_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ out,
               int batch, int h, int width, int pool) {
  using C = MmaCfg<CIN, COUT>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem);                    // [tap][cout][cin + PAD]
  bf16* sX = reinterpret_cast<bf16*>(smem + C::W_BYTES);       // [row][col][cin + PAD]
  float* sBias = reinterpret_cast<float*>(smem + C::W_BYTES + C::X_BYTES);

  // folded weights, transposed to (tap, cout, cin) so B fragments are 32-bit loads
  for (int i = threadIdx.x; i < 9 * CIN * COUT; i += THREADS) {
    const int co = i % COUT, ci = (i / COUT) % CIN, t = i / (COUT * CIN);
    sW[(t * COUT + co) * C::WS + ci] = w[i];
  }
  for (int i = threadIdx.x; i < COUT; i += THREADS) sBias[i] = bias[i];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int cg = warp & 3;   // 16-pixel column group of the tile
  const int nw = warp >> 2;  // half of Cout
  const int h_out = pool ? h / 2 : h;
  const int row_tiles = pool ? h / 2 : (h + 1) / 2;
  const int col_tiles = (width + TW - 1) / TW;
  const long long n_tiles = (long long)batch * row_tiles * col_tiles;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int cb = int(tile % col_tiles);
    const int p = int((tile / col_tiles) % row_tiles);
    const int b = int(tile / ((long long)col_tiles * row_tiles));
    const int y0 = 2 * p - 1, x0 = cb * TW - 1;  // input origin of the halo'd tile

    __syncthreads();  // weights are in / the previous tile's readers are done
    constexpr int VEC = CIN / 8;
    for (int i = threadIdx.x; i < IN_ROWS * IN_COLS * VEC; i += THREADS) {
      const int v = i % VEC, pix = i / VEC;
      const int ic = pix % IN_COLS, ir = pix / IN_COLS;
      const int y = y0 + ir, xc = x0 + ic;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (y >= 0 && y < h && xc >= 0 && xc < width)
        val = *reinterpret_cast<const uint4*>(x + ((size_t(b) * h + y) * width + xc) * CIN + v * 8);
      *reinterpret_cast<uint4*>(sX + pix * C::XS + v * 8) = val;
    }
    __syncthreads();

    float acc[2][C::NFRAG][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < C::NFRAG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;

#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t % 3;
#pragma unroll
      for (int k0 = 0; k0 < CIN; k0 += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bf16* p0 = sX + ((r + dy) * IN_COLS + cg * 16 + gid + dx) * C::XS + k0 + 2 * tq;
          const bf16* p8 = p0 + 8 * C::XS;
          a[r][0] = ld32(p0);
          a[r][1] = ld32(p8);
          a[r][2] = ld32(p0 + 8);
          a[r][3] = ld32(p8 + 8);
        }
#pragma unroll
        for (int j = 0; j < C::NFRAG; ++j) {
          const bf16* pw = sW + (t * COUT + nw * C::WN + 8 * j + gid) * C::WS + k0 + 2 * tq;
          const uint32_t b0 = ld32(pw), b1 = ld32(pw + 8);
          mma_bf16(acc[0][j], a[0], b0, b1);
          mma_bf16(acc[1][j], a[1], b0, b1);
        }
      }
    }

    // epilogue: + bias, ReLU, pool the two rows in f32, one cast
#pragma unroll
    for (int j = 0; j < C::NFRAG; ++j) {
      const int n = nw * C::WN + 8 * j + 2 * tq;
      const float b0 = sBias[n], b1 = sBias[n + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = cb * TW + cg * 16 + gid + 8 * hh;
        if (col >= width) continue;
        const float u0 = fmaxf(acc[0][j][2 * hh] + b0, 0.f), u1 = fmaxf(acc[0][j][2 * hh + 1] + b1, 0.f);
        const float l0 = fmaxf(acc[1][j][2 * hh] + b0, 0.f), l1 = fmaxf(acc[1][j][2 * hh + 1] + b1, 0.f);
        if (pool) {
          const __nv_bfloat162 v = __floats2bfloat162_rn((u0 + l0) * 0.5f, (u1 + l1) * 0.5f);
          *reinterpret_cast<__nv_bfloat162*>(out + ((size_t(b) * h_out + p) * width + col) * COUT + n) = v;
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out + ((size_t(b) * h_out + 2 * p) * width + col) * COUT + n) =
              __floats2bfloat162_rn(u0, u1);
          if (2 * p + 1 < h)
            *reinterpret_cast<__nv_bfloat162*>(out + ((size_t(b) * h_out + 2 * p + 1) * width + col) * COUT + n) =
                __floats2bfloat162_rn(l0, l1);
        }
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
  const size_t total = size_t(batch) * h_out * width * c_out;
  for (size_t i = size_t(blockIdx.x) * THREADS + threadIdx.x; i < total; i += size_t(gridDim.x) * THREADS) {
    const int co = int(i % c_out);
    size_t r = i / c_out;
    const int col = int(r % width);
    r /= width;
    const int ho = int(r % h_out);
    const int b = int(r / h_out);
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
          for (int ci = 0; ci < c_in; ++ci) acc = fmaf(to_f32(xp[ci]), to_f32(wp[size_t(ci) * c_out]), acc);
        }
      }
      res += fmaxf(acc + bias[co], 0.f);
    }
    out[i] = from_f32<T>(pool ? res * 0.5f : res);
  }
}

// Cin = 1 (block 1, K = 9): one thread per output pixel computes all its
// channels, 8 at a time, from 12 input values held in registers, and writes
// them as 16-byte vectors. Bound by that output write.
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
cudaError_t launch_mma(const void* x, const void* w, const float* b, void* out, int batch, int h,
                       int width, int pool, cudaStream_t s) {
  using C = MmaCfg<CIN, COUT>;
  auto kern = conv_block_mma<CIN, COUT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, C::SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long row_tiles = pool ? h / 2 : (h + 1) / 2;
  const long long tiles = (long long)batch * row_tiles * ((width + TW - 1) / TW);
  const int grid = int(tiles < (long long)per_sm * sm_count() ? tiles : (long long)per_sm * sm_count());
  kern<<<grid, THREADS, C::SMEM, s>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w), b,
                                       static_cast<bf16*>(out), batch, h, width, pool);
  return cudaSuccess;
}

template <typename T>
void launch_direct(const void* x, const void* w, const float* b, void* out, int batch, int h, int width,
                   int c_in, int c_out, int pool, cudaStream_t s) {
  const size_t total = size_t(batch) * (pool ? h / 2 : h) * width * c_out;
  const size_t want = (total + THREADS - 1) / THREADS, cap = size_t(sm_count()) * 32;
  conv_block_direct<T><<<int(want < cap ? want : cap), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), b, static_cast<T*>(out), batch, h, width, c_in,
      c_out, pool);
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
    err = launch_mma<32, 64>(x, w, b, out, batch, h, width, pool, s);
  } else if (bf16_mode && c_in == 64 && c_out == 128) {
    err = launch_mma<64, 128>(x, w, b, out, batch, h, width, pool, s);
  } else if (c_in == 1 && c_out % 8 == 0) {
    err = bf16_mode ? launch_cin1<bf16>(x, w, b, out, batch, h, width, c_out, pool, s)
                    : launch_cin1<float>(x, w, b, out, batch, h, width, c_out, pool, s);
  } else if (bf16_mode) {
    launch_direct<bf16>(x, w, b, out, batch, h, width, c_in, c_out, pool, s);
  } else {
    launch_direct<float>(x, w, b, out, batch, h, width, c_in, c_out, pool, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of the kernel dfac_conv_block picks for
// these channel counts, in bytes (0: the direct kernel uses none).
extern "C" int dfac_conv_block_smem(int c_in, int c_out, int bf16_mode) {
  if (bf16_mode && c_in == 32 && c_out == 64) return int(MmaCfg<32, 64>::SMEM);
  if (bf16_mode && c_in == 64 && c_out == 128) return int(MmaCfg<64, 128>::SMEM);
  if (c_in == 1 && c_out % 8 == 0) return 10 * c_out * int(sizeof(float));
  return 0;
}

extern "C" const char* dfac_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
