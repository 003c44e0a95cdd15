// Conv-formulation probe checksums for Hopper (sm_90a): K6 and K9.
//
// Replaces: scripts/train_opt_probe.py  stage 13's kern_g (:1108), kern_h
// (:1123), kern_i (:1136), kern_j (:1154) and kern_k (:1166), launched by
// run (:1179-1189); and scripts/pallas_err_probe.py  kern_g (:44), kern_i
// (:60), kern_j (:69), kern_k (:82), launched by run (:96-106), which are
// the same four kernels on the same inputs. Each forms every output of a
// conv in f32 from bf16 operands and writes the per-sample sum of them into
// out[b, :, :] (8 x 128 f32):
//   g  y[t,f,co] = sum_k x[t+dy, (f+dx-1) mod Fp] * w9[k,co]   t<rows, f<Fp   (roll taps)
//   h  y[t,f,co] = sum_k x[t+dy, f+dx] * w9[k,co]              t<rows, f<cols (slice taps)
//   i  y[t,f,co] = sum_k p[t,f,k] * w9[k,co]                   all of p
//   j  y[t,f,co] = sum_{dy,dx,ci} h[t+dy, f+dx, ci] * w2[3dy+dx,ci,co]        f<cols
//   k  as j with the column (f+dx-1) mod F2p, f<F2p                          (roll)
// with k = 3 dy + dx. pltpu.roll is np.roll, so the roll taps wrap around
// the padded width; they are not zero-padded. The checksum factors
// algebraically; the kernels do not use that: every y is formed and summed,
// because the probe exists to time the conv's work.
//
// What bounds it on the card, at stage 13's B=512: g/h read 88 MB of x
// (~26 us at 3.35 TB/s) against 24 / 12 GFLOP (~24 / 12 us at the 989
// TFLOP/s bf16 peak); i reads 755 MB of patches (~0.23 ms); j and k are
// 0.53 and 0.58 TFLOP (~0.54 / 0.59 ms at the bf16 peak).
//
// Design:
//  * g, h, i (K = 9, N = 32): too thin for the tensor cores. One block per
//    8 output rows of a sample stages its input rows (x: 10 rows of the
//    full padded width, so the wrap is an index mod Fp in shared memory;
//    p: the tile's 8 x cols x 9 patches) with 16-byte loads, and keeps the
//    9 x N weights in shared memory as f32. A thread holds the 36 taps of
//    4 pixels of one column in registers and forms their N outputs, 36
//    multiply-adds per 9 broadcast weight loads.
//  * j, k (K = 9 x 32, N = 64): implicit GEMM on the tensor cores with
//    mma.sync m16n8k16 (mma_bf16.cuh), the tiling of conv_block.cu: a tile
//    is 2 output rows x 64 columns, its 4 x 66 input pixels sit in shared
//    memory (for k the 66 columns are taken mod F2p, so the wrap costs
//    nothing inside the loop), and the weights stay in shared memory while
//    a block walks over its sample's tiles. Each warp sums its accumulators
//    where the epilogue of conv_block.cu would store them.
//  * One launch, deterministic sums: each block reduces its threads in a
//    fixed order into its slot of out[b] (a sample has at most 1024
//    blocks) and counts itself done in done[b]; the last block of sample b
//    to finish adds the slots in a fixed order (one warp, then a shuffle
//    tree) and fills out[b] with the total. No float atomics, so a call
//    repeats bit for bit.
//  * Optionally (tests) every y is written to a (B, rows, cols, N) f32
//    buffer as it is formed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dfac::ld32;
using dfac::mma_bf16;

constexpr int THREADS = 256;
constexpr int OUT_PER_SAMPLE = 8 * 128;  // the checksum's (8, 128) block
enum Case { G_ROLL = 0, H_SLICE = 1, I_PATCHES = 2, J_SLICE = 3, K_ROLL = 4 };

// Sum of `v` over the block, in a fixed order; the total is valid in thread 0.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
  return total;
}

// Called by every thread of a block of sample blockIdx.y with its sum
// `total` (valid in thread 0): store it in the block's slot of out[b]; the
// block that finishes last sums the slots in a fixed order and fills out[b].
__device__ void finish_sample(float total, float* out, unsigned int* done) {
  __shared__ bool last;
  __shared__ float s_total;
  float* ob = out + size_t(blockIdx.y) * OUT_PER_SAMPLE;
  if (threadIdx.x == 0) {
    ob[blockIdx.x] = total;
    __threadfence();  // the slot is visible before the count says so
    last = atomicAdd(done + blockIdx.y, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  if (threadIdx.x < 32) {  // lane l adds slots l, l + 32, ... in order, then a fixed shuffle tree
    __threadfence();
    float sum = 0.f;
    for (unsigned int i = threadIdx.x; i < gridDim.x; i += 32) sum += __ldcg(ob + i);  // from L2, past L1
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (threadIdx.x == 0) s_total = sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < OUT_PER_SAMPLE; i += THREADS) ob[i] = s_total;
}

// Copy `n` bf16 from global to shared memory, 16 bytes a step when both
// ends allow it; elements past `valid` are zero.
__device__ void stage(bf16* dst, const bf16* src, int n, int valid, bool vec) {
  if (vec && valid == n) {
    for (int i = threadIdx.x; i < n / 8; i += THREADS)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = i < valid ? src[i] : __float2bfloat16_rn(0.f);
  }
}

// ---- g, h, i: CUDA cores --------------------------------------------------

constexpr int R1 = 8;   // output rows per block
constexpr int PX = 4;   // pixels (rows of one column) per thread step

size_t conv1_smem(int mode, int f_in, int cols, int n_out) {
  const size_t in = mode == I_PATCHES ? size_t(R1) * cols * 9 : size_t(R1 + 2) * f_in;
  return (in * sizeof(bf16) + 15) / 16 * 16 + size_t(9) * n_out * sizeof(float);
}

// in: x (B, t_in, f_in) for g/h, p (B, rows, cols, 9) for i; w (9, n_out).
template <int MODE>
__global__ void __launch_bounds__(THREADS)
conv1_checksum(const bf16* __restrict__ in, const bf16* __restrict__ w, float* __restrict__ out,
               float* __restrict__ y, unsigned int* __restrict__ done, int t_in, int f_in, int rows, int cols,
               int n_out, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_in = reinterpret_cast<bf16*>(smem);
  const size_t in_elems = MODE == I_PATCHES ? size_t(R1) * cols * 9 : size_t(R1 + 2) * f_in;
  float* s_w = reinterpret_cast<float*>(smem + (in_elems * sizeof(bf16) + 15) / 16 * 16);
  const int b = blockIdx.y, r0 = blockIdx.x * R1;

  for (int i = threadIdx.x; i < 9 * n_out; i += THREADS) s_w[i] = __bfloat162float(w[i]);
  if (MODE == I_PATCHES) {
    const int n = R1 * cols * 9;
    const int valid = min(rows - r0, R1) * cols * 9;
    stage(s_in, in + (size_t(b) * rows + r0) * cols * 9, n, valid, vec);
  } else {
    const int n = (R1 + 2) * f_in;
    const int valid = max(0, min(t_in - r0, R1 + 2)) * f_in;
    stage(s_in, in + (size_t(b) * t_in + r0) * f_in, n, valid, vec);
  }
  __syncthreads();

  float acc = 0.f;
  for (int g = threadIdx.x; g < cols * (R1 / PX); g += THREADS) {
    const int c = g % cols, rr = (g / cols) * PX;  // column, first local row
    float tap[PX][9];
    if (MODE == I_PATCHES) {
#pragma unroll
      for (int p = 0; p < PX; ++p)
#pragma unroll
        for (int k = 0; k < 9; ++k) tap[p][k] = __bfloat162float(s_in[((rr + p) * cols + c) * 9 + k]);
    } else {
      int col[3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        col[dx] = MODE == G_ROLL ? (c + dx - 1 + f_in) % f_in : c + dx;
      float v[PX + 2][3];
#pragma unroll
      for (int r = 0; r < PX + 2; ++r)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) v[r][dx] = __bfloat162float(s_in[(rr + r) * f_in + col[dx]]);
#pragma unroll
      for (int p = 0; p < PX; ++p)
#pragma unroll
        for (int k = 0; k < 9; ++k) tap[p][k] = v[p + k / 3][k % 3];
    }
    float s = 0.f;
    for (int co = 0; co < n_out; ++co) {
      float wk[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) wk[k] = s_w[k * n_out + co];
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        float yv = 0.f;
#pragma unroll
        for (int k = 0; k < 9; ++k) yv = fmaf(tap[p][k], wk[k], yv);
        const int t = r0 + rr + p;
        if (t < rows) {
          s += yv;
          if (y) y[((size_t(b) * rows + t) * cols + c) * n_out + co] = yv;
        }
      }
    }
    acc += s;
  }
  finish_sample(block_sum(acc), out, done);
}

// ---- j, k: tensor cores ---------------------------------------------------

constexpr int CI2 = 32, CO2 = 64;
constexpr int TW = 64;          // output columns per tile
constexpr int IN_ROWS = 4;      // 2 output rows + 2
constexpr int IN_COLS = TW + 2;
constexpr int XS = CI2 + 8;     // smem pixel stride (bf16): conflict-free fragment loads
constexpr int WS = CI2 + 8;     // smem weight row stride, rows = (tap, co)
constexpr int WN = CO2 / 2;     // output channels per warp
constexpr int NFRAG = WN / 8;
constexpr size_t W_BYTES = size_t(9) * CO2 * WS * 2;
constexpr size_t X_BYTES = size_t(IN_ROWS) * IN_COLS * XS * 2;
constexpr size_t SMEM2 = W_BYTES + X_BYTES;
constexpr int MAX_BLOCKS2 = 8;  // blocks per sample: each loads the weights once
static_assert(SMEM2 <= 232448, "227 KB of shared memory per block");

// h (B, t_in, f_in, 32), w (9, 32, 64); y over t < rows, f < cols.
template <bool WRAP>
__global__ void __launch_bounds__(THREADS)
conv2_checksum(const bf16* __restrict__ h, const bf16* __restrict__ w, float* __restrict__ out,
               float* __restrict__ y, unsigned int* __restrict__ done, int t_in, int f_in, int rows, int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem);            // [tap][co][ci + 8]
  bf16* sX = reinterpret_cast<bf16*>(smem + W_BYTES);  // [row][col][ci + 8]
  const int b = blockIdx.y;

  for (int i = threadIdx.x; i < 9 * CI2 * CO2; i += THREADS) {
    const int co = i % CO2, ci = (i / CO2) % CI2, t = i / (CO2 * CI2);
    sW[(t * CO2 + co) * WS + ci] = w[i];
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int cg = warp & 3;   // 16-column group of the tile
  const int nw = warp >> 2;  // half of the output channels
  const int row_tiles = (rows + 1) / 2, col_tiles = (cols + TW - 1) / TW;
  const int n_tiles = row_tiles * col_tiles;
  const bf16* hs = h + size_t(b) * t_in * f_in * CI2;
  float acc_sum = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int cb = tile % col_tiles, p = tile / col_tiles;
    const int y0 = 2 * p, x0 = cb * TW - (WRAP ? 1 : 0);

    __syncthreads();  // weights are in / the previous tile's readers are done
    constexpr int VEC = CI2 / 8;
    for (int i = threadIdx.x; i < IN_ROWS * IN_COLS * VEC; i += THREADS) {
      const int v = i % VEC, pix = i / VEC;
      const int ic = pix % IN_COLS, ir = pix / IN_COLS;
      const int yy = y0 + ir;
      int xc = x0 + ic;
      if (WRAP) xc = (xc % f_in + f_in) % f_in;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (yy < t_in && xc < f_in)
        val = *reinterpret_cast<const uint4*>(hs + (size_t(yy) * f_in + xc) * CI2 + v * 8);
      *reinterpret_cast<uint4*>(sX + pix * XS + v * 8) = val;
    }
    __syncthreads();

    float acc[2][NFRAG][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < NFRAG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;

#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t % 3;
#pragma unroll
      for (int k0 = 0; k0 < CI2; k0 += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bf16* p0 = sX + ((r + dy) * IN_COLS + cg * 16 + gid + dx) * XS + k0 + 2 * tq;
          const bf16* p8 = p0 + 8 * XS;
          a[r][0] = ld32(p0);
          a[r][1] = ld32(p8);
          a[r][2] = ld32(p0 + 8);
          a[r][3] = ld32(p8 + 8);
        }
#pragma unroll
        for (int j = 0; j < NFRAG; ++j) {
          const bf16* pw = sW + (t * CO2 + nw * WN + 8 * j + gid) * WS + k0 + 2 * tq;
          const uint32_t b0 = ld32(pw), b1 = ld32(pw + 8);
          mma_bf16(acc[0][j], a[0], b0, b1);
          mma_bf16(acc[1][j], a[1], b0, b1);
        }
      }
    }

    // accumulator (r, j, 2 hh + e) holds y[2p + r, col, n + e]
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = y0 + r;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < NFRAG; ++j) {
        const int n = nw * WN + 8 * j + 2 * tq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = cb * TW + cg * 16 + gid + 8 * hh;
          if (col >= cols) continue;
          s += acc[r][j][2 * hh] + acc[r][j][2 * hh + 1];
          if (y) {
            float* yp = y + ((size_t(b) * rows + row) * cols + col) * CO2 + n;
            yp[0] = acc[r][j][2 * hh];
            yp[1] = acc[r][j][2 * hh + 1];
          }
        }
      }
    }
    acc_sum += s;
  }
  finish_sample(block_sum(acc_sum), out, done);
}

int blocks_per_sample(int kase, int rows, int cols) {
  if (kase <= I_PATCHES) return (rows + R1 - 1) / R1;
  const int tiles = ((rows + 1) / 2) * ((cols + TW - 1) / TW);
  return tiles < MAX_BLOCKS2 ? tiles : MAX_BLOCKS2;
}

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

}  // namespace

// kase: 0 g, 1 h, 2 i, 3 j, 4 k. in: x (B, t_in, f_in) bf16 for g/h, patches
// (B, rows, cols, 9) for i (t_in = rows, f_in = cols), h (B, t_in, f_in, 32)
// for j/k; w: (9, n_out) for g/h/i, (9, 32, 64) for j/k (n_out = 64); out
// (B, 8, 128) f32; y: null, or (B, rows, cols, n_out) f32 for every output;
// done: B zeroed counters (scratch). 16-byte aligned `in` and `out`. One
// kernel launch on `stream`, no synchronisation; returns cudaGetLastError().
extern "C" int dfac_conv_probe(int kase, const void* in, const void* w, float* out, float* y, void* done_,
                               int batch, int t_in, int f_in, int rows, int cols, int n_out, void* stream) {
  if (kase < 0 || kase > K_ROLL || batch <= 0 || batch > 65535 || rows <= 0 || cols <= 0 || n_out <= 0 ||
      n_out > 1024 || blocks_per_sample(kase, rows, cols) > OUT_PER_SAMPLE ||
      (kase != I_PATCHES && rows + 2 > t_in) || ((kase == H_SLICE || kase == J_SLICE) && cols + 2 > f_in) ||
      ((kase == G_ROLL || kase == K_ROLL) && cols != f_in) || (kase >= J_SLICE && n_out != CO2) ||
      (kase == I_PATCHES && (rows != t_in || cols != f_in)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(in);
  const bf16* wk = static_cast<const bf16*>(w);
  unsigned int* done = static_cast<unsigned int*>(done_);
  const dim3 grid(blocks_per_sample(kase, rows, cols), batch);
  cudaError_t err = cudaSuccess;
  if (kase <= I_PATCHES) {
    const size_t smem = conv1_smem(kase, f_in, cols, n_out);
    const int vec = kase == I_PATCHES ? (cols * 9) % 8 == 0 : f_in % 8 == 0;
    if (kase == G_ROLL) {
      err = set_smem(conv1_checksum<G_ROLL>, smem);
      if (err == cudaSuccess)
        conv1_checksum<G_ROLL><<<grid, THREADS, smem, s>>>(x, wk, out, y, done, t_in, f_in, rows, cols, n_out, vec);
    } else if (kase == H_SLICE) {
      err = set_smem(conv1_checksum<H_SLICE>, smem);
      if (err == cudaSuccess)
        conv1_checksum<H_SLICE><<<grid, THREADS, smem, s>>>(x, wk, out, y, done, t_in, f_in, rows, cols, n_out, vec);
    } else {
      err = set_smem(conv1_checksum<I_PATCHES>, smem);
      if (err == cudaSuccess)
        conv1_checksum<I_PATCHES><<<grid, THREADS, smem, s>>>(x, wk, out, y, done, t_in, f_in, rows, cols, n_out, vec);
    }
  } else if (kase == J_SLICE) {
    err = set_smem(conv2_checksum<false>, SMEM2);
    if (err == cudaSuccess)
      conv2_checksum<false><<<grid, THREADS, SMEM2, s>>>(x, wk, out, y, done, t_in, f_in, rows, cols);
  } else {
    err = set_smem(conv2_checksum<true>, SMEM2);
    if (err == cudaSuccess)
      conv2_checksum<true><<<grid, THREADS, SMEM2, s>>>(x, wk, out, y, done, t_in, f_in, rows, cols);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of the kernel dfac_conv_probe runs for
// this case and geometry, in bytes.
extern "C" int dfac_conv_probe_smem(int kase, int f_in, int cols, int n_out) {
  return kase <= I_PATCHES ? int(conv1_smem(kase, f_in, cols, n_out)) : int(SMEM2);
}
