// Conv-formulation probe checksums for Hopper (sm_90a): K6 to K11.
//
// K6 and K9 (dfac_conv_probe) replace: scripts/train_opt_probe.py  stage
// 13's kern_g (:1108), kern_h (:1123), kern_i (:1136), kern_j (:1154) and
// kern_k (:1166), launched by run (:1179-1189); and
// scripts/pallas_err_probe.py  kern_g (:44), kern_i
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
//  * j, k (K = 9 x 32, N = 64), and f, j2-j5 below: conv2_checksum, an
//    implicit GEMM on wgmma (hopper.cuh), the design of conv_block.cu's
//    conv_block_tc: M = 64 output pixels (2 conv rows x 32 columns), N =
//    CO, K = 9 taps x CI, bf16 operands, f32 accumulators (products exact,
//    no TF32).
//    - Persistent blocks (at most SMs x blocks per SM, never more than one
//      per two tiles) load the weights once each, by 16-byte loads of 8 x 8
//      (ci, co) blocks transposed in registers, into the swizzled K-major
//      (tap, co) rows that wgmma's B descriptor reads (64-byte swizzle at CI
//      = 32, 128-byte at CI = 64); f's and j4's w2dx layout is read in that
//      same fill, no re-layout op.
//    - Each of a block's two warpgroups walks its share of the (sample,
//      tile) pairs, a contiguous range, down each 32-column strip (a tile
//      shares two halo rows with the one before it, still in L2), through a
//      cp.async ring of its own 4 x 34 halo tiles (16-byte copies, zero
//      fill past the input; for k each copy's source column is taken mod
//      F2p, so the wrap costs nothing inside the loop). A comes by
//      ldmatrix.x4 (a tap shift starts its window at any pixel, off the
//      8-row pattern an A descriptor's swizzle needs), one wgmma m64nCOk16
//      per k16 step, A double-buffered across taps; the next tile's copies
//      are issued once the first tap's wgmmas fly.
//    - What bounds it: the tensor cores' work and the copies, A loads,
//      barriers and sums share the warpgroups' issue slots (taking either
//      out leaves most of the time: PERF.md §6).
//    - Shared with conv_block_tc through hopper.cuh: the swizzled weight
//      rows (w_off) and the named barriers. Its own: the block shape
//      (Conv2Cfg: no bias, more stages) and the halo copies (HaloCopies:
//      k's wrapped source column, indices stepped per lane).
//    - No store epilogue: each thread sums its valid accumulators (row <
//      rows, col < cols) where conv_block_tc would store them.
//  * One launch, deterministic sums. g, h, i: each block reduces its
//    threads in a fixed order into its slot of out[b] (a sample has at
//    most 1024 blocks) and counts itself done in done[b]; the last block
//    of sample b to finish adds the slots in a fixed order (one warp, then
//    a shuffle tree) and fills out[b] with the total. conv2_checksum does
//    the same per tile: a tile's sum (threads, a shuffle tree, then its
//    four warps in order) goes to slot out[b][tile of b] (a sample has at
//    most 1024 tiles; the entries refuse more), done[b] counts tiles (one
//    fence and count per warpgroup's run of a sample's tiles: a fence per
//    tile stalls the warpgroup at every tile), and the warp that counts a
//    sample's last tiles adds its slots in order. No float atomics: a call
//    repeats bit for bit, and a sample's sum does not depend on its batch
//    or on the grid.
//  * Optionally (tests) every y is written to a (B, rows, cols, N) f32
//    buffer as it is formed.
//
// K7 and K8 (dfac_conv_pass) replace: scripts/train_opt_probe.py  stage
// 11's kern_v0..v4 (:845-901, launched by run :903-919) and stage 12's
// kern_a (:974), kern_c (:989), kern_d (:1001) and kern_f (:1021),
// launched by run (:1038-1048). x (B, T, F), w9 (9, 32), k = 3 dy + dx:
//   v0  sum x + sum x^2 per sample                            (no conv)
//   v1  y[t,f,co] = sum_k xp[t+dy, f+dx] w9[k,co], t<T, f<F   (SAME: xp is x zero-padded by 1)
//   v2  as v1, on the tensor cores
//   v3  as v2, summed over each group of 8 samples; a tail of < 8 samples is dropped
//   v4  SAME conv -> y 1.01 + 0.01 -> ReLU -> mean of rows 2t, 2t+1 (t < T/2) -> bf16 (B, T/2, F, 32)
//   a   y[t,f,co] = sum_k x[t+dy, f+dx] w9[k,co], t<T-2, f<F-2  (VALID), tensor cores
//   c   y[m,co] = sum_k xf[min(dy W + dx, 2W) + m] w9[k,co], m < Np - 2W, on the flat padded
//       sample xf (Np = (T+2) W, W = F+2); jax.lax.dynamic_slice clamps its start so that
//       the slice fits, so taps 7 and 8 read tap 6's window. Tensor cores
//   d   a's y on the CUDA cores: the h kernel above at rows T-2, cols F-2
//   f   conv2 of h1 (B, T2+2, F+2, 32) with w2dx (3, 96, 64), w[3dy+dx][ci][co] =
//       w2dx[dx][32 dy + ci][co]: the j kernel above, reading w2dx's layout as it stages
//       the weights (one launch, no re-layout op)
//
// What bounds K7/K8 on the card, at the probe's B=512, T=321, F=180: every
// case but v4 and f reads ~59 MB of x (~18 us at 3.35 TB/s) for 8.4-8.6e9
// MACs (~17 us at the 989 TFLOP/s bf16 peak), so bytes and operations are
// nearly even; on the CUDA cores (v1, d) the f32 FMA rate (67 TFLOP/s)
// makes them ~0.25 ms of arithmetic. v4 writes 944 MB (~0.28 ms); f is
// 0.54 TFLOP (~0.55 ms at the bf16 peak).
//
// Design (K7/K8):
//  * v1 and d: the CUDA-core conv1 kernel of g/h; v1 adds a SAME mode that
//    stages its rows zero-padded (R1 + 2 rows of F + 2 columns, the rows
//    above and below the sample zero), so the inner loop is h's.
//  * v2, v3, a, c: one tensor-core kernel, mma.sync m16n8k16 with K = 9
//    padded to 16 by zero weight rows (exact). A block stages its input
//    window in shared memory (SAME: 10 zero-padded rows; VALID: 10 rows;
//    flat: a 2048-output chunk plus its 2W-element reach); each warp takes
//    16 consecutive outputs of a row as the M tile, builds its A fragment
//    from the window (thread (gid, tq) reads taps 2tq, 2tq + 1 and, for
//    tq = 0, tap 8 of pixels gid and gid + 8), and multiplies it by the
//    four 8-channel B fragments it keeps in registers. For v3 a block's
//    rows run across the group's 8 samples (virtual row v is row v mod T of
//    sample v / T), and a tap in a row of another sample reads zero. The
//    K padding wastes 7/16 of the tensor-core work, which is not the limit:
//    the fragment build is.
//  * v4: one thread per pooled pixel holds its 4 x 3 inputs in registers
//    and forms the two conv rows of all 32 channels with f32 FMAs, then
//    the affine, ReLU and the pool in f32 and one cast, written as 16-byte
//    vectors (the style of conv_block.cu's Cin = 1 kernel): the write bounds it.
//  * v0: 4-byte (bf16 pair) loads, f32 sums, the checksum reduction below.
//  * Every checksum case ends in finish_sample: one launch, a result that
//    repeats bit for bit.
//
// K10 and K11 (dfac_conv_chunk, and dfac_conv_probe's j) replace:
// scripts/train_opt_probe.py  stage 14's kern_h2 (:1248), kern_i2 (:1266)
// and kern_j2 (:1288), launched by run (:1304-1314); stage 15's make_convk
// (:1355, as j3 at :1426 and j5 at :1440), make_conv_inter (:1375, as j4)
// and kern_c2 (:1456), launched by run (:1401-1411). k = 3 dy + dx:
//   h2  y[t,f,co] = sum_k x[t+dy, s_i + j + dx] w9[k,co], f = 128 i + j, j < 128, i < 2, t < 320;
//       s_i = min(128 i, Fp - 130): kern_h2 reads pl.ds(128 fi, 130) of a 256-wide ref
//       (:1251), and JAX's interpreter clamps that read as jax.lax.dynamic_slice clamps a
//       start, so window 1 reads columns 126-255 (Mosaic reads past the block: undefined)
//   i2  y[t,f,co] = sum_k p9[k, t, f] w9[k,co], t < 320, on tap-leading patches (B, 9, 336, 256)
//   j2, j3  stage 13's j (dfac_conv_probe, kase 3)
//   j4  f's y on h1 (B, 176, 192, 32) over t < 160, f < 176 (w2i in w2dx's layout)
//   j5  conv3: y[t,f,co] = sum_{k,ci} h2[t+dy, f+dx, ci] w3[k,ci,co], CI = 64, CO = 128, t < 80, f < 176
//   c2  y[m,co] = sum_{k<16} wt[co,k] tap_k[m], m < 8 x 8,192: chunk c = m / Mc reads tap k < 9
//       at m + min(o_k, L - Mc - c Mc), o_k = dy W + dx, W = 182 (the interpreter's clamp of
//       pl.ds(c Mc + o_k, Mc), :1462: chunk 7 reads all nine taps from L - Mc), taps 9-15 zero
//
// What bounds K10/K11 on the card, at the stages' B=512: h2 reads 84 MB of x
// (~25 us) for 2.4e10 FLOP (~24 us at the 989 TFLOP/s bf16 peak); i2 reads
// 755 MB of patches (~0.23 ms) for the same FLOP, so bytes bound it ~10x
// over operations and the CUDA cores serve; j2-j4 are 0.53 TFLOP each (~0.54
// ms), j5 1.06 TFLOP (~1.08 ms); c2 is 1.9e10 FLOP (~20 us) on 60 MB of xf's
// row 0 (~18 us), not the 967 MB array.
//
// Design (K10/K11): every case reuses a kernel above, so the stage's
// question -- which formulation feeds the matrix unit best -- is asked of
// the same tensor-core (or CUDA-core) code paths:
//  * h2: conv1_mma's VALID mode with output windows: a block stages its 10
//    input rows at full width, and each output column maps to its window's
//    input column (the clamp is index arithmetic; the window is found by
//    comparisons, as a division per pixel cost h2 ~30% per tile). One launch.
//  * i2: conv1_checksum with a tap-plane layout: a block stages rows r0 ..
//    r0 + 7 of each of the 9 planes (9 x 8 x 256 bf16), a thread's 9 vector
//    loads in flight together; the inner loop is i's.
//  * j4: f's kernel (dx layout) with rows and columns given, not T - 2, F - 2.
//  * j5: conv2_checksum at (CI, CO) = (64, 128), wgmma m64n128k16: its
//    weights (147,456 B) and each warpgroup's two halo stages (19,584 B
//    each) fit one block per SM, as conv_block_tc's block 3.
//  * c2: conv1_mma's flat mode in chunks: a block of 2,048 outputs lies in
//    one chunk, and its taps' offsets min(o_k, L - Mc - c Mc) are fixed for
//    the block, so the staged window starts at tap 0's and the clamp costs
//    nothing in the loop; wt (32, 16) is already the kernel's [co][k] layout,
//    and taps 9-15 are the A fragment's zero lanes, so 0 x wt[co, 9..15] is
//    formed as the reference forms it. Only row 0 of each sample is read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace dfac;

using bf16 = __nv_bfloat16;

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
// ends allow it; elements past `valid` are zero. The scalar path loads 8
// values into registers before it stores any, so 8 loads are in flight.
__device__ void stage(bf16* dst, const bf16* src, int n, int valid, bool vec) {
  if (vec && valid == n) {
    for (int i = threadIdx.x; i < n / 8; i += THREADS)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else {
    constexpr int U = 8;
    for (int i0 = threadIdx.x; i0 < n; i0 += U * THREADS) {
      bf16 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = i0 + u * THREADS < valid ? src[i0 + u * THREADS] : __float2bfloat16_rn(0.f);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * THREADS < n) dst[i0 + u * THREADS] = v[u];
    }
  }
}

// Stage the zero-padded rows r0 - 1 .. r0 + R1 of `n_rows` contiguous rows
// of width f_in (a sample, or v3's group of samples) into R1 + 2 rows of
// f_in + 2 columns: each thread loads its column of all rows into registers
// before it stores any, so they are in flight together.
template <int R>
__device__ void stage_padded(bf16* dst, const bf16* rows, int n_rows, int f_in, int r0) {
  const int stride = f_in + 2;
  for (int c = threadIdx.x; c < stride; c += THREADS) {
    const bool col_ok = c >= 1 && c <= f_in;
    bf16 v[R + 2];
#pragma unroll
    for (int j = 0; j < R + 2; ++j) {
      const int t = r0 - 1 + j;
      v[j] = col_ok && t >= 0 && t < n_rows ? rows[size_t(t) * f_in + c - 1] : __float2bfloat16_rn(0.f);
    }
#pragma unroll
    for (int j = 0; j < R + 2; ++j) dst[j * stride + c] = v[j];
  }
}

// ---- g, h, i: CUDA cores --------------------------------------------------

constexpr int R1 = 8;   // output rows per block
constexpr int PX = 4;   // pixels (rows of one column) per thread step
constexpr int SAME_PAD = 5;  // conv1_checksum's zero-padded taps (stage 11's v1)
constexpr int I_PLANES = 6;  // conv1_checksum's tap-leading patches (stage 14's i2)

__host__ __device__ size_t conv1_in_elems(int mode, int f_in, int cols) {
  if (mode == I_PATCHES || mode == I_PLANES) return size_t(R1) * cols * 9;
  return size_t(R1 + 2) * (mode == SAME_PAD ? f_in + 2 : f_in);
}

size_t conv1_smem(int mode, int f_in, int cols, int n_out) {
  return (conv1_in_elems(mode, f_in, cols) * sizeof(bf16) + 15) / 16 * 16 + size_t(9) * n_out * sizeof(float);
}

// Stage rows r0 .. r0 + R1 - 1 of the 9 tap planes of one sample, `plane`
// elements apart, n = R1 x cols elements each (rows past `valid` zero): a
// thread loads its vector of all 9 planes into registers before it stores
// any, so they are in flight together.
__device__ void stage_planes(bf16* dst, const bf16* src, size_t plane, int n, int valid, bool vec) {
  if (vec && valid == n) {
    for (int i = threadIdx.x; i < n / 8; i += THREADS) {
      uint4 v[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = reinterpret_cast<const uint4*>(src + k * plane)[i];
#pragma unroll
      for (int k = 0; k < 9; ++k) reinterpret_cast<uint4*>(dst + k * n)[i] = v[k];
    }
  } else {
    for (int k = 0; k < 9; ++k) stage(dst + k * n, src + k * plane, n, valid, false);
  }
}

// in: x (B, t_in, f_in) for g/h/SAME, p (B, rows, cols, 9) for i, p9 (B, 9,
// t_in, f_in) for I_PLANES (cols = f_in); w (9, n_out).
template <int MODE>
__global__ void __launch_bounds__(THREADS)
conv1_checksum(const bf16* __restrict__ in, const bf16* __restrict__ w, float* __restrict__ out,
               float* __restrict__ y, unsigned int* __restrict__ done, int t_in, int f_in, int rows, int cols,
               int n_out, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_in = reinterpret_cast<bf16*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + (conv1_in_elems(MODE, f_in, cols) * sizeof(bf16) + 15) / 16 * 16);
  const int b = blockIdx.y, r0 = blockIdx.x * R1;
  const int stride = MODE == SAME_PAD ? f_in + 2 : f_in;  // of a staged x row

  for (int i = threadIdx.x; i < 9 * n_out; i += THREADS) s_w[i] = __bfloat162float(w[i]);
  if (MODE == I_PATCHES) {
    const int n = R1 * cols * 9;
    const int valid = min(rows - r0, R1) * cols * 9;
    stage(s_in, in + (size_t(b) * rows + r0) * cols * 9, n, valid, vec);
  } else if (MODE == I_PLANES) {  // rows r0 .. r0 + R1 - 1 of each tap plane
    stage_planes(s_in, in + (size_t(b) * 9 * t_in + r0) * f_in, size_t(t_in) * f_in, R1 * cols,
                 max(0, min(t_in - r0, R1)) * cols, vec);
  } else if (MODE == SAME_PAD) {  // rows r0 - 1 .. r0 + R1, a zero column on each side
    stage_padded<R1>(s_in, in + size_t(b) * t_in * f_in, t_in, f_in, r0);
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
    } else if (MODE == I_PLANES) {
#pragma unroll
      for (int p = 0; p < PX; ++p)
#pragma unroll
        for (int k = 0; k < 9; ++k) tap[p][k] = __bfloat162float(s_in[(k * R1 + rr + p) * cols + c]);
    } else {
      int col[3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        col[dx] = MODE == G_ROLL ? (c + dx - 1 + f_in) % f_in : c + dx;
      float v[PX + 2][3];
#pragma unroll
      for (int r = 0; r < PX + 2; ++r)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) v[r][dx] = __bfloat162float(s_in[(rr + r) * stride + col[dx]]);
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

// ---- j, k, f, j2-j5: conv2 / conv3 on wgmma ---------------------------------

constexpr int CI2 = 32, CO2 = 64;   // conv2
constexpr int CI3 = 64, CO3 = 128;  // conv3 (stage 15's j5)
constexpr int WG_THREADS = 128;     // a warpgroup; a block holds two, each walking tiles of its own
constexpr int TW = 32;              // output columns per tile: 2 conv rows x 32 = wgmma's M = 64
constexpr int IN_ROWS = 4;          // 2 conv rows + 2
constexpr int IN_COLS = TW + 2;
constexpr int XPAD = 8;             // bf16 after each halo pixel: conflict-free ldmatrix rows

template <int CI, int CO>
struct Conv2Cfg {
  // halo tiles in each warpgroup's cp.async ring, and blocks per SM: three
  // and two at conv2, two and one at conv3, as many as fit
  static constexpr int STAGES = CO == CO3 ? 2 : 3;
  static constexpr int MIN_BLOCKS = CO == CO3 ? 1 : 2;
  static constexpr int XS = CI + XPAD;     // halo pixel stride (bf16)
  static constexpr int ROW_B = CI * 2;     // weight row (tap, co): CI bf16, 64 or 128 bytes
  static constexpr int KSTEPS = CI / 16;   // wgmma k16 steps per tap
  static constexpr int NACC = CO / 2;      // f32 accumulators per thread: 64 x CO per warpgroup
  static constexpr size_t W_BYTES = size_t(9) * CO * ROW_B;
  static constexpr size_t X_BYTES = size_t(IN_ROWS) * IN_COLS * XS * 2;  // one stage
  static constexpr size_t ALIGN = 1024;  // the 128-byte swizzle repeats every 1024 bytes
  static constexpr size_t SMEM = ALIGN + W_BYTES + 2 * STAGES * X_BYTES;
  static_assert((CI == CI2 && CO == CO2) || (CI == CI3 && CO == CO3), "conv2 (32 -> 64) or conv3 (64 -> 128)");
  static_assert(X_BYTES % 16 == 0, "16-byte aligned stages");
  static_assert(SMEM * MIN_BLOCKS <= 232448, "227 KB of shared memory per SM");
};

// Result slots of a sample: one per tile (a sample has at most OUT_PER_SAMPLE).
int conv2_tiles(int rows, int cols) { return ((rows + 1) / 2) * ((cols + TW - 1) / TW); }

__device__ __forceinline__ uint32_t word(const uint4& v, int m) {
  return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
}

// The weights, once per block, into K-major rows (tap, co) of CI bf16: w (9,
// CI, CO), or with DX_LAYOUT w2dx (3, 3 CI, CO), w[3 dy + dx][ci][co] =
// w2dx[dx][CI dy + ci][co]. A thread takes an 8 x 8 block (8 input channels
// of 8 output channels of one tap) by eight 16-byte loads, transposes it in
// registers and stores 8 chunks of 16 bytes.
template <bool DX_LAYOUT, int CI, int CO>
__device__ void fill_weights(unsigned char* sW, const bf16* __restrict__ w) {
  constexpr int CB = CI / 8, OB = CO / 8;
  for (int blk = threadIdx.x; blk < 9 * CB * OB; blk += THREADS) {
    const int ob = blk % OB, cb = (blk / OB) % CB, t = blk / (OB * CB);
    const int src_row = (DX_LAYOUT ? (t % 3) * 3 + t / 3 : t) * CI + cb * 8;  // input channel cb * 8 of tap t
    uint4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __ldg(reinterpret_cast<const uint4*>(w + size_t(src_row + i) * CO + ob * 8));
#pragma unroll
    for (int c = 0; c < 8; ++c) {  // output channel ob * 8 + c: the low (even c) or high half of word c / 2
      const uint32_t sel = c & 1 ? 0x7632u : 0x5410u;
      const uint4 o = make_uint4(__byte_perm(word(v[0], c / 2), word(v[1], c / 2), sel),
                                 __byte_perm(word(v[2], c / 2), word(v[3], c / 2), sel),
                                 __byte_perm(word(v[4], c / 2), word(v[5], c / 2), sel),
                                 __byte_perm(word(v[6], c / 2), word(v[7], c / 2), sel));
      *reinterpret_cast<uint4*>(sW + w_off<CI>(t * CO + ob * 8 + c, cb)) = o;
    }
  }
}

// The copies of a halo tile, IN_ROWS x IN_COLS pixels of CI channels, by a
// warpgroup: copy i = wt + 128 k of lane wt is 16-byte chunk i % VEC of
// pixel i / VEC. 128 is a multiple of VEC, so a lane's chunk is the same for
// every k and its pixel advances by 128 / VEC: the indices are added, not
// divided (the copies share the warps' issue slots with the tensor loop).
template <bool WRAP, int CI>
struct HaloCopies {
  static constexpr int VEC = CI / 8, XS = CI + XPAD, N = IN_ROWS * IN_COLS * VEC;
  static constexpr int PER = (N + WG_THREADS - 1) / WG_THREADS, PIX_STEP = WG_THREADS / VEC;
  static_assert(PIX_STEP < IN_COLS, "a lane's pixel moves on by less than a halo row");
  int wt, ic0, ir0, chunk;  // the lane, its first pixel's halo column and row, its chunk

  __device__ explicit HaloCopies(int lane) : wt(lane), ic0((lane / VEC) % IN_COLS), ir0(lane / VEC / IN_COLS),
                                             chunk(lane % VEC) {}

  // Input rows y0 .. y0 + 3 and columns x0 .. x0 + 33 of sample hs (t_in x
  // f_in pixels; WRAP: each column taken mod f_in) into `stage`; pixels
  // outside the input are zero-filled.
  __device__ __forceinline__ void issue(uint32_t stage, const bf16* __restrict__ hs, int y0, int x0, int t_in,
                                        int f_in) const {
    int ic = ic0, ir = ir0;
    const uint32_t dst = stage + uint32_t(((ir0 * IN_COLS + ic0) * XS + chunk * 8) * 2);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (k < PER - 1 || wt + k * WG_THREADS < N) {
        int xc = x0 + ic;
        if (WRAP && (xc < 0 || xc >= f_in)) {  // the roll taps, at the edge strips only: no division
          while (xc < 0) xc += f_in;
          while (xc >= f_in) xc -= f_in;
        }
        const int yy = y0 + ir;
        const bool in = yy < t_in && xc < f_in;
        const bf16* src = in ? hs + size_t(yy * f_in + xc) * CI + chunk * 8 : hs;
        cp_async16(dst + uint32_t(k * PIX_STEP * XS * 2), src, in ? 16 : 0);
      }
      ic += PIX_STEP;
      if (ic >= IN_COLS) ic -= IN_COLS, ++ir;
    }
  }
};

// Warp 0 of a warpgroup, every lane: store tile `tile`'s sum (its four
// warps' sums, added in order) in the tile's slot of out[b]. At the end of
// the warpgroup's run of tiles of sample b (`flush`), count the run's
// `run` tiles done in done[b], once: the fence stalls the whole warpgroup,
// too long to pay per tile. The warp that counts a sample's last tiles adds
// the sample's slots in a fixed order (lane l takes slots l, l + 32, ...,
// then a shuffle tree) and fills out[b] with the total. No float atomics:
// the result does not depend on the grid, the batch or the order of the
// tiles.
__device__ void publish(const float* warp_sums, float* out, unsigned int* done, int tile, int tiles_per, int lane,
                        int& run, bool flush) {
  const int b = tile / tiles_per;
  float* ob = out + size_t(b) * OUT_PER_SAMPLE;
  if (lane == 0) ob[tile - b * tiles_per] = ((warp_sums[0] + warp_sums[1]) + warp_sums[2]) + warp_sums[3];
  ++run;
  if (!flush) return;
  unsigned int last = 0;
  if (lane == 0) {
    __threadfence();  // the run's slots are visible before the count says so
    last = atomicAdd(done + b, unsigned(run)) + unsigned(run) == unsigned(tiles_per);
  }
  run = 0;
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  float sum = 0.f;
  for (int i = lane; i < tiles_per; i += 32) sum += __ldcg(ob + i);  // from L2, past L1
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float4 v = make_float4(sum, sum, sum, sum);
  for (int i = lane; i < OUT_PER_SAMPLE / 4; i += 32) reinterpret_cast<float4*>(ob)[i] = v;
}

// h (B, t_in, f_in, CI), w (9, CI, CO) or with DX_LAYOUT w2dx (3, 3 CI, CO);
// y over t < rows, f < cols; n_tiles = B x conv2_tiles(rows, cols), in the
// order (sample, 32-column group, row pair): a tile shares two of its four
// halo rows with the one before it.
template <bool WRAP, bool DX_LAYOUT, int CI, int CO>
__global__ void __launch_bounds__(THREADS, Conv2Cfg<CI, CO>::MIN_BLOCKS)
conv2_checksum(const bf16* __restrict__ h, const bf16* __restrict__ w, float* __restrict__ out,
               float* __restrict__ y, unsigned int* __restrict__ done, int n_tiles, int t_in, int f_in, int rows,
               int cols) {
  using C = Conv2Cfg<CI, CO>;
  constexpr int S = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_sums[2][2][4];  // [warpgroup][tile parity][warp]: a tile's warp sums
  unsigned char* smem = smem_raw + ((C::ALIGN - (smem_u32(smem_raw) & (C::ALIGN - 1))) & (C::ALIGN - 1));
  const uint32_t sW = smem_u32(smem);  // [tap * CO + co][ci], swizzled

  // Warpgroup g = 2 * block + wg walks its share of the tiles, [begin, end),
  // in order, through a ring of its own (S x [row][col][ci + XPAD]).
  const int wg = threadIdx.x / WG_THREADS, wt = threadIdx.x % WG_THREADS;
  const uint32_t ring = sW + uint32_t(C::W_BYTES) + wg * S * uint32_t(C::X_BYTES);
  const int row_tiles = (rows + 1) / 2, tiles_per = row_tiles * ((cols + TW - 1) / TW);
  const long long n_wg = 2LL * gridDim.x, g = 2LL * blockIdx.x + wg;
  const int begin = int(n_tiles * g / n_wg), end = int(n_tiles * (g + 1) / n_wg);
  const HaloCopies<WRAP, CI> copies(wt);
  auto halo = [&](uint32_t stage, int tile) {  // tile's input rows 2p .. 2p + 3, columns cb TW (- 1: WRAP) ..
    const int b = tile / tiles_per, rem = tile - b * tiles_per;
    copies.issue(stage, h + size_t(b) * t_in * f_in * CI, 2 * (rem % row_tiles), (rem / row_tiles) * TW - WRAP,
                 t_in, f_in);
  };
  // the first S - 1 tiles' copies fly while the weights are stored; one group per tile
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (begin + k < end) halo(ring + k * uint32_t(C::X_BYTES), begin + k);
    cp_async_commit();
  }
  fill_weights<DX_LAYOUT, CI, CO>(smem, w);
  fence_proxy_async();  // the weights' ordinary stores, before wgmma (the async proxy) reads them
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;  // warp of the warpgroup
  const int gid = lane >> 2, tq = lane & 3;
  const int px0 = warp * 8;  // this warp's 8 columns of the tile
  // A: warp M row i is conv row i / 8 at column px0 + i % 8. ldmatrix.x4 lane l
  // addresses row l % 8 of matrix l / 8: (rows 0-7, k 0-7), (rows 8-15, k 0-7),
  // (rows 0-7, k 8-15), (rows 8-15, k 8-15), the m16k16 fragment's order.
  const int lq = lane >> 3, lr = lane & 7;
  const uint32_t a_lane = uint32_t((((lq & 1) * IN_COLS + px0 + lr) * C::XS + 8 * (lq >> 1)) * 2);

  // Warpgroup 1 starts once warpgroup 0 is half way through its first tile,
  // so that one's epilogue, copies and barrier fall in the other's wgmmas.
  bool lead = wg == 0;  // warpgroup 0 has yet to release warpgroup 1
  if (wg == 1) stagger_wait();
  if (lead && begin >= end) {
    stagger_release();
    lead = false;
  }
  int s = 0, par = 0;  // this tile's stage and parity
  int run = 0;         // warp 0: slots stored since the last count
  for (int tile = begin; tile < end; ++tile, s = s + 1 == S ? 0 : s + 1, par ^= 1) {
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
        const uint64_t desc = b_desc_kmajor<C::ROW_B>(sW + uint32_t((t * CO) * C::ROW_B + kk * 32));
        if constexpr (CO == 64) wgmma_n64(acc, a[t & 1][kk], desc);
        else wgmma_n128(acc, a[t & 1][kk], desc);
      }
      wgmma_commit();
      if (t == 0) {  // while the tensor cores work: the ring's next copies, the last tile's sum
        if (tile + S - 1 < end) halo(ring + (s == 0 ? S - 1 : s - 1) * uint32_t(C::X_BYTES), tile + S - 1);
        cp_async_commit();
        if (warp == 0 && tile > begin)  // the run of a sample ends where the next tile is another's
          publish(s_sums[wg][par ^ 1], out, done, tile - 1, tiles_per, lane, run, tile % tiles_per == 0);
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

    // acc[4j], acc[4j + 1]: conv row 2p at column col, channels 8j + 2tq, + 1;
    // acc[4j + 2], acc[4j + 3]: conv row 2p + 1. The tile's valid outputs,
    // summed in a fixed order: thread, shuffle tree, then warps 0-3 in publish.
    const int b = tile / tiles_per, rem = tile - b * tiles_per;
    const int cb = rem / row_tiles, p = rem - cb * row_tiles;
    const int row = 2 * p, col = cb * TW + px0 + gid;
    const bool ok0 = col < cols, ok1 = ok0 && row + 1 < rows;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CO / 8; ++j) {
      if (ok0) sum += acc[4 * j] + acc[4 * j + 1];
      if (ok1) sum += acc[4 * j + 2] + acc[4 * j + 3];
    }
    if (y) {
      float* y0 = y + ((size_t(b) * rows + row) * cols + col) * CO + 2 * tq;
      float* y1 = y0 + size_t(cols) * CO;  // conv row 2p + 1
#pragma unroll
      for (int j = 0; j < CO / 8; ++j) {
        if (ok0) *reinterpret_cast<float2*>(y0 + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
        if (ok1) *reinterpret_cast<float2*>(y1 + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) s_sums[wg][par][warp] = sum;
  }
  wg_barrier(wg);  // the last tile's warp sums are in
  if (warp == 0 && begin < end) publish(s_sums[wg][par ^ 1], out, done, end - 1, tiles_per, lane, run, true);
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

// One persistent launch: as many blocks as fit at once, at most one per
// two tiles (a block's two warpgroups walk tiles of their own).
template <bool WRAP, bool DX_LAYOUT, int CI, int CO>
cudaError_t launch_conv2(const bf16* h, const bf16* w, float* out, float* y, unsigned int* done, int batch,
                         int t_in, int f_in, int rows, int cols, cudaStream_t s) {
  using C = Conv2Cfg<CI, CO>;
  auto kern = conv2_checksum<WRAP, DX_LAYOUT, CI, CO>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, C::SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // < 2^31: batch <= 65535 and a sample's tiles <= OUT_PER_SAMPLE, checked by the entries
  const long long tiles = (long long)batch * conv2_tiles(rows, cols);
  const long long pairs = (tiles + 1) / 2, cap = (long long)per_sm * sm_count();
  kern<<<int(pairs < cap ? pairs : cap), THREADS, C::SMEM, s>>>(h, w, out, y, done, int(tiles), t_in, f_in, rows,
                                                                cols);
  return cudaSuccess;
}

int blocks_per_sample(int kase, int rows, int cols) {
  return kase <= I_PATCHES ? (rows + R1 - 1) / R1 : conv2_tiles(rows, cols);
}

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// ---- K7 / K8 (stages 11 and 12) -------------------------------------------

enum Pass { V0_SUMS = 0, V1_SAME_FMA, V2_SAME_MMA, V3_GROUP_MMA, V4_EMIT, A_VALID_MMA, C_FLAT_MMA, D_VALID_FMA,
            F_CONV2_DX };

// v0: out[b] = sum x + sum x^2 over the n elements of sample b.
constexpr int V0_CHUNK = THREADS * 32;  // elements per block

__global__ void __launch_bounds__(THREADS)
sum_sq_checksum(const bf16* __restrict__ x, float* __restrict__ out, unsigned int* __restrict__ done, int n) {
  const bf16* xs = x + size_t(blockIdx.y) * n;
  const int e0 = blockIdx.x * V0_CHUNK, e1 = min(n, e0 + V0_CHUNK);
  float s = 0.f, q = 0.f;
  if (n % 2 == 0) {  // bf16 pairs: every sample starts 4-byte aligned
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(xs);
    for (int i = e0 / 2 + threadIdx.x; i < e1 / 2; i += THREADS) {
      const float2 v = __bfloat1622float2(x2[i]);
      s += v.x + v.y;
      q = fmaf(v.x, v.x, fmaf(v.y, v.y, q));
    }
  } else {
    for (int i = e0 + threadIdx.x; i < e1; i += THREADS) {
      const float v = __bfloat162float(xs[i]);
      s += v;
      q = fmaf(v, v, q);
    }
  }
  finish_sample(block_sum(s + q), out, done);
}

// v2, v3, a, c: conv1 with N = 32 output channels on the tensor cores.
constexpr int CO1 = 32;
constexpr int FLAT_CHUNK = 2048;  // c: outputs per block
enum MmaMode { M_SAME = 0, M_VALID = 1, M_FLAT = 2 };

// Elements of the block's input window in shared memory (after the 16 x 32
// weights). SAME: t_in, f_in are x's; VALID: the same; FLAT: t_in = L, f_in = W
// (a chunk of outputs reaches 2W + 2 further).
size_t conv1_mma_smem(int mode, int f_in) {
  const size_t elems = mode == M_SAME    ? size_t(R1 + 2) * (f_in + 2)
                       : mode == M_VALID ? size_t(R1 + 2) * f_in
                                         : size_t(FLAT_CHUNK) + 2 * size_t(f_in) + 2;
  return (size_t(CO1) * 16 + elems) * sizeof(bf16);
}

// Output blocks per result block: SAME, a sample (or v3's group of `group`
// samples) of t_in rows; VALID, `rows` output rows; FLAT, n_win chunks of
// `win` outputs.
int conv1_mma_blocks(int mode, int t_in, int group, int rows, int win, int n_win) {
  if (mode == M_SAME) return (group * t_in + R1 - 1) / R1;
  if (mode == M_VALID) return (rows + R1 - 1) / R1;
  return n_win * ((win + FLAT_CHUNK - 1) / FLAT_CHUNK);
}

// w: (9, 32), or with W_CO_K (32, 16) read as it is (k = 9..15 meet zero taps).
// SAME: x (B, t_in, f_in); result block blockIdx.y covers samples
//   blockIdx.y * group .. + group - 1 (group = 1 but for v3): (group t_in) x f_in outputs.
// VALID: x (B, t_in, f_in); output rows t < rows and n_win windows of `win`
//   columns; window i reads input columns from min(i win, f_in - win - 2),
//   as jax.lax.dynamic_slice clamps the start of a (win + 2)-wide slice
//   (stage 12's a: one window of f_in - 2; stage 14's h2: two of 128).
// FLAT: the flat padded row of each sample (L = t_in elements, row width W =
//   f_in) starts in_stride elements after the previous one; n_win chunks of
//   `win` outputs; output m of chunk c reads tap k at m + min(dy W + dx, L -
//   win - c win), the start clamped as in VALID (stage 12's c: one chunk of
//   L - 2W; stage 15's c2: eight of 8,192).
// y, when given, is (results, rows, cols, 32) f32.
template <int MODE, bool W_CO_K = false>
__global__ void __launch_bounds__(THREADS)
conv1_mma(const bf16* __restrict__ x, const bf16* __restrict__ w, float* __restrict__ out,
          float* __restrict__ y, unsigned int* __restrict__ done, int t_in, int f_in, int group, int rows,
          int win, int n_win, long long in_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem);  // [co][k]: taps 0-8, then zeros or wt's own k = 9..15
  bf16* sX = sW + CO1 * 16;                  // the block's input window
  const unsigned short* sXu = reinterpret_cast<const unsigned short*>(sX);
  const int bo = blockIdx.y;

  for (int i = threadIdx.x; i < CO1 * 16; i += THREADS) {
    const int co = i / 16, k = i % 16;
    sW[i] = W_CO_K ? w[i] : k < 9 ? w[k * CO1 + co] : __float2bfloat16_rn(0.f);
  }

  // the result block's outputs: n_rows x cols; this block's window starts at
  // output row row0 and, for FLAT (one row of outputs), at column c_base, and
  // holds c_lim columns of outputs
  int stride, n_rows, cols, c_lim, row0 = 0, c_base = 0, flat_lim = 0;
  __shared__ int s_edge[R1];  // SAME: bit 0, output row r is a sample's first row; bit 1, its last
  if (MODE == M_SAME) {
    stride = f_in + 2, n_rows = group * t_in, cols = c_lim = f_in, row0 = blockIdx.x * R1;
    // the group's samples are contiguous: its row v is row v % T of sample v / T
    stage_padded<R1>(sX, x + size_t(bo) * n_rows * f_in, n_rows, f_in, row0);
    if (threadIdx.x < R1) {
      const int t = (row0 + threadIdx.x) % t_in;
      s_edge[threadIdx.x] = (t == 0 ? 1 : 0) | (t == t_in - 1 ? 2 : 0);
    }
  } else if (MODE == M_VALID) {
    stride = f_in, n_rows = rows, cols = c_lim = n_win * win, row0 = blockIdx.x * R1;
    const int valid = max(0, min(t_in - row0, R1 + 2)) * f_in;
    stage(sX, x + (size_t(bo) * t_in + row0) * f_in, (R1 + 2) * f_in, valid, f_in % 8 == 0);
  } else {
    const int parts = (win + FLAT_CHUNK - 1) / FLAT_CHUNK, chunk = blockIdx.x / parts;
    const int part = blockIdx.x - chunk * parts;
    stride = f_in, n_rows = 1, cols = n_win * win;
    c_base = chunk * win + part * FLAT_CHUNK, c_lim = min(FLAT_CHUNK, win - part * FLAT_CHUNK);
    flat_lim = t_in - win - chunk * win;  // a tap offset past it is clamped to it
    const int start = c_base + min(0, flat_lim);  // tap 0's window; every tap starts at or after it
    const int n = FLAT_CHUNK + 2 * f_in + 2;
    stage(sX, x + size_t(bo) * in_stride + start, n, min(n, t_in - start), false);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  // this thread's taps in the A fragment: k = 2tq, 2tq + 1 and (tq = 0) k = 8
  int off[3], dyk[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int k = e < 2 ? 2 * tq + e : 8, dy = k / 3, dx = k % 3;
    dyk[e] = dy;
    off[e] = MODE == M_FLAT ? min(dy * stride + dx, flat_lim) - min(0, flat_lim) : dy * stride + dx;
  }
  uint32_t bw[CO1 / 8][2];  // B fragments: rows k, column co = 8 j + gid
#pragma unroll
  for (int j = 0; j < CO1 / 8; ++j) {
    bw[j][0] = ld32(sW + (8 * j + gid) * 16 + 2 * tq);
    bw[j][1] = ld32(sW + (8 * j + gid) * 16 + 2 * tq + 8);
  }

  const int ct = MODE == M_FLAT ? FLAT_CHUNK / 16 : (cols + 15) / 16;  // 16-output tiles per row
  const int n_rows_blk = MODE == M_FLAT ? 1 : R1;
  float s = 0.f;
  // warp w takes tiles w, w + 8, ... of the block's n_rows_blk x ct tiles, row by row
  int r = warp / ct, cb = warp % ct;
  for (; r < n_rows_blk; cb += THREADS / 32) {
    while (cb >= ct) cb -= ct, ++r;
    if (r >= n_rows_blk) break;
    const int c0 = cb * 16, row = row0 + r;
    bool tap_ok[3] = {true, true, true};
    if (MODE == M_SAME) {  // taps above the first / below the last row of a sample read zero
      const int edge = s_edge[r];
#pragma unroll
      for (int e = 0; e < 3; ++e) tap_ok[e] = !((dyk[e] == 0 && (edge & 1)) || (dyk[e] == 2 && (edge & 2)));
    }
    uint32_t a[4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // pixels gid and gid + 8 of the tile
      const int c = c0 + gid + 8 * hh;
      int in_c = c;  // the input column of tap 0
      if (MODE == M_VALID && n_win > 1) {  // window wi = c / win, by comparisons: a division costs ~20 instructions
        int wi = 0;
        while (wi + 1 < n_win && c >= (wi + 1) * win) ++wi;
        in_c = min(wi * win, f_in - win - 2) + c - wi * win;
      }
      const int base = r * stride + in_c;
      uint32_t lo = 0u, hi = 0u, k8 = 0u;
      if (row < n_rows && c < c_lim) {
        if (tap_ok[0]) lo = sXu[base + off[0]];
        if (tap_ok[1]) hi = sXu[base + off[1]];
        if (tq == 0 && tap_ok[2]) k8 = sXu[base + off[2]];
      }
      a[hh] = lo | (hi << 16);
      a[2 + hh] = k8;
    }
    float acc[CO1 / 8][4];
#pragma unroll
    for (int j = 0; j < CO1 / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      mma_bf16(acc[j], a, bw[j][0], bw[j][1]);
    }
    // accumulator (j, 2 hh + e) holds y[pixel gid + 8 hh, co 8 j + 2 tq + e]; a
    // pixel outside the outputs has a zero A row, so its y is 0
#pragma unroll
    for (int j = 0; j < CO1 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s += acc[j][e];
    if (y) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = c0 + gid + 8 * hh;
        if (row >= n_rows || c >= c_lim) continue;
        float* yp = y + ((size_t(bo) * n_rows + row) * cols + c_base + c) * CO1 + 2 * tq;
#pragma unroll
        for (int j = 0; j < CO1 / 8; ++j) {
          yp[8 * j] = acc[j][2 * hh];
          yp[8 * j + 1] = acc[j][2 * hh + 1];
        }
      }
    }
  }
  finish_sample(block_sum(s), out, done);
}

// v4: x (B, t_in, f_in), w (9, n_out) -> out (B, t_in / 2, f_in, n_out) bf16:
// SAME conv, y 1.01 + 0.01, ReLU, the mean of conv rows 2t and 2t + 1, one
// cast. One thread per pooled pixel.
__global__ void __launch_bounds__(THREADS)
conv1_emit(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out, int batch, int t_in,
           int f_in, int n_out) {
  extern __shared__ float s_w[];  // [9][n_out]
  for (int i = threadIdx.x; i < 9 * n_out; i += THREADS) s_w[i] = __bfloat162float(w[i]);
  __syncthreads();
  const int t_out = t_in / 2;
  const long long pix = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (pix >= (long long)batch * t_out * f_in) return;
  const int col = int(pix % f_in);
  const long long r = pix / f_in;
  const int to = int(r % t_out), b = int(r / t_out);
  float xv[4][3];  // rows 2 to - 1 .. 2 to + 2, columns col - 1 .. col + 1
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 2 * to - 1 + i;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int c = col - 1 + j;
      xv[i][j] = t >= 0 && t < t_in && c >= 0 && c < f_in ? __bfloat162float(x[(size_t(b) * t_in + t) * f_in + c])
                                                           : 0.f;
    }
  }
  bf16* o = out + pix * n_out;
  for (int c0 = 0; c0 < n_out; c0 += 8) {
    float res[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) res[e] = 0.f;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float v = xv[rr + t / 3][t % 3];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(v, s_w[t * n_out + c0 + e], acc[e]);
      }
      // separate multiply and add, as the reference's y * 1.01 + 0.01 (no contraction)
#pragma unroll
      for (int e = 0; e < 8; ++e) res[e] += fmaxf(__fadd_rn(__fmul_rn(acc[e], 1.01f), 0.01f), 0.f);
    }
    uint4 v;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) p2[e] = __floats2bfloat162_rn(0.5f * res[2 * e], 0.5f * res[2 * e + 1]);
    *reinterpret_cast<uint4*>(o + c0) = v;
  }
}

// Blocks per result block of a K7/K8 case (0: its geometry is refused).
int pass_blocks(int kase, int t_in, int f_in, int group) {
  switch (kase) {
    case V0_SUMS: return (t_in * f_in + V0_CHUNK - 1) / V0_CHUNK;
    case V1_SAME_FMA: return (t_in + R1 - 1) / R1;
    case D_VALID_FMA: return t_in >= 3 && f_in >= 3 ? blocks_per_sample(H_SLICE, t_in - 2, f_in - 2) : 0;
    case F_CONV2_DX: return t_in >= 3 && f_in >= 3 ? conv2_tiles(t_in - 2, f_in - 2) : 0;
    case V2_SAME_MMA: case V3_GROUP_MMA: return conv1_mma_blocks(M_SAME, t_in, group, 0, 0, 0);
    case A_VALID_MMA: return t_in >= 3 && f_in >= 3 ? conv1_mma_blocks(M_VALID, t_in, 1, t_in - 2, f_in - 2, 1) : 0;
    case C_FLAT_MMA: return t_in > 2 * f_in ? conv1_mma_blocks(M_FLAT, t_in, 1, 1, t_in - 2 * f_in, 1) : 0;
    default: return 0;
  }
}

size_t pass_smem(int kase, int f_in, int n_out) {
  switch (kase) {
    case V1_SAME_FMA: return conv1_smem(SAME_PAD, f_in, f_in, n_out);
    case D_VALID_FMA: return conv1_smem(H_SLICE, f_in, f_in - 2, n_out);
    case F_CONV2_DX: return Conv2Cfg<CI2, CO2>::SMEM;
    case V2_SAME_MMA: case V3_GROUP_MMA: return conv1_mma_smem(M_SAME, f_in);
    case A_VALID_MMA: return conv1_mma_smem(M_VALID, f_in);
    case C_FLAT_MMA: return conv1_mma_smem(M_FLAT, f_in);
    case V4_EMIT: return size_t(9) * n_out * sizeof(float);
    default: return 0;
  }
}

template <typename K, typename... Args>
cudaError_t launch(K kern, dim3 grid, size_t smem, cudaStream_t s, Args... args) {
  cudaError_t err = set_smem(kern, smem);
  if (err == cudaSuccess) kern<<<grid, THREADS, smem, s>>>(args...);
  return err;
}

}  // namespace

// kase: 0 g, 1 h, 2 i, 3 j, 4 k. in: x (B, t_in, f_in) bf16 for g/h, patches
// (B, rows, cols, 9) for i (t_in = rows, f_in = cols), h (B, t_in, f_in, 32)
// for j/k; w: (9, n_out) for g/h/i, (9, 32, 64) for j/k (n_out = 64); out
// (B, 8, 128) f32; y: null, or (B, rows, cols, n_out) f32 for every output;
// done: B zeroed counters (scratch). 16-byte aligned `in`, `w` and `out`.
// One kernel launch on `stream`, no synchronisation; returns
// cudaGetLastError().
extern "C" int dfac_conv_probe(int kase, const void* in, const void* w, float* out, float* y, void* done_,
                               int batch, int t_in, int f_in, int rows, int cols, int n_out, void* stream) {
  if (kase < 0 || kase > K_ROLL || batch <= 0 || batch > 65535 || rows <= 0 || cols <= 0 || n_out <= 0 ||
      n_out > 1024 || blocks_per_sample(kase, rows, cols) > OUT_PER_SAMPLE ||
      (kase != I_PATCHES && rows + 2 > t_in) || ((kase == H_SLICE || kase == J_SLICE) && cols + 2 > f_in) ||
      ((kase == G_ROLL || kase == K_ROLL) && cols != f_in) ||
      (kase >= J_SLICE && (n_out != CO2 || size_t(t_in) * f_in > (size_t(1) << 30))) ||
      (kase == I_PATCHES && (rows != t_in || cols != f_in)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(in);
  const bf16* wk = static_cast<const bf16*>(w);
  unsigned int* done = static_cast<unsigned int*>(done_);
  cudaError_t err = cudaSuccess;
  if (kase <= I_PATCHES) {
    const dim3 grid(blocks_per_sample(kase, rows, cols), batch);
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
    err = launch_conv2<false, false, CI2, CO2>(x, wk, out, y, done, batch, t_in, f_in, rows, cols, s);
  } else {
    err = launch_conv2<true, false, CI2, CO2>(x, wk, out, y, done, batch, t_in, f_in, rows, cols, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of the kernel dfac_conv_probe runs for
// this case and geometry, in bytes.
extern "C" int dfac_conv_probe_smem(int kase, int f_in, int cols, int n_out) {
  return kase <= I_PATCHES ? int(conv1_smem(kase, f_in, cols, n_out)) : int(Conv2Cfg<CI2, CO2>::SMEM);
}

// Stages 11 and 12 (K7, K8). kase: 0 v0, 1 v1, 2 v2, 3 v3, 4 v4, 5 a, 6 c,
// 7 d, 8 f. in: x (B, t_in, f_in) bf16, but for c the flat padded samples
// (B, 1, t_in = Np) with f_in = W (M = Np - 2W outputs), and for f h1 (B,
// t_in, f_in, 32). w: (9, n_out) for v1, d, v4; (9, 32) for v2, v3, a, c
// (n_out = 32); w2dx (3, 96, 64) for f (n_out = 64); unused for v0. out:
// (n_res, 8, 128) f32, where n_res = batch result blocks (samples; for v3
// groups of `group` samples), or for v4 (batch, t_in / 2, f_in, n_out) bf16.
// y: null, or every output in f32 (not for v0 and v4). done: n_res zeroed
// counters (scratch; unused for v4). 16-byte aligned `in`, `w` and `out`.
// One kernel launch on `stream`, no synchronisation; returns
// cudaGetLastError().
extern "C" int dfac_conv_pass(int kase, const void* in, const void* w, void* out, float* y, void* done_, int batch,
                              int t_in, int f_in, int n_out, int group, void* stream) {
  if (kase < V0_SUMS || kase > F_CONV2_DX || batch <= 0 || batch > 65535 || t_in <= 0 || f_in <= 0 ||
      group < 1 || (kase != V3_GROUP_MMA && group != 1))
    return (int)cudaErrorInvalidValue;
  const bool mma = kase == V2_SAME_MMA || kase == V3_GROUP_MMA || kase == A_VALID_MMA || kase == C_FLAT_MMA;
  if ((mma && n_out != CO1) || (kase == F_CONV2_DX && n_out != CO2) ||
      ((kase == V1_SAME_FMA || kase == D_VALID_FMA) && (n_out <= 0 || n_out > 1024)) ||
      (kase == V4_EMIT && (n_out <= 0 || n_out % 8 || t_in < 2)) || size_t(t_in) * f_in > (size_t(1) << 30))
    return (int)cudaErrorInvalidValue;
  const int blocks = pass_blocks(kase, t_in, f_in, group);
  const size_t smem = pass_smem(kase, f_in, n_out);
  if ((kase != V4_EMIT && (blocks <= 0 || blocks > OUT_PER_SAMPLE)) || smem > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(in);
  const bf16* wk = static_cast<const bf16*>(w);
  float* o = static_cast<float*>(out);
  unsigned int* done = static_cast<unsigned int*>(done_);
  const dim3 grid(blocks, batch);
  cudaError_t err = cudaSuccess;
  switch (kase) {
    case V0_SUMS:
      sum_sq_checksum<<<grid, THREADS, 0, s>>>(x, o, done, t_in * f_in);
      break;
    case V1_SAME_FMA:
      err = launch(conv1_checksum<SAME_PAD>, grid, smem, s, x, wk, o, y, done, t_in, f_in, t_in, f_in, n_out, 0);
      break;
    case D_VALID_FMA:
      err = launch(conv1_checksum<H_SLICE>, grid, smem, s, x, wk, o, y, done, t_in, f_in, t_in - 2, f_in - 2, n_out,
                   int(f_in % 8 == 0));
      break;
    case F_CONV2_DX:
      err = launch_conv2<false, true, CI2, CO2>(x, wk, o, y, done, batch, t_in, f_in, t_in - 2, f_in - 2, s);
      break;
    case V2_SAME_MMA:
    case V3_GROUP_MMA:
      err = launch(conv1_mma<M_SAME>, grid, smem, s, x, wk, o, y, done, t_in, f_in, group, 0, 0, 0, 0LL);
      break;
    case A_VALID_MMA:
      err = launch(conv1_mma<M_VALID>, grid, smem, s, x, wk, o, y, done, t_in, f_in, 1, t_in - 2, f_in - 2, 1, 0LL);
      break;
    case C_FLAT_MMA:
      err = launch(conv1_mma<M_FLAT>, grid, smem, s, x, wk, o, y, done, t_in, f_in, 1, 1, t_in - 2 * f_in, 1,
                   (long long)t_in);
      break;
    case V4_EMIT: {
      const long long pixels = (long long)batch * (t_in / 2) * f_in;
      if (pixels == 0) return (int)cudaSuccess;
      err = launch(conv1_emit, dim3(unsigned((pixels + THREADS - 1) / THREADS)), smem, s, x, wk,
                   static_cast<bf16*>(out), batch, t_in, f_in, n_out);
      break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of the kernel dfac_conv_pass runs for this
// case and geometry, in bytes.
extern "C" int dfac_conv_pass_smem(int kase, int f_in, int n_out) { return int(pass_smem(kase, f_in, n_out)); }

// ---- K10 / K11 (stages 14 and 15) -------------------------------------------

namespace {

enum Chunked { H2_WINDOWS = 0, I2_PLANES = 1, J4_CONV2_DX = 2, J5_CONV3 = 3, C2_FLAT_CHUNKS = 4 };

// Blocks per sample of a K10/K11 case (0: its geometry is refused).
int chunk_blocks(int kase, int t_in, int f_in, int rows, int cols, int win) {
  switch (kase) {
    case H2_WINDOWS:
      return win > 0 && cols % win == 0 && rows + 2 <= t_in && win + 2 <= f_in
                 ? conv1_mma_blocks(M_VALID, t_in, 1, rows, win, cols / win) : 0;
    case I2_PLANES: return rows <= t_in && cols == f_in ? (rows + R1 - 1) / R1 : 0;
    case J4_CONV2_DX: case J5_CONV3:
      return rows + 2 <= t_in && cols + 2 <= f_in ? conv2_tiles(rows, cols) : 0;
    case C2_FLAT_CHUNKS:
      return win > 0 && cols % win == 0 && win <= t_in ? conv1_mma_blocks(M_FLAT, t_in, 1, 1, win, cols / win) : 0;
    default: return 0;
  }
}

size_t chunk_smem(int kase, int f_in, int cols, int n_out) {
  switch (kase) {
    case H2_WINDOWS: return conv1_mma_smem(M_VALID, f_in);
    case I2_PLANES: return conv1_smem(I_PLANES, f_in, cols, n_out);
    case J4_CONV2_DX: return Conv2Cfg<CI2, CO2>::SMEM;
    case J5_CONV3: return Conv2Cfg<CI3, CO3>::SMEM;
    case C2_FLAT_CHUNKS: return conv1_mma_smem(M_FLAT, f_in);
    default: return 0;
  }
}

}  // namespace

// Stages 14 and 15 (K10, K11); j2 and j3 are dfac_conv_probe's j. kase:
//   0 h2: x (B, t_in, f_in), w9 (9, 32); rows x cols outputs in windows of `win` columns
//   1 i2: p9 (B, 9, t_in, f_in) tap-leading patches, w9 (9, n_out); rows <= t_in, cols = f_in
//   2 j4: h1 (B, t_in, f_in, 32), w2i (3, 96, 64) as stage 12's w2dx; rows x cols outputs
//   3 j5: h2 (B, t_in, f_in, 64), w3 (9, 64, 128); rows x cols outputs
//   4 c2: xf (B, rows, L = t_in) of which row 0 is read, flat padded rows of width W = f_in;
//         wt (32, 16); cols = n_chunks x win outputs in chunks of win = Mc
// n_out: 32 (h2, c2), 64 (j4), 128 (j5), any of 1..1024 (i2). out (B, 8, 128)
// f32; y: null, or (B, rows, cols, n_out) f32 for every output (c2: (B, 1,
// cols, 32)); done: B zeroed counters (scratch). 16-byte aligned `in`, `w`
// and `out`. One kernel launch on `stream`, no synchronisation; returns
// cudaGetLastError().
extern "C" int dfac_conv_chunk(int kase, const void* in, const void* w, float* out, float* y, void* done_,
                               int batch, int t_in, int f_in, int rows, int cols, int win, int n_out,
                               void* stream) {
  const int want_out[] = {CO1, n_out, CO2, CO3, CO1};
  if (kase < H2_WINDOWS || kase > C2_FLAT_CHUNKS || batch <= 0 || batch > 65535 || t_in <= 0 || f_in <= 0 ||
      rows <= 0 || cols <= 0 || n_out <= 0 || n_out > 1024 || n_out != want_out[kase] ||
      size_t(t_in) * f_in * (kase == I2_PLANES ? 9 : 1) * (kase == J5_CONV3 ? CI3 : kase == J4_CONV2_DX ? CI2 : 1) >
          (size_t(1) << 30))
    return (int)cudaErrorInvalidValue;
  const int blocks = chunk_blocks(kase, t_in, f_in, rows, cols, win);
  const size_t smem = chunk_smem(kase, f_in, cols, n_out);
  if (blocks <= 0 || blocks > OUT_PER_SAMPLE || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(in);
  const bf16* wk = static_cast<const bf16*>(w);
  unsigned int* done = static_cast<unsigned int*>(done_);
  const dim3 grid(blocks, batch);
  cudaError_t err = cudaSuccess;
  switch (kase) {
    case H2_WINDOWS:
      err = launch(conv1_mma<M_VALID>, grid, smem, s, x, wk, out, y, done, t_in, f_in, 1, rows, win, cols / win, 0LL);
      break;
    case I2_PLANES:
      err = launch(conv1_checksum<I_PLANES>, grid, smem, s, x, wk, out, y, done, t_in, f_in, rows, cols, n_out,
                   int(f_in % 8 == 0));
      break;
    case J4_CONV2_DX:
      err = launch_conv2<false, true, CI2, CO2>(x, wk, out, y, done, batch, t_in, f_in, rows, cols, s);
      break;
    case J5_CONV3:
      err = launch_conv2<false, false, CI3, CO3>(x, wk, out, y, done, batch, t_in, f_in, rows, cols, s);
      break;
    case C2_FLAT_CHUNKS:
      err = launch(conv1_mma<M_FLAT, true>, grid, smem, s, x, wk, out, y, done, t_in, f_in, 1, 1, win, cols / win,
                   (long long)rows * t_in);
      break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of the kernel dfac_conv_chunk runs for this
// case and geometry, in bytes.
extern "C" int dfac_conv_chunk_smem(int kase, int f_in, int cols, int n_out) {
  return int(chunk_smem(kase, f_in, cols, n_out));
}
