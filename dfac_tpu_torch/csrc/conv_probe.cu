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
//  * g, h, i (K = 9 padded to 16, N = 32), and v2, v3, a, c, h2, i2, c2
//    below: conv1_tc, one tensor-core conv1 kernel (see "conv1_tc" below).
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
//  * One launch, deterministic sums. conv2_checksum: a tile's sum
//    (threads, a shuffle tree, then its four warps in order) goes to slot
//    out[b][tile of b] (a sample has at most 1024 tiles; the entries refuse
//    more), done[b] counts tiles (one fence and count per warpgroup's run
//    of a sample's tiles: a fence per tile stalls the warpgroup at every
//    tile), and the warp that counts a sample's last tiles adds its slots
//    in order (publish). conv1_tc and conv1_checksum do the same per band.
//    No float atomics: a call repeats bit for bit, and a sample's sum does
//    not depend on its batch or on the grid.
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
//   d   a's y on the CUDA cores
//   f   conv2 of h1 (B, T2+2, F+2, 32) with w2dx (3, 96, 64), w[3dy+dx][ci][co] =
//       w2dx[dx][32 dy + ci][co]: the j kernel above, reading w2dx's layout as it stages
//       the weights (one launch, no re-layout op)
//
// What bounds K7/K8 on the card, at the probe's B=512, T=321, F=180: every
// case but v4 and f reads ~59 MB of x (~18 us at 3.35 TB/s) for 8.4-8.6e9
// MACs (~17 us at the 989 TFLOP/s bf16 peak), so bytes and operations are
// nearly even on the tensor cores; v1 and d stay on the CUDA cores (the
// stages compare the TPU's VPU and MXU), where the f32 FMA rate (67
// TFLOP/s) makes them 0.254 / 0.250 ms of arithmetic. v4 writes 944 MB
// (~0.28 ms); f is 0.54 TFLOP (~0.55 ms at the bf16 peak).
//
// Design (K7/K8):
//  * v1 and d: conv1_checksum, register-tiled FMAs (no tensor core). Its
//    floor is the FMA pipe: each y takes 9 FMAs and one add into the sum,
//    so every other instruction, idle lane or stalled cycle is lost time.
//    - a band is 32 output rows of a sample, and a block of 128 threads is
//      exactly its 32 rows x 4 channel octets, whatever F is: no idle lane
//      but the rows past a sample's last;
//    - a thread keeps its octet's 72 weights in registers for its life and
//      walks its row in quads of 4 columns: 288 FMAs and 32 adds for six
//      16-byte shared loads (its 3 x 8 window), ~88% of the loop's issue;
//    - the band's input rows are copied by 16-byte cp.async two bands
//      ahead (from the 8-element boundary below them: rows of 180 or 178
//      columns need no aligned source) and built once into f32 rows with
//      the zero padding and the row edges resolved, so the loop has no
//      test (staging synchronously from global loads cost a sixth of the
//      time);
//    - whole quads run with no mask and no y test (WITH_Y is a template
//      argument); a ragged last quad runs once, masked;
//    - persistent blocks walk contiguous ranges of (sample, band); a
//      band's sum goes to its slot (publish).
//    What binds it (PERF.md, patched copies timed beside it): the quad
//    loop runs at about two thirds of the issue rate at full clock, and
//    the build and copies take about a tenth of the time.
//  * v2, v3, a, c: conv1_tc (SAME: v2; v3 in groups of 8 samples, a tap in
//    a row of another sample reading zero; VALID: a; FLAT: c).
//  * v4: conv1_emit, the design of conv_block.cu's conv_block_cin1_tc on
//    the tensor cores, so that the CUDA cores only load, finish and store
//    and the 944 MB write bounds it (576 FMAs a pooled pixel on the CUDA
//    cores are issue-bound well above the write). Both conv rows of
//    a pooled pixel are one mma.sync m16n8k16 product with K = 16 (the 4 x
//    3 input window) and N = 64, B (halved) in registers, C zero; then the
//    affine (rounded apart), ReLU, the pool and one cast in registers,
//    16-byte stores (see conv1_emit below).
//  * v0: 4-byte (bf16 pair) loads, f32 sums, one block a chunk of a
//    sample, summed by finish_sample: one launch, a result that repeats
//    bit for bit.
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
// the same tensor-core code paths:
//  * h2, i2, c2: conv1_tc (SLICE in two windows, the second's source
//    columns clamped when its copy rows are built; PLANES; FLAT in 8
//    chunks, each chunk's clamped tap offsets fixed for its bands, wt (32,
//    16) read as it is: taps 9-15 are the A tile's zero rows, so 0 x wt[co,
//    9..15] is formed as the reference forms it). Only row 0 of each xf
//    sample is read.
//  * j4: f's kernel (dx layout) with rows and columns given, not T - 2, F - 2.
//  * j5: conv2_checksum at (CI, CO) = (64, 128), wgmma m64n128k16: its
//    weights (147,456 B) and each warpgroup's two halo stages (19,584 B
//    each) fit one block per SM, as conv_block_tc's block 3.
//
// conv1_tc (g, h, i, i2, v2, v3, a, c, h2, c2) replaces the Pallas dots on
// the TPU's matrix unit: train_opt_probe.py kern_g (:1108), kern_h (:1123),
// kern_i (:1136), kern_v2 (:869), kern_v3 (:877), kern_a (:974), kern_c
// (:989), kern_h2 (:1248), kern_i2 (:1266), kern_c2 (:1456), and
// pallas_err_probe.py kern_g (:44), kern_i (:60).
//  * What bounds it on this card: at B=512 each case is 1.9e10-2.4e10 FLOP
//    (~20-25 us at the bf16 peak) on 59-88 MB of input (~18-26 us), or for
//    i and i2 755 MB of patches (~0.23 ms). Each output's 32 f32 y values
//    must be formed and summed, one FADD each. Timed beside patched copies
//    of itself (no tile loop, no build; PERF.md), the tile loop takes about
//    half the time (a warp's ldmatrix, wgmma, wait and 16 FADDs in a row:
//    latency, not the tensor cores), the build of the copy rows or planes
//    about a third (i, i2: the 755 MB of copies instead).
//  * The shape: one wgmma m64n32k16 per 64 outputs, K = 9 taps padded to
//    16 (taps 9-15 point at a zero row), B (16 x 32) once per block in
//    shared memory as 8 x 8 core matrices (no swizzle), scale-d = 0 so no
//    accumulator is zeroed by hand. A tile is 64 outputs: 2-D cases (g, h,
//    a, h2, v2, v3) 8 output rows x 8 columns, 1-D cases (i, i2, c, c2) 64
//    consecutive outputs. The tile loop is compiled with and without y's
//    stores (no test per tile) and unrolled twice, so the next tile's
//    ldmatrix flies while this tile's y are summed in two add chains; at
//    most 64 registers (4 blocks an SM).
//  * A is built as whole tiles, not tap by tap: the A tile is read MN-major
//    by ldmatrix.x4.trans, each lane giving one 16-byte row of 8
//    consecutive outputs of one tap (the rows of taps 9-15 are one zero
//    row). The 2-D cases take candidate (b) of the design: three
//    dx-shifted copy rows per staged input row (column j of copy dx holds
//    the input tap dx reads for output column j), so any tap of any 8
//    outputs of a row is one aligned row, and a copy serves the three
//    output rows that read it; the im2col tile of candidate (a) would
//    build 9 values per output where the copies build ~3.4. The 1-D cases
//    build 9 tap planes per band (i2's layout): their taps share no rows.
//  * Edges, clamps, windows and the wrap are resolved while the copies and
//    planes are built (ROLL: the column mod f_in; SLICE: h2's clamped
//    window start; SAME: zero columns; FLAT: each chunk's clamped offsets),
//    or once per band per lane (SAME: a tap above a sample's first row or
//    below its last, and every row past the result's last, points at the
//    zero row). Outputs past the edges read zero taps, so their y is 0 and
//    the tile loop sums every y with no test.
//  * Persistent blocks of two warpgroups walk a contiguous range of
//    (result, band) pairs: a 2-D band is 16 output rows (two rows of
//    tiles; 8 or 24 were slower), a 1-D band 1,024 outputs (FLAT, whose
//    stages are small: 2,048). The band's input span (its 18 input rows,
//    or its outputs' patches, plane segments or flat span) is copied by
//    16-byte cp.async from the 8-element boundary at or below its start
//    (so rows of 180 or 178 columns and 18-byte patches need no aligned
//    source) into a ring of two raw stages, two bands ahead; the block
//    builds the band's copy rows or planes from it, then its warpgroups
//    take the band's tiles in turn.
//  * Sums: a band's sum (each thread's y in tile order, a shuffle tree,
//    the 8 warps in order) goes to its slot of out[b], a band a slot (at
//    most 1,024 bands a result: 64-output tiles would need 1,280 slots for
//    g and 7,223 for v3's group), counted once per run of a result's bands
//    (publish). Every y is formed in the accumulators and summed; the
//    checksum is not factored algebraically, and the return_y mode runs
//    the same loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

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

// One warp, every lane: store the sum `value` of item `item` (a tile of
// conv2_checksum, a band of conv1_tc) in its slot of out[b], b = item /
// items_per. At the end of the caller's run of items of sample b (`flush`),
// count the run's `run` items done in done[b], once: the fence stalls the
// warp's whole warpgroup or block, too long to pay per item. The warp that
// counts a sample's last items adds the sample's slots in a fixed order
// (lane l takes slots l, l + 32, ..., then a shuffle tree) and fills out[b]
// with the total. No float atomics: the result does not depend on the
// grid, the batch or the order of the items.
__device__ void publish(float value, float* out, unsigned int* done, int item, int items_per, int lane, int& run,
                        bool flush) {
  const int b = item / items_per;
  float* ob = out + size_t(b) * OUT_PER_SAMPLE;
  if (lane == 0) ob[item - b * items_per] = value;
  ++run;
  if (!flush) return;
  unsigned int last = 0;
  if (lane == 0) {
    __threadfence();  // the run's slots are visible before the count says so
    last = atomicAdd(done + b, unsigned(run)) + unsigned(run) == unsigned(items_per);
  }
  run = 0;
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  float sum = 0.f;
  for (int i = lane; i < items_per; i += 32) sum += __ldcg(ob + i);  // from L2, past L1
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float4 v = make_float4(sum, sum, sum, sum);
  for (int i = lane; i < OUT_PER_SAMPLE / 4; i += 32) reinterpret_cast<float4*>(ob)[i] = v;
}

// A tile's sum: its four warps' sums, added in order.
__device__ __forceinline__ float tile_sum(const float* warp_sums) {
  return ((warp_sums[0] + warp_sums[1]) + warp_sums[2]) + warp_sums[3];
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
          publish(tile_sum(s_sums[wg][par ^ 1]), out, done, tile - 1, tiles_per, lane, run, tile % tiles_per == 0);
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
    // summed in a fixed order: thread, shuffle tree, then warps 0-3 in tile_sum.
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
  if (warp == 0 && begin < end) publish(tile_sum(s_sums[wg][par ^ 1]), out, done, end - 1, tiles_per, lane, run, true);
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

// ---- g, h, i, i2, v2, v3, a, c, h2, c2: conv1 on wgmma ----------------------

constexpr int CO1 = 32;                      // conv1's output channels: wgmma's N
constexpr int TC1_ROWS = 16;                 // a 2-D band: 16 output rows; its tiles 8 rows x 8 columns
constexpr int TC1_IN = TC1_ROWS + 2;         // a 2-D band's input rows
constexpr int TC1_B = CO1 * 16 * 2;          // B: 32 x 16 bf16 as 8 x 8 core matrices
constexpr int TC1_ZERO = TC1_B;              // a zero row of 16 bytes: taps 9-15, masked pixels
constexpr int TC1_TAPS = TC1_B + 128;        // then the tap store, then two raw stages
enum Tc1Mode { TC_ROLL = 0, TC_SLICE = 1, TC_SAME = 2, TC_PATCHES = 3, TC_PLANES = 4, TC_FLAT = 5 };

// A 1-D band's outputs (its tiles 64 of them; FLAT's raw stages are small,
// so its bands are longer); a tap plane's bytes (= 16
// mod 128: conflict-free ldmatrix); PLANES: a plane's raw segment (elements),
// a band and two partial chunks.
__host__ __device__ constexpr int tc1_pix(int mode) { return mode == TC_FLAT ? 2048 : 1024; }
__host__ __device__ constexpr int tc1_plane_b(int mode) { return 2 * tc1_pix(mode) + 16; }
__host__ __device__ constexpr int tc1_seg(int mode) { return tc1_pix(mode) + 16; }

// A launch's geometry (host-computed). Outputs per result: rows x cols
// (FLAT: rows = chunks of cols outputs each), y (n_res, rows, cols, 32).
struct Tc1 {
  int n_res, bands, bpc;  // results; bands (result slots) per result; FLAT: bands per chunk
  int rows, cols;
  int t_in, f_in;         // input rows and row width (FLAT: the flat row's length L and its width W)
  int group;              // SAME: samples per result (v3: 8)
  int win;                // SLICE: output columns per window (window i reads from min(i win, f_in - win - 2))
  long long res_stride;   // input elements from one result to the next
  long long plane;        // PLANES: elements from one tap plane to the next
  long long in_total;     // input elements the launch may read (copies past them read zeros)
  int rsb;                // 2-D: bytes of a staged copy row (= 16 mod 128)
  int raw_bytes;          // bytes of one raw stage
};

__host__ __device__ constexpr bool tc1_rows(int mode) { return mode <= TC_SAME; }

Tc1 tc1_geom(int mode, int n_res, int rows, int cols, int t_in, int f_in, int group, int win, long long res_stride,
             long long plane, long long in_total) {
  Tc1 p{};
  p.n_res = n_res, p.rows = rows, p.cols = cols, p.t_in = t_in, p.f_in = f_in, p.group = group, p.win = win;
  p.res_stride = res_stride, p.plane = plane, p.in_total = in_total, p.bpc = 1;
  if (tc1_rows(mode)) {
    p.bands = (rows + TC1_ROWS - 1) / TC1_ROWS;
    p.rsb = (cols + 7) / 8 * 16;
    p.rsb += (16 - p.rsb % 128 + 128) % 128;
    p.raw_bytes = (TC1_IN * f_in + 16) * 2;
  } else if (mode == TC_FLAT) {
    p.bpc = (cols + tc1_pix(mode) - 1) / tc1_pix(mode);
    p.bands = rows * p.bpc;
    p.raw_bytes = (tc1_pix(mode) + 2 * f_in + 2 + 16) * 2;
  } else {
    p.bands = int(((long long)rows * cols + tc1_pix(mode) - 1) / tc1_pix(mode));
    p.raw_bytes = mode == TC_PLANES ? 9 * tc1_seg(mode) * 2 : (9 * tc1_pix(mode) + 16) * 2;
  }
  p.raw_bytes = (p.raw_bytes + 15) / 16 * 16 + 32;  // raw8 reads up to 15 elements past its last
  return p;
}

size_t tc1_smem(int mode, const Tc1& p) {
  const size_t taps = tc1_rows(mode) ? size_t(TC1_IN) * 3 * p.rsb : size_t(9) * tc1_plane_b(mode);
  return TC1_TAPS + taps + 2 * size_t(p.raw_bytes);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D (64 x 32 f32) = A (64 x 16 bf16 in registers) * B (16 x 32, K-major by
// descriptor): scale-d = 0, so D starts from zero (no zeroing instructions).
__device__ __forceinline__ void wgmma_n32_fresh(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
}

// B's descriptor: no swizzle, 8 x 8 core matrices of 128 bytes, the two
// along K 128 bytes apart (LBO), the four along N 256 apart (SBO).
__device__ __forceinline__ uint64_t tc1_b_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}

__device__ __forceinline__ uint32_t half_on(uint32_t lo, uint32_t hi) { return __funnelshift_r(lo, hi, 16); }

// Raw elements e .. e + 7 of a stage: the aligned 16-byte chunks holding
// them, shifted by e % 8. A warp's lanes read neighbouring chunks (no bank
// conflicts) at one e % 8 (the builds step e by whole chunks across lanes),
// so the switch does not diverge. Reads up to 15 elements past e.
__device__ __forceinline__ uint4 raw8(const unsigned char* raw, int e) {
  const uint4* c = reinterpret_cast<const uint4*>(raw) + (e >> 3);
  const uint4 a = c[0];
  if ((e & 7) == 0) return a;
  const uint4 b = c[1];
  switch (e & 7) {
    case 1: return make_uint4(half_on(a.x, a.y), half_on(a.y, a.z), half_on(a.z, a.w), half_on(a.w, b.x));
    case 2: return make_uint4(a.y, a.z, a.w, b.x);
    case 3: return make_uint4(half_on(a.y, a.z), half_on(a.z, a.w), half_on(a.w, b.x), half_on(b.x, b.y));
    case 4: return make_uint4(a.z, a.w, b.x, b.y);
    case 5: return make_uint4(half_on(a.z, a.w), half_on(a.w, b.x), half_on(b.x, b.y), half_on(b.y, b.z));
    case 6: return make_uint4(a.w, b.x, b.y, b.z);
    default: return make_uint4(half_on(a.w, b.x), half_on(b.x, b.y), half_on(b.y, b.z), half_on(b.z, b.w));
  }
}

__device__ __forceinline__ unsigned short raw1(const unsigned char* raw, int e) {
  return reinterpret_cast<const unsigned short*>(raw)[e];
}

// Eight bf16 (bits) into a 16-byte row.
__device__ __forceinline__ uint4 pack8(const unsigned short (&v)[8]) {
  return make_uint4(v[0] | uint32_t(v[1]) << 16, v[2] | uint32_t(v[3]) << 16, v[4] | uint32_t(v[5]) << 16,
                    v[6] | uint32_t(v[7]) << 16);
}

// 16-byte copies of input elements [g0, g1) into `dst`, from the 8-element
// boundary at or below g0, so that every copy is aligned: element g0 lands
// at element g0 % 8 of the stage. Elements at or past `total` read zero.
__device__ __forceinline__ void copy_span(uint32_t dst, const bf16* __restrict__ x, long long g0, long long g1,
                                          long long total, int lane0, int lanes) {
  const long long a0 = g0 & ~7LL;
  const int n = int((g1 - a0 + 7) >> 3);
  for (int i = lane0; i < n; i += lanes) {
    const long long e = a0 + 8LL * i, left = total - e;
    const int bytes = left >= 8 ? 16 : left > 0 ? int(left) * 2 : 0;
    cp_async16(dst + 16u * i, bytes ? x + e : x, bytes);
  }
}

// A band's place: its result, its index in the result (its slot) and, for
// FLAT, its chunk and its part of the chunk. Stepped, not divided, from one
// band to the next.
struct Tc1Pos {
  int res, bi, chunk, part;
  __device__ Tc1Pos(const Tc1& p, int band)
      : res(band / p.bands), bi(band - res * p.bands), chunk(bi / p.bpc), part(bi - chunk * p.bpc) {}
  __device__ void next(const Tc1& p) {
    if (++part == p.bpc) part = 0, ++chunk;
    if (++bi == p.bands) bi = 0, chunk = 0, ++res;
  }
};

// FLAT: chunk c's clamped tap offsets, min(dy W + dx, L - win - c win).
__device__ __forceinline__ int flat_lim(const Tc1& p, int chunk) { return p.t_in - p.cols - chunk * p.cols; }

// The raw copies of band `band` into the stage at `dst` (all threads; one
// cp.async group is committed by the caller). 2-D: the band's input rows,
// contiguous in x (v3: across the group's samples); PATCHES: its pixels'
// 9-tap records; PLANES: its pixels in each of the 9 planes; FLAT: the
// span its taps read.
template <int MODE>
__device__ void tc1_stage(uint32_t dst, const bf16* __restrict__ x, const Tc1& p, const Tc1Pos& at) {
  const int bi = at.bi;
  const long long base = at.res * p.res_stride;
  if constexpr (tc1_rows(MODE)) {
    const int u0 = bi * TC1_ROWS - (MODE == TC_SAME), n_in = MODE == TC_SAME ? p.group * p.t_in : p.t_in;
    const int lo = max(u0, 0), hi = min(u0 + TC1_IN, n_in);
    if (hi > lo)
      copy_span(dst, x, base + (long long)lo * p.f_in, base + (long long)hi * p.f_in, p.in_total, threadIdx.x,
                THREADS);
  } else if constexpr (MODE == TC_FLAT) {
    const int chunk = at.chunk, i0 = at.part * tc1_pix(MODE), nv = min(tc1_pix(MODE), p.cols - i0);
    const int lim = flat_lim(p, chunk);
    const long long g = base + (long long)chunk * p.cols + i0;
    copy_span(dst, x, g + min(0, lim), g + nv + min(2 * p.f_in + 2, lim), p.in_total, threadIdx.x, THREADS);
  } else {
    const int p0 = bi * tc1_pix(MODE), nv = int(min((long long)tc1_pix(MODE), (long long)p.rows * p.cols - p0));
    if constexpr (MODE == TC_PATCHES) {
      copy_span(dst, x, base + 9LL * p0, base + 9LL * (p0 + nv), p.in_total, threadIdx.x, THREADS);
    } else {  // 9 segments of tc1_seg(MODE) elements; threads 28 k .. 28 k + 27 copy plane k's
      const int k = threadIdx.x / 28;
      if (k < 9) {
        const long long g = base + k * p.plane + p0;
        copy_span(dst + k * tc1_seg(MODE) * 2, x, g, g + nv, p.in_total, threadIdx.x - 28 * k, 28);
      }
    }
  }
}

// The tap store of band `band` from its raw stage `raw` (all threads).
// 2-D: for each of the band's TC1_IN input rows and dx = 0, 1, 2 a copy row
// of the output columns' tap-dx inputs (row r at r * 3 rsb, copy dx at dx *
// rsb): column j holds the input column tap dx reads for output column j --
// (j + dx - 1) mod f_in (ROLL), j + dx in j's window (SLICE), j + dx - 1 or
// zero past the edge (SAME) -- and zero for j >= cols or rows outside the
// input. 1-D: plane k holds tap k of the band's outputs (zero past them).
template <int MODE>
__device__ void tc1_build(unsigned char* taps, const unsigned char* raw, const Tc1& p, const Tc1Pos& at) {
  const int bi = at.bi;
  const long long base = at.res * p.res_stride;
  if constexpr (tc1_rows(MODE)) {
    const int u0 = bi * TC1_ROWS - (MODE == TC_SAME), n_in = MODE == TC_SAME ? p.group * p.t_in : p.t_in;
    const int lo = max(u0, 0);
    const int lead = int((base + (long long)lo * p.f_in) & 7);  // raw element of (row lo, column 0)
    const int gpr = (p.cols + 7) / 8;
    for (int it = threadIdx.x; it < 3 * gpr; it += THREADS) {
      const int dx = it / gpr, q = it - dx * gpr, j0 = 8 * q;
      int src0, wi = 0, wstart = 0;  // the input column of output column j0; SLICE: j0's window and its start
      bool fast;                     // 8 contiguous input columns inside the row
      if constexpr (MODE == TC_SLICE) {
        wi = j0 / p.win;
        wstart = wi * p.win;
        src0 = min(wstart, p.f_in - p.win - 2) + j0 - wstart + dx;
        fast = j0 + 7 < p.cols && j0 + 7 < wstart + p.win;
      } else {
        src0 = j0 + dx - 1;
        fast = j0 + 7 < p.cols && src0 >= 0 && src0 + 7 < p.f_in;
      }
      unsigned char* dst = taps + dx * p.rsb + 16 * q;
      for (int r = 0; r < TC1_IN; ++r) {
        const int u = u0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (u >= 0 && u < n_in) {
          const int e0 = lead + (u - lo) * p.f_in;  // raw element of (row u, column 0)
          if (fast) {
            v = raw8(raw, e0 + src0);
          } else {  // an edge chunk: each column by the case's map (-1: zero)
            unsigned short h[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int j = j0 + e;
              int c = -1;
              if (j < p.cols) {
                if constexpr (MODE == TC_ROLL) {
                  c = j + dx - 1;
                  c += c < 0 ? p.f_in : c >= p.f_in ? -p.f_in : 0;
                } else if constexpr (MODE == TC_SLICE) {
                  // a chunk spans at most two windows of 8 or more columns
                  const int wj = p.win >= 8 ? (j < wstart + p.win ? wi : wi + 1) : j / p.win;
                  c = min(wj * p.win, p.f_in - p.win - 2) + j - wj * p.win + dx;
                } else {
                  c = j + dx - 1;
                  if (c >= p.f_in) c = -1;
                }
              }
              h[e] = c >= 0 ? raw1(raw, e0 + c) : (unsigned short)0;
            }
            v = pack8(h);
          }
        }
        *reinterpret_cast<uint4*>(dst + r * 3 * p.rsb) = v;
      }
    }
  } else {
    // the band's outputs; the raw element of output 0's tap k is ld0 + k (PATCHES), ld0 + the
    // chunk's clamped offset of tap k (FLAT), or k segments on and (ld0 + k plane) % 8 (PLANES)
    int nv, ld0, lim = 0, plane8 = 0;
    if constexpr (MODE == TC_FLAT) {
      const int chunk = at.chunk, i0 = at.part * tc1_pix(MODE);
      lim = flat_lim(p, chunk);
      nv = min(tc1_pix(MODE), p.cols - i0);
      ld0 = int((base + (long long)chunk * p.cols + i0 + min(0, lim)) & 7) - min(0, lim);
    } else {
      const int p0 = bi * tc1_pix(MODE);
      nv = int(min((long long)tc1_pix(MODE), (long long)p.rows * p.cols - p0));
      ld0 = MODE == TC_PATCHES ? int((base + 9LL * p0) & 7) : int((base + p0) & 7);
      plane8 = int(p.plane & 7);
    }
    for (int it = threadIdx.x; it < 9 * (tc1_pix(MODE) / 8); it += THREADS) {
      const int k = it / (tc1_pix(MODE) / 8), q = it - k * (tc1_pix(MODE) / 8), i0 = 8 * q;
      const int ld = MODE == TC_FLAT      ? ld0 + min((k / 3) * p.f_in + k % 3, lim)
                     : MODE == TC_PLANES ? k * tc1_seg(MODE) + ((ld0 + k * plane8) & 7)
                                         : ld0 + k;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (MODE != TC_PATCHES && i0 + 7 < nv) {
        v = raw8(raw, ld + i0);
      } else if (i0 < nv) {
        unsigned short h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = i0 + e < nv ? raw1(raw, ld + (MODE == TC_PATCHES ? 9 : 1) * (i0 + e)) : (unsigned short)0;
        v = pack8(h);
      }
      *reinterpret_cast<uint4*>(taps + k * tc1_plane_b(MODE) + 16 * q) = v;
    }
  }
}

// x: g, h, a, h2 (ROLL, SLICE): (results, t_in, f_in); v2, v3 (SAME): the
// results' group x t_in rows of f_in; i (PATCHES): (results, rows x cols,
// 9); i2 (PLANES): (results, 9, t_in, f_in), cols = f_in; c, c2 (FLAT): each
// result's flat row of L = t_in elements, res_stride apart. w: (9, 32), or
// with W_CO_K (32, 16) read as it is (k = 9..15 meet zero taps). Persistent
// blocks walk a contiguous range of (result, band) pairs; a band's tiles
// are split between the block's two warpgroups, tile j to warpgroup j % 2.
template <int MODE, bool W_CO_K = false>
__global__ void __launch_bounds__(THREADS, 4)
conv1_tc(const bf16* __restrict__ x, const bf16* __restrict__ w, float* __restrict__ out, float* __restrict__ y,
         unsigned int* __restrict__ done, const Tc1 p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_warp[THREADS / 32];
  const uint32_t s0 = smem_u32(smem), taps = s0 + TC1_TAPS;  // shared addresses
  const int raw_off = TC1_TAPS + (tc1_rows(MODE) ? TC1_IN * 3 * p.rsb : 9 * tc1_plane_b(MODE));  // the stages' offset
  const int n_bands = p.n_res * p.bands;
  const int begin = int((long long)n_bands * blockIdx.x / gridDim.x);
  const int end = int((long long)n_bands * (blockIdx.x + 1) / gridDim.x);

  // the first two bands' copies fly while B is stored
  Tc1Pos cur(p, begin), ahead(p, begin);  // this band; the band whose copies are issued next
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (begin + k < end) tc1_stage<MODE>(s0 + raw_off + k * p.raw_bytes, x, p, ahead);
    ahead.next(p);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < CO1 * 16; i += THREADS) {  // B[k][n] at core matrix (n / 8, k / 8)
    const int n = i >> 4, k = i & 15;
    const bf16 v = W_CO_K ? w[i] : k < 9 ? w[k * CO1 + n] : __float2bfloat16_rn(0.f);
    *reinterpret_cast<bf16*>(smem + (n >> 3) * 256 + (k >> 3) * 128 + (n & 7) * 16 + (k & 7) * 2) = v;
  }
  if (threadIdx.x < 4) reinterpret_cast<uint32_t*>(smem + TC1_ZERO)[threadIdx.x] = 0u;
  fence_proxy_async();  // B's ordinary stores, before wgmma (the async proxy) reads them
  const uint64_t b_desc = tc1_b_desc(s0);

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, wg = threadIdx.x >> 7;
  const int gid = lane >> 2, tq = lane & 3;
  // ldmatrix.x4.trans lane l reads row l % 8 of matrix l / 8: matrix m holds
  // taps 8 (m / 2) .. + 7 (rows) of the 8 outputs of group 2 warp + m % 2
  // (columns), transposed into the A fragment (rows outputs, k taps).
  const int grp = 2 * warp + ((lane >> 3) & 1), tap = (lane >> 4) * 8 + (lane & 7);
  const int dy = tap / 3, dx = tap - 3 * dy;
  uint32_t a_base = s0 + TC1_ZERO, a_step = 0;  // this lane's row of tile 0, and from tile to tile
  if (!tc1_rows(MODE) && tap < 9) a_base = taps + tap * tc1_plane_b(MODE) + 16 * grp, a_step = 128;

  int run = 0;  // warp 0: slots stored since the last count
  for (int band = begin, s = 0; band < end; ++band, s ^= 1, cur.next(p)) {
    const int res = cur.res, bi = cur.bi;
    const int raw = raw_off + s * p.raw_bytes;
    cp_async_wait<1>();
    __syncthreads();  // the band's copies are in; the last band's tiles are done with the tap store
    tc1_build<MODE>(smem + TC1_TAPS, smem + raw, p, cur);
    __syncthreads();  // the tap store is built; the stage is free
    if (band + 2 < end) tc1_stage<MODE>(s0 + raw, x, p, ahead);
    ahead.next(p);
    cp_async_commit();

    int n_tiles, t_a = 0, pix = 0, nv = 0;  // 2-D: the accumulators' first output row; 1-D: the band's outputs
    // 2-D: the lane's row of the first tile of the band's rows 8 half .. 8 half + 7
    auto set_half = [&](int half) {
      const int g = 8 * half + grp, t_g = bi * TC1_ROWS + g;  // the lane's group: a band row
      a_base = s0 + TC1_ZERO, a_step = 0;
      bool on = tap < 9 && t_g < p.rows;
      if (MODE == TC_SAME && on) {  // a tap above a sample's first row or below its last reads zero
        const int t = t_g % p.t_in;
        on = !(dy == 0 && t == 0) && !(dy == 2 && t == p.t_in - 1);
      }
      if (on) a_base = taps + (g + dy) * 3 * p.rsb + dx * p.rsb, a_step = 16;
      t_a = bi * TC1_ROWS + 8 * half + 2 * warp;
    };
    if (tc1_rows(MODE)) {
      n_tiles = (p.cols + 7) / 8;
    } else {
      if constexpr (MODE == TC_FLAT) {
        const int i0 = cur.part * tc1_pix(MODE);
        pix = cur.chunk * p.cols + i0, nv = min(tc1_pix(MODE), p.cols - i0);
      } else {
        pix = bi * tc1_pix(MODE), nv = int(min((long long)tc1_pix(MODE), (long long)p.rows * p.cols - pix));
      }
      n_tiles = (nv + 63) / 64;
    }

    float sum = 0.f, sum_odd = 0.f;  // the even and the odd accumulators' y: two add chains
    // the tile loop, compiled with and without y's stores (no test per tile);
    // unrolled twice, so that the next tile's ldmatrix is issued while this
    // tile's y are summed
    auto tiles = [&](auto with_y) {
      uint32_t a_addr = a_base + wg * a_step;
#pragma unroll 2
      for (int j = wg; j < n_tiles; j += 2, a_addr += 2 * a_step) {
        uint32_t a[4];
        ldsm_x4_trans(a_addr, a);
        float d[16];
        wgmma_fence();  // the A registers just written, before wgmma reads them
        wgmma_n32_fresh(d, a, b_desc);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(d);
        // d[4n], d[4n + 1]: output (2-D: row t_a, column 8j + gid; 1-D: 64j +
        // 16 warp + gid), channels 8n + 2tq, + 1; d[4n + 2], d[4n + 3]: the
        // next row (1-D: 8 outputs on). Outputs past the edges have zero taps,
        // so their y is 0: every y of the tile is summed, in a fixed order.
#pragma unroll
        for (int i = 0; i < 16; i += 2) sum += d[i], sum_odd += d[i + 1];
        if constexpr (decltype(with_y)::value) {
          bool ok0, ok1;
          float *y0, *y1;
          if (tc1_rows(MODE)) {
            const int col = 8 * j + gid;
            ok0 = col < p.cols && t_a < p.rows, ok1 = col < p.cols && t_a + 1 < p.rows;
            y0 = y + ((size_t(res) * p.rows + t_a) * p.cols + col) * CO1 + 2 * tq;
            y1 = y0 + size_t(p.cols) * CO1;
          } else {
            const int i = 64 * j + 16 * warp + gid;
            ok0 = i < nv, ok1 = i + 8 < nv;
            y0 = y + (size_t(res) * p.rows * p.cols + pix + i) * CO1 + 2 * tq;
            y1 = y0 + 8 * CO1;
          }
#pragma unroll
          for (int n = 0; n < CO1 / 8; ++n) {
            if (ok0) *reinterpret_cast<float2*>(y0 + 8 * n) = make_float2(d[4 * n], d[4 * n + 1]);
            if (ok1) *reinterpret_cast<float2*>(y1 + 8 * n) = make_float2(d[4 * n + 2], d[4 * n + 3]);
          }
        }
      }
    };
    for (int half = 0; half < (tc1_rows(MODE) ? TC1_ROWS / 8 : 1); ++half) {
      if constexpr (tc1_rows(MODE)) set_half(half);
      if (y) tiles(std::true_type{});
      else tiles(std::false_type{});
    }
    // the band's sum: threads, a shuffle tree, then the block's 8 warps in order
    sum += sum_odd;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) s_warp[threadIdx.x >> 5] = sum;
    __syncthreads();
    if (threadIdx.x < 32) {
      float total = 0.f;
#pragma unroll
      for (int i = 0; i < THREADS / 32; ++i) total += s_warp[i];
      publish(total, out, done, band, p.bands, lane, run, band + 1 == end || bi + 1 == p.bands);
    }
  }
}

// One persistent launch: as many blocks as fit at once, at most one per band.
template <int MODE, bool W_CO_K = false>
cudaError_t launch_conv1_tc(const bf16* x, const bf16* w, float* out, float* y, unsigned int* done, const Tc1& p,
                            cudaStream_t s) {
  auto kern = conv1_tc<MODE, W_CO_K>;
  const size_t smem = tc1_smem(MODE, p);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // < 2^31: results <= 65535 and bands <= OUT_PER_SAMPLE, checked by the entries
  const long long bands = (long long)p.n_res * p.bands, cap = (long long)per_sm * sm_count();
  kern<<<int(bands < cap ? bands : cap), THREADS, smem, s>>>(x, w, out, y, done, p);
  return cudaSuccess;
}

// The instance of conv1_tc for `mode` (FLAT: W_CO_K for c2's wt).
cudaError_t launch_tc1(int mode, bool w_co_k, const bf16* x, const bf16* w, float* out, float* y, unsigned int* done,
                       const Tc1& p, cudaStream_t s) {
  switch (mode) {
    case TC_ROLL: return launch_conv1_tc<TC_ROLL>(x, w, out, y, done, p, s);
    case TC_SLICE: return launch_conv1_tc<TC_SLICE>(x, w, out, y, done, p, s);
    case TC_SAME: return launch_conv1_tc<TC_SAME>(x, w, out, y, done, p, s);
    case TC_PATCHES: return launch_conv1_tc<TC_PATCHES>(x, w, out, y, done, p, s);
    case TC_PLANES: return launch_conv1_tc<TC_PLANES>(x, w, out, y, done, p, s);
    default:
      return w_co_k ? launch_conv1_tc<TC_FLAT, true>(x, w, out, y, done, p, s)
                    : launch_conv1_tc<TC_FLAT>(x, w, out, y, done, p, s);
  }
}

// g, h, i (dfac_conv_probe kase 0-2) on conv1_tc: ROLL, SLICE (one window
// of all cols), PATCHES.
int probe_tc1_mode(int kase) { return kase == G_ROLL ? TC_ROLL : kase == H_SLICE ? TC_SLICE : TC_PATCHES; }
Tc1 probe_tc1(int kase, int batch, int t_in, int f_in, int rows, int cols) {
  const long long per = kase == I_PATCHES ? 9LL * rows * cols : (long long)t_in * f_in;
  return tc1_geom(probe_tc1_mode(kase), batch, rows, cols, t_in, f_in, 1, cols, per, 0, batch * per);
}

int blocks_per_sample(int kase, int rows, int cols) {
  return kase <= I_PATCHES ? probe_tc1(kase, 1, rows + 2, cols, rows, cols).bands : conv2_tiles(rows, cols);
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

// ---- v1, d: conv1_checksum, a register-tiled conv1 on the CUDA cores ------
//
// A block of 128 threads takes a band of 32 output rows of one sample:
// thread (r, o) = (threadIdx.x / 4, threadIdx.x % 4) forms output row r's y
// for channels 8 o .. 8 o + 7, holding those channels' 72 weights in
// registers for its whole life. It walks its row in quads of 4 columns: a
// quad is 4 x 8 y from the 3 x 6 window of its three input rows, 288 FMAs
// and 32 adds for six 16-byte shared-memory loads. The band's input rows
// arrive by cp.async two bands ahead and are built into f32 rows once.

constexpr int FMA_THREADS = 128;           // a band's 32 output rows x 4 channel octets
constexpr int FMA_ROWS = FMA_THREADS / 4;  // output rows per band (result slot)
constexpr int FMA_IN = FMA_ROWS + 2;       // the band's input rows
constexpr int FMA_BLOCKS = 3;              // at least 3 blocks an SM: at most 168 registers a thread

// A launch's geometry (host-computed): y over t < rows, f < cols of x (B,
// t_in, f_in); SAME (v1) pads x with one zero on each side, VALID (d) reads
// x[t + dy, f + dx].
struct Fma1 {
  int t_in, f_in, rows, cols;
  int bands;           // per sample
  int stride;          // f32 of a built row: every column a quad's window reads, 16-byte aligned
  int raw_bytes;       // one raw stage: a band's input rows as bf16, from the 8-element boundary below them
  long long in_total;  // elements of x (copies past them read zeros)
};

Fma1 fma1_geom(bool same, int batch, int t_in, int f_in) {
  Fma1 p{};
  p.t_in = t_in, p.f_in = f_in;
  p.rows = same ? t_in : t_in - 2, p.cols = same ? f_in : f_in - 2;
  p.bands = (p.rows + FMA_ROWS - 1) / FMA_ROWS;
  p.stride = 4 * ((p.cols + 3) / 4) + 4;
  if (p.stride % 32 == 0) p.stride += 4;  // the two rows of a 16-byte load phase fall on other banks
  p.raw_bytes = ((FMA_IN * f_in + 16) * 2 + 15) / 16 * 16 + 32;  // raw8 reads up to 15 elements past its last
  p.in_total = (long long)batch * t_in * f_in;
  return p;
}

size_t fma1_smem(const Fma1& p) { return size_t(FMA_IN) * p.stride * sizeof(float) + 2 * size_t(p.raw_bytes); }

// A band's place: its sample, first output row, output rows, and the input
// rows [lo, hi) it reads that lie in x.
template <bool SAME>
struct Fma1Band {
  int b, t0, n, lo, hi;
  __device__ Fma1Band(const Fma1& p, int band)
      : b(band / p.bands), t0((band - b * p.bands) * FMA_ROWS), n(min(FMA_ROWS, p.rows - t0)),
        lo(max(t0 - SAME, 0)), hi(min(t0 - SAME + n + 2, p.t_in)) {}
  __device__ long long base(const Fma1& p) const { return (long long)b * p.t_in * p.f_in; }
};

// The copies of a band's input rows into a raw stage (all threads; the
// caller commits one cp.async group).
template <bool SAME>
__device__ void fma1_copy(uint32_t raw, const bf16* __restrict__ x, const Fma1& p, int band) {
  const Fma1Band<SAME> at(p, band);
  const long long base = at.base(p);
  copy_span(raw, x, base + (long long)at.lo * p.f_in, base + (long long)at.hi * p.f_in, p.in_total, threadIdx.x,
            FMA_THREADS);
}

// The band's n + 2 f32 rows from its raw stage: row j is input row t0 -
// SAME + j, its column c input column c - SAME, zero outside x. Eight
// columns a step; inside the row they are one shifted 16-byte read.
template <bool SAME>
__device__ void fma1_build(float* rows, const unsigned char* raw, const Fma1& p, const Fma1Band<SAME>& at) {
  const int lead = int((at.base(p) + (long long)at.lo * p.f_in) & 7);  // raw element of (row lo, column 0)
  const int gpr = (p.stride + 7) / 8;
  for (int it = threadIdx.x; it < (at.n + 2) * gpr; it += FMA_THREADS) {
    const int j = it / gpr, c0 = 8 * (it - j * gpr), u = at.t0 - SAME + j;
    float v[8] = {};
    if (u >= 0 && u < p.t_in) {
      const int e0 = lead + (u - at.lo) * p.f_in + c0 - SAME;  // raw element of column c0
      if (c0 - SAME >= 0 && c0 + 7 - SAME < p.f_in) {
        const uint4 r = raw8(raw, e0);
        const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) v[2 * e] = __uint_as_float(w[e] << 16), v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      } else {  // an edge: each column inside the row, or zero
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ic = c0 + e - SAME;
          if (ic >= 0 && ic < p.f_in) v[e] = __uint_as_float(uint32_t(raw1(raw, e0 + e)) << 16);
        }
      }
    }
    float4* dst = reinterpret_cast<float4*>(rows + j * p.stride + c0);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    if (c0 + 4 < p.stride) dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Element i (0-7, known at compile time) of the 8 built columns lo, hi.
__device__ __forceinline__ float col_of(const float4& lo, const float4& hi, int i) {
  const float4& v = i < 4 ? lo : hi;
  const int j = i & 3;
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One quad: output columns 4q .. 4q + 3 of the thread's row and octet from
// its three input rows' built columns 4q .. 4q + 7 (lo, hi). The y of the
// first `valid` columns (WHOLE: all four) go to the two sums, channel pairs
// in order, and with WITH_Y to yq (the quad's first output, channel 8 o).
template <bool WITH_Y, bool WHOLE>
__device__ __forceinline__ void fma1_quad(const float4 (&lo)[3], const float4 (&hi)[3], const float (&wk)[9][8],
                                          float& s0, float& s1, float* yq, int valid) {
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    float yv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      yv[e] = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) yv[e] = fmaf(col_of(lo[k / 3], hi[k / 3], cc + k % 3), wk[k][e], yv[e]);
    }
    if (WHOLE || cc < valid) {
#pragma unroll
      for (int e = 0; e < 8; e += 2) s0 += yv[e], s1 += yv[e + 1];
      if constexpr (WITH_Y) {
        reinterpret_cast<float4*>(yq + cc * CO1)[0] = make_float4(yv[0], yv[1], yv[2], yv[3]);
        reinterpret_cast<float4*>(yq + cc * CO1)[1] = make_float4(yv[4], yv[5], yv[6], yv[7]);
      }
    }
  }
}

// The thread's output row from its three built input rows (the first at
// `row`): whole quads with no test, then a last partial quad, masked.
// Returns the sum of the row's y. (A window kept across quads in rotating
// registers saves three of the six loads but triples the loop's code, and
// ran slower.)
template <bool WITH_Y>
__device__ __forceinline__ float fma1_row(const float* row, int stride, int cols, const float (&wk)[9][8],
                                          float* yrow) {
  float4 lo[3], hi[3];
  auto load = [&](int c) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      lo[dy] = *reinterpret_cast<const float4*>(row + dy * stride + c);
      hi[dy] = *reinterpret_cast<const float4*>(row + dy * stride + c + 4);
    }
  };
  float s0 = 0.f, s1 = 0.f;
  const int whole = cols / 4;
  for (int q = 0; q < whole; ++q) {
    load(4 * q);
    fma1_quad<WITH_Y, true>(lo, hi, wk, s0, s1, yrow + 4 * CO1 * q, 4);
  }
  if (cols % 4) {
    load(4 * whole);
    fma1_quad<WITH_Y, false>(lo, hi, wk, s0, s1, yrow + 4 * CO1 * whole, cols % 4);
  }
  return s0 + s1;
}

// x (B, t_in, f_in), w (9, 32); n_bands = B x p.bands, walked by persistent
// blocks in contiguous ranges, each band's copies issued two bands ahead
// into a ring of two raw stages. A band's sum (each thread's row, a shuffle
// tree, the 4 warps in order) goes to its slot of out[b] through publish.
template <bool SAME, bool WITH_Y>
__global__ void __launch_bounds__(FMA_THREADS, FMA_BLOCKS)
conv1_checksum(const bf16* __restrict__ x, const bf16* __restrict__ w, float* __restrict__ out,
               float* __restrict__ y, unsigned int* __restrict__ done, int n_bands, const Fma1 p) {
  extern __shared__ __align__(16) unsigned char smem[];  // [FMA_IN][stride] f32, then the two raw stages
  __shared__ float s_warp[FMA_THREADS / 32];
  float* rows = reinterpret_cast<float*>(smem);
  const int raw0 = FMA_IN * p.stride * int(sizeof(float));
  const int oct = threadIdx.x & 3, r = threadIdx.x >> 2, lane = threadIdx.x & 31;
  const int begin = int((long long)n_bands * blockIdx.x / gridDim.x);
  const int end = int((long long)n_bands * (blockIdx.x + 1) / gridDim.x);
#pragma unroll
  for (int k = 0; k < 2; ++k) {  // the first two bands' copies fly while the weights load
    if (begin + k < end) fma1_copy<SAME>(smem_u32(smem + raw0 + k * p.raw_bytes), x, p, begin + k);
    cp_async_commit();
  }
  float wk[9][8];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) wk[k][e] = __bfloat162float(w[k * CO1 + 8 * oct + e]);

  int run = 0;  // warp 0: slots stored since the last count
  for (int band = begin, s = 0; band < end; ++band, s ^= 1) {
    const Fma1Band<SAME> at(p, band);
    const int raw = raw0 + s * p.raw_bytes;
    cp_async_wait<1>();
    __syncthreads();  // the band's copies are in
    fma1_build<SAME>(rows, smem + raw, p, at);
    __syncthreads();  // its rows are built; the raw stage is free
    if (band + 2 < end) fma1_copy<SAME>(smem_u32(smem + raw), x, p, band + 2);
    cp_async_commit();
    float sum = 0.f;
    if (r < at.n)
      sum = fma1_row<WITH_Y>(rows + r * p.stride, p.stride, p.cols, wk,
                             WITH_Y ? y + (size_t(at.b) * p.rows + at.t0 + r) * p.cols * CO1 + 8 * oct : nullptr);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) s_warp[threadIdx.x >> 5] = sum;
    __syncthreads();  // the band's warp sums are in, and no thread reads its rows any more
    if (threadIdx.x < 32)
      publish(((s_warp[0] + s_warp[1]) + s_warp[2]) + s_warp[3], out, done, band, p.bands, lane, run,
              band + 1 == end || at.t0 + FMA_ROWS >= p.rows);
  }
}

// One persistent launch: as many blocks as fit at once, at most one per band.
template <bool SAME>
cudaError_t launch_fma1(const bf16* x, const bf16* w, float* out, float* y, unsigned int* done, int batch,
                        const Fma1& p, cudaStream_t s) {
  auto kern = y ? conv1_checksum<SAME, true> : conv1_checksum<SAME, false>;
  const size_t smem = fma1_smem(p);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, FMA_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // < 2^31: batch <= 65535 and bands <= OUT_PER_SAMPLE, checked by the entry
  const long long bands = (long long)batch * p.bands, cap = (long long)per_sm * sm_count();
  kern<<<int(bands < cap ? bands : cap), FMA_THREADS, smem, s>>>(x, w, out, y, done, int(bands), p);
  return cudaSuccess;
}

// ---- v4: conv1_emit, conv_block.cu's block-1 product on the tensor cores ----
//
// conv_block_cin1_tc's design with v4's epilogue: both conv rows of a pooled
// pixel as one mma.sync m16n8k16 product, K = 16 (the 4 x 3 input window,
// k = 4 * row + col: ops/conv_block.py CIN1_TC_K), N = 64 (conv row 0's 32
// channels, then conv row 1's: CIN1_TC_N), each warp walking 16-pixel tiles
// of the flat (b, to, col) output. B is the weights scaled by 0.5
// (CIN1_TC_SCALE) and C is zero, so the product is y / 2; then per channel
// (y / 2) 1.01 + 0.01 / 2 (multiply and add rounded apart, as the plain
// version), ReLU, the sum of the two conv rows and one cast. Halving commutes
// with every rounding on the way (barring subnormal y), so this is the plain
// version's 0.5 (relu(y 1.01 + 0.01) + relu(y' 1.01 + 0.01)) bit for bit
// on the same y, one multiply a channel cheaper.
// Fragment layout (PTX m16n8k16): lane (g, q) = (lane / 4, lane % 4) holds A
// rows g and g + 8 at k = 2q, 2q + 1 and 2q + 8, 2q + 9, B column g at the
// same k, and accumulators of rows g, g + 8 at columns 2q, 2q + 1.

constexpr int EMIT_TILES = 4;  // 16-pixel tiles per warp and loop trip: their loads in flight together

// n / d for 0 <= n < 2^31 by one multiply and shift (Granlund-Montgomery):
// m = ceil(2^(31 + l) / d) with 2^l >= d, q = (n * m) >> (31 + l).
struct Divisor {
  uint32_t m, shift;
};

Divisor make_divisor(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  return {uint32_t(((1ull << (31 + l)) + d - 1) / d), 31 + l};
}

__device__ __forceinline__ uint32_t div_by(uint32_t n, const Divisor& v) {
  return uint32_t((uint64_t(n) * v.m) >> v.shift);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One channel of a pooled pixel from its conv rows' halved y, a (row 2 to)
// and b.
__device__ __forceinline__ float emit_pool(float a, float b) {
  const float ra = fmaxf(__fadd_rn(__fmul_rn(a, 1.01f), 0.5f * 0.01f), 0.f);
  const float rb = fmaxf(__fadd_rn(__fmul_rn(b, 1.01f), 0.5f * 0.01f), 0.f);
  return ra + rb;
}

// x (B, t_in, f_in), w (9, 32) -> out (B, t_in / 2, f_in, 32) bf16; pixels =
// B x t_in / 2 x f_in.
__global__ void __launch_bounds__(THREADS, 2)
conv1_emit(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out, int t_in, int f_in,
           int pixels, Divisor div_w, Divisor div_to) {
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
      const float lo = tap ? 0.5f * __bfloat162float(w[(dy * 3 + dx) * CO1 + ch]) : 0.f;
      const float hi = tap && dx == 0 ? 0.5f * __bfloat162float(w[(dy * 3 + 1) * CO1 + ch]) : 0.f;
      bw[j][e] = bf16x2(lo, hi);  // exact: half a bf16 is a bf16
    }
  }

  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const int t_out = t_in / 2;
  // this lane's first window value: column col - 1 (even q, with col beside
  // it) or col + 1 (odd q, with the zero column beside it)
  const int dcol = (q & 1) ? 1 : -1;
  const bool pair = !(q & 1);
  const int tiles = (pixels + 15) / 16;
  const int step = gridDim.x * (THREADS / 32) * EMIT_TILES;
  for (int t0 = (blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5)) * EMIT_TILES; t0 < tiles; t0 += step) {
    uint32_t a[EMIT_TILES][4];  // tile t0 + u: A rows g (pixel 16 (t0 + u) + g) and g + 8
#pragma unroll
    for (int u = 0; u < EMIT_TILES; ++u) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * (t0 + u) + g + 8 * half;
        const uint32_t r = div_by(uint32_t(p), div_w);
        const int col = p - int(r) * f_in;
        const uint32_t b = div_by(r, div_to);
        const int to = int(r) - int(b) * t_out;
        const int y0 = 2 * to - 1 + (q >> 1);  // window row q / 2; the second register's is y0 + 2
        const bool in = p < pixels;
        const bool c_ok = in && ((q & 1) ? col + 1 < f_in : col > 0);
        const bool y0_ok = y0 >= 0, y1_ok = y0 + 2 < t_in;
        const unsigned short* row = xs + (ptrdiff_t(b) * t_in + y0) * f_in + col;
        const unsigned short v00 = c_ok && y0_ok ? __ldg(row + dcol) : 0;
        const unsigned short v01 = pair && in && y0_ok ? __ldg(row) : 0;
        const unsigned short v10 = c_ok && y1_ok ? __ldg(row + 2 * f_in + dcol) : 0;
        const unsigned short v11 = pair && in && y1_ok ? __ldg(row + 2 * f_in) : 0;
        a[u][half] = uint32_t(v00) | (uint32_t(v01) << 16);
        a[u][2 + half] = uint32_t(v10) | (uint32_t(v11) << 16);
      }
    }
#pragma unroll
    for (int u = 0; u < EMIT_TILES; ++u) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_bf16_bias(acc[j], a[u], bw[j][0], bw[j][1], 0.f, 0.f);
      // acc[jj] is conv row 2 to, acc[jj + 4] conv row 2 to + 1; accumulator
      // rows g and g + 8 are the two pixels, n-tile jj's columns channels 8q
      // + 2jj, + 1: each lane stores 8 channels of a pixel in one 16-byte store
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          v[jj] = bf16x2(emit_pool(acc[jj][2 * half], acc[jj + 4][2 * half]),
                         emit_pool(acc[jj][2 * half + 1], acc[jj + 4][2 * half + 1]));
        const int p = 16 * (t0 + u) + g + 8 * half;
        if (p < pixels) *reinterpret_cast<uint4*>(out + size_t(p) * CO1 + 8 * q) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

cudaError_t launch_emit(const bf16* x, const bf16* w, bf16* out, int batch, int t_in, int f_in, cudaStream_t s) {
  const long long pixels = (long long)batch * (t_in / 2) * f_in;
  if (pixels == 0) return cudaSuccess;
  if (pixels > 0x7fffffffLL - 16 * EMIT_TILES) return cudaErrorInvalidValue;  // pixel indices stay in int
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv1_emit, THREADS, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // persistent: as many blocks as fit at once, each warp walking EMIT_TILES 16-pixel tiles a trip
  constexpr int per_block = 16 * EMIT_TILES * (THREADS / 32);
  const long long blocks = (pixels + per_block - 1) / per_block, cap = (long long)per_sm * sm_count();
  conv1_emit<<<int(blocks < cap ? blocks : cap), THREADS, 0, s>>>(x, w, out, t_in, f_in, int(pixels),
                                                                  make_divisor(uint32_t(f_in)),
                                                                  make_divisor(uint32_t(t_in / 2)));
  return cudaSuccess;
}

// v2, v3 (SAME), a (SLICE, one window) and c (FLAT, one chunk of Np - 2W)
// on conv1_tc; batch is the results' count.
int pass_tc1_mode(int kase) {
  return kase == A_VALID_MMA ? TC_SLICE : kase == C_FLAT_MMA ? TC_FLAT : TC_SAME;
}
Tc1 pass_tc1(int kase, int batch, int t_in, int f_in, int group) {
  const long long per = (long long)group * t_in * f_in;  // input elements per result (c: t_in = Np, f_in = W)
  if (kase == A_VALID_MMA)
    return tc1_geom(TC_SLICE, batch, t_in - 2, f_in - 2, t_in, f_in, 1, f_in - 2, per, 0, batch * per);
  if (kase == C_FLAT_MMA)
    return tc1_geom(TC_FLAT, batch, 1, t_in - 2 * f_in, t_in, f_in, 1, 0, t_in, 0, (long long)batch * t_in);
  return tc1_geom(TC_SAME, batch, group * t_in, f_in, t_in, f_in, group, f_in, per, 0, batch * per);
}

// Blocks (conv1_tc: bands) per result block of a K7/K8 case (0: its
// geometry is refused).
int pass_blocks(int kase, int t_in, int f_in, int group) {
  switch (kase) {
    case V0_SUMS: return (t_in * f_in + V0_CHUNK - 1) / V0_CHUNK;
    case V1_SAME_FMA: return fma1_geom(true, 1, t_in, f_in).bands;
    case D_VALID_FMA: return t_in >= 3 && f_in >= 3 ? fma1_geom(false, 1, t_in, f_in).bands : 0;
    case F_CONV2_DX: return t_in >= 3 && f_in >= 3 ? conv2_tiles(t_in - 2, f_in - 2) : 0;
    case V2_SAME_MMA: case V3_GROUP_MMA: return pass_tc1(kase, 1, t_in, f_in, group).bands;
    case A_VALID_MMA: return t_in >= 3 && f_in >= 3 ? pass_tc1(kase, 1, t_in, f_in, 1).bands : 0;
    case C_FLAT_MMA: return t_in > 2 * f_in ? pass_tc1(kase, 1, t_in, f_in, 1).bands : 0;
    default: return 0;
  }
}

size_t pass_smem(int kase, int f_in, int n_out) {
  switch (kase) {
    case V1_SAME_FMA: return fma1_smem(fma1_geom(true, 1, 1, f_in));  // t_in only sizes the bands
    case D_VALID_FMA: return fma1_smem(fma1_geom(false, 1, 3, f_in));
    case F_CONV2_DX: return Conv2Cfg<CI2, CO2>::SMEM;
    case V2_SAME_MMA: case V3_GROUP_MMA: case A_VALID_MMA: case C_FLAT_MMA:  // t_in only sizes the bands
      return tc1_smem(pass_tc1_mode(kase), pass_tc1(kase, 1, 2 * f_in + 3, f_in, 1));
    default: return 0;
  }
}

}  // namespace

// kase: 0 g, 1 h, 2 i, 3 j, 4 k. in: x (B, t_in, f_in) bf16 for g/h, patches
// (B, rows, cols, 9) for i (t_in = rows, f_in = cols), h (B, t_in, f_in, 32)
// for j/k; w: (9, 32) for g/h/i (n_out = 32), (9, 32, 64) for j/k (n_out = 64); out
// (B, 8, 128) f32; y: null, or (B, rows, cols, n_out) f32 for every output;
// done: B zeroed counters (scratch). 16-byte aligned `in`, `w` and `out`.
// One kernel launch on `stream`, no synchronisation; returns
// cudaGetLastError().
extern "C" int dfac_conv_probe(int kase, const void* in, const void* w, float* out, float* y, void* done_,
                               int batch, int t_in, int f_in, int rows, int cols, int n_out, void* stream) {
  if (kase < 0 || kase > K_ROLL || batch <= 0 || batch > 65535 || rows <= 0 || cols <= 0 || n_out <= 0 ||
      n_out > 1024 || blocks_per_sample(kase, rows, cols) > OUT_PER_SAMPLE ||
      (kase != I_PATCHES && rows + 2 > t_in) || ((kase == H_SLICE || kase == J_SLICE) && cols + 2 > f_in) ||
      ((kase == G_ROLL || kase == K_ROLL) && cols != f_in) || size_t(t_in) * f_in > (size_t(1) << 30) ||
      n_out != (kase >= J_SLICE ? CO2 : CO1) || (kase == I_PATCHES && (rows != t_in || cols != f_in)) ||
      (kase <= I_PATCHES && tc1_smem(probe_tc1_mode(kase), probe_tc1(kase, 1, t_in, f_in, rows, cols)) > 232448))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(in);
  const bf16* wk = static_cast<const bf16*>(w);
  unsigned int* done = static_cast<unsigned int*>(done_);
  cudaError_t err = cudaSuccess;
  if (kase <= I_PATCHES) {
    err = launch_tc1(probe_tc1_mode(kase), false, x, wk, out, y, done, probe_tc1(kase, batch, t_in, f_in, rows, cols),
                     s);
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
  return kase <= I_PATCHES ? int(tc1_smem(probe_tc1_mode(kase), probe_tc1(kase, 1, 1, f_in, 1, cols)))
                           : int(Conv2Cfg<CI2, CO2>::SMEM);
}

// Stages 11 and 12 (K7, K8). kase: 0 v0, 1 v1, 2 v2, 3 v3, 4 v4, 5 a, 6 c,
// 7 d, 8 f. in: x (B, t_in, f_in) bf16, but for c the flat padded samples
// (B, 1, t_in = Np) with f_in = W (M = Np - 2W outputs), and for f h1 (B,
// t_in, f_in, 32). w: (9, 32) for the conv1 cases v1-v4, a, c, d (n_out =
// 32); w2dx (3, 96, 64) for f (n_out = 64); unused for v0. out: (n_res, 8,
// 128) f32, where n_res = batch result blocks (samples; for v3 groups of
// `group` samples), or for v4 (batch, t_in / 2, f_in, 32) bf16.
// y: null, or every output in f32 (not for v0 and v4). done: n_res zeroed
// counters (scratch; unused for v4). 16-byte aligned `in`, `w` and `out`.
// One kernel launch on `stream`, no synchronisation; returns
// cudaGetLastError().
extern "C" int dfac_conv_pass(int kase, const void* in, const void* w, void* out, float* y, void* done_, int batch,
                              int t_in, int f_in, int n_out, int group, void* stream) {
  if (kase < V0_SUMS || kase > F_CONV2_DX || batch <= 0 || batch > 65535 || t_in <= 0 || f_in <= 0 ||
      group < 1 || (kase != V3_GROUP_MMA && group != 1))
    return (int)cudaErrorInvalidValue;
  // every conv1 case takes kern_v1's 32 output channels, f conv2's 64
  if ((kase != V0_SUMS && n_out != (kase == F_CONV2_DX ? CO2 : CO1)) || (kase == V4_EMIT && t_in < 2) ||
      size_t(t_in) * f_in > (size_t(1) << 30))
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
  cudaError_t err = cudaSuccess;
  switch (kase) {
    case V0_SUMS:
      sum_sq_checksum<<<dim3(blocks, batch), THREADS, 0, s>>>(x, o, done, t_in * f_in);
      break;
    case V1_SAME_FMA:
      err = launch_fma1<true>(x, wk, o, y, done, batch, fma1_geom(true, batch, t_in, f_in), s);
      break;
    case D_VALID_FMA:
      err = launch_fma1<false>(x, wk, o, y, done, batch, fma1_geom(false, batch, t_in, f_in), s);
      break;
    case F_CONV2_DX:
      err = launch_conv2<false, true, CI2, CO2>(x, wk, o, y, done, batch, t_in, f_in, t_in - 2, f_in - 2, s);
      break;
    case V2_SAME_MMA:
    case V3_GROUP_MMA:
    case A_VALID_MMA:
    case C_FLAT_MMA:
      err = launch_tc1(pass_tc1_mode(kase), false, x, wk, o, y, done, pass_tc1(kase, batch, t_in, f_in, group), s);
      break;
    case V4_EMIT:
      err = launch_emit(x, wk, static_cast<bf16*>(out), batch, t_in, f_in, s);
      break;
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

// h2 (SLICE in windows of `win` columns), i2 (PLANES) and c2 (FLAT: cols /
// win chunks of win outputs; xf's rows x t_in elements a sample) on conv1_tc.
int chunk_tc1_mode(int kase) { return kase == H2_WINDOWS ? TC_SLICE : kase == I2_PLANES ? TC_PLANES : TC_FLAT; }
Tc1 chunk_tc1(int kase, int batch, int t_in, int f_in, int rows, int cols, int win) {
  if (kase == H2_WINDOWS) {
    const long long per = (long long)t_in * f_in;
    return tc1_geom(TC_SLICE, batch, rows, cols, t_in, f_in, 1, win, per, 0, batch * per);
  }
  if (kase == I2_PLANES) {
    const long long per = 9LL * t_in * f_in;
    return tc1_geom(TC_PLANES, batch, rows, cols, t_in, f_in, 1, 0, per, (long long)t_in * f_in, batch * per);
  }
  const long long per = (long long)rows * t_in;
  return tc1_geom(TC_FLAT, batch, cols / win, win, t_in, f_in, 1, 0, per, 0, batch * per);
}

// Blocks (conv1_tc: bands) per sample of a K10/K11 case (0: its geometry is
// refused).
int chunk_blocks(int kase, int t_in, int f_in, int rows, int cols, int win) {
  switch (kase) {
    case H2_WINDOWS:
      return win > 0 && cols % win == 0 && rows + 2 <= t_in && win + 2 <= f_in
                 ? chunk_tc1(kase, 1, t_in, f_in, rows, cols, win).bands : 0;
    case I2_PLANES: return rows <= t_in && cols == f_in ? chunk_tc1(kase, 1, t_in, f_in, rows, cols, win).bands : 0;
    case J4_CONV2_DX: case J5_CONV3:
      return rows + 2 <= t_in && cols + 2 <= f_in ? conv2_tiles(rows, cols) : 0;
    case C2_FLAT_CHUNKS:
      return win > 0 && cols % win == 0 && win <= t_in ? chunk_tc1(kase, 1, t_in, f_in, rows, cols, win).bands : 0;
    default: return 0;
  }
}

size_t chunk_smem(int kase, int f_in, int cols, int n_out) {
  switch (kase) {
    case J4_CONV2_DX: return Conv2Cfg<CI2, CO2>::SMEM;
    case J5_CONV3: return Conv2Cfg<CI3, CO3>::SMEM;
    default:  // h2, i2, c2: the rows, the window and the chunks only size the bands
      return tc1_smem(chunk_tc1_mode(kase), chunk_tc1(kase, 1, 1, f_in, 1, cols, cols));
  }
}

}  // namespace

// Stages 14 and 15 (K10, K11); j2 and j3 are dfac_conv_probe's j. kase:
//   0 h2: x (B, t_in, f_in), w9 (9, 32); rows x cols outputs in windows of `win` columns
//   1 i2: p9 (B, 9, t_in, f_in) tap-leading patches, w9 (9, 32); rows <= t_in, cols = f_in
//   2 j4: h1 (B, t_in, f_in, 32), w2i (3, 96, 64) as stage 12's w2dx; rows x cols outputs
//   3 j5: h2 (B, t_in, f_in, 64), w3 (9, 64, 128); rows x cols outputs
//   4 c2: xf (B, rows, L = t_in) of which row 0 is read, flat padded rows of width W = f_in;
//         wt (32, 16); cols = n_chunks x win outputs in chunks of win = Mc
// n_out: 32 (h2, i2, c2), 64 (j4), 128 (j5). out (B, 8, 128)
// f32; y: null, or (B, rows, cols, n_out) f32 for every output (c2: (B, 1,
// cols, 32)); done: B zeroed counters (scratch). 16-byte aligned `in`, `w`
// and `out`. One kernel launch on `stream`, no synchronisation; returns
// cudaGetLastError().
extern "C" int dfac_conv_chunk(int kase, const void* in, const void* w, float* out, float* y, void* done_,
                               int batch, int t_in, int f_in, int rows, int cols, int win, int n_out,
                               void* stream) {
  const int want_out[] = {CO1, CO1, CO2, CO3, CO1};
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
  cudaError_t err = cudaSuccess;
  switch (kase) {
    case H2_WINDOWS:
    case I2_PLANES:
    case C2_FLAT_CHUNKS:
      err = launch_tc1(chunk_tc1_mode(kase), kase == C2_FLAT_CHUNKS, x, wk, out, y, done,
                       chunk_tc1(kase, batch, t_in, f_in, rows, cols, win), s);
      break;
    case J4_CONV2_DX:
      err = launch_conv2<false, true, CI2, CO2>(x, wk, out, y, done, batch, t_in, f_in, rows, cols, s);
      break;
    case J5_CONV3:
      err = launch_conv2<false, false, CI3, CO3>(x, wk, out, y, done, batch, t_in, f_in, rows, cols, s);
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
