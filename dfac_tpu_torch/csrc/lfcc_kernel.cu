// Post-FFT LFCC kernel for Hopper (sm_90a): power spectrum -> 60 cepstra.
//
// Replaces: dfac_tpu/ops/pallas/lfcc_kernel.py  _fb_log_dct_kernel (:41),
// launched by fused_fb_log_dct (:54-88). Same math, per row (one frame):
//   ceps = log(max(P @ FB, floor)) @ DCT[:, :60]    (257 bins, 120 filters)
// The rFFT and the power re^2 + im^2 stay outside, as in the JAX package.
//
// What bounds it on the card: at B=128 (41,088 rows) it reads 42 MB of
// power and writes 9.9 MB of cepstra, ~16 us at 3.35 TB/s. The DCT is
// 2 * 120 * 60 = 14.4 kFLOP per row (0.59 GFLOP per batch, ~9 us at the
// 67 TFLOP/s f32 peak); the banded filterbank ~1 kFLOP per row. Both are
// tens of microseconds, so the kernel is memory-bound only if the DCT runs
// near the FMA rate, i.e. if its operands come from registers and not from
// one shared-memory load per multiply-add.
//
// Design:
//  * One block = 64 rows. A tile is contiguous in device memory (64 x 257
//    floats), so it is copied flat and coalesced into shared memory: 16-byte
//    loads when the tile starts on a 16-byte boundary (every tile does when
//    the tensor does, since 64 * 257 * 4 is a multiple of 16), scalar loads
//    otherwise and for the ragged end. No row stride or padding is needed.
//  * Filterbank + log, f32: a thread owns one row and 30 filters, and a warp
//    covers 32 rows of one filter, so the band bounds and weights are
//    warp-uniform broadcasts and the power reads hit 32 banks (row stride
//    257 is odd). Each filter sums only its band of nonzero bins (host-
//    computed fb_lo / fb_hi), which equals the dense product; the loop is
//    the one in K1's epilogue (csrc/gemm_frontend.cu), term for term. The
//    energies wait in registers, then overwrite the dead power tile.
//  * DCT-II, f32 on the CUDA cores (TF32 would round the f32 operands): the
//    120 x 60 matrix sits in shared memory, and each thread keeps a 4 x 4
//    register tile of outputs, 16 multiply-adds per 5 shared loads, summed
//    over the filters in order, as K1 does.
//  * Real sizes only: the TPU's 128-lane paddings (257 -> 384, 120 -> 128,
//    60 -> 128) and the column mask they needed are gone.
//  * 94.6 KB of shared memory per block, so two blocks share an SM and one
//    block's copy overlaps the other's arithmetic.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int NBINS = 257, NFILT = 120, NCEPS = 60;
constexpr int ROWS = 64;                                     // rows per block
constexpr int THREADS = 256;                                 // 8 warps
constexpr int FSTEP = THREADS / ROWS;                        // filter stride of one thread
constexpr int FILT_PER_THREAD = NFILT / FSTEP;               // 30
constexpr int E_LD = NFILT + 1;                              // log-energy row stride (odd)
constexpr int RT = 4, CT = 4;                                // DCT register tile
constexpr int CGROUPS = NCEPS / CT;                          // 15
constexpr int DCT_THREADS = (ROWS / RT) * CGROUPS;           // 240

constexpr size_t SMEM_DCT = size_t(NFILT) * NCEPS * sizeof(float);  // 28,800
constexpr size_t SMEM_TILE = size_t(ROWS) * NBINS * sizeof(float);  // 65,792
constexpr size_t SMEM = SMEM_DCT + SMEM_TILE;

static_assert(THREADS % ROWS == 0 && NFILT % FSTEP == 0, "filters split evenly over threads");
static_assert(ROWS % RT == 0 && NCEPS % CT == 0 && DCT_THREADS <= THREADS, "DCT tiles cover the block");
static_assert(ROWS * E_LD <= ROWS * NBINS, "energies alias the power tile");
static_assert(SMEM_DCT % 16 == 0 && (NCEPS * sizeof(float)) % 16 == 0, "16-byte DCT rows and tile start");
static_assert(2 * SMEM <= 232448, "two blocks per SM");

__global__ void __launch_bounds__(THREADS, 2)
fb_log_dct_kernel(const float* __restrict__ power, const float* __restrict__ fb,
                  const int* __restrict__ fb_lo, const int* __restrict__ fb_hi,
                  const float* __restrict__ dct, float* __restrict__ out,
                  int total_rows, float log_floor) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sD = reinterpret_cast<float*>(smem);  // (120, 60) DCT
  float* sP = sD + NFILT * NCEPS;              // (64, 257) power tile
  float* sE = sP;                              // (64, 121) log energies, after the tile dies
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, total_rows - row0);

  for (int i = threadIdx.x; i < NFILT * NCEPS / 4; i += THREADS)
    reinterpret_cast<float4*>(sD)[i] = __ldg(reinterpret_cast<const float4*>(dct) + i);

  // the tile, flat: power[row0 * 257, (row0 + rows) * 257) -> sP; zeros past the end
  const float* src = power + size_t(row0) * NBINS;
  const int n = rows * NBINS;
  int n4 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += THREADS)
      reinterpret_cast<float4*>(sP)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
  }
  for (int i = 4 * n4 + threadIdx.x; i < n; i += THREADS) sP[i] = __ldg(src + i);
  for (int i = n + threadIdx.x; i < ROWS * NBINS; i += THREADS) sP[i] = 0.f;
  __syncthreads();

  // filterbank (banded) + log, f32: row r, filters m0, m0 + 4, ..., m0 + 116
  const int r = threadIdx.x % ROWS, m0 = threadIdx.x / ROWS;
  const float* p = sP + r * NBINS;
  float e[FILT_PER_THREAD];
#pragma unroll
  for (int j = 0; j < FILT_PER_THREAD; ++j) {
    const int m = m0 + j * FSTEP;
    float acc = 0.f;
    for (int k = __ldg(fb_lo + m), hi = __ldg(fb_hi + m); k <= hi; ++k)
      acc = fmaf(p[k], __ldg(fb + k * NFILT + m), acc);
    e[j] = logf(fmaxf(acc, log_floor));
  }
  __syncthreads();  // every power read is done before the energies overwrite the tile
#pragma unroll
  for (int j = 0; j < FILT_PER_THREAD; ++j) sE[r * E_LD + m0 + j * FSTEP] = e[j];
  __syncthreads();

  // DCT-II (orthonormal), first 60, f32: rows 4 rg .. 4 rg + 3, cepstra 4 cg .. 4 cg + 3
  if (threadIdx.x >= DCT_THREADS) return;
  const int rg = threadIdx.x / CGROUPS, cg = threadIdx.x - rg * CGROUPS;
  const float* e0 = sE + rg * RT * E_LD;
  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;
#pragma unroll 4
  for (int m = 0; m < NFILT; ++m) {
    const float4 d = reinterpret_cast<const float4*>(sD + m * NCEPS)[cg];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float x = e0[i * E_LD + m];
      acc[i][0] = fmaf(x, d.x, acc[i][0]);
      acc[i][1] = fmaf(x, d.y, acc[i][1]);
      acc[i][2] = fmaf(x, d.z, acc[i][2]);
      acc[i][3] = fmaf(x, d.w, acc[i][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int lr = rg * RT + i;
    if (lr < rows)
      reinterpret_cast<float4*>(out + size_t(row0 + lr) * NCEPS)[cg] =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace

// power (rows, 257) f32, contiguous, any 4-byte alignment; fb (257, 120);
// fb_lo / fb_hi (120,) int32; dct (120, 60), 16-byte aligned;
// out (rows, 60) f32, 16-byte aligned.
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int dfac_fb_log_dct(const float* power, const float* fb, const int* fb_lo,
                               const int* fb_hi, const float* dct, float* out, int rows,
                               float log_floor, void* stream) {
  if (rows <= 0 || rows > INT_MAX - ROWS || (reinterpret_cast<uintptr_t>(dct) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fb_log_dct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return (int)err;
  fb_log_dct_kernel<<<(rows + ROWS - 1) / ROWS, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      power, fb, fb_lo, fb_hi, dct, out, rows, log_floor);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of the post-FFT kernel, in bytes.
extern "C" int dfac_fb_log_dct_smem() { return int(SMEM); }
