// GEMM-native LFCC front-end for Hopper (sm_90a): waveform -> 60 cepstra.
//
// Replaces: dfac_tpu/ops/pallas/gemm_frontend.py  _frontend_kernel (:71),
// launched by gemm_lfcc_cepstra (:93-135). Same math, per frame:
//   re, im = frame @ windowed cos / sin DFT basis   (K = 320, 257 bins)
//   P      = re^2 + im^2
//   ceps   = log(max(P @ FB, floor)) @ DCT[:, :60]  (120 filters)
//
// What bounds it on the card: the DFT product is 2 * 320 * 514 = 329k
// FLOP per frame against 1.3 kB of waveform read and 240 B of cepstra
// written, far above the H100's ~295 FLOP/byte ridge, so it is bound by
// the tensor cores (bf16) or the FP32 pipes (f32 mode), plus the time the
// block spends re-staging the 348 kB basis through shared memory.
//
// Design:
//  * One block = 64 frames. Frames are read straight from the waveform
//    (hop = win/2: frame t is samples [160 t, 160 t + 320)), rounded to
//    the compute dtype, and kept in shared memory; no frames tensor is
//    ever written to device memory.
//  * bf16 mode: WMMA 16x16x16 bf16 products with f32 accumulation. The
//    basis groups 16 bins per 32 columns (cos, then sin of the same bins),
//    so a warp's cos and sin accumulators for one group hold the same
//    (frame, bin) at the same fragment index and the power is formed in
//    registers. The basis (320 x 544 bf16) does not fit beside the tiles,
//    so it is streamed in chunks of up to 4 groups (320 x 128).
//  * f32 mode: the DFT runs on the CUDA cores in full f32 (TF32 would lose
//    the precision the mode exists for).
//  * Filterbank, log and DCT run in f32 on the 64 x 272 power tile in
//    shared memory. Each triangular filter sums only its band of nonzero
//    bins (host-computed fb_lo / fb_hi), which equals the dense product.
//  * Only the tensor-core tile padding remains (257 -> 272 bins); the
//    TPU's 128-lane padding (320 -> 384, 120 -> 128, 60 -> 128) is gone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int WIN = 320, HOP = 160, NBINS = 257, NFILT = 120, NCEPS = 60;
constexpr int GROUP = 16;                                            // bins per column group
constexpr int NGROUPS = (NBINS + GROUP - 1) / GROUP;                 // 17
constexpr int CHUNK = 4;                                             // groups per staged chunk
constexpr int BASIS_COLS = NGROUPS * 2 * GROUP;                      // 544
constexpr int ROWS = 64;                                             // frames per block
constexpr int THREADS = 256;                                         // 8 warps
constexpr int P_LD = NGROUPS * GROUP + 4;                            // power row stride (f32)
constexpr int E_LD = NFILT + 1;                                      // log-energy row stride (f32)
constexpr int A_LD = WIN + 8;                                        // bf16 frame row stride
constexpr int B_COLS = CHUNK * 2 * GROUP;                            // 128
constexpr int B_LD = B_COLS + 8;                                     // bf16 basis-chunk row stride

constexpr size_t SMEM_P = size_t(ROWS) * P_LD * sizeof(float);
constexpr size_t SMEM_BF16 = size_t(ROWS) * A_LD * 2 + size_t(WIN) * B_LD * 2 + SMEM_P;
constexpr size_t SMEM_F32 = size_t(ROWS) * WIN * sizeof(float) + SMEM_P;
static_assert(size_t(ROWS) * E_LD * 4 <= size_t(WIN) * B_LD * 2, "energies alias the basis chunk");
static_assert(SMEM_BF16 <= 232448 && SMEM_F32 <= 232448, "227 KB of shared memory per block");

// 64 frames of the waveform -> shared memory, rounded to T (zeros past the end).
template <typename T>
__device__ void load_frames(T* sA, int lda, const float* __restrict__ wave, int row0,
                            int total_rows, int n_samples, int n_frames) {
  for (int i = threadIdx.x; i < ROWS * WIN; i += THREADS) {
    const int r = i / WIN, j = i - r * WIN, g = row0 + r;
    float v = 0.f;
    if (g < total_rows) {
      const int u = g / n_frames, t = g - u * n_frames;
      v = __ldg(wave + size_t(u) * n_samples + size_t(t) * HOP + j);
    }
    if constexpr (sizeof(T) == 2) {
      sA[r * lda + j] = __float2bfloat16_rn(v);
    } else {
      sA[r * lda + j] = v;
    }
  }
}

// bf16 DFT on the tensor cores: power spectrum of 64 frames -> sP.
// Warp w owns rows [32 (w & 1), +32) and group (w >> 1) of each chunk.
__device__ void dft_power_bf16(const bf16* sA, bf16* sB, float* sP, const bf16* __restrict__ basis) {
  const int warp = threadIdx.x >> 5;
  const int rs = warp & 1, gc = warp >> 1;
  for (int c0 = 0; c0 < NGROUPS; c0 += CHUNK) {
    __syncthreads();  // the previous chunk's readers are done
    const int groups = NGROUPS - c0 < CHUNK ? NGROUPS - c0 : CHUNK;
    const int vec = groups * 2 * GROUP / 8;  // 16-byte vectors per basis row of the chunk
    for (int i = threadIdx.x; i < WIN * vec; i += THREADS) {
      const int k = i / vec, v = i - k * vec;
      const uint4 val = *reinterpret_cast<const uint4*>(basis + size_t(k) * BASIS_COLS + c0 * 2 * GROUP + v * 8);
      *reinterpret_cast<uint4*>(sB + k * B_LD + v * 8) = val;
    }
    __syncthreads();
    const int g = c0 + gc;
    if (g >= NGROUPS) continue;  // warp-uniform: the last chunk is short
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> re[2], im[2];
    for (int i = 0; i < 2; ++i) {
      wmma::fill_fragment(re[i], 0.f);
      wmma::fill_fragment(im[i], 0.f);
    }
    for (int k = 0; k < WIN; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bc, bs;
      wmma::load_matrix_sync(bc, sB + k * B_LD + gc * 2 * GROUP, B_LD);
      wmma::load_matrix_sync(bs, sB + k * B_LD + gc * 2 * GROUP + GROUP, B_LD);
      for (int i = 0; i < 2; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sA + (rs * 32 + i * 16) * A_LD + k, A_LD);
        wmma::mma_sync(re[i], a, bc, re[i]);
        wmma::mma_sync(im[i], a, bs, im[i]);
      }
    }
    for (int i = 0; i < 2; ++i) {
      // same fragment type => same (row, col) at the same index
      for (int e = 0; e < re[i].num_elements; ++e)
        re[i].x[e] = re[i].x[e] * re[i].x[e] + im[i].x[e] * im[i].x[e];
      wmma::store_matrix_sync(sP + (rs * 32 + i * 16) * P_LD + g * GROUP, re[i], P_LD, wmma::mem_row_major);
    }
  }
}

// f32 DFT on the CUDA cores: one bin x 8 frames per task.
__device__ void dft_power_f32(const float* sA, float* sP, const float* __restrict__ basis) {
  for (int task = threadIdx.x; task < NBINS * (ROWS / 8); task += THREADS) {
    const int rg = task / NBINS, bin = task - rg * NBINS;
    const int col = (bin / GROUP) * 2 * GROUP + bin % GROUP;
    float re[8], im[8];
    for (int r = 0; r < 8; ++r) re[r] = im[r] = 0.f;
    const float* a = sA + rg * 8 * WIN;
    for (int k = 0; k < WIN; ++k) {
      const float c = __ldg(basis + size_t(k) * BASIS_COLS + col);
      const float s = __ldg(basis + size_t(k) * BASIS_COLS + col + GROUP);
      for (int r = 0; r < 8; ++r) {
        const float x = a[r * WIN + k];  // broadcast: one address per warp
        re[r] = fmaf(x, c, re[r]);
        im[r] = fmaf(x, s, im[r]);
      }
    }
    for (int r = 0; r < 8; ++r) sP[(rg * 8 + r) * P_LD + bin] = re[r] * re[r] + im[r] * im[r];
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
frontend_kernel(const float* __restrict__ wave, const void* __restrict__ basis,
                const float* __restrict__ fb, const int* __restrict__ fb_lo,
                const int* __restrict__ fb_hi, const float* __restrict__ dct,
                float* __restrict__ out, int total_rows, int n_samples, int n_frames,
                float log_floor) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row0 = blockIdx.x * ROWS;
  float* sP;
  float* sE;  // log energies, aliasing the (dead) DFT operands
  if constexpr (BF16) {
    bf16* sA = reinterpret_cast<bf16*>(smem);
    bf16* sB = sA + ROWS * A_LD;
    sP = reinterpret_cast<float*>(sB + WIN * B_LD);
    sE = reinterpret_cast<float*>(sB);
    load_frames(sA, A_LD, wave, row0, total_rows, n_samples, n_frames);
    dft_power_bf16(sA, sB, sP, static_cast<const bf16*>(basis));
  } else {
    float* sA = reinterpret_cast<float*>(smem);
    sP = sA + ROWS * WIN;
    sE = sA;
    load_frames(sA, WIN, wave, row0, total_rows, n_samples, n_frames);
    __syncthreads();
    dft_power_f32(sA, sP, static_cast<const float*>(basis));
  }
  __syncthreads();

  // filterbank (banded) + log, f32
  for (int i = threadIdx.x; i < ROWS * NFILT; i += THREADS) {
    const int r = i / NFILT, m = i - r * NFILT;
    const float* p = sP + r * P_LD;
    float e = 0.f;
    for (int k = __ldg(fb_lo + m), hi = __ldg(fb_hi + m); k <= hi; ++k)
      e = fmaf(p[k], __ldg(fb + k * NFILT + m), e);
    sE[r * E_LD + m] = logf(fmaxf(e, log_floor));
  }
  __syncthreads();

  // DCT-II (orthonormal), first 60, f32
  for (int i = threadIdx.x; i < ROWS * NCEPS; i += THREADS) {
    const int r = i / NCEPS, c = i - r * NCEPS, g = row0 + r;
    if (g >= total_rows) continue;
    const float* e = sE + r * E_LD;
    float acc = 0.f;
    for (int m = 0; m < NFILT; ++m) acc = fmaf(e[m], __ldg(dct + m * NCEPS + c), acc);
    out[size_t(g) * NCEPS + c] = acc;
  }
}

}  // namespace

// wave (n_utt, n_samples) f32; basis (320, 544) bf16 or f32; fb (257, 120);
// fb_lo / fb_hi (120,) int32; dct (120, 60); out (n_utt * n_frames, 60) f32.
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int dfac_gemm_frontend(const float* wave, const void* basis, const float* fb,
                                  const int* fb_lo, const int* fb_hi, const float* dct,
                                  float* out, int n_utt, int n_samples, int n_frames,
                                  float log_floor, int bf16_mode, void* stream) {
  const long long total = (long long)n_utt * n_frames;
  if (total <= 0 || total > INT_MAX - ROWS || n_samples < (n_frames - 1) * HOP + WIN)
    return (int)cudaErrorInvalidValue;
  const int blocks = int((total + ROWS - 1) / ROWS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16_mode) {
    err = cudaFuncSetAttribute(frontend_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BF16));
    if (err != cudaSuccess) return (int)err;
    frontend_kernel<true><<<blocks, THREADS, SMEM_BF16, s>>>(
        wave, basis, fb, fb_lo, fb_hi, dct, out, int(total), n_samples, n_frames, log_floor);
  } else {
    err = cudaFuncSetAttribute(frontend_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_F32));
    if (err != cudaSuccess) return (int)err;
    frontend_kernel<false><<<blocks, THREADS, SMEM_F32, s>>>(
        wave, basis, fb, fb_lo, fb_hi, dct, out, int(total), n_samples, n_frames, log_floor);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of the front-end kernel, in bytes.
extern "C" int dfac_gemm_frontend_smem(int bf16_mode) { return int(bf16_mode ? SMEM_BF16 : SMEM_F32); }
