// GEMM-native LFCC front-end for Hopper (sm_90a): waveform -> 60 cepstra.
//
// Replaces: dfac_tpu/ops/pallas/gemm_frontend.py  _frontend_kernel (:71),
// launched by gemm_lfcc_cepstra (:93-135). Same math, per frame:
//   re, im = frame @ windowed cos / sin DFT basis   (K = 320, 257 bins)
//   P      = re^2 + im^2
//   ceps   = log(max(P @ FB, floor)) @ DCT[:, :60]  (120 filters)
// Frame t of an utterance is samples [160 t, 160 t + 320): two consecutive
// 160-sample blocks. Frames are read straight from the waveform; no frames
// tensor is written to device memory.
//
// Only bins 0..255 are computed: the last triangular filter ends at bin 255,
// so bin 256 feeds no filter (P @ FB multiplies it by zeros). The wrapper
// checks that, and the other facts of the filterbank the epilogue relies on
// (ops/gemm_frontend.py, kernel_constants).
//
// What bounds it on the card, at B = 128 (41,088 frames): the DFT is 2 * 320
// * 514 = 329 kFLOP per frame, 13.5 GFLOP a batch, 0.0137 ms at the bf16
// tensor-core peak and 0.2 ms at the f32 CUDA-core peak; the epilogue is ~15
// kFLOP of f32 per frame (0.009 ms); the waveform read and the cepstra
// written are 36 MB (0.011 ms). So: operations, on the tensor cores in bf16
// mode and on the FP32 pipes in f32 mode.
//
// bf16 mode (frontend_bf16), the serving chain's front-end:
//  * Persistent blocks, one per SM, of four warpgroups: two issue the
//    wgmmas and write the power, two run the filters, log and DCT of the
//    same rows a chunk behind (the filters and the DCT are CUDA-core work
//    that two warps per scheduler could not keep beside the wgmmas). Each
//    block walks tiles of 128 frames (row half w, 64 rows, to wgmma
//    warpgroup w and epilogue warpgroup w) in a grid-stride loop; 321 tiles
//    at B = 128.
//  * A, the frames: each warpgroup loads its 64 rows as bf16 (rounded by
//    __float2bfloat16_rn), 320 + 8 per row (656-byte rows: ldmatrix rows land
//    on distinct bank quads). Each 160-sample block is read from device
//    memory once and stored into both frames that hold it; 16-byte loads
//    where the utterance's row is 16-byte aligned, scalar loads where not,
//    ten in flight per thread. A reaches wgmma from registers by ldmatrix.x4.
//  * B, the windowed basis, 320 x 512 bf16 (330 KB) stays in global memory
//    (L2) as the ring's stage images: [chunk 4][K slab 10][N 128][K 32],
//    K-major, already in the 64-byte swizzle (ops/gemm_frontend.py,
//    swizzle64). Thread 0 streams them through a ring of 7 stages (N 128 x
//    K 32 = 8 KB each), one bulk copy (1-D TMA) per stage, with an mbarrier
//    "full" per stage (expect_tx, then the copy's bytes) and one "empty"
//    (each wgmma warp arrives once its wgmmas on the stage are done; thread
//    0 then refills it). Small stages keep more of them in flight in the
//    same shared memory.
//  * Columns are interleaved by 8: columns 16g..16g+7 of a chunk are the
//    cos of bins 8g..8g+7, 16g+8..16g+15 their sin. So a thread's
//    accumulator holds the cos and the sin of the same (frame, bin), and
//    the power forms in registers. One wgmma m64n128k16 per k16 step; a
//    chunk is 64 bins, 4 chunks x 10 slabs = 40 ring steps per tile.
//  * Epilogue, f32, per chunk, in a fixed order (no float atomics, so two
//    calls agree bit for bit): the wgmma warpgroup writes the power into a
//    ring of 68 bins per row in shared memory (the chunk's 64 and the 4
//    before, as a filter spans at most 5 bins) and hands it over by a named
//    barrier; the epilogue warpgroup sums each filter whose last bin is in
//    the chunk over its band in ascending bin order -> log -> the chunk's
//    log energies, hands the ring back, and adds those filters' DCT terms
//    (constants in shared memory, 120 x 64, zero past 60) into 4 x 8
//    cepstra per thread in registers.
//  * Shared memory: ring 57,344 + A 83,968 + power 35,328 + log energies
//    16,384 + DCT 30,720 + bands, rows and barriers 6,000 + alignment 1,024
//    = 230,768 B.
//
// f32 mode (frontend_f32), the extraction CLI's `gemm` method: exact f32
// products on the CUDA cores (TF32 would lose the precision the mode exists
// for), as a register-tiled SGEMM with the same epilogue; see the kernel.
//  * Shared memory: ring 49,152 + frames 81,920 + power 34,048 + log
//    energies 16,384 + DCT 30,720 + bands and rows 5,120 = 217,344 B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace dfac;
using bf16 = __nv_bfloat16;

constexpr int WIN = 320, HOP = 160, NFILT = 120, NCEPS = 60;
constexpr int MAX_BAND = 5;  // bins per filter, at most (checked by the wrapper)
constexpr int CEPS_LD = 64;  // DCT columns, padded from 60
constexpr int ROWS = 64;     // frames per warpgroup (bf16) or per block (f32)

// ---- shared epilogue: filterbank -> log -> DCT, f32 -------------------------

constexpr int W_LD = 8;  // a filter's band weights, padded: two float4 loads

struct Epilogue {
  const float* dct;  // [NFILT][CEPS_LD]
  const float* fbw;  // [NFILT][W_LD]: the band's weights, zero past its end
  const int* lo;     // [NFILT] first bin of the band
  const int* f0;     // [chunks + 1]: filters whose last bin lies before chunk c
};

// The epilogue's constants, by every thread of the block.
__device__ void load_epilogue(float* dct_s, float* fbw_s, int* lo_s, int* f0_s, int chunks, int chunk_bins,
                              const float* __restrict__ fb, const int* __restrict__ fb_lo,
                              const int* __restrict__ fb_hi, const float* __restrict__ dct) {
  for (int i = threadIdx.x; i < NFILT * CEPS_LD; i += blockDim.x) {
    const int f = i / CEPS_LD, c = i % CEPS_LD;
    dct_s[i] = c < NCEPS ? dct[f * NCEPS + c] : 0.f;
  }
  for (int i = threadIdx.x; i < NFILT * W_LD; i += blockDim.x) {
    const int f = i / W_LD, b = i % W_LD, lo = fb_lo[f];
    fbw_s[i] = lo + b <= fb_hi[f] ? fb[(lo + b) * NFILT + f] : 0.f;
  }
  for (int f = threadIdx.x; f < NFILT; f += blockDim.x) lo_s[f] = fb_lo[f];
  if (int(threadIdx.x) <= chunks) {
    int n = 0;
    for (int f = 0; f < NFILT; ++f) n += fb_hi[f] < int(threadIdx.x) * chunk_bins;
    f0_s[threadIdx.x] = n;
  }
}

// Log energies, for row r, of filters k = q, q + nq, q + 2 nq, ... of those
// chunk c completes: each sums its band
// in ascending bin order from the power ring (bin b at b % RING), as 5 terms;
// the terms past the band's end have weight 0 (the ring holds finite values
// everywhere: it is zeroed at the start), so they leave the sum as it was.
// Four filters in flight per thread.
template <int RING, int P_LD>
__device__ __forceinline__ void filters_log(const float* p, float* log_e, const Epilogue& ep, int c, int r, int q,
                                            int nq, float log_floor) {
  constexpr int U = 4;
  const int fa = ep.f0[c], m1 = (ep.f0[c + 1] - fa - q + nq - 1) / nq;  // this thread's filters
  const float* pr = p + r * P_LD;
  for (int m0 = 0; m0 < m1; m0 += U) {
    float e[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      e[u] = 0.f;
      if (m0 + u < m1) {
        const int f = fa + q + (m0 + u) * nq, pos0 = ep.lo[f] % RING;
        const float4 w0 = *reinterpret_cast<const float4*>(ep.fbw + f * W_LD);
        const float w4 = ep.fbw[f * W_LD + 4];
        const float w[MAX_BAND] = {w0.x, w0.y, w0.z, w0.w, w4};
#pragma unroll
        for (int b = 0; b < MAX_BAND; ++b) {
          const int pos = pos0 + b;
          e[u] = fmaf(pr[pos < RING ? pos : pos - RING], w[b], e[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (m0 + u < m1) log_e[(q + (m0 + u) * nq) * ROWS + r] = logf(fmaxf(e[u], log_floor));  // [filter - fa][row]
  }
}

// ceps (RT rows x CT columns of this thread, rows rg * RT.., columns cg * CT..)
// += chunk c's log energies ([filter][row]) @ those filters' DCT rows.
template <int RT, int CT>
__device__ __forceinline__ void dct_partial(float (&acc)[RT][CT], const float* log_e, const Epilogue& ep, int c,
                                            int rg, int cg) {
  static_assert(RT % 4 == 0 && CT % 4 == 0, "float4 operands");
  const float* dct = ep.dct + ep.f0[c] * CEPS_LD + cg * CT;
  const int nf = ep.f0[c + 1] - ep.f0[c];
#pragma unroll 2
  for (int k = 0; k < nf; ++k) {
    float e[RT], d[CT];
#pragma unroll
    for (int i = 0; i < RT; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(log_e + k * ROWS + rg * RT + i);
      e[i] = v.x, e[i + 1] = v.y, e[i + 2] = v.z, e[i + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < CT; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(dct + k * CEPS_LD + j);
      d[j] = v.x, d[j + 1] = v.y, d[j + 2] = v.z, d[j + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(e[i], d[j], acc[i][j]);
  }
}

template <int RT, int CT>
__device__ __forceinline__ void store_ceps(const float (&acc)[RT][CT], float* __restrict__ out, int row0,
                                           int total_rows, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = row0 + rg * RT + i;
    if (row >= total_rows) continue;
#pragma unroll
    for (int j = 0; j < CT; j += 4) {
      const int col = cg * CT + j;
      if (col < NCEPS)
        *reinterpret_cast<float4*>(out + size_t(row) * NCEPS + col) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
    }
  }
}

// Four samples from device memory; 16-byte load where aligned.
__device__ __forceinline__ float4 ld4(const float* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// ---- bf16 mode ----------------------------------------------------------------

namespace bf {
// warpgroups 0-1: wgmma and power; 2-3: filters, log and DCT of the same
// rows. 16 warps, 4 per scheduler: up to 128 registers a thread (a 17th
// warp, as a producer, would cap them at 96)
constexpr int CONSUMERS = 256, EPILOGUE = 256, THREADS = CONSUMERS + EPILOGUE;
constexpr int TILE = 2 * ROWS;                            // frames per tile
constexpr int CHUNK_BINS = 64, CHUNKS = 4, N = 2 * CHUNK_BINS, KS = 32, SLABS = WIN / KS;
constexpr int STEPS = CHUNKS * SLABS;  // ring steps per tile
constexpr int STAGES = 7;
constexpr int STAGE_BYTES = N * KS * 2;  // 8 KB: 128 rows of 64 bytes
constexpr int A_LD = WIN + 8;            // bf16 per frame row
constexpr int RING = CHUNK_BINS + MAX_BAND - 1;  // power ring: the chunk's bins and the 4 before
constexpr int P_LD = RING + 1;  // odd: the filters' column reads hit 32 banks
constexpr int MAX_CF = 32;  // filters completed per chunk, at most (checked by the wrapper)
constexpr int DCT_RT = 4, DCT_CT = 8;  // 16 x 8 threads of a warpgroup over 64 rows x 64 columns
// named barriers (0 is __syncthreads): per row half w, its wgmma warpgroup's
// own, the power ring's hand-overs each way, its epilogue warpgroup's own
constexpr int BAR_MMA = 1, BAR_FREE = 3, BAR_READY = 5, BAR_EPI = 7;

constexpr size_t OFF_A = size_t(STAGES) * STAGE_BYTES;
constexpr size_t OFF_P = OFF_A + size_t(TILE) * A_LD * 2;
constexpr size_t OFF_E = OFF_P + size_t(TILE) * P_LD * 4;
constexpr size_t OFF_D = OFF_E + size_t(2) * MAX_CF * ROWS * 4;
constexpr size_t OFF_FBW = OFF_D + size_t(NFILT) * CEPS_LD * 4;
constexpr size_t OFF_LO = OFF_FBW + size_t(NFILT) * W_LD * 4;
constexpr size_t OFF_F0 = OFF_LO + NFILT * 4;
constexpr size_t OFF_ROW = OFF_F0 + 32;
constexpr size_t OFF_TAIL = OFF_ROW + size_t(TILE) * 8;
constexpr size_t OFF_BAR = OFF_TAIL + size_t(TILE) * 4;
constexpr size_t ALIGN = 1024;  // the 128-byte swizzle repeats every 1024 bytes
constexpr size_t SMEM = ALIGN + OFF_BAR + 2 * STAGES * 8;
static_assert(SMEM <= 232448, "227 KB of shared memory per block");
static_assert(WIN % KS == 0 && OFF_A % 16 == 0 && OFF_E % 16 == 0 && OFF_D % 16 == 0 && OFF_FBW % 16 == 0 &&
                  OFF_ROW % 8 == 0 && OFF_BAR % 8 == 0, "layout");
static_assert(ROWS * CEPS_LD == 128 * DCT_RT * DCT_CT, "a warpgroup's DCT tiles");

__device__ __forceinline__ void bar_sync(int id, int n) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A warpgroup's 64 frame rows (from row0) -> bf16 rows of 320 (+8) in sA;
// rows past the end are zero. Row r's first block (samples 0-159) is read
// once and stored into row r and, when row r - 1 is the frame before it in
// the same utterance, into row r - 1's second half; the other second halves
// (an utterance's last frame, the warpgroup's last row) are read on their own.
__device__ void load_frames(bf16* sA, long long* row_off, int* tail, const float* __restrict__ wave, int row0,
                            int total_rows, int n_samples, int n_frames, int wg, int wt) {
  if (wt < ROWS) {
    const int g = row0 + wt;
    if (g < total_rows) {
      const int u = g / n_frames, t = g - u * n_frames;
      row_off[wt] = (long long)u * n_samples + (long long)t * HOP;
      tail[wt] = t == n_frames - 1 || wt == ROWS - 1;
    } else {
      row_off[wt] = -1;
      tail[wt] = 1;
    }
  }
  bar_sync(BAR_MMA + wg, 128);
  constexpr int V = HOP / 4;  // 4-sample vectors per block
  auto put = [&](int r, int half, int v, float4 x) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 bits;
    bits.x = *reinterpret_cast<const uint32_t*>(&lo);
    bits.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(sA + r * A_LD + half * HOP + 4 * v) = bits;
  };
  constexpr int BATCH = 10;  // loads in flight per thread
  static_assert((ROWS * V) % (128 * BATCH) == 0, "whole batches");
  for (int i0 = wt; i0 < ROWS * V; i0 += 128 * BATCH) {
    float4 x[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + 128 * b, r = i / V;
      const long long off = row_off[r];
      x[b] = off < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : ld4(wave + off + 4 * (i - r * V));
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + 128 * b, r = i / V, v = i - r * V;
      put(r, 0, v, x[b]);
      if (r > 0 && !tail[r - 1]) put(r - 1, 1, v, x[b]);
    }
  }
  for (int i = wt; i < ROWS * V; i += 128) {
    const int r = i / V, v = i - r * V;
    if (!tail[r]) continue;
    const long long off = row_off[r];
    put(r, 1, v, off < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : ld4(wave + off + HOP + 4 * v));
  }
  bar_sync(BAR_MMA + wg, 128);
}
}  // namespace bf

__global__ void __launch_bounds__(bf::THREADS, 1)
frontend_bf16(const float* __restrict__ wave, const bf16* __restrict__ basis, const float* __restrict__ fb,
              const int* __restrict__ fb_lo, const int* __restrict__ fb_hi, const float* __restrict__ dct,
              float* __restrict__ out, int total_rows, int n_samples, int n_frames, float log_floor) {
  using namespace bf;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  const uint32_t ring = smem_u32(smem);
  bf16* sA = reinterpret_cast<bf16*>(smem + OFF_A);
  float* sP = reinterpret_cast<float*>(smem + OFF_P);
  float* sE = reinterpret_cast<float*>(smem + OFF_E);
  long long* sRow = reinterpret_cast<long long*>(smem + OFF_ROW);
  int* sTail = reinterpret_cast<int*>(smem + OFF_TAIL);
  const uint32_t full = smem_u32(smem + OFF_BAR), empty = full + STAGES * 8;
  float* sD = reinterpret_cast<float*>(smem + OFF_D);
  float* sFbw = reinterpret_cast<float*>(smem + OFF_FBW);
  int* sLo = reinterpret_cast<int*>(smem + OFF_LO);
  int* sF0 = reinterpret_cast<int*>(smem + OFF_F0);
  load_epilogue(sD, sFbw, sLo, sF0, CHUNKS, CHUNK_BINS, fb, fb_lo, fb_hi, dct);
  for (int i = threadIdx.x; i < TILE * P_LD; i += blockDim.x) sP[i] = 0.f;  // finite everywhere (filters_log)
  const Epilogue ep{sD, sFbw, sLo, sF0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s * 8, 1);   // the filler's arrival, then the stage's bytes
      mbar_init(empty + s * 8, 8);  // the wgmma warps, once their wgmmas on the stage are done
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n_tiles = (total_rows + TILE - 1) / TILE;

  const int wg = (threadIdx.x >> 7) & 1, wt = threadIdx.x & 127, warp = wt >> 5, lane = threadIdx.x & 31;
  float* sPw = sP + wg * ROWS * P_LD;
  if (threadIdx.x >= CONSUMERS) {  // epilogue warpgroup of row half wg, a chunk behind its wgmma warpgroup
    float* sEw = sE + wg * MAX_CF * ROWS;
    const int rg = wt / (CEPS_LD / DCT_CT), cg = wt % (CEPS_LD / DCT_CT);
    float ceps[DCT_RT][DCT_CT];
    bar_arrive(BAR_FREE + wg, 256);  // the power ring starts free
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
#pragma unroll
      for (int i = 0; i < DCT_RT; ++i)
#pragma unroll
        for (int k = 0; k < DCT_CT; ++k) ceps[i][k] = 0.f;
      for (int c = 0; c < CHUNKS; ++c) {
        bar_sync(BAR_READY + wg, 256);  // chunk c's power is in the ring
        filters_log<RING, P_LD>(sPw, sEw, ep, c, wt % ROWS, wt / ROWS, 2, log_floor);
        const bool last = c == CHUNKS - 1 && tile + int(gridDim.x) >= n_tiles;
        if (!last) bar_arrive(BAR_FREE + wg, 256);  // the ring's bins are read: the next chunk's power may come
        bar_sync(BAR_EPI + wg, 128);  // the chunk's log energies are in
        dct_partial(ceps, sEw, ep, c, rg, cg);
        bar_sync(BAR_EPI + wg, 128);  // the DCT is done reading them
      }
      store_ceps(ceps, out, tile * TILE + wg * ROWS, total_rows, rg, cg);
    }
    return;
  }

  // wgmma warpgroup of row half wg
  const int gid = lane >> 2, tq = lane & 3, lq = lane >> 3, lr = lane & 7;
  bf16* sAw = sA + wg * ROWS * A_LD;
  // ldmatrix.x4 lane l addresses row l % 8 of matrix l / 8: (rows 0-7, k 0-7),
  // (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15) of the warp's 16.
  const uint32_t a_lane = smem_u32(sAw) + uint32_t(((16 * warp + (lq & 1) * 8 + lr) * A_LD + 8 * (lq >> 1)) * 2);
  // Thread 0 fills the ring: stages 0..STAGES-1 now, then stage j again
  // with step j + STAGES once both warpgroups have released it (refill).
  const bool filler = threadIdx.x == 0;
  int steps = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) steps += STEPS;
  const unsigned char* basis_b = reinterpret_cast<const unsigned char*>(basis);
  auto fill = [&](int step) {
    const uint32_t bar = full + (step % STAGES) * 8;
    mbar_arrive_expect_tx(bar, STAGE_BYTES);
    bulk_g2s(ring + (step % STAGES) * STAGE_BYTES, basis_b + size_t(step % STEPS) * STAGE_BYTES, STAGE_BYTES, bar);
  };
  auto refill = [&](uint32_t step) {  // step's stage, once both warpgroups are done with it
    if (step + STAGES < uint32_t(steps)) {
      mbar_wait(empty + (step % STAGES) * 8, (step / STAGES) & 1);
      fill(int(step) + STAGES);
    }
  };
  if (filler)
    for (int k = 0; k < STAGES && k < steps; ++k) fill(k);
  uint32_t j = 0;  // ring step
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE + wg * ROWS;
    load_frames(sAw, sRow + wg * ROWS, sTail + wg * ROWS, wave, row0, total_rows, n_samples, n_frames, wg, wt);
    for (int c = 0; c < CHUNKS; ++c) {
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      uint32_t a[2][KS / 16][4];  // A registers of two slabs: one in flight, one loading
#pragma unroll
      for (int s = 0; s < SLABS; ++s, ++j) {
        const uint32_t slot = j % STAGES;
        mbar_wait(full + slot * 8, (j / STAGES) & 1);  // the stage's bytes have landed
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk) ldsm_x4(a_lane + uint32_t((s * KS + kk * 16) * 2), a[s & 1][kk]);
        fence_regs(acc);
        wgmma_fence();  // the A registers just written, before wgmma reads them
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk)
          wgmma_n128(acc, a[s & 1][kk], b_desc_kmajor<64>(ring + slot * STAGE_BYTES + kk * 32));
        wgmma_commit();
        if (s > 0) {
          wgmma_wait<1>();  // the slab before is done: its stage and A registers are free
          fence_regs(a[(s + 1) & 1]);
          if (lane == 0) mbar_arrive(empty + ((j - 1) % STAGES) * 8);
          if (filler) refill(j - 1);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + ((j - 1) % STAGES) * 8);
      if (filler) refill(j - 1);

      // power: n8 block 2g is the cos of bins 8g.. of the chunk, 2g + 1 their
      // sin; a thread holds rows gid and gid + 8 of its warp's 16, bins 2tq, +1
      bar_sync(BAR_FREE + wg, 256);  // the epilogue has read the previous chunk's bins
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int pos = (c * CHUNK_BINS + 8 * g + 2 * tq) % RING;
        float* p = sPw + (16 * warp + gid) * P_LD + pos;
        const float* x = acc + 8 * g;
        p[0] = x[0] * x[0] + x[4] * x[4];
        p[1] = x[1] * x[1] + x[5] * x[5];
        p[8 * P_LD] = x[2] * x[2] + x[6] * x[6];
        p[8 * P_LD + 1] = x[3] * x[3] + x[7] * x[7];
      }
      bar_arrive(BAR_READY + wg, 256);
    }
  }
}

// ---- f32 mode -----------------------------------------------------------------

namespace f32 {
constexpr int THREADS = 256;
constexpr int CHUNK_BINS = 128, CHUNKS = 2, N = 2 * CHUNK_BINS, KS = 16, SLABS = WIN / KS;
constexpr int STEPS = CHUNKS * SLABS;  // ring steps per tile
constexpr int STAGES = 3;
constexpr int STAGE_FLOATS = KS * N;   // 16 KB
constexpr int BASIS_COLS = CHUNKS * N;  // 512
constexpr int RING = CHUNK_BINS + MAX_BAND - 1;  // power ring: the chunk's bins and the 4 before
constexpr int P_LD = RING + 1;  // odd: the filters' column reads hit 32 banks
constexpr int MAX_CF = 64;  // filters completed per chunk, at most (checked by the wrapper)
constexpr int DCT_RT = 4, DCT_CT = 4;  // 16 x 16 threads over 64 rows x 64 columns

constexpr size_t OFF_A = size_t(STAGES) * STAGE_FLOATS * 4;
constexpr size_t OFF_P = OFF_A + size_t(WIN) * ROWS * 4;
constexpr size_t OFF_E = OFF_P + size_t(ROWS) * P_LD * 4;
constexpr size_t OFF_D = OFF_E + size_t(MAX_CF) * ROWS * 4;
constexpr size_t OFF_FBW = OFF_D + size_t(NFILT) * CEPS_LD * 4;
constexpr size_t OFF_LO = OFF_FBW + size_t(NFILT) * W_LD * 4;
constexpr size_t OFF_F0 = OFF_LO + NFILT * 4;
constexpr size_t OFF_ROW = OFF_F0 + 32;
constexpr size_t OFF_TAIL = OFF_ROW + size_t(ROWS) * 8;
constexpr size_t SMEM = OFF_TAIL + size_t(ROWS) * 4;
static_assert(SMEM <= 232448, "227 KB of shared memory per block");
static_assert(WIN % KS == 0 && OFF_P % 16 == 0 && OFF_E % 16 == 0 && OFF_D % 16 == 0 && OFF_FBW % 16 == 0 &&
                  OFF_ROW % 8 == 0,
              "layout");
static_assert(ROWS * CEPS_LD == THREADS * DCT_RT * DCT_CT, "the block's DCT tiles");
static_assert(THREADS % ROWS == 0 && (ROWS * (HOP / 4)) % THREADS == 0, "frame loads: one row per thread");

// 64 frame rows (from row0) -> f32 in sA, K-major ([k][row]); rows past the
// end are zero. Blocks are read once, as in bf::load_frames; a lane per row,
// so the transposing stores hit 32 banks (THREADS is a multiple of ROWS, so
// a thread keeps its row).
__device__ void load_frames(float* sA, long long* row_off, int* tail, const float* __restrict__ wave, int row0,
                            int total_rows, int n_samples, int n_frames) {
  const int tid = threadIdx.x;
  if (tid < ROWS) {
    const int g = row0 + tid;
    if (g < total_rows) {
      const int u = g / n_frames, t = g - u * n_frames;
      row_off[tid] = (long long)u * n_samples + (long long)t * HOP;
      tail[tid] = t == n_frames - 1 || tid == ROWS - 1;
    } else {
      row_off[tid] = -1;
      tail[tid] = 1;
    }
  }
  __syncthreads();
  constexpr int V = HOP / 4;
  auto put = [&](int r, int k0, float4 x) {
    sA[(k0 + 0) * ROWS + r] = x.x;
    sA[(k0 + 1) * ROWS + r] = x.y;
    sA[(k0 + 2) * ROWS + r] = x.z;
    sA[(k0 + 3) * ROWS + r] = x.w;
  };
  constexpr int BATCH = ROWS * V / THREADS;  // 10 loads in flight per thread
  float4 x[BATCH];
#pragma unroll
  for (int b = 0; b < BATCH; ++b) {
    const long long off = row_off[tid % ROWS];
    x[b] = off < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : ld4(wave + off + 4 * ((tid + b * THREADS) / ROWS));
  }
#pragma unroll
  for (int b = 0; b < BATCH; ++b) {
    const int r = tid % ROWS, v = (tid + b * THREADS) / ROWS;
    put(r, 4 * v, x[b]);
    if (r > 0 && !tail[r - 1]) put(r - 1, HOP + 4 * v, x[b]);
  }
  for (int i = tid; i < ROWS * V; i += THREADS) {
    const int r = i % ROWS, v = i / ROWS;
    if (!tail[r]) continue;
    const long long off = row_off[r];
    put(r, HOP + 4 * v, off < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : ld4(wave + off + HOP + 4 * v));
  }
  __syncthreads();
}
}  // namespace f32

// f32 mode (frontend_f32), the extraction CLI's `gemm` method: exact f32
// products on the CUDA cores, a register-tiled SGEMM. Persistent blocks of
// 256 threads walk tiles of 64 frames (K-major in shared memory, 80 KB); the
// basis, [320][2 chunks][cos of 128 bins | their sin] f32, streams through a
// cp.async ring of 3 K-slabs (16 x 256 = 16 KB each), refilled by the whole
// block two slabs ahead of the one it multiplies. A thread holds 8 frames x 4
// bins, cos and sin: 64 accumulators fed by four 16-byte shared loads per 64
// FMAs (frames and cos/sin columns both contiguous). The epilogue is bf16
// mode's with 128-bin chunks, 4 x 4 cepstra per thread.
__global__ void __launch_bounds__(f32::THREADS, 1)
frontend_f32(const float* __restrict__ wave, const float* __restrict__ basis, const float* __restrict__ fb,
             const int* __restrict__ fb_lo, const int* __restrict__ fb_hi, const float* __restrict__ dct,
             float* __restrict__ out, int total_rows, int n_samples, int n_frames, float log_floor) {
  using namespace f32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sRing = reinterpret_cast<float*>(smem);
  float* sA = reinterpret_cast<float*>(smem + OFF_A);
  float* sP = reinterpret_cast<float*>(smem + OFF_P);
  float* sE = reinterpret_cast<float*>(smem + OFF_E);
  float* sD = reinterpret_cast<float*>(smem + OFF_D);
  float* sFbw = reinterpret_cast<float*>(smem + OFF_FBW);
  int* sLo = reinterpret_cast<int*>(smem + OFF_LO);
  int* sF0 = reinterpret_cast<int*>(smem + OFF_F0);
  long long* sRow = reinterpret_cast<long long*>(smem + OFF_ROW);
  int* sTail = reinterpret_cast<int*>(smem + OFF_TAIL);
  const int tid = threadIdx.x;
  const int n_tiles = (total_rows + ROWS - 1) / ROWS;
  int steps = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) steps += STEPS;
  const uint32_t ring = smem_u32(sRing);
  // ring step j: K rows 16 * (j % SLABS).., columns of chunk (j % STEPS) / SLABS
  auto fill = [&](int j) {
    const int step = j % STEPS, chunk = step / SLABS, slab = step % SLABS;
    const float* src = basis + size_t(slab * KS) * BASIS_COLS + chunk * N;
    const uint32_t dst = ring + uint32_t((j % STAGES) * STAGE_FLOATS * 4);
    for (int i = tid; i < STAGE_FLOATS / 4; i += THREADS) {
      const int kr = i / (N / 4), v = i % (N / 4);
      cp_async16(dst + uint32_t((kr * N + 4 * v) * 4), src + kr * BASIS_COLS + 4 * v, 16);
    }
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {  // one group per step, empty or not
    if (k < steps) fill(k);
    cp_async_commit();
  }
  load_epilogue(sD, sFbw, sLo, sF0, CHUNKS, CHUNK_BINS, fb, fb_lo, fb_hi, dct);
  for (int i = threadIdx.x; i < ROWS * P_LD; i += blockDim.x) sP[i] = 0.f;  // finite everywhere (filters_log)
  const Epilogue ep{sD, sFbw, sLo, sF0};

  // DFT tile: warp w covers frame groups 4 (w / 4).. and bin groups 8 (w % 4)..
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = (warp >> 2) * 4 + (lane >> 3), cg = (warp & 3) * 8 + (lane & 7);  // frames 8rg.., bins 4cg..
  const int drg = tid / (CEPS_LD / DCT_CT), dcg = tid % (CEPS_LD / DCT_CT);
  int j = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS;
    load_frames(sA, sRow, sTail, wave, row0, total_rows, n_samples, n_frames);
    float ceps[DCT_RT][DCT_CT];
#pragma unroll
    for (int i = 0; i < DCT_RT; ++i)
#pragma unroll
      for (int k = 0; k < DCT_CT; ++k) ceps[i][k] = 0.f;
    for (int c = 0; c < CHUNKS; ++c) {
      float re[8][4], im[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) re[i][k] = im[i][k] = 0.f;
      for (int s = 0; s < SLABS; ++s, ++j) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // step j's slab is in; every thread is done with the slab of step j - 1
        if (j + STAGES - 1 < steps) fill(j + STAGES - 1);
        cp_async_commit();
        const float* b = sRing + (j % STAGES) * STAGE_FLOATS + 4 * cg;
        const float* a = sA + s * KS * ROWS + 8 * rg;
#pragma unroll
        for (int kr = 0; kr < KS; ++kr) {
          const float4 a0 = *reinterpret_cast<const float4*>(a + kr * ROWS);
          const float4 a1 = *reinterpret_cast<const float4*>(a + kr * ROWS + 4);
          const float4 bc = *reinterpret_cast<const float4*>(b + kr * N);
          const float4 bs = *reinterpret_cast<const float4*>(b + kr * N + CHUNK_BINS);
          const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float cs[4] = {bc.x, bc.y, bc.z, bc.w}, sn[4] = {bs.x, bs.y, bs.z, bs.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              re[i][k] = fmaf(x[i], cs[k], re[i][k]);
              im[i][k] = fmaf(x[i], sn[k], im[i][k]);
            }
        }
      }
      const int pos = (c * CHUNK_BINS + 4 * cg) % RING;  // 4 bins, never across the ring's end
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* p = sP + (8 * rg + i) * P_LD + pos;
#pragma unroll
        for (int k = 0; k < 4; ++k) p[k] = re[i][k] * re[i][k] + im[i][k] * im[i][k];
      }
      __syncthreads();
      filters_log<RING, P_LD>(sP, sE, ep, c, tid % ROWS, tid / ROWS, THREADS / ROWS, log_floor);
      __syncthreads();
      dct_partial(ceps, sE, ep, c, drg, dcg);
    }
    store_ceps(ceps, out, row0, total_rows, drg, dcg);
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

}  // namespace

// wave (n_utt, n_samples) f32; basis in the mode's layout (ops/gemm_frontend.py,
// kernel_constants), bf16 or f32; fb (257, 120); fb_lo / fb_hi (120,) int32; dct
// (120, 60); out (n_utt * n_frames, 60) f32. Launches on `stream`, does not
// synchronise; returns cudaGetLastError().
extern "C" int dfac_gemm_frontend(const float* wave, const void* basis, const float* fb,
                                  const int* fb_lo, const int* fb_hi, const float* dct,
                                  float* out, int n_utt, int n_samples, int n_frames,
                                  float log_floor, int bf16_mode, void* stream) {
  const long long total = (long long)n_utt * n_frames;
  if (total <= 0 || total > INT_MAX - bf::TILE || n_samples < (n_frames - 1) * HOP + WIN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16_mode) {
    err = cudaFuncSetAttribute(frontend_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bf::SMEM));
    if (err != cudaSuccess) return (int)err;
    const long long tiles = (total + bf::TILE - 1) / bf::TILE;
    const int grid = int(tiles < sm_count() ? tiles : sm_count());
    frontend_bf16<<<grid, bf::THREADS, bf::SMEM, s>>>(wave, static_cast<const bf16*>(basis), fb, fb_lo, fb_hi, dct,
                                                      out, int(total), n_samples, n_frames, log_floor);
  } else {
    err = cudaFuncSetAttribute(frontend_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, int(f32::SMEM));
    if (err != cudaSuccess) return (int)err;
    const long long tiles = (total + ROWS - 1) / ROWS;
    const int grid = int(tiles < sm_count() ? tiles : sm_count());
    frontend_f32<<<grid, f32::THREADS, f32::SMEM, s>>>(wave, static_cast<const float*>(basis), fb, fb_lo, fb_hi,
                                                       dct, out, int(total), n_samples, n_frames, log_floor);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of the front-end kernel, in bytes.
extern "C" int dfac_gemm_frontend_smem(int bf16_mode) { return int(bf16_mode ? bf::SMEM : f32::SMEM); }
