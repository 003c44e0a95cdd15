// Post-FFT LFCC kernel for Hopper (sm_90a): power spectrum -> 60 cepstra.
//
// Replaces: dfac_tpu/ops/pallas/lfcc_kernel.py  _fb_log_dct_kernel (:41),
// launched by fused_fb_log_dct (:54-88). Same math, per row (one frame):
//   ceps = log(max(P @ FB, floor)) @ DCT[:, :60]    (257 bins, 120 filters)
// The rFFT and the power re^2 + im^2 stay outside, as in the JAX package.
//
// What bounds it on the card: bytes. At B=128 (41,088 rows) it reads 42.2
// MB of power and writes 9.9 MB of cepstra, 15.6 us at 3.35 TB/s (NVIDIA
// H100 SXM data sheet). The arithmetic is close behind: the DCT is 7,200
// FFMAs a row and the filters and logs ~4,000 more instructions, against
// the ~12,700 thread instructions a row that the SMs issue in those 15.6 us.
// So the HBM stream must never stop, and the filters, the logs and the DCT
// must keep the schedulers issuing.
//
// Design: persistent blocks, one an SM, each walking a contiguous range of
// 32-row tiles (ranges balanced to one tile), with three roles.
//  * Copies: a tile is contiguous in device memory (32 x 257 floats, a
//    multiple of 16 bytes), so one producer thread brings it by one 1-D
//    bulk copy into a ring of 4 slots with full and empty mbarriers. Power
//    may start at any 4-byte offset: every tile is copied from the 16-byte
//    boundary below its first float and read at that offset. The copy of
//    the last tile stops at the last 16-byte boundary of the tensor, and
//    the producer copies the last 0-3 floats by plain loads, so no copy
//    reads past the end of power.
//  * Filterbank + log (warpgroup 0), f32: lane = row (the row stride 257 is
//    odd, so the 32 power reads of a warp hit 32 banks), a warp runs every
//    4th filter into registers, frees the slot, then stores the energies,
//    filter-major, into one of two 64-row energy buffers. Each filter's
//    weights sit in shared memory padded with zeros to 5 bins (the widest
//    band of the corpus filterbank) with the band's first bin, so the loop
//    has a fixed trip count. Adding 0 * p to the sum changes no bit for
//    finite p, so each energy is the in-order band sum of the kernel this
//    one replaced and of K1's epilogue: logf(fmaxf(acc, floor)).
//  * DCT-II (warpgroup 1), f32 on the CUDA cores (TF32 would round the f32
//    operands): the 120 x 60 matrix sits in shared memory; a thread keeps 8
//    rows x 4 cepstra of a buffer in registers, 32 FFMAs for three 16-byte
//    loads, summed over the filters in order. Per output the products and
//    their order are the replaced kernel's, so the cepstra are the same bits.
// The two warpgroups hand the energy buffers over by mbarriers, so the
// filters of the next 64 rows run while the DCT of the last ones does, and
// a slot is held only while its tile's filters run: the copies stay ahead.
// What binds it, read from patched copies timed beside it (PERF.md, PR 14):
// the copies alone stream near the bytes bound and the filters add a
// little; the DCT warps' FFMA issue takes most of the rest. A DCT on the
// tensor cores (split TF32) was only a little faster and gave up the exact
// bits.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace dfac;

constexpr int NBINS = 257, NFILT = 120, NCEPS = 60;
constexpr int TILE_ROWS = 32;                   // rows per tile: the walk and the copy
constexpr int TILE_FLOATS = TILE_ROWS * NBINS;  // 8,224, a multiple of 4
constexpr int SLOT_FLOATS = TILE_FLOATS + 4;    // room for the 16-byte boundary below
constexpr int STAGES = 4;                       // ring slots
constexpr int PAIR = 2;                         // tiles per energy buffer
constexpr int E_ROWS = PAIR * TILE_ROWS;        // 64 rows per energy buffer and DCT
constexpr int E_BUFS = 2;
constexpr int FB_WARPS = 4, DCT_WARPS = 4;     // the filter warps, then the DCT warps
constexpr int PRODUCER_WARP = FB_WARPS + DCT_WARPS;
constexpr int THREADS = 32 * (PRODUCER_WARP + 1);
constexpr int BAND = 5;                         // bins per filter, padded
constexpr int BAND_LD = 8;                      // 5 weights, the first bin, 2 unused
constexpr int FSTEP = FB_WARPS;                 // a filter warp's filter stride
constexpr int FILT_PER_WARP = NFILT / FSTEP;    // 30
constexpr int RT = 8, CT = 4;                   // DCT register tile: rows x cepstra
constexpr int CGROUPS = NCEPS / CT;             // 15
constexpr int DCT_THREADS = (E_ROWS / RT) * CGROUPS;  // 120 of the DCT warps' 128

constexpr size_t OFF_BAND = size_t(NFILT) * NCEPS * sizeof(float);                  // 28,800
constexpr size_t OFF_E = OFF_BAND + size_t(NFILT) * BAND_LD * sizeof(float);        // 32,640
constexpr size_t OFF_RING = OFF_E + size_t(E_BUFS) * NFILT * E_ROWS * sizeof(float);  // 94,080
constexpr size_t OFF_BAR = OFF_RING + size_t(STAGES) * SLOT_FLOATS * sizeof(float);   // 225,728
constexpr size_t SMEM = OFF_BAR + 2 * (STAGES + E_BUFS) * sizeof(uint64_t);          // 225,824

static_assert(TILE_FLOATS % 4 == 0, "every tile starts at the same offset from a 16-byte boundary");
static_assert(NFILT % FSTEP == 0 && E_ROWS % RT == 0 && NCEPS % CT == 0, "tiles cover the work");
static_assert(DCT_THREADS <= 32 * DCT_WARPS && RT % 4 == 0, "the DCT warps cover the DCT");
static_assert(OFF_E % 16 == 0 && OFF_RING % 16 == 0 && (SLOT_FLOATS * 4) % 16 == 0 && OFF_BAR % 8 == 0,
              "16-byte loads and copies, 8-byte barriers");
static_assert(SMEM <= 232448, "one block per SM");
static_assert((NCEPS * sizeof(float)) % 16 == 0, "16-byte rows of DCT and out");

__global__ void __launch_bounds__(THREADS, 1)
fb_log_dct_kernel(const float* __restrict__ power, const float* __restrict__ fb,
                  const int* __restrict__ fb_lo, const int* __restrict__ fb_hi,
                  const float* __restrict__ dct, float* __restrict__ out,
                  int total_rows, float log_floor) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sD = reinterpret_cast<float*>(smem);               // (120, 60) DCT
  float* sB = reinterpret_cast<float*>(smem + OFF_BAND);    // (120, 8) padded bands
  float* sE = reinterpret_cast<float*>(smem + OFF_E);       // E_BUFS x (120, 64) log energies
  float* ring = reinterpret_cast<float*>(smem + OFF_RING);  // STAGES x SLOT_FLOATS
  // mbarriers: a slot's tile landed / was read; an energy buffer was written / read
  const uint32_t full0 = smem_u32(smem + OFF_BAR), empty0 = full0 + 8 * STAGES;
  const uint32_t efull0 = empty0 + 8 * STAGES, eempty0 = efull0 + 8 * E_BUFS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // this block's tiles [c0, c1); power seen from the 16-byte boundary at or below it
  const int n_tiles = (total_rows + TILE_ROWS - 1) / TILE_ROWS;
  const int c0 = int((long long)blockIdx.x * n_tiles / gridDim.x);
  const int c1 = int((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
  const int o = int((reinterpret_cast<uintptr_t>(power) & 15) / 4);
  const float* base = power - o;
  const long long end = o + (long long)total_rows * NBINS, end16 = end & ~3LL;

  // tile c -> its ring slot: [c * TILE_FLOATS, min(c * TILE_FLOATS + SLOT_FLOATS, end16)) by
  // one bulk copy; the last tile's [end16, end) by plain loads
  auto issue = [&](int c) {
    const int i = c - c0, slot = i % STAGES;
    mbar_wait(empty0 + 8 * slot, ((i / STAGES) & 1) ^ 1);
    const long long lo = (long long)c * TILE_FLOATS, hi = min(lo + SLOT_FLOATS, end16);
    float* dst = ring + slot * SLOT_FLOATS;
    if (c == n_tiles - 1)
      for (long long q = end16; q < end; ++q) dst[q - lo] = __ldg(base + q);
    mbar_arrive_expect_tx(full0 + 8 * slot, uint32_t(hi - lo) * 4);
    bulk_g2s(smem_u32(dst), base + lo, uint32_t(hi - lo) * 4, full0 + 8 * slot);
  };

  const bool producer = warp == PRODUCER_WARP && lane == 0;
  if (producer) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, FSTEP);  // one arrival per filter warp
    }
    for (int b = 0; b < E_BUFS; ++b) {
      mbar_init(efull0 + 8 * b, 32 * FB_WARPS);    // every filter thread, after its stores
      mbar_init(eempty0 + 8 * b, 32 * DCT_WARPS);  // every DCT thread, after its loads
    }
    mbar_init_fence();
    for (int c = c0; c < min(c1, c0 + STAGES); ++c) issue(c);
  } else if (warp < PRODUCER_WARP) {
    for (int i = threadIdx.x; i < NFILT * NCEPS / 4; i += 32 * PRODUCER_WARP)
      reinterpret_cast<float4*>(sD)[i] = __ldg(reinterpret_cast<const float4*>(dct) + i);
    if (threadIdx.x < NFILT) {  // filter m's weights on bins s .. s + 4, zero outside its band
      const int m = threadIdx.x, lo = __ldg(fb_lo + m), hi = __ldg(fb_hi + m), s = min(lo, NBINS - BAND);
      float* b = sB + m * BAND_LD;
#pragma unroll
      for (int j = 0; j < BAND; ++j) b[j] = s + j >= lo && s + j <= hi ? __ldg(fb + (s + j) * NFILT + m) : 0.f;
      b[BAND] = __int_as_float(s);
      b[BAND + 1] = b[BAND + 2] = 0.f;
    }
  }
  __syncthreads();
  if (warp == PRODUCER_WARP) {
    if (producer)
      for (int c = c0 + STAGES; c < c1; ++c) issue(c);
    return;
  }

  // 64-row groups of this block: group k is tiles c0 + 2k, c0 + 2k + 1, in energy buffer k % 2
  if (warp < FSTEP) {
    // filterbank (banded, padded) + log: row `lane` of each tile, filters warp, warp + 4, ..., warp + 116
    for (int k = 0, ca = c0; ca < c1; ++k, ca += PAIR) {
      const int b = k % E_BUFS;
      float* e_buf = sE + b * NFILT * E_ROWS;
      if (k >= E_BUFS) mbar_wait(eempty0 + 8 * b, (k / E_BUFS - 1) & 1);  // the DCT is done with group k - 2
      for (int c = ca; c < min(ca + PAIR, c1); ++c) {
        const int i = c - c0, slot = i % STAGES;
        mbar_wait(full0 + 8 * slot, (i / STAGES) & 1);
        const float* p = ring + slot * SLOT_FLOATS + o + lane * NBINS;
        float ev[FILT_PER_WARP];  // in registers: no store between the loads lets the filters overlap
#pragma unroll
        for (int j = 0; j < FILT_PER_WARP; ++j) {
          const int m = warp + FSTEP * j;
          const float4 w = *reinterpret_cast<const float4*>(sB + m * BAND_LD);
          const float2 w4 = *reinterpret_cast<const float2*>(sB + m * BAND_LD + 4);
          const float* q = p + __float_as_int(w4.y);
          float acc = 0.f;
          acc = fmaf(q[0], w.x, acc);
          acc = fmaf(q[1], w.y, acc);
          acc = fmaf(q[2], w.z, acc);
          acc = fmaf(q[3], w.w, acc);
          acc = fmaf(q[4], w4.x, acc);
          ev[j] = logf(fmaxf(acc, log_floor));
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * slot);  // this warp is done with the slot
        float* e = e_buf + (c - ca) * TILE_ROWS + lane;
#pragma unroll
        for (int j = 0; j < FILT_PER_WARP; ++j) e[(warp + FSTEP * j) * E_ROWS] = ev[j];
      }
      mbar_arrive(efull0 + 8 * b);
    }
    return;
  }

  // DCT-II (orthonormal), first 60, f32: rows 8 rg .. 8 rg + 7, cepstra 4 cg .. 4 cg + 3 of a group
  const int dt = threadIdx.x - 32 * FB_WARPS, rg = dt / CGROUPS, cg = dt - rg * CGROUPS;
  for (int k = 0, ca = c0; ca < c1; ++k, ca += PAIR) {
    const int b = k % E_BUFS;
    const long long row_a = (long long)ca * TILE_ROWS;
    const int rows = int(min((long long)(min(ca + PAIR, c1) - ca) * TILE_ROWS, total_rows - row_a));
    mbar_wait(efull0 + 8 * b, (k / E_BUFS) & 1);
    if (dt < DCT_THREADS && rg * RT < rows) {
      const float* e0 = sE + b * NFILT * E_ROWS + rg * RT;
      const float* d0 = sD + cg * CT;
      float acc[RT][CT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int n = 0; n < CT; ++n) acc[r][n] = 0.f;
#pragma unroll 4
      for (int m = 0; m < NFILT; ++m) {
        float x[RT];
#pragma unroll
        for (int v = 0; v < RT / 4; ++v) {
          const float4 x4 = *reinterpret_cast<const float4*>(e0 + m * E_ROWS + 4 * v);
          x[4 * v] = x4.x, x[4 * v + 1] = x4.y, x[4 * v + 2] = x4.z, x[4 * v + 3] = x4.w;
        }
        const float4 d = *reinterpret_cast<const float4*>(d0 + m * NCEPS);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          acc[r][0] = fmaf(x[r], d.x, acc[r][0]);
          acc[r][1] = fmaf(x[r], d.y, acc[r][1]);
          acc[r][2] = fmaf(x[r], d.z, acc[r][2]);
          acc[r][3] = fmaf(x[r], d.w, acc[r][3]);
        }
      }
      mbar_arrive(eempty0 + 8 * b);  // the loads are done: the filters may refill the buffer
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (rg * RT + r < rows)
          reinterpret_cast<float4*>(out + (row_a + rg * RT + r) * NCEPS)[cg] =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
      mbar_arrive(eempty0 + 8 * b);
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

int grid_for(int rows) { return std::min(sm_count(), (rows + TILE_ROWS - 1) / TILE_ROWS); }

}  // namespace

// power (rows, 257) f32, contiguous, any 4-byte alignment; fb (257, 120);
// fb_lo / fb_hi (120,) int32, no band wider than 5 bins; dct (120, 60),
// 16-byte aligned; out (rows, 60) f32, 16-byte aligned.
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int dfac_fb_log_dct(const float* power, const float* fb, const int* fb_lo,
                               const int* fb_hi, const float* dct, float* out, int rows,
                               float log_floor, void* stream) {
  if (rows <= 0 || rows > INT_MAX - E_ROWS || (reinterpret_cast<uintptr_t>(dct) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fb_log_dct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return (int)err;
  fb_log_dct_kernel<<<grid_for(rows), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      power, fb, fb_lo, fb_hi, dct, out, rows, log_floor);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of the post-FFT kernel, in bytes.
extern "C" int dfac_fb_log_dct_smem() { return int(SMEM); }

// The post-FFT kernel's walk: rows per tile, ring slots, padded band width,
// and (for `rows` rows, on the current device) the blocks of a launch.
extern "C" int dfac_fb_log_dct_tile_rows() { return TILE_ROWS; }
extern "C" int dfac_fb_log_dct_stages() { return STAGES; }
extern "C" int dfac_fb_log_dct_band() { return BAND; }
extern "C" int dfac_fb_log_dct_grid(int rows) { return rows > 0 ? grid_for(rows) : 0; }
