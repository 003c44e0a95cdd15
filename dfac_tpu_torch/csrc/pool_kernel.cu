// Standalone floor-mode (2,1) time pool for Hopper (sm_90a): K5.
//
// Replaces: scripts/pool_kernel_probe.py  _pool_kernel (:81), launched by
// pool_pallas (:89-109). Same function, in the input dtype (bf16 or f32):
//   out[b, t, f, c] = T( T(x[b, 2t, f, c] + x[b, 2t+1, f, c]) * 0.5 ),  t < T_in // 2
// The sum is rounded to T before the halving, as the Pallas body adds in
// x's dtype; halving is exact, so this is one rounding of (a + b) / 2. An
// odd last row is dropped (floor mode) and never read.
//
// What bounds it on the card: nothing but bytes. Every output element
// costs two input reads, one write and two flops. Each of the probe's two
// pools at B=512 (512x321x180x32 and 512x160x180x64, bf16) reads 1.89 GB
// and writes 0.94 GB: ~0.85 ms at 3.35 TB/s.
//
// Design: the Pallas grid (b, T_out // tt) becomes one block per (sample,
// tile of tt output rows), so the CLI keeps its tt and its precondition.
// An output row and its two input rows are contiguous runs of F * C
// elements; the block's threads walk the tile in 16-byte vectors (8 bf16
// or 4 f32 per thread and step), neighbouring threads on neighbouring
// addresses, with scalar steps only when F * C * sizeof(T) is not a
// multiple of 16 or a pointer is not 16-byte aligned. No shared memory:
// each byte is touched once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;

__device__ __forceinline__ float pool_pair(float a, float b) { return (a + b) * 0.5f; }
__device__ __forceinline__ bf16 pool_pair(bf16 a, bf16 b) {
  const bf16 s = __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  return __float2bfloat16_rn(__bfloat162float(s) * 0.5f);
}

template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Vec {
  T v[VEC];
};

// One block = one sample's tile of tt output rows; VEC elements per step.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
time_pool_kernel(const T* __restrict__ x, T* __restrict__ out, int t_in, int t_out, int row, int tt) {
  const int tiles = t_out / tt;
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int row_vecs = row / VEC;
  const int n = tt * row_vecs;
  const T* xs = x + size_t(b) * t_in * row;
  T* os = out + (size_t(b) * t_out + size_t(tile) * tt) * row;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i / row_vecs, v = i - r * row_vecs;
    const int t = tile * tt + r;
    const Vec<T, VEC> a = *reinterpret_cast<const Vec<T, VEC>*>(xs + size_t(2 * t) * row + v * VEC);
    const Vec<T, VEC> c = *reinterpret_cast<const Vec<T, VEC>*>(xs + size_t(2 * t + 1) * row + v * VEC);
    Vec<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.v[e] = pool_pair(a.v[e], c.v[e]);
    *reinterpret_cast<Vec<T, VEC>*>(os + size_t(r) * row + v * VEC) = o;
  }
}

template <typename T>
void launch(const void* x, void* out, int batch, int t_in, int row, int tt, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int t_out = t_in / 2;
  const bool vec = (size_t(row) * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int grid = batch * (t_out / tt);
  if (vec)
    time_pool_kernel<T, VEC><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(out), t_in,
                                                       t_out, row, tt);
  else
    time_pool_kernel<T, 1><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(out), t_in, t_out,
                                                     row, tt);
}

}  // namespace

// x (B, T_in, F, C) contiguous, bf16 or f32; out (B, T_in // 2, F, C) in x's
// dtype; row = F * C; (T_in // 2) % tt == 0. Launches on `stream`, does not
// synchronise; returns cudaGetLastError().
extern "C" int dfac_time_pool(const void* x, void* out, int batch, int t_in, int row, int tt, int bf16_mode,
                              void* stream) {
  const int t_out = t_in / 2;
  if (batch <= 0 || t_out <= 0 || row <= 0 || tt <= 0 || t_out % tt != 0 ||
      (long long)tt * row > 0x7fffffffLL || (long long)batch * (t_out / tt) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_mode)
    launch<bf16>(x, out, batch, t_in, row, tt, s);
  else
    launch<float>(x, out, batch, t_in, row, tt, s);
  return (int)cudaGetLastError();
}
