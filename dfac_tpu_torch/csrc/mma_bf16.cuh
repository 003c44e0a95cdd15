// bf16 tensor-core helper of the port's mma.sync kernel (conv_block.cu's
// block-1 kernel): one mma.sync m16n8k16 with f32 accumulators.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace dfac {

// D = A * B + C with C's rows all (c0, c1): a thread's two accumulator
// columns start at c0 and c1 in both of its rows (a per-column bias).
__device__ __forceinline__ void mma_bf16_bias(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1,
                                              float c0, float c1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c0), "f"(c1), "f"(c0), "f"(c1));
}

}  // namespace dfac
