// Warp-level tensor-core products (mma.sync) for probe_blocks.cu's
// small_mm (bf16), and for the MLP chains' first version and ring design
// in diag/chain_designs.cu (bf16 and int8). The production kernels and the
// chains (mlp_chain.cu) use wgmma (point_mlp.cuh).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "mma.m16n8k32"); g = lane / 4, t = lane % 4:
//   bf16 m16n8k16, A row-major 16x16: a0 (row g, k 2t..2t+1), a1 (row g+8,
//     same k), a2 (row g, k 8+2t..), a3 (row g+8, k 8+2t..); B col-major
//     16x8: b0 (k 2t..2t+1, col g), b1 (k 8+2t.., col g).
//   s8 m16n8k32, A row-major 16x32: a0 (row g, k 4t..4t+3), a1 (row g+8),
//     a2 (row g, k 16+4t..), a3 (row g+8, k 16+4t..); B col-major 32x8:
//     b0 (k 4t..4t+3, col g), b1 (k 16+4t.., col g).
//   The accumulator 16x8 (fp32 or s32): c0, c1 (row g, cols 2t, 2t+1),
//     c2, c3 (row g+8, same cols).
// Each 32-bit register holds its elements in ascending k, the lowest in
// the low bits.

#pragma once

#include <cstdint>

namespace drt {
namespace ms {

// d += a . b, bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b, int8 operands, int32 accumulation (exact).
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 values (lo at the lower k) in one register.
__device__ __forceinline__ uint32_t pack_bf16(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// The 32 bits at p (4-byte aligned).
__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *static_cast<const uint32_t*>(p);
}

}  // namespace ms
}  // namespace drt
