// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel in this directory is built by nvcc into its own shared
// library with a plain C interface (ops/kernels/build.py) and called through
// ctypes; each C entry point returns cudaGetLastError() after its launch so
// the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace svl {

typedef __nv_bfloat16 bf16;

// Two floats -> one 32-bit register of bf16 (lo in the low half), rounded
// to nearest even: the element order mma.sync fragments expect.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Round a float to the nearest bf16 and back (the bf16 rounding points of
// the JAX reference, kept explicit in fp32 code).
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x16 bf16, row-major fragment) * b (16x8 bf16, col-major
// fragment), fp32 accumulate.  Fragment layout (PTX ISA, m16n8k16):
//   g = lane / 4, t = lane % 4
//   a[0] = A[g][2t..2t+1]     a[1] = A[g+8][2t..2t+1]
//   a[2] = A[g][2t+8..2t+9]   a[3] = A[g+8][2t+8..2t+9]
//   b0   = B[2t..2t+1][g]     b1   = B[2t+8..2t+9][g]
//   c[0..1] = C[g][2t..2t+1]  c[2..3] = C[g+8][2t..2t+1]
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of a 16x16 tile at (row0, col0) of a row-major bf16 array in
// shared memory with row stride `ld` elements.
__device__ __forceinline__ void load_a_frag(uint32_t a[4], const bf16* s,
                                            int ld, int row0, int col0,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + (row0 + g) * ld + col0 + 2 * t;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * ld);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * ld + 8);
}

// B fragment of a 16(k) x 8(n) tile whose columns are rows of a bf16 array
// in shared memory (n-major, k contiguous; row stride `ld`): the layout of a
// torch Linear weight (out, in) and of K in q.k^T.
__device__ __forceinline__ void load_b_frag(uint32_t& b0, uint32_t& b1,
                                            const bf16* s, int ld, int n0,
                                            int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld_u32(p);
  b1 = ld_u32(p + 8);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace svl

extern "C" const char* svl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
