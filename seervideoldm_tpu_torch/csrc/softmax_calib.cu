// K10: the on-chip softmax calibration, repeated fp32 row softmax over data
// that never leaves the SM.
//
// Replaces tools/floor_budget.py::softmax_s_per_elem (Pallas body :122-131,
// pallas_call :138): x (rows, cols) fp32; `reps` times
//   m = rowmax(s); e = exp(s - m); l = rowsum(e); s = e / (l == 0 ? 1 : l) + 1e-6
// then out[row] = rowsum(s).  The floor budgets divide its time by
// reps * rows * cols: the seconds per score element that an attention
// kernel pays for its softmax, whatever its matmuls cost.
//
// The instruction mix is that of the port's attention kernels
// (attn_fwd_hopper.cuh): exp2f of a log2(e)-scaled argument, one FMA to form it,
// fmaxf / add reductions within a lane and over the warp with shuffles.
// The reciprocal of l is taken once per row and the normalisation is one
// FMA per element.
//
// Design for Hopper (the TPU kept one 2 MB block in VMEM): one warp owns one
// row and keeps all of it in registers for every rep (cols = 32 * E, E
// floats per lane); HBM is touched only to load x once (16-byte vector
// loads, lanes on neighbouring addresses) and to store the row sums.  A CTA
// is 8 warps = 8 rows; __launch_bounds__(256, 2) caps registers at 128 per
// thread so two CTAs (16 warps) stay resident on every SM.  The calibration
// shape fills the card in one wave: rows = SMs * 8 * 2 (2112 on a 132-SM
// H100 SXM), cols = 2048 (E = 64).
//
// What bounds it on an H100: the MUFU.  One ex2 per element per rep at 16
// per clock per SM (CUDA C++ Programming Guide, arithmetic-instruction
// throughput, compute capability 9.0) is 132 * 16 * 1.98 GHz = 4.18e12 per
// second, 0.239 ps per element; the ~4 fp32 max / FMA / add per element at
// 128 per clock per SM come to ~0.12 ps, and HBM (8 bytes per element once,
// not per rep) to nothing at large reps.
#include <math.h>

#include "common.cuh"

namespace svl {

constexpr int SMC_ROWS = 8;                  // rows (warps) per CTA
constexpr int SMC_COLS = 2048;               // the calibration's width
constexpr int SMC_THREADS = SMC_ROWS * 32;
constexpr float SMC_LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// E floats per lane; element j of lane L is column 4 * (32 * (j / 4) + L) +
// j % 4 (float4 loads).  Four partial max / sum chains per lane for ILP.
// s_out, when not null, receives the final s (rows, cols): a check output
// that depends on every pass, since the row sums are 1 + cols * 1e-6 after
// any normalising pass.
template <int E>
__global__ void __launch_bounds__(SMC_THREADS, 2)
softmax_calib_kernel(const float* __restrict__ x, float* __restrict__ out,
                     float* __restrict__ s_out, int rows, int reps) {
  static_assert(E % 4 == 0, "E must be a multiple of 4");
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * SMC_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float4* src = reinterpret_cast<const float4*>(x + (size_t)row * 32 * E);
  float s[E];
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const float4 v = src[i * 32 + lane];
    s[4 * i] = v.x;
    s[4 * i + 1] = v.y;
    s[4 * i + 2] = v.z;
    s[4 * i + 3] = v.w;
  }
  for (int r = 0; r < reps; ++r) {
    float mp[4] = {s[0], s[1], s[2], s[3]};
#pragma unroll
    for (int i = 4; i < E; ++i) mp[i & 3] = fmaxf(mp[i & 3], s[i]);
    const float m = warp_max(fmaxf(fmaxf(mp[0], mp[1]), fmaxf(mp[2], mp[3])));
    const float mb = m * SMC_LOG2E;
    float lp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < E; ++i) {
      s[i] = exp2f(fmaf(s[i], SMC_LOG2E, -mb));
      lp[i & 3] += s[i];
    }
    const float l = warp_sum((lp[0] + lp[1]) + (lp[2] + lp[3]));
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int i = 0; i < E; ++i) s[i] = fmaf(s[i], inv, 1e-6f);
  }
  float tp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < E; ++i) tp[i & 3] += s[i];
  const float t = warp_sum((tp[0] + tp[1]) + (tp[2] + tp[3]));
  if (lane == 0) out[row] = t;
  if (s_out != nullptr) {
    float4* dst = reinterpret_cast<float4*>(s_out + (size_t)row * 32 * E);
#pragma unroll
    for (int i = 0; i < E / 4; ++i)
      dst[i * 32 + lane] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2],
                                       s[4 * i + 3]);
  }
}

}  // namespace svl

// x (rows, SMC_COLS) fp32 contiguous, out (rows) fp32, s_out (rows,
// SMC_COLS) fp32 or null.  Returns 0, a cudaError_t code, or -1 for
// arguments the kernel does not take.
extern "C" int svl_softmax_calib(const void* x, void* out, void* s_out,
                                 int rows, int reps, void* stream) {
  if (rows <= 0 || reps < 0) return -1;
  const dim3 grid((rows + svl::SMC_ROWS - 1) / svl::SMC_ROWS);
  svl::softmax_calib_kernel<svl::SMC_COLS / 32>
      <<<grid, svl::SMC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<float*>(out),
          static_cast<float*>(s_out), rows, reps);
  return static_cast<int>(cudaGetLastError());
}
