// K3 / K4 / K5: fused GEGLU feed-forward, one kernel body with a
// compile-time prologue/epilogue mode.
//
// Replaces seervideoldm_tpu/ops/pallas/geglu_ff.py:
//   MODE 0 (K5) geglu_ff        -> _geglu_ff_fwd_impl, body _kernel
//       out = (h * gelu(g)) W2 + b2,          [h; g] = x W1 + b1
//   MODE 1 (K3) ln_geglu_ff      -> _ln_geglu_ff_impl, body _kernel_ln
//       out = x + FF(LN(x))
//   MODE 2 (K4) ln_geglu_ff_proj -> _ln_proj_impl, body _kernel_ln_proj
//       y = x + FF(LN(x));  out = (y W3 + b3) + res
// All three share _ff_core, and so do the modes here.
//
// Rounding points kept exactly as the JAX bodies (geglu_ff.py:89-96, 112,
// 135, 160-162): h = bf16(x W1h) + bf16 b1h and g likewise (bf16 adds);
// a = bf16(fp32(h) * gelu_erf(fp32(g))); acc += a W2 in fp32; epilogue
// bf16(acc) + b2 (+ x); K4 adds z = y W3 in fp32 then bf16(z) + b3 + res.
// gelu uses the exact erf (erff): the TPU kernel's Abramowitz-Stegun erf
// existed only because Mosaic has no erf, and the JAX plain path is exact.
// LN: fp32 mean and variance over the channels, eps from the caller.
//
// What bounds it on an H100: at the main-path shapes (24576 x 320, inner
// 1280; 6144 x 640, inner 2560) ~60 GFLOP against a few tens of MB, so the
// tensor cores (~0.06 ms).  The TPU kernel kept W1 and W2 resident in VMEM
// (2.5 MB at c = 320, 9.8 MB at c = 640); here the weights stream from the
// 50 MB L2 through shared memory in 64-wide inner chunks, and the
// (tokens x c) fp32 accumulator lives in registers, which caps the token
// tile at 32 rows (8 warps: 2 row groups x 4 column groups).  mma.sync
// m16n8k16 with synchronous staging; TMA/wgmma pipelining is later work.
//
// Layout (torch Linear layout, (out, in), contiguous, bf16 unless noted):
//   x (n, C); w1 (2 * inner, C) rows [hidden | gate]; b1 (2 * inner);
//   w2 (C, inner); b2 (C); gamma/beta fp32 (C); w3 (C, C); b3 (C);
//   res (n, C); out (n, C).  n % 32 == 0, inner % 64 == 0, C % 64 == 0.
#include <math.h>

#include "common.cuh"

namespace svl {

constexpr int FF_BM = 32;        // tokens per CTA
constexpr int FF_IC = 64;        // inner columns per chunk
constexpr int FF_KS = 64;        // k slab of the staged W1 / W3 tiles
constexpr int FF_THREADS = 256;  // 8 warps
constexpr int FF_PAD = 8;        // row padding (bf16) against bank conflicts

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

template <int C>
struct FFSmem {
  static constexpr int XS = C + FF_PAD;       // x / LN(x) / y tile stride
  static constexpr int WS = FF_KS + FF_PAD;   // staged W1 slab stride
  static constexpr int AS = FF_IC + FF_PAD;   // a tile stride
  static constexpr int W2S = FF_IC + FF_PAD;  // staged W2 chunk / W3 slab
  static constexpr int X_ELEMS = FF_BM * XS;
  static constexpr int W1_ELEMS = 2 * FF_IC * WS;
  static constexpr int A_ELEMS = FF_BM * AS;
  static constexpr int W2_ELEMS = C * W2S;
  static constexpr int BYTES =
      (X_ELEMS + W1_ELEMS + A_ELEMS + W2_ELEMS) * (int)sizeof(bf16);
};

// rows x 64 columns of a row-major bf16 matrix (row stride ld) into shared
// memory with row stride sld, in 16-byte vectors.
__device__ __forceinline__ void stage64(bf16* dst, int sld, const bf16* src,
                                        size_t ld, int rows) {
  for (int i = threadIdx.x; i < rows * 8; i += FF_THREADS) {
    const int r = i >> 3, c8 = i & 7;
    *reinterpret_cast<uint4*>(dst + r * sld + c8 * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c8 * 8);
  }
}

template <int C, int MODE>
__global__ void __launch_bounds__(FF_THREADS)
    geglu_ff_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, const bf16* __restrict__ w3,
                    const bf16* __restrict__ b3, const bf16* __restrict__ res,
                    bf16* __restrict__ out, int n, int inner, float eps) {
  using S = FFSmem<C>;
  constexpr int NT = C / 32;  // 8-column output tiles per warp (C/4 cols)
  extern __shared__ __align__(16) unsigned char ff_smem[];
  bf16* xs = reinterpret_cast<bf16*>(ff_smem);
  bf16* w1s = xs + S::X_ELEMS;
  bf16* as = w1s + S::W1_ELEMS;
  bf16* w2s = as + S::A_ELEMS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 1, wc = warp >> 1;  // 2 row groups x 4 col groups
  const int row0 = blockIdx.x * FF_BM;

  // ---- prologue: x tile, or LN(x) in fp32 rounded to bf16
  if (MODE == 0) {
    for (int i = tid; i < FF_BM * (C / 8); i += FF_THREADS) {
      const int r = i / (C / 8), c8 = i % (C / 8);
      *reinterpret_cast<uint4*>(xs + r * S::XS + c8 * 8) =
          *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * C + c8 * 8);
    }
  } else {
    for (int r = warp; r < FF_BM; r += FF_THREADS / 32) {
      const bf16* xr = x + (size_t)(row0 + r) * C;
      float sum = 0.f;
      for (int c = lane; c < C; c += 32) sum += __bfloat162float(xr[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float mean = sum / C;
      float var = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float dv = __bfloat162float(xr[c]) - mean;
        var += dv * dv;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
      const float rstd = rsqrtf(var / C + eps);
      for (int c = lane; c < C; c += 32) {
        const float ln = (__bfloat162float(xr[c]) - mean) * rstd * gamma[c] + beta[c];
        xs[r * S::XS + c] = __float2bfloat16_rn(ln);
      }
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int ic0 = 0; ic0 < inner; ic0 += FF_IC) {
    // ---- phase 1: h, g (32 x 64 each) = x (32 x C) . W1 chunk^T
    float hacc[2][4], gacc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[nt][e] = gacc[nt][e] = 0.f;
    for (int k0 = 0; k0 < C; k0 += FF_KS) {
      __syncthreads();
      stage64(w1s, S::WS, w1 + (size_t)ic0 * C + k0, C, FF_IC);
      stage64(w1s + FF_IC * S::WS, S::WS, w1 + (size_t)(inner + ic0) * C + k0,
              C, FF_IC);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FF_KS; kk += 16) {
        uint32_t a[4];
        load_a_frag(a, xs, S::XS, wr * 16, k0 + kk, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t b0, b1;
          load_b_frag(b0, b1, w1s, S::WS, wc * 16 + nt * 8, kk, lane);
          mma_16816(hacc[nt], a, b0, b1);
          load_b_frag(b0, b1, w1s + FF_IC * S::WS, S::WS, wc * 16 + nt * 8, kk,
                      lane);
          mma_16816(gacc[nt], a, b0, b1);
        }
      }
    }
    // a = bf16(h * gelu(g)) into shared memory
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = wc * 16 + nt * 8 + 2 * t;
      const float bh0 = __bfloat162float(b1[ic0 + col]);
      const float bh1 = __bfloat162float(b1[ic0 + col + 1]);
      const float bg0 = __bfloat162float(b1[inner + ic0 + col]);
      const float bg1 = __bfloat162float(b1[inner + ic0 + col + 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float h0 = bf16r(bf16r(hacc[nt][2 * r]) + bh0);
        const float h1 = bf16r(bf16r(hacc[nt][2 * r + 1]) + bh1);
        const float g0 = bf16r(bf16r(gacc[nt][2 * r]) + bg0);
        const float g1 = bf16r(bf16r(gacc[nt][2 * r + 1]) + bg1);
        *reinterpret_cast<uint32_t*>(as + (wr * 16 + g + 8 * r) * S::AS + col) =
            pack_bf16x2(h0 * gelu_erf(g0), h1 * gelu_erf(g1));
      }
    }
    // W2[:, ic0 : ic0 + 64] (C rows)
    stage64(w2s, S::W2S, w2 + ic0, inner, C);
    __syncthreads();
    // ---- phase 2: acc (32 x C) += a (32 x 64) . W2 chunk^T
#pragma unroll
    for (int kk = 0; kk < FF_IC; kk += 16) {
      uint32_t a[4];
      load_a_frag(a, as, S::AS, wr * 16, kk, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        load_b_frag(b0, b1, w2s, S::W2S, wc * (C / 4) + nt * 8, kk, lane);
        mma_16816(acc[nt], a, b0, b1);
      }
    }
  }

  // ---- epilogue: y = bf16(acc) + b2 (+ x)
  float y[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = wc * (C / 4) + nt * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + wr * 16 + g + ((e >> 1) << 3);
      float v = bf16r(bf16r(acc[nt][e]) + __bfloat162float(b2[col + (e & 1)]));
      if (MODE >= 1) v = bf16r(v + __bfloat162float(x[(size_t)row * C + col + (e & 1)]));
      y[nt][e] = v;
    }
  }

  if (MODE == 2) {
    // y into the x tile (free since the last phase 1), then z = y . W3^T
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = wc * (C / 4) + nt * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<uint32_t*>(xs + (wr * 16 + g + 8 * r) * S::XS + col) =
            pack_bf16x2(y[nt][2 * r], y[nt][2 * r + 1]);
        acc[nt][2 * r] = acc[nt][2 * r + 1] = 0.f;
      }
    }
    for (int k0 = 0; k0 < C; k0 += FF_KS) {
      __syncthreads();
      stage64(w2s, S::W2S, w3 + k0, C, C);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FF_KS; kk += 16) {
        uint32_t a[4];
        load_a_frag(a, xs, S::XS, wr * 16, k0 + kk, lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b0, b1;
          load_b_frag(b0, b1, w2s, S::W2S, wc * (C / 4) + nt * 8, kk, lane);
          mma_16816(acc[nt], a, b0, b1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = wc * (C / 4) + nt * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + wr * 16 + g + ((e >> 1) << 3);
        const float z = bf16r(bf16r(acc[nt][e]) + __bfloat162float(b3[col + (e & 1)]));
        y[nt][e] = z + __bfloat162float(res[(size_t)row * C + col + (e & 1)]);
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = wc * (C / 4) + nt * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + wr * 16 + g + 8 * r;
      *reinterpret_cast<uint32_t*>(out + (size_t)row * C + col) =
          pack_bf16x2(y[nt][2 * r], y[nt][2 * r + 1]);
    }
  }
}

template <int C, int MODE>
static int launch(const bf16* x, const float* gamma, const float* beta,
                  const bf16* w1, const bf16* b1, const bf16* w2,
                  const bf16* b2, const bf16* w3, const bf16* b3,
                  const bf16* res, bf16* out, int n, int inner, float eps,
                  cudaStream_t stream) {
  constexpr int bytes = FFSmem<C>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      geglu_ff_kernel<C, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  geglu_ff_kernel<C, MODE><<<n / FF_BM, FF_THREADS, bytes, stream>>>(
      x, gamma, beta, w1, b1, w2, b2, w3, b3, res, out, n, inner, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace svl

// mode 0: K5 geglu_ff; 1: K3 ln_geglu_ff; 2: K4 ln_geglu_ff_proj.  Returns
// 0 on success, a cudaError_t code after a failed launch, or -1 for a shape
// this build does not cover: c must be a multiple of 64, at most 704 for
// mode 0 and 320 for the LN modes (the JAX site gates: weights <= 12 MB,
// c <= 320); n % 32 == 0; inner % 64 == 0.
extern "C" int svl_geglu_ff_fwd(const void* x, const void* gamma,
                                const void* beta, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                const void* w3, const void* b3,
                                const void* res, void* out, int n, int c,
                                int inner, float eps, int mode, void* stream) {
  using svl::bf16;
  if (n % svl::FF_BM != 0 || inner % svl::FF_IC != 0 || mode < 0 || mode > 2)
    return -1;
  const bf16* xx = static_cast<const bf16*>(x);
  const float* gg = static_cast<const float*>(gamma);
  const float* bb = static_cast<const float*>(beta);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const bf16* b1p = static_cast<const bf16*>(b1);
  const bf16* w2p = static_cast<const bf16*>(w2);
  const bf16* b2p = static_cast<const bf16*>(b2);
  const bf16* w3p = static_cast<const bf16*>(w3);
  const bf16* b3p = static_cast<const bf16*>(b3);
  const bf16* rp = static_cast<const bf16*>(res);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVL_ARGS xx, gg, bb, w1p, b1p, w2p, b2p, w3p, b3p, rp, op, n, inner, eps, s
#define SVL_LN_CASE(CV)                                            \
  case CV:                                                         \
    if (mode == 0) return svl::launch<CV, 0>(SVL_ARGS);            \
    if (mode == 1) return svl::launch<CV, 1>(SVL_ARGS);            \
    return svl::launch<CV, 2>(SVL_ARGS);
#define SVL_CASE(CV) \
  case CV:           \
    if (mode == 0) return svl::launch<CV, 0>(SVL_ARGS); \
    return -1;
  switch (c) {
    SVL_LN_CASE(64) SVL_LN_CASE(128) SVL_LN_CASE(192) SVL_LN_CASE(256)
    SVL_LN_CASE(320)
    SVL_CASE(384) SVL_CASE(448) SVL_CASE(512) SVL_CASE(576) SVL_CASE(640)
    SVL_CASE(704)
    default: return -1;
  }
#undef SVL_CASE
#undef SVL_LN_CASE
#undef SVL_ARGS
  return -1;
}
