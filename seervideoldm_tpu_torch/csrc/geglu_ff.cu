// K3 / K4 / K5: the GEGLU feed-forward as two Hopper GEMMs, an up kernel
// and a down kernel, launched back to back on one stream; each public mode
// is one call of the C entries below from the Python wrapper.
//
// Replaces seervideoldm_tpu/ops/pallas/geglu_ff.py:
//   mode 0 (K5) geglu_ff         -> _geglu_ff_fwd_impl, body _kernel
//       out = (h * gelu(g)) W2^T + b2,        [h; g] = x W1^T + b1
//   mode 1 (K3) ln_geglu_ff       -> _ln_geglu_ff_impl, body _kernel_ln
//       out = x + FF(LN(x))
//   mode 2 (K4) ln_geglu_ff_proj  -> _ln_proj_impl, body _kernel_ln_proj
//       y = x + FF(LN(x));  out = (y W3^T + b3) + res
//
// Rounding points kept exactly as the JAX bodies (geglu_ff.py:89-97, 112,
// 135, 160-162): h = bf16(acc_h) + bf16 b1h and g likewise (bf16 adds);
// a = bf16(fp32(h) * gelu_erf(fp32(g))); the second product accumulates in
// fp32, then bf16(acc) + b2 (+ x, a bf16 add); K4 then z = y W3^T in fp32
// and out = bf16((z + b3) + res), one rounding: the TPU body rounds z and
// each add to bf16, and where res cancels z an order-dependent flip of
// bf16(z) (one ulp at |z| in [4, 8) is 0.03) then stood in an output near
// 0 (1.5 % of the kernel checks' draws missed by it).  gelu uses the exact erf (erff): the TPU kernel's
// Abramowitz-Stegun erf existed only because Mosaic has no erf, and the JAX
// plain path is exact.  LN: the TPU kernels' cen * rsqrt(var + eps), the
// mean and centred variance summed in fp64 and rounded once to fp32 (see
// ln_rows), eps from the caller, one bf16 rounding after the affine.
// Splitting the FF at `a` changes no number: the TPU kernel rounds `a` to
// bf16 at that point.
//
// Bound on an H100: 6 n c inner FLOPs (+ 2 n c^2 for K4) against
// 2 (2 n c + 3 c inner) bytes: tensor-core bound, 0.061 ms at (6144, 640,
// inner 2560) and (24576, 320, inner 1280).  The design adds the
// intermediate `a` (n x inner bf16), written once by the up kernel and read
// once by the down kernel: 2 n inner 2 bytes, 63 MB at 6144 x 2560 and 126
// MB at 24576 x 1280 (the down kernel runs right after the up kernel, so
// much of it is served from the 50 MB L2).  The bound does not count it.
//
// Design.  The earlier body fused both products in one kernel with a
// 32-token CTA that re-streamed every weight from L2 (1.9 GB of L2 traffic
// per call at c = 640); a larger token tile cannot hold its (tokens x c)
// fp32 accumulator at c = 640, so here the FF is two GEMMs with 128-token
// tiles:
//   up:   a[128 x BN] tile; per 64-wide k chunk two wgmma streams from the
//         same A tile, one against W1 rows [j0, j0+BN) (hidden), one
//         against rows [inner+j0, ...) (gate), so element e of h pairs with
//         element e of g in registers and the GEGLU runs in the epilogue.
//         Modes 1, 2: c <= 320, so the CTA keeps its whole 128 x c A panel
//         in shared memory (80 KB at c = 320), normalises it in place once
//         (each consumer warp 16 rows: x read with 16-byte loads, fp32
//         statistics, written in the TMA swizzle), and only W1 streams.
//         A CTA takes `tiles` neighbouring column tiles of one row block
//         (ops/kernels/geglu_ff.py::plan) and normalises its rows once for
//         all of them, so a row block is normalised inner / (BN tiles)
//         times: 128 c elements against tiles * 128 * 2 BN * c * 2 FLOPs,
//         under 1 % of the work, and no separate LN launch.  (The pass is
//         latency-bound, four rows in flight per warp; the plan weighs it.)
//         Mode 0 takes `tiles` per CTA too: its ring runs on from one tile
//         into the next, so the first fill is paid once.
//   down: out[128 x BN] tile = a W2^T over k = inner.  Modes 0, 1: BN from
//         {64, 128, 320} chosen per shape on the host (ops/kernels/
//         geglu_ff.py::plan) to fill the 132 SMs.  Mode 2: BN = c (whole
//         rows, 160 fp32 accumulators a thread at c = 320); y = bf16(acc) +
//         b2 + x goes to shared memory as bf16 in the TMA swizzle, W3
//         streams through a two-stage ring and the same accumulator takes
//         z = y W3^T.
// Both kernels: 384 threads, one producer warp (setmaxnreg 40) issuing TMA
// copies (cp.async.bulk.tensor, 128-byte swizzle, 64-wide k boxes) into a
// ring of 3-6 stages with full/empty mbarriers, and two consumer
// warpgroups (setmaxnreg 232), 64 rows each, issuing wgmma.mma_async
// m64n128k16 / m64n64k16 (bf16 in, fp32 accumulate) from shared memory with
// descriptors in the same 128-byte swizzle, one commit group in flight.
// One CTA per SM (up to 208 KB of shared memory).  The tensor maps of the
// activations change address every call, so the host encodes all of them
// per call (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, as the
// build links no -lcuda): four or five encodes a call, a few microseconds
// of host time.
// The epilogues store straight from the accumulator fragments.
//
// Layout (torch Linear layout, (out, in), contiguous, bf16 unless noted):
//   x (n, c); w1 (2 inner, c) rows [hidden | gate]; b1 (2 inner);
//   a (n, inner); w2 (c, inner); b2 (c); gamma/beta fp32 (c); w3 (c, c);
//   b3 (c); res (n, c); out (n, c).  Every operand is K-major, as wgmma
//   wants both; nothing is transposed.
// Coverage: n % 128 == 0, inner % 64 == 0, c % 64 == 0, c <= 704 (mode 0)
// or c <= 320 (modes 1, 2).
// Registers and spills (-Xptxas -v, printed by chip_smoke.py phase 2):
// every instantiation 168 registers at entry (the launch bound's share of
// 384 threads; setmaxnreg then moves them from the producer warpgroup to
// the consumers) and 0 bytes of spills.
#include <math.h>

#include "hopper.cuh"

namespace svl {
namespace ff {

constexpr int BM = 128;        // tokens per CTA (two consumer warpgroups)
constexpr int BK = 64;         // k per stage: one 128-byte swizzle row
constexpr int THREADS = 384;   // producer warpgroup + two consumers
constexpr int TILE_A = BM * BK * 2;           // 16 KB
constexpr int SMEM_BUDGET = 208 * 1024;       // tiles; + alignment, barriers
constexpr int SMEM_EXTRA = 1024 + 256;

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

// One k16 step of a 64 x BN accumulator (BN a multiple of 64): m64n128
// products over 128-row blocks of the B tile, m64n64 for a 64-row rest.
// The n128 fragment is two n64 fragments side by side, so acc[32 q ...]
// always holds columns [64 q, 64 q + 64).
template <int BN>
__device__ __forceinline__ void mma_k16(float* acc, uint64_t da, uint64_t db) {
#pragma unroll
  for (int q = 0; q < BN / 128; ++q) wgmma_n128(acc + q * 64, da, db + q * 1024);
  if constexpr (BN % 128 != 0)
    wgmma_n64(acc + (BN / 128) * 64, da, db + (BN / 128) * 1024);
}

// One 64-wide k chunk: four k16 steps, the descriptors advanced by 32 bytes
// (2 in their 16-byte units) inside the swizzled 128-byte rows.
template <int BN>
__device__ __forceinline__ void mma_chunk(float* acc, uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) mma_k16<BN>(acc, da + 2 * kk, db + 2 * kk);
}

template <int N>
__device__ __forceinline__ void zero_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
  fence_acc<N>(d);
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of 16 rows (r0 ...) of the 128 x C A panel, four rows in
// flight (their loads issued together: the pass is latency-bound): x rows
// read with 16-byte loads (a lane takes vectors lane, lane + 32).  The
// formula and rounding points of the plain version (ops/kernels/
// geglu_ff.py::_layer_norm), so that `a` agrees with it bit for bit: the
// mean and the centred variance summed in fp64 (exact for bf16 inputs, so
// the warp's order of summation does not matter) and rounded once to fp32;
// then in fp32, every step correctly rounded and none contracted into an
// fma, cen = x - mean, rsd = 1 / sqrt(var + eps), ((cen * rsd) * gamma) +
// beta, one bf16 rounding, written into the panel's C / 64 swizzled
// 128 x 64 chunks.
template <int C>
__device__ __forceinline__ void ln_rows(unsigned char* panel, const bf16* x,
                                       const float* gamma, const float* beta,
                                       int m0, int r0, int lane, float eps) {
  constexpr int NV = C / 8, VPL = (NV + 31) / 32, RG = 4;
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  for (int i0 = 0; i0 < 16; i0 += RG) {
    float v[RG][VPL][8], mean[RG], rsd[RG];  // rsd: 1 / sqrt(var + eps)
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const uint4* xr =
          reinterpret_cast<const uint4*>(x + (size_t)(m0 + r0 + i0 + i) * C);
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int idx = lane + 32 * j;
        if (idx < NV) {
          const uint4 u = xr[idx];
          const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
          for (int k = 0; k < 8; ++k) v[i][j][k] = __bfloat162float(e[k]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      double sum = 0.0;
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        if (lane + 32 * j < NV) {
#pragma unroll
          for (int k = 0; k < 8; ++k) sum += (double)v[i][j][k];
        }
      mean[i] = __double2float_rn(warp_sum_f64(sum) / C);
    }
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      double var = 0.0;
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        if (lane + 32 * j < NV) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            v[i][j][k] = __fsub_rn(v[i][j][k], mean[i]);
            var += (double)v[i][j][k] * (double)v[i][j][k];
          }
        }
      const float var32 = __double2float_rn(warp_sum_f64(var) / C);
      rsd[i] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var32, eps)));
    }
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int idx = lane + 32 * j;
      if (idx < NV) {
        const float4 ga = g4[2 * idx], gb = g4[2 * idx + 1];
        const float4 ba = b4[2 * idx], bb = b4[2 * idx + 1];
        const float gm[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
        const float bt[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int i = 0; i < RG; ++i) {
          float y[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            y[k] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j][k], rsd[i]), gm[k]),
                             bt[k]);
          uint32_t o[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) o[k] = pack_bf16x2(y[2 * k], y[2 * k + 1]);
          *reinterpret_cast<uint4*>(panel + (idx >> 3) * TILE_A +
                                    swz(r0 + i0 + i, (idx & 7) * 8)) =
              make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
    }
  }
}

// --------------------------------------------------------------- up kernel

// CLN = 0: mode 0, A streams with W1; CLN = C: modes 1, 2, the LN'd A
// panel (C / 64 chunks) stays resident and only W1 streams.
template <int BN, int CLN>
struct UpPlan {
  static constexpr int TILE_W = BN * BK * 2;
  static constexpr int STAGE = (CLN ? 0 : TILE_A) + 2 * TILE_W;
  static constexpr int PANEL = CLN / 64 * TILE_A;
  static constexpr int S0 = (SMEM_BUDGET - PANEL) / STAGE;
  static constexpr int STAGES = S0 > 6 ? 6 : S0;
  static constexpr int BYTES = PANEL + STAGES * STAGE + SMEM_EXTRA;
  static_assert(STAGES >= 3, "ring too shallow");
};

// a = bf16(h * gelu(g)), [h; g] = P(x) W1^T + b1: a CTA takes `tiles`
// neighbouring 128 x BN tiles of a in one row block (one LN of its rows for
// all of them; the ring runs on across tiles, so the next tile's loads
// overlap this one's epilogue); grid (inner / (BN tiles), n / 128).
template <int BN, int CLN>
__global__ void __launch_bounds__(THREADS, 1)
    geglu_up_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w1,
                    const bf16* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const bf16* __restrict__ b1,
                    bf16* __restrict__ a, int c, int inner, int tiles,
                    float eps) {
  using P = UpPlan<BN, CLN>;
  constexpr bool LN = CLN > 0;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t ring = base + P::PANEL;
  const uint32_t bars = ring + P::STAGES * P::STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (P::STAGES + s); };

  const int nk = LN ? CLN / BK : c / BK;
  const int jb = blockIdx.x * tiles * BN, m0 = blockIdx.y * BM;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      if (!LN) tma_prefetch(&tm_x);
      tma_prefetch(&tm_w1);
      int s = 0;
      uint32_t ph = 0;
      for (int j0 = jb; j0 < jb + tiles * BN; j0 += BN)
        for (int it = 0; it < nk; ++it) {
          mbar_wait(empty(s), ph ^ 1);
          mbar_expect_tx(full(s), P::STAGE);
          const uint32_t st = ring + s * P::STAGE;
          const int k0 = it * BK;
          if (!LN) tma_load(st, &tm_x, k0, m0, full(s));
          const uint32_t wt = st + (LN ? 0 : TILE_A);
          tma_load(wt, &tm_w1, k0, j0, full(s));
          tma_load(wt + P::TILE_W, &tm_w1, k0, inner + j0, full(s));
          if (++s == P::STAGES) { s = 0; ph ^= 1; }
        }
    }
  } else {  // consumers: rows [64 cw, 64 cw + 64) of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    if constexpr (LN) {
      ln_rows<CLN>(gbase, x, gamma, beta, m0, cw * 64 + wq * 16, lane, eps);
      fence_async_smem();
      named_sync(2 + cw, 128);
    }
    const int t = lane & 3, row0 = m0 + cw * 64 + wq * 16 + (lane >> 2);
    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (int j0 = jb; j0 < jb + tiles * BN; j0 += BN) {
      float h[BN / 2], g[BN / 2];
      zero_acc<BN / 2>(h);
      zero_acc<BN / 2>(g);
      for (int it = 0; it < nk; ++it) {
        mbar_wait(full(s), ph);
        const uint32_t st = ring + s * P::STAGE;
        const uint32_t at = LN ? base + it * TILE_A : st;
        const uint64_t da = desc_sw128(at + cw * 64 * 128);
        const uint32_t wt = st + (LN ? 0 : TILE_A);
        wgmma_fence();
        mma_chunk<BN>(h, da, desc_sw128(wt));
        mma_chunk<BN>(g, da, desc_sw128(wt + P::TILE_W));
        wgmma_commit();
        wgmma_wait<1>();
        if (it > 0 && lane == 0) mbar_arrive(empty(prev));
        prev = s;
        if (++s == P::STAGES) { s = 0; ph ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc<BN / 2>(h);
      fence_acc<BN / 2>(g);
      if (lane == 0) mbar_arrive(empty(prev));

      // fragment: h[4 q + 2 r + e] at row 16 wq + lane / 4 + 8 r, column
      // 8 q + 2 (lane % 4) + e of this warpgroup's 64 x BN block
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const int col = j0 + q * 8 + 2 * t;
        const __nv_bfloat162 bh = *reinterpret_cast<const __nv_bfloat162*>(b1 + col);
        const __nv_bfloat162 bg =
            *reinterpret_cast<const __nv_bfloat162*>(b1 + inner + col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * q + 2 * r;
          const float h0 = bf16r(bf16r(h[i]) + __low2float(bh));
          const float h1 = bf16r(bf16r(h[i + 1]) + __high2float(bh));
          const float g0 = bf16r(bf16r(g[i]) + __low2float(bg));
          const float g1 = bf16r(bf16r(g[i + 1]) + __high2float(bg));
          *reinterpret_cast<uint32_t*>(a + (size_t)(row0 + 8 * r) * inner + col) =
              pack_bf16x2(h0 * gelu_erf(g0), h1 * gelu_erf(g1));
        }
      }
    }
  }
}

// ------------------------------------------------------------- down kernel

template <int BN, int MODE>
struct DownPlan {
  static constexpr int BOX = BN <= 256 ? BN : BN / 2;  // TMA box rows <= 256
  static constexpr int TILE_B = BN * BK * 2;
  static constexpr int STAGE = TILE_A + TILE_B;
  static constexpr int S0 = SMEM_BUDGET / STAGE;
  static constexpr int STAGES = S0 > 6 ? 6 : S0;
  // mode 2 tail, over the drained ring: the y panel, then two W3 stages
  static constexpr int YP = BN / 64 * TILE_A;
  static constexpr int TAIL = MODE == 2 ? YP + 2 * TILE_B : 0;
  static constexpr int TILES =
      STAGES * STAGE > TAIL ? STAGES * STAGE : TAIL;
  static constexpr int BYTES = TILES + SMEM_EXTRA;
  static_assert(STAGES >= 3 && TILES <= SMEM_BUDGET, "shared memory plan");
};

// out = bf16(a W2^T) + b2 (mode 1: + x); mode 2 (BN = c): y = that + x,
// out = bf16((y W3^T + b3) + res).  One 128 x BN tile of out per CTA; grid
// (c / BN, n / 128).
template <int BN, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    geglu_down_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_w2,
                      const __grid_constant__ CUtensorMap tm_w3,
                      const bf16* __restrict__ b2, const bf16* __restrict__ x,
                      const bf16* __restrict__ b3, const bf16* __restrict__ res,
                      bf16* __restrict__ out, int c, int inner) {
  using P = DownPlan<BN, MODE>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + P::TILES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (P::STAGES + s); };
  auto tfull = [&](int s) { return bars + 8 * (2 * P::STAGES + s); };
  auto tempty = [&](int s) { return bars + 8 * (2 * P::STAGES + 2 + s); };
  const uint32_t tail_go = bars + 8 * (2 * P::STAGES + 4);

  const int nk = inner / BK;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(tfull(s), 1);
      mbar_init(tempty(s), 8);
    }
    mbar_init(tail_go, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_a);
      tma_prefetch(&tm_w2);
      int s = 0;
      uint32_t ph = 0;
      for (int it = 0; it < nk; ++it) {
        mbar_wait(empty(s), ph ^ 1);
        mbar_expect_tx(full(s), P::STAGE);
        const uint32_t st = base + s * P::STAGE;
        tma_load(st, &tm_a, it * BK, m0, full(s));
#pragma unroll
        for (int b = 0; b < BN / P::BOX; ++b)
          tma_load(st + TILE_A + b * P::BOX * 128, &tm_w2, it * BK,
                   n0 + b * P::BOX, full(s));
        if (++s == P::STAGES) { s = 0; ph ^= 1; }
      }
      if constexpr (MODE == 2) {
        // W3 streams once the consumers have drained the ring
        mbar_wait(tail_go, 0);
        for (int kc = 0; kc < BN / BK; ++kc) {
          const int ts = kc & 1;
          mbar_wait(tempty(ts), ((kc >> 1) & 1) ^ 1);
          mbar_expect_tx(tfull(ts), P::TILE_B);
          const uint32_t st = base + P::YP + ts * P::TILE_B;
#pragma unroll
          for (int b = 0; b < BN / P::BOX; ++b)
            tma_load(st + b * P::BOX * 128, &tm_w3, kc * BK, b * P::BOX,
                     tfull(ts));
        }
      }
    }
  } else {  // consumers: rows [64 cw, 64 cw + 64) of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    float acc[BN / 2];
    zero_acc<BN / 2>(acc);
    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (int it = 0; it < nk; ++it) {
      mbar_wait(full(s), ph);
      const uint32_t st = base + s * P::STAGE;
      wgmma_fence();
      mma_chunk<BN>(acc, desc_sw128(st + cw * 64 * 128), desc_sw128(st + TILE_A));
      wgmma_commit();
      wgmma_wait<1>();
      if (it > 0 && lane == 0) mbar_arrive(empty(prev));
      prev = s;
      if (++s == P::STAGES) { s = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    fence_acc<BN / 2>(acc);

    // fragment: acc[4 q + 2 r + e] at row 16 wq + lane / 4 + 8 r, column
    // 8 q + 2 (lane % 4) + e of this warpgroup's 64 x BN block
    const int t = lane & 3, prow = cw * 64 + wq * 16 + (lane >> 2);
    const int row0 = m0 + prow;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int col = n0 + q * 8 + 2 * t;
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(b2 + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * q + 2 * r;
        const size_t off = (size_t)(row0 + 8 * r) * c + col;
        float v0 = bf16r(bf16r(acc[i]) + __low2float(bb));
        float v1 = bf16r(bf16r(acc[i + 1]) + __high2float(bb));
        if constexpr (MODE >= 1) {
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + off);
          v0 = bf16r(v0 + __low2float(xv));
          v1 = bf16r(v1 + __high2float(xv));
        }
        if constexpr (MODE < 2) {
          *reinterpret_cast<uint32_t*>(out + off) = pack_bf16x2(v0, v1);
        } else {
          acc[i] = v0;
          acc[i + 1] = v1;
        }
      }
    }

    if constexpr (MODE == 2) {
      // both warpgroups are done with the ring: W3 may stream, y may land
      named_sync(1, 256);
      if (threadIdx.x == 128) mbar_arrive(tail_go);
#pragma unroll
      for (int q = 0; q < BN / 8; ++q)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * q + 2 * r, col = q * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(gbase + (col >> 6) * TILE_A +
                                       swz(prow + 8 * r, col & 63)) =
              pack_bf16x2(acc[i], acc[i + 1]);
        }
      fence_async_smem();
      named_sync(2 + cw, 128);
      zero_acc<BN / 2>(acc);
      for (int kc = 0; kc < BN / BK; ++kc) {
        const int ts = kc & 1;
        mbar_wait(tfull(ts), (kc >> 1) & 1);
        wgmma_fence();
        mma_chunk<BN>(acc, desc_sw128(base + kc * TILE_A + cw * 64 * 128),
                      desc_sw128(base + P::YP + ts * P::TILE_B));
        wgmma_commit();
        wgmma_wait<1>();
        if (kc > 0 && lane == 0) mbar_arrive(tempty(ts ^ 1));
      }
      wgmma_wait<0>();
      fence_acc<BN / 2>(acc);
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const int col = q * 8 + 2 * t;
        const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(b3 + col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * q + 2 * r;
          const size_t off = (size_t)(row0 + 8 * r) * c + col;
          const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(res + off);
          const float z0 = acc[i] + __low2float(bb);
          const float z1 = acc[i + 1] + __high2float(bb);
          *reinterpret_cast<uint32_t*>(out + off) =
              pack_bf16x2(z0 + __low2float(rv), z1 + __high2float(rv));
        }
      }
    }
  }
}

// -------------------------------------------------------------------- host

// A rows x cols row-major bf16 matrix read in boxes of 64 columns (128
// bytes, the swizzle span) x box_rows rows.
static bool encode(CUtensorMap* map, const void* ptr, int rows, int cols,
                   int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  return encode_bf16(map, ptr, 2, dims, strides, box);
}

template <int BN, int CLN>
static int launch_up(const CUtensorMap& tx, const CUtensorMap& tw,
                     const bf16* x, const float* gamma, const float* beta,
                     const bf16* b1, bf16* a, int n, int c, int inner,
                     int tiles, float eps, cudaStream_t stream) {
  constexpr int bytes = UpPlan<BN, CLN>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      geglu_up_kernel<BN, CLN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  geglu_up_kernel<BN, CLN>
      <<<dim3(inner / (BN * tiles), n / BM), THREADS, bytes, stream>>>(
          tx, tw, x, gamma, beta, b1, a, c, inner, tiles, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int MODE>
static int launch_down(const CUtensorMap& ta, const CUtensorMap& tw2,
                       const CUtensorMap& tw3, const bf16* b2, const bf16* x,
                       const bf16* b3, const bf16* res, bf16* out, int n,
                       int c, int inner, cudaStream_t stream) {
  constexpr int bytes = DownPlan<BN, MODE>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      geglu_down_kernel<BN, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  geglu_down_kernel<BN, MODE><<<dim3(c / BN, n / BM), THREADS, bytes, stream>>>(
      ta, tw2, tw3, b2, x, b3, res, out, c, inner);
  return static_cast<int>(cudaGetLastError());
}

static bool covered(int n, int c, int inner, bool ln) {
  return n > 0 && n % BM == 0 && inner > 0 && inner % BK == 0 && c > 0 &&
         c % 64 == 0 && c <= (ln ? 320 : 704);
}

}  // namespace ff
}  // namespace svl

// a (n, inner) = bf16(h * gelu(g)), [h; g] = P(x) W1^T + b1, P = LayerNorm
// (gamma, beta, eps) if ln else the identity; bn (64 or 128, dividing
// inner) the column tile, tiles (dividing inner / bn) the tiles a CTA takes.  Returns 0, a cudaError_t code, or -1 for a shape
// this build does not cover (n % 128, inner % 64, c % 64 == 0, c <= 704,
// or c <= 320 with ln).
extern "C" int svl_geglu_up(const void* x, const void* gamma, const void* beta,
                            const void* w1, const void* b1, void* a, int n,
                            int c, int inner, float eps, int ln, int bn,
                            int tiles, void* stream) {
  using namespace svl::ff;
  using svl::bf16;
  if (!covered(n, c, inner, ln) || (bn != 64 && bn != 128) || inner % bn ||
      tiles < 1 || (inner / bn) % tiles)
    return -1;
  CUtensorMap tx{}, tw{};
  if ((!ln && !encode(&tx, x, n, c, BM)) || !encode(&tw, w1, 2 * inner, c, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  const bf16* b1p = static_cast<const bf16*>(b1);
  bf16* ap = static_cast<bf16*>(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVL_UP(BN, C) \
  return launch_up<BN, C>(tx, tw, xp, gp, bp, b1p, ap, n, c, inner, tiles, \
                          eps, s)
#define SVL_UP_BN(C) \
  if (bn == 128) SVL_UP(128, C); \
  SVL_UP(64, C)
  if (!ln) { SVL_UP_BN(0); }
  switch (c) {
    case 64: SVL_UP_BN(64);
    case 128: SVL_UP_BN(128);
    case 192: SVL_UP_BN(192);
    case 256: SVL_UP_BN(256);
    case 320: SVL_UP_BN(320);
    default: return -1;
  }
#undef SVL_UP_BN
#undef SVL_UP
}

// out (n, c) from a (n, inner): mode 0 bf16(a W2^T) + b2; mode 1 that + x;
// mode 2 (bn == c) y = that + x, out = bf16((y W3^T + b3) + res).  bn, the
// column tile of modes 0 and 1, is 64, 128 or 320 and divides c.  Returns
// as svl_geglu_up.
extern "C" int svl_geglu_down(const void* a, const void* w2, const void* b2,
                              const void* x, const void* w3, const void* b3,
                              const void* res, void* out, int n, int c,
                              int inner, int mode, int bn, void* stream) {
  using namespace svl::ff;
  using svl::bf16;
  if (mode < 0 || mode > 2 || !covered(n, c, inner, mode > 0)) return -1;
  if (mode == 2 ? bn != c
                : ((bn != 64 && bn != 128 && bn != 320) || c % bn))
    return -1;
  const int box = bn <= 256 ? bn : bn / 2;
  CUtensorMap ta{}, tw2{}, tw3{};
  if (!encode(&ta, a, n, inner, BM) || !encode(&tw2, w2, c, inner, box) ||
      (mode == 2 && !encode(&tw3, w3, c, c, box)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* b2p = static_cast<const bf16*>(b2);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* b3p = static_cast<const bf16*>(b3);
  const bf16* rp = static_cast<const bf16*>(res);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVL_DOWN(BN, MODE)                                                    \
  return launch_down<BN, MODE>(ta, tw2, tw3, b2p, xp, b3p, rp, op, n, c,     \
                               inner, s)
#define SVL_DOWN_BN(MODE)              \
  if (bn == 64) SVL_DOWN(64, MODE);    \
  if (bn == 128) SVL_DOWN(128, MODE);  \
  SVL_DOWN(320, MODE)
  if (mode == 0) { SVL_DOWN_BN(0); }
  if (mode == 1) { SVL_DOWN_BN(1); }
  switch (c) {
    case 64: SVL_DOWN(64, 2);
    case 128: SVL_DOWN(128, 2);
    case 192: SVL_DOWN(192, 2);
    case 256: SVL_DOWN(256, 2);
    case 320: SVL_DOWN(320, 2);
    default: return -1;
  }
#undef SVL_DOWN_BN
#undef SVL_DOWN
}
