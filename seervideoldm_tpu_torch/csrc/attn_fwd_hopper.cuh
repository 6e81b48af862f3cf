// The attention forward on Hopper: one warp-specialised body that K2
// (flash_attention.cu: flash_fwd_wgmma_kernel) and K1 / K6
// (swat_attention.cu: swat_fwd_wgmma_kernel) instantiate.
//
// A CTA is 1 + CWG warpgroups.  Warpgroup 0 is the producer: its first
// thread keeps TMA loads in flight (cp.async.bulk.tensor, 128-byte
// swizzle), first the CTA's query tiles, then the key/value tiles through a
// ring of 2-4 stages with full / empty mbarriers; when q and k are rotated
// in the kernel (K6 with rot_dim > 0: fp32 trig) its warps 1-3 rotate
// each key tile in shared memory once, after it lands, and release it to
// the consumers on a second mbarrier (ready).
// Warpgroups 1 .. CWG (2 or 3) are consumers: each holds one query tile of
// 64 rows (rotating it first when K6 rotates), and for every key tile that
// arrives and that its query tile sees:
//   S = Q K^T     wgmma m64n64k16, Q and K from shared memory (K-major),
//                 ceil(d / 16) k steps over the zero-padded head dim;
//   online softmax in registers (fp32 scores, running max and sum in the
//                 log2 domain, an l == 0 guard; p = ex2(s * scale log2(e)
//                 - m), one FFMA and one MUFU ex2 a score), p rounded to
//                 bf16 once, as the A operand of
//   O += P V      wgmma m64n64k16 with A from registers (the S accumulator
//                 fragments of two 8-key groups are the A fragment of a
//                 16-key chunk) and V read from shared memory MN-major
//                 through the descriptor's transpose bit: no transposed
//                 copy of V is made.
// A stage is released one key tile later, once the wait for the next S
// shows its P V products done.  The consumer warpgroups run
// unsynchronised, so one's exponentials overlap another's products: a
// warpgroup alone is latency-bound, and a third one (CWG 3) raises the
// throughput where its 152 registers suffice (d_pad <= 128).  Each key
// tile is loaded (and rotated) once per CTA and serves every query tile
// the CTA holds; the host's plan (ops/kernels/flash_attention.py::plan,
// swat_attention.py::plan) picks CWG so that the card fills.
//
// Head dims: d % 8 == 0, d <= 160, zero-padded by TMA's out-of-bounds fill
// to DPAD = 64, 128 or 192 (boxes of 64 columns, one 128-byte swizzle row
// each): S runs ceil(d / 16) k steps, O all DPAD columns (the padded
// columns of V are zero and are never stored).
//
// Numerics, as the TPU kernels and the plain versions: fp32 scores, running
// max and sum; p in bf16 only as the P V operand; fp32 accumulation;
// normalisation after P V with an l == 0 guard; the lse written in the log2
// domain, m + log2(l) (-inf for a row with no visible key), which the
// backward kernels (K7, K8, K9) read.
#pragma once

#include <math.h>

#include "hopper.cuh"

namespace svl {

// -------------------------------------------- SWAT windows and rotation

constexpr int SW_WS = 8;  // window side; ws^2 = 64 tokens = one tile

// Index, within one (f, h, w) volume, of token r (row-major in its ws x ws
// window) of window (wy, wx) in `frame`.
__device__ __forceinline__ size_t window_token(int frame, int wy, int wx,
                                               int r, int h, int w) {
  return ((size_t)frame * h + wy * SW_WS + r / SW_WS) * w + wx * SW_WS +
         r % SW_WS;
}

// The source of the rotation of q and k, a compile-time parameter:
// ROT_NONE (v, g, or q/k that arrive rotated: K2, K6/K9 with rot_dim = 0),
// ROT_TABLES (the fp32 cos/sin tables: K1/K7), ROT_TRIG (fp32 cos/sin
// computed from the token's position and the rotary frequencies: K6/K9
// with rot_dim > 0).
constexpr int ROT_NONE = 0;
constexpr int ROT_TABLES = 1;
constexpr int ROT_TRIG = 2;

struct RotSrc {
  const float* cos_t;     // ROT_TABLES: (f, h, w, d)
  const float* sin_t;
  const float* inv_freq;  // ROT_TRIG: rot_dim / 2 fp32 frequencies
  int rot_dim;            // ROT_TRIG: lanes >= rot_dim pass through
};

// cos and sin of the rotation of the pair (columns c, c + 1) of token `tok`
// (its index in the (f, h, w) volume, which is also its rotary position
// frame * h * w + row * w + col).  ROT_TRIG forms the phase as one fp32
// product pos * inv_freq, as the plain version does, and takes the
// full-range sincosf (phases reach 1e4 rad).
template <int ROT>
__device__ __forceinline__ void rot_cs(const RotSrc& rs, size_t tok, int d,
                                       int c, float2& cs, float2& sn) {
  if (ROT == ROT_TABLES) {
    cs = *reinterpret_cast<const float2*>(rs.cos_t + tok * d + c);
    sn = *reinterpret_cast<const float2*>(rs.sin_t + tok * d + c);
  } else if (c < rs.rot_dim) {
    float s, co;
    sincosf((float)tok * rs.inv_freq[c >> 1], &s, &co);
    cs = make_float2(co, co);
    sn = make_float2(s, s);
  } else {
    cs = make_float2(1.f, 1.f);
    sn = make_float2(0.f, 0.f);
  }
}

// The rotation of one pair in fp32, t * cos + rotate_half(t) * sin over
// interleaved pairs (rotate_half(t)[2i] = -t[2i+1], rotate_half(t)[2i+1] =
// t[2i]), each product and the sum rounded as the plain version rounds
// them (no fma contraction), so that the bf16 result is the plain one.
__device__ __forceinline__ void rotate_pair(float& x0, float& x1,
                                            const float2& cs,
                                            const float2& sn) {
  const float r0 = __fadd_rn(__fmul_rn(x0, cs.x), __fmul_rn(-x1, sn.x));
  const float r1 = __fadd_rn(__fmul_rn(x1, cs.y), __fmul_rn(x0, sn.y));
  x0 = r0;
  x1 = r1;
}

namespace hat {

constexpr int BQ = 64;        // rows of a query tile: one warpgroup's m64
constexpr int BKV = 64;       // keys of a key/value tile (one SWAT frame)
constexpr int BOX = 64 * 128; // bytes of a 64-row x 64-column bf16 box
constexpr int ROTATORS = 96;  // producer warps 1-3
constexpr int SMEM_MAX = 227 * 1024;
constexpr int SMEM_FIXED = 1024 + 256;  // alignment slack, barriers

// The compile-time shape of an instantiation: CWG consumer warpgroups of
// one query tile each behind one producer warpgroup; in shared memory the
// CTA's CWG query tiles, then a ring of k + v stages.
template <int DPAD, int CWG>
struct Plan {
  static constexpr int THREADS = 128 * (CWG + 1);
  static constexpr int NB = DPAD / 64;        // 64-column boxes per row
  static constexpr int TILE = NB * BOX;       // one 64-row q, k or v tile
  static constexpr int STAGE = 2 * TILE;      // k + v
  static constexpr int QBYTES = CWG * TILE;  // the CTA's query tiles
  // registers a thread after setmaxnreg: the 65536 of the SM shared
  static constexpr int PRODUCER_REGS = CWG == 2 ? 56 : 40;
  static constexpr int CONSUMER_REGS = CWG == 2 ? 224 : 152;
  static_assert(DPAD % 64 == 0, "head dim padded to 64-column boxes");
  static_assert(128 * (PRODUCER_REGS + CWG * CONSUMER_REGS) <= 65536,
                "register split");
};

// One call's geometry.  Flash (K2): `rows` query rows and `kv_len` keys per
// batch*head row bh; tiles are 64 consecutive rows.  SWAT (K1/K6): f
// frames of an (h, w) grid per bh (rows = f h w tokens), one 8 x 8 window
// per CTA column; tile t is frame t of the window (64 tokens), kv_len =
// f * 64 window tokens.  `stages`: ring stages (layout()).
struct Problem {
  bf16* o;
  float* lse;        // may be null
  RotSrc rs;         // SWAT, ROT != ROT_NONE
  int rows, kv_len, d;
  int qtiles, ktiles;
  int f, h, w;
  int causal;        // flash: n == m, key <= query; SWAT: over window tokens
  float scale_log2;  // scale * log2(e)
  int stages;
};

// 2^x on the MUFU (ex2.approx.ftz: 2^-22 relative; 0 at -inf), as the
// softmax calibration K10 measures it.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Pin register values ahead of a wgmma.fence (the compiler may otherwise
// sink their definitions past it, and ptxas then serialises the wgmmas).
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Rotate tile `tile` (64 window tokens of `frame`, NB boxes) in shared
// memory, in place: bf16 -> fp32 rotation (rot_cs: ROT_TRIG) -> bf16.  A
// rotary pair (c, c + 1), c even, lies in one 16-byte unit of the swizzle.
// Threads rt = 0 .. nt - 1 take pairs rt, rt + nt, ... (row-major over the
// tile's 64 rows of `pairs`), RU at a time.
template <int ROT, int RU>
__device__ __forceinline__ void rotate_tile(unsigned char* tile,
                                            const Problem& pb, int frame,
                                            int wy, int wx, int rt, int nt) {
  const int pairs = (ROT == ROT_TRIG ? pb.rs.rot_dim : pb.d) / 2;
  const int total = BQ * pairs;
  const int dr = nt / pairs, dp = nt - dr * pairs;
  int r = rt / pairs, pc = rt - r * pairs;  // row and pair of item i
  for (int i0 = rt; i0 < total; i0 += RU * nt) {
    uint32_t off[RU], xr[RU];
    float2 cs[RU], sn[RU];
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      if (i0 + u * nt < total) {
        const int c = 2 * pc;
        off[u] = (c >> 6) * BOX + swz(r, c & 63);
        xr[u] = *reinterpret_cast<const uint32_t*>(tile + off[u]);
        rot_cs<ROT>(pb.rs, window_token(frame, wy, wx, r, pb.h, pb.w), pb.d,
                    c, cs[u], sn[u]);
      }
      r += dr;
      pc += dp;
      if (pc >= pairs) { pc -= pairs; ++r; }
    }
#pragma unroll
    for (int u = 0; u < RU; ++u)
      if (i0 + u * nt < total) {
        float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xr[u]));
        rotate_pair(x.x, x.y, cs[u], sn[u]);
        *reinterpret_cast<__nv_bfloat162*>(tile + off[u]) =
            __floats2bfloat162_rn(x.x, x.y);
      }
  }
}

template <int DPAD, int CWG, bool SWAT, int ROT>
__device__ __forceinline__ void attn_fwd_body(const CUtensorMap* tq,
                                              const CUtensorMap* tk,
                                              const CUtensorMap* tv,
                                              const Problem& pb) {
  using P = Plan<DPAD, CWG>;
  constexpr int NB = P::NB;
  constexpr bool ROTATE = ROT != ROT_NONE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t ring = base + P::QBYTES;
  const uint32_t bars = ring + pb.stages * P::STAGE;
  const uint32_t qfull = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto ready = [&](int s) { return bars + 8 + 8 * (pb.stages + s); };
  auto empty = [&](int s) { return bars + 8 + 8 * (2 * pb.stages + s); };

  const int bh = SWAT ? blockIdx.z : blockIdx.y;
  const int wins_x = SWAT ? pb.w / SW_WS : 1;
  const int wy = SWAT ? blockIdx.y / wins_x : 0;
  const int wx = SWAT ? blockIdx.y % wins_x : 0;
  // the query tile of consumer warpgroup k: CTA x holds tiles x CWG ...
  // x CWG + CWG - 1 (ops/kernels/flash_attention.py::cta_tiles); -1 past
  // the last
  auto tile_of = [&](int k) {
    const int t = blockIdx.x * CWG + k;
    return t < pb.qtiles ? t : -1;
  };
  int last = -1, nvalid = 0;
#pragma unroll
  for (int k = 0; k < CWG; ++k) {
    const int t = tile_of(k);
    if (t >= 0) {
      ++nvalid;
      last = max(last, t);
    }
  }
  const int kt_end = pb.causal ? min(last + 1, pb.ktiles) : pb.ktiles;

  auto load_tile = [&](uint32_t dst, const CUtensorMap* map, int tile,
                       uint32_t bar) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (SWAT)
        tma_load_5d(dst + b * BOX, map, b * 64, wx * SW_WS, wy * SW_WS, tile,
                    bh, bar);
      else
        tma_load_3d(dst + b * BOX, map, b * 64, tile * BQ, bh, bar);
    }
  };

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < pb.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), ROTATORS);
      mbar_init(empty(s), 4 * CWG);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P::PRODUCER_REGS));
    if (threadIdx.x == 0) {  // TMA issue
      tma_prefetch(tq);
      tma_prefetch(tk);
      tma_prefetch(tv);
      mbar_expect_tx(qfull, nvalid * P::TILE);
      for (int k = 0; k < CWG; ++k) {
        const int t = tile_of(k);
        if (t >= 0) load_tile(base + k * P::TILE, tq, t, qfull);
      }
      int s = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < kt_end; ++kt) {
        mbar_wait(empty(s), ph ^ 1);
        mbar_expect_tx(full(s), P::STAGE);
        const uint32_t st = ring + s * P::STAGE;
        load_tile(st, tk, kt, full(s));
        load_tile(st + P::TILE, tv, kt, full(s));
        if (++s == pb.stages) { s = 0; ph ^= 1; }
      }
    } else if (ROTATE && threadIdx.x >= 32) {
      // rotation of key frames 0 .. kt_end - 1 (each consumer warpgroup
      // rotates its own query tiles)
      const int rt = threadIdx.x - 32;
      int s = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < kt_end; ++kt) {
        mbar_wait(full(s), ph);
        rotate_tile<ROT, 4>(gbase + P::QBYTES + s * P::STAGE, pb, kt, wy, wx,
                            rt, ROTATORS);
        fence_async_smem();
        mbar_arrive(ready(s));
        if (++s == pb.stages) { s = 0; ph ^= 1; }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(P::CONSUMER_REGS));
    const int cw = wg - 1, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int tile = tile_of(cw);
    float o[DPAD / 2], mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
    float sc[32];
#pragma unroll
    for (int i = 0; i < DPAD / 2; ++i) o[i] = 0.f;
    const int ksteps = (pb.d + 15) / 16;
    mbar_wait(qfull, 0);
    const uint32_t qt = base + cw * P::TILE;
    if (ROTATE && tile >= 0) {  // this warpgroup's query tile
      rotate_tile<ROT, 10>(gbase + cw * P::TILE, pb, tile, wy, wx,
                           threadIdx.x - 128 * wg, 128);
      fence_async_smem();
      named_sync(2 + cw, 128);
    }
    int s = 0, prev = -1;
    uint32_t ph = 0;
    for (int kt = 0; kt < kt_end; ++kt) {
      mbar_wait(ROTATE ? ready(s) : full(s), ph);
      const uint32_t kst = ring + s * P::STAGE, vst = kst + P::TILE;
      const int key0 = kt * BKV;
      const bool act = tile >= 0 && !(pb.causal && kt > tile);
      if (act) {  // S = Q K^T, accumulator initialised by scale-d = 0
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DPAD / 16; ++kk)
          if (kk < ksteps) {
            const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
            wgmma_n64(sc, desc_sw128(qt + off), desc_sw128(kst + off), kk > 0);
          }
        wgmma_commit();
      }
      // S is done, and so is the previous key tile's P V
      wgmma_wait<0>();
      if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
      if (act) {
        fence_acc<32>(sc);
        fence_acc<DPAD / 2>(o);

        // sc[4 q + 2 r + e]: row 16 wq + g + 8 r, key 8 q + 2 t + e; raw
        // scores, scaled into the log2 domain inside the exponent
        if ((pb.causal && kt == tile) || key0 + BKV > pb.kv_len) {
          const bool diag = pb.causal && kt == tile;
#pragma unroll
          for (int q = 0; q < 8; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = 16 * wq + g + 8 * (e >> 1);
              const int key = 8 * q + 2 * t + (e & 1);
              if ((diag && key > row) || key0 + key >= pb.kv_len)
                sc[4 * q + e] = -INFINITY;
            }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 32; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float nm_use[2], alpha[2];  // nm_use: -(running max), log2 domain
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(mrow[r], quad_max(mx[r]) * pb.scale_log2);
          // a row with every key so far masked keeps m = -inf: exponentiate
          // against 0 so its probabilities are exactly 0
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          nm_use[r] = -m_use;
          alpha[r] = ex2(mrow[r] - m_use);
          mrow[r] = m_new;
          lrow[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < DPAD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        uint32_t pa[4][4];  // A fragments of the four 16-key chunks
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = ex2(fmaf(sc[4 * q + e], pb.scale_log2, nm_use[e >> 1]));
            lrow[e >> 1] += p[e];
          }
          pa[q >> 1][2 * (q & 1)] = pack_bf16x2(p[0], p[1]);
          pa[q >> 1][2 * (q & 1) + 1] = pack_bf16x2(p[2], p[3]);
        }
        fence_acc<DPAD / 2>(o);
        fence_regs<16>(&pa[0][0]);
        wgmma_fence();
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int kc = 0; kc < 4; ++kc)
            wgmma_rs_n64_tb(o + 32 * b, pa[kc],
                            desc_sw128_mn(vst + b * BOX + kc * 16 * 128, BOX));
        wgmma_commit();
      }
      prev = s;
      if (++s == pb.stages) { s = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    fence_acc<DPAD / 2>(o);
    if (tile < 0) return;

    // o[4 i + 2 r + e]: row 16 wq + g + 8 r, column 8 i + 2 t + e
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(lrow[r]);
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      const float lse = l == 0.f ? -INFINITY : mrow[r] + log2f(l);
      const int row = 16 * wq + g + 8 * r;
      size_t at;  // the row's index among the bh row's tokens
      if (SWAT) {
        at = window_token(tile, wy, wx, row, pb.h, pb.w);
      } else {
        at = (size_t)tile * BQ + row;
        if (at >= (size_t)pb.rows) continue;
      }
      const size_t tok = (size_t)bh * pb.rows + at;
      if (t == 0 && pb.lse != nullptr) pb.lse[tok] = lse;
      bf16* out = pb.o + tok * pb.d;
#pragma unroll
      for (int i = 0; i < DPAD / 8; ++i) {
        const int c = 8 * i + 2 * t;
        if (c < pb.d)
          *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
              o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      }
    }
  }
}

// The ring stages of one call (Problem::stages) and its dynamic shared
// memory; false if no ring of at least two stages fits.
template <int DPAD, int CWG>
__host__ bool layout(Problem& pb, int& bytes) {
  using P = Plan<DPAD, CWG>;
  pb.stages = (SMEM_MAX - SMEM_FIXED - P::QBYTES) / P::STAGE;
  if (pb.stages > 4) pb.stages = 4;
  bytes = SMEM_FIXED + P::QBYTES + pb.stages * P::STAGE;
  return pb.stages >= 2;
}

// The launch of one instantiation: its shared-memory limit raised once,
// then the kernel with this call's layout; returns cudaGetLastError(), or
// -1 when the layout does not fit.
template <int DPAD, int CWG, auto KERNEL>
static int launch(dim3 grid, const CUtensorMap& tq, const CUtensorMap& tk,
                  const CUtensorMap& tv, Problem pb, cudaStream_t stream) {
  int bytes = 0;
  if (!layout<DPAD, CWG>(pb, bytes)) return -1;
  static const cudaError_t attr = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  KERNEL<<<grid, Plan<DPAD, CWG>::THREADS, bytes, stream>>>(tq, tk, tv, pb);
  return static_cast<int>(cudaGetLastError());
}

// The padded head dim of d (-1: not covered) and whether an instantiation
// takes cwg consumer warpgroups: two always, three up to d_pad 128 (O, S
// and P of a tile in 152 registers).
__host__ __forceinline__ int dpad_of(int d) {
  if (d <= 0 || d % 8 != 0 || d > 160) return -1;
  return d <= 64 ? 64 : d <= 128 ? 128 : 192;
}

__host__ __forceinline__ bool cwg_ok(int dpad, int cwg) {
  return cwg == 2 || (cwg == 3 && dpad <= 128);
}

}  // namespace hat
}  // namespace svl
