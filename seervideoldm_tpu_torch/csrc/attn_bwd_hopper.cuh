// The attention backward on Hopper: two warp-specialised kernels that K8
// (flash_attention.cu: flash_bwd_dq_kernel, flash_bwd_dkv_kernel) and K7 /
// K9 (swat_attention.cu: swat_bwd_dq_kernel, swat_bwd_dkv_kernel)
// instantiate.  The forward kernels (attn_fwd_hopper.cuh) save lse = m +
// log2(l) per query row, so the backward needs no online softmax: p =
// exp2(s * scale log2(e) - lse) exactly.  Deterministic: no atomics, dq
// from its own kernel, every output element written by one thread once.
//
// A CTA is 1 + CWG warpgroups.  Warpgroup 0 is the producer: its first
// thread keeps TMA loads in flight (128-byte swizzle, full / empty
// mbarriers), first the CTA's own tiles, then the streamed tiles through a
// ring of four stages.  Warpgroups 1 .. CWG are consumers, each the owner
// of one 64-row tile:
//
//   dq kernel     a consumer owns 64 query rows: Q and G stay in shared
//                 memory, lse in registers; the ring streams the visible
//                 K / V tiles twice.  Pass 1: S = Q K^T and dP = G V^T
//                 (wgmma, both operands K-major from shared memory), p =
//                 ex2(s scale log2(e) - lse), delta += rowsum(p dp), all
//                 fp32; delta is written for the dk/dv kernel.  Pass 2: S
//                 and dP again, ds = p (dp - delta) scale, dq += ds K
//                 (wgmma with A from registers: the S accumulator
//                 fragments of two 8-key groups are the A fragment of a
//                 16-key chunk; K read MN-major through the descriptor's
//                 transpose bit, so no transposed copy exists).  With dq
//                 not wanted, pass 1 alone.
//   dk/dv kernel  a consumer owns 64 keys: K and V stay in shared memory;
//                 the ring streams Q and G tiles, each with its 64 lse and
//                 delta values (fp32 TMA boxes).  S^T = K Q^T and dP^T = V
//                 G^T (both K-major), p^T and ds^T in fp32 registers, dv +=
//                 p^T G and dk += ds^T Q (A from registers, B MN-major).
//
// Numerics, as the TPU bodies and the plain versions: s, p, dp, delta and
// ds are fp32; p and ds enter their three products as bf16 pairs hi =
// bf16(x), lo = bf16(x - hi) (split_bf16x2), two products against the same
// bf16 B operand, which carries about 16 of fp32's 24 mantissa bits;
// accumulation is fp32 and the outputs bf16.  Masked elements (key past
// the keys, key > query when causal, a query row past the rows) give p = 0
// exactly, and so does a row whose lse is -inf (bwd_lse).  Padding rows and
// columns are never stored.
//
// Causal: a consumer visits only the tiles on or below the diagonal (dq:
// key tile <= its query tile; dk/dv: query tile >= its key tile), and the
// grid is one-dimensional, group-major, ordered so that the CTAs with the
// most tiles start first (cta_tiles; ops/kernels/flash_attention.py::
// bwd_cta_tiles is the same map for the CPU tests, held against this one
// on the card through svl_attn_bwd_cta).
//
// Head dims: d % 8 == 0, d <= BWD_MAX_D = 80, zero-padded by TMA's
// out-of-bounds fill to DPAD = 64 or 128 (one or two 64-column boxes).  S
// and dP run ceil(d / 16) k steps, the other products all DPAD columns.
// Registers decide the warpgroup counts: the dk/dv consumer holds two
// 64 x DPAD fp32 accumulators besides S^T and dP^T (64 + 64 + 32 + 32 a
// thread at DPAD 128), so it runs with two consumer warpgroups at 240
// registers and issues its products one 16-query chunk at a time at DPAD
// 128 (two chunks in flight at DPAD 64); the dq consumer (one accumulator)
// takes three warpgroups at 160 registers where DPAD is 64.  The producer
// keeps 24 (setmaxnreg).  Latency: each consumer issues its S and dP,
// waits, forms p (and ds) in registers and issues its products; it waits
// for those only with the next tile's S and dP (but the dk/dv consumer at
// DPAD 128, which has no registers left for it), so a tile's products run
// back to back with the next tile's scores, and the 2-3 consumers of a
// CTA interleave their exponentials with one another's products.
#pragma once

#include <type_traits>

#include "attn_fwd_hopper.cuh"

namespace svl {

constexpr int BWD_MAX_D = 80;  // widest head dim the backward is built for

// Two fp32 values as a bf16 pair hi (returned, lo element in the low half)
// and the rounded remainder lo = bf16(x - hi).
__device__ __forceinline__ uint32_t split_bf16x2(float x0, float x1,
                                                 uint32_t& lo) {
  const uint32_t hi = pack_bf16x2(x0, x1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack_bf16x2(x0 - __low2float(h), x1 - __high2float(h));
  return hi;
}

// lse as saved by the forward -> the value the backward subtracts: a row
// with no visible key (lse = -inf) must give p = 0, not inf
__device__ __forceinline__ float bwd_lse(float lse) {
  return lse == -INFINITY ? INFINITY : lse;
}

// The adjoint of the rotation on one pair (columns c, c + 1) of token
// `tok` (its index in the (f, h, w) volume): t * cos - rotate_half(t) *
// sin, rounded as the plain version rounds it.
template <int ROT>
__device__ __forceinline__ void derotate_pair(const RotSrc& rs, size_t tok,
                                              int d, int c, float& v0,
                                              float& v1) {
  if (ROT == ROT_NONE) return;
  float2 cs, sn;
  rot_cs<ROT>(rs, tok, d, c, cs, sn);
  const float r0 = __fsub_rn(__fmul_rn(v0, cs.x), __fmul_rn(-v1, sn.x));
  const float r1 = __fsub_rn(__fmul_rn(v1, cs.y), __fmul_rn(v0, sn.y));
  v0 = r0;
  v1 = r1;
}

namespace hab {

using hat::BOX;
using hat::BQ;
using hat::SMEM_FIXED;
using hat::SMEM_MAX;

constexpr int SCALARS = 256;  // bytes of one tile's 64 fp32 lse (or delta)

// The compile-time shape of an instantiation: CWG consumer warpgroups of
// one 64-row tile each behind one producer warpgroup; in shared memory the
// consumers' own tiles (dq: Q and G; dk/dv: K and V), then a ring of
// STAGES stages (dq: K and V; dk/dv: Q, G, lse and delta, 1024-byte
// aligned), then the barriers.
template <int DPAD, int CWG, bool DKV>
struct Plan {
  static constexpr int THREADS = 128 * (CWG + 1);
  static constexpr int NB = DPAD / 64;
  static constexpr int TILE = NB * BOX;
  static constexpr int OWN = 2 * CWG * TILE;
  static constexpr int STAGE = DKV ? 2 * TILE + 1024 : 2 * TILE;
  // ring stages: four in every instantiation (two and three time within
  // 2 % of four on an H100 at every backward shape the card checks take)
  static constexpr int STAGES = 4;
  static constexpr int SMEM = SMEM_FIXED + OWN + STAGES * STAGE;
  // registers a thread after setmaxnreg: the producer's one issuing
  // thread needs few, the consumers take the rest of the SM's 65536
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = CWG == 2 ? 240 : 160;
  // 16-key (dq) or 16-query (dk/dv) chunks whose products are in flight at
  // once: their A fragments (hi and lo) stay live until the products end
  static constexpr int IN_FLIGHT = DKV && DPAD == 128 ? 1 : 2;
  static_assert(DPAD == 64 || DPAD == 128, "backward head dims up to 80");
  static_assert(SMEM <= SMEM_MAX, "a CTA's shared memory");
  static_assert(128 * (PRODUCER_REGS + CWG * CONSUMER_REGS) <= 65536,
                "register split");
};

// One call's geometry.  Flash (K8): n query rows and m keys per
// batch*head row, tiles of 64 consecutive rows, one unit per bh.  SWAT
// (K7/K9): f frames of an (h, w) grid per bh, one unit per (window, bh),
// tile t = frame t of the window (64 tokens), n = m = f * 64.
struct Problem {
  const float* lse;  // dq kernel: (bh, rows) as the forward wrote it
  float* delta;      // dq kernel: written; dk/dv kernel: read by TMA
  bf16* dq;          // null: pass 1 (delta) alone
  bf16* dk;
  bf16* dv;
  RotSrc rs;         // the adjoint of dq's and dk's rotation (DEROT)
  int n, m, d;
  int qtiles, ktiles;
  int f, h, w;
  int units, windows;
  int causal;        // flash: n == m, key <= query; SWAT: over window tokens
  float scale, scale_log2;
};

struct Unit {
  int bh, wy, wx;
};

// The tiles of CTA `block` in a one-dimensional, group-major grid of
// `units` columns: its unit (block % units), its own tiles [own, own_end)
// (dq: query tiles, dk/dv: key tiles, `cwg` a CTA) and the tiles [vis,
// vis_end) its ring streams.  Causal: the dq grid starts with the groups
// of the last query tiles, the dk/dv grid with those of the first key
// tiles (the most tiles either way); a dq CTA streams the key tiles up to
// its last query tile, a dk/dv CTA the query tiles from its first key
// tile (its consumers skip the tiles above their own diagonal).
struct CtaTiles {
  int unit, own, own_end, vis, vis_end;
};

__host__ __device__ inline CtaTiles cta_tiles(int block, int cwg, bool dkv,
                                              int units, int qtiles,
                                              int ktiles, bool causal) {
  const int n_own = dkv ? ktiles : qtiles;
  const int groups = (n_own + cwg - 1) / cwg;
  const int gi = block / units;
  const int group = causal && !dkv ? groups - 1 - gi : gi;
  CtaTiles c;
  c.unit = block % units;
  c.own = group * cwg;
  c.own_end = c.own + cwg < n_own ? c.own + cwg : n_own;
  if (dkv) {
    c.vis = causal ? c.own : 0;
    c.vis_end = qtiles;
  } else {
    c.vis = 0;
    c.vis_end = causal && c.own_end < ktiles ? c.own_end : ktiles;
  }
  return c;
}

template <bool SWAT>
__device__ __forceinline__ Unit unit_of(const Problem& pb, int u) {
  if (!SWAT) return Unit{u, 0, 0};
  const int win = u % pb.windows, wins_x = pb.w / SW_WS;
  return Unit{u / pb.windows, win / wins_x, win % wins_x};
}

// Row r of `tile` of unit `un`: its index among the bh row's tokens (`at`;
// for SWAT its index in the (f, h, w) volume, the rotary position) and in
// the whole tensor (`tok`); false past the last row (flash, `rows` = n or
// m).
template <bool SWAT>
__device__ __forceinline__ bool token_of(const Problem& pb, const Unit& un,
                                         int tile, int r, int rows,
                                         size_t& at, size_t& tok) {
  if (SWAT) {
    at = window_token(tile, un.wy, un.wx, r, pb.h, pb.w);
    tok = (size_t)un.bh * pb.f * pb.h * pb.w + at;
    return true;
  }
  at = (size_t)tile * BQ + r;
  tok = (size_t)un.bh * rows + at;
  return at < (size_t)rows;
}

// One 64-row bf16 tile (NB boxes of 64 columns) of unit `un`.
template <int NB, bool SWAT>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int tile, const Unit& un,
                                          uint32_t bar) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (SWAT)
      tma_load_5d(dst + b * BOX, map, b * 64, un.wx * SW_WS, un.wy * SW_WS,
                  tile, un.bh, bar);
    else
      tma_load_3d(dst + b * BOX, map, b * 64, tile * BQ, un.bh, bar);
  }
}

// The 64 fp32 row values (lse or delta) of query tile `tile` of unit `un`:
// flash through a map over the bh * n values (a tile past row n reads the
// next bh's values, which the consumers mask), SWAT through a 4-D map (w, h, f,
// bh) whose (8, 8) box is the window frame in token order.
template <bool SWAT>
__device__ __forceinline__ void load_scalars(uint32_t dst,
                                             const CUtensorMap* map, int tile,
                                             const Unit& un, int n,
                                             uint32_t bar) {
  if (SWAT)
    tma_load_4d(dst, map, un.wx * SW_WS, un.wy * SW_WS, tile, un.bh, bar);
  else
    tma_load(dst, map, un.bh * n + tile * BQ, 0, bar);
}

// acc (64 x 64, fp32) = A B^T over ksteps of 16 columns, both tiles K-major
// in the 128-byte swizzle (DPAD / 64 boxes of 64 columns).
template <int DPAD>
__device__ __forceinline__ void ss_product(float* acc, uint32_t a, uint32_t b,
                                           int ksteps) {
#pragma unroll
  for (int kk = 0; kk < DPAD / 16; ++kk)
    if (kk < ksteps) {
      const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
      wgmma_n64(acc, desc_sw128(a + off), desc_sw128(b + off), kk > 0);
    }
}

// The A fragments (hi, lo) of 16-column chunk kc of a 64 x 64 fp32
// accumulator x (x[4 q + e]: row 16 wq + g + 8 (e >> 1), column 8 q + 2 t +
// (e & 1)).
__device__ __forceinline__ void chunk_frags(const float* x, int kc,
                                            uint32_t hi[4], uint32_t lo[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    hi[j] = split_bf16x2(x[8 * kc + 2 * j], x[8 * kc + 2 * j + 1], lo[j]);
}

// Before chunk kc's fragments are written: the products of the chunk whose
// fragments they replace have ended.
template <int IN_FLIGHT>
__device__ __forceinline__ void free_frags(int kc) {
  if (IN_FLIGHT == 2) {
    if (kc >= 2) wgmma_wait<1>();
  } else if (kc >= 1) {
    wgmma_wait<0>();
  }
}

// Store a consumer's 64 x DPAD fp32 accumulator as bf16 (columns < d),
// de-rotating each pair with DEROT's adjoint.
template <int DPAD, bool SWAT, int DEROT>
__device__ __forceinline__ void store_rows(const float* acc, bf16* out,
                                           const Problem& pb, const Unit& un,
                                           int tile, int rows, int wq, int g,
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    size_t at, tok;
    if (!token_of<SWAT>(pb, un, tile, 16 * wq + g + 8 * r, rows, at, tok))
      continue;
    bf16* row = out + tok * pb.d;
#pragma unroll
    for (int i = 0; i < DPAD / 8; ++i) {
      const int c = 8 * i + 2 * t;
      if (c < pb.d) {
        float v0 = acc[4 * i + 2 * r], v1 = acc[4 * i + 2 * r + 1];
        derotate_pair<DEROT>(pb.rs, at, pb.d, c, v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(row + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Shared memory of a CTA, 1024-byte aligned: the own tiles, the ring, the
// barriers (dq: own-tiles full, then full and empty per stage).
struct Smem {
  uint32_t base, ring, bars;
  unsigned char* gbase;  // the generic address of `base`
};

template <typename P>
__device__ __forceinline__ Smem smem_layout() {
  extern __shared__ unsigned char smem_raw[];
  Smem sm;
  const uint32_t raw = smem_u32(smem_raw);
  sm.base = (raw + 1023) & ~1023u;
  sm.gbase = smem_raw + (sm.base - raw);
  sm.ring = sm.base + P::OWN;
  sm.bars = sm.ring + P::STAGES * P::STAGE;
  return sm;
}

// --------------------------------------------------------------- dq kernel

template <int DPAD, int CWG, bool SWAT, int DEROT>
__device__ __forceinline__ void dq_body(const CUtensorMap* tq,
                                        const CUtensorMap* tg,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const Problem& pb) {
  using P = Plan<DPAD, CWG, false>;
  constexpr int NB = P::NB, STAGES = P::STAGES;
  const Smem sm = smem_layout<P>();
  const uint32_t own_full = sm.bars;
  auto full = [&](int s) { return sm.bars + 8 + 8 * s; };
  auto empty = [&](int s) { return sm.bars + 8 + 8 * (STAGES + s); };

  const CtaTiles ct = cta_tiles(blockIdx.x, CWG, false, pb.units, pb.qtiles,
                                pb.ktiles, pb.causal);
  const Unit un = unit_of<SWAT>(pb, ct.unit);
  auto tile_of = [&](int k) {
    const int t = ct.own + k;
    return t < ct.own_end ? t : -1;
  };
  const int nvalid = ct.own_end - ct.own;
  const int passes = pb.dq != nullptr ? 2 : 1;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * CWG);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      tma_prefetch(tq);
      tma_prefetch(tg);
      tma_prefetch(tk);
      tma_prefetch(tv);
      mbar_expect_tx(own_full, nvalid * 2 * P::TILE);
      for (int k = 0; k < CWG; ++k) {
        const int t = tile_of(k);
        if (t < 0) continue;
        load_tile<NB, SWAT>(sm.base + 2 * k * P::TILE, tq, t, un, own_full);
        load_tile<NB, SWAT>(sm.base + (2 * k + 1) * P::TILE, tg, t, un,
                            own_full);
      }
      int s = 0;
      uint32_t ph = 0;
      for (int pass = 0; pass < passes; ++pass)
        for (int kt = ct.vis; kt < ct.vis_end; ++kt) {
          mbar_wait(empty(s), ph ^ 1);
          mbar_expect_tx(full(s), P::STAGE);
          const uint32_t st = sm.ring + s * P::STAGE;
          load_tile<NB, SWAT>(st, tk, kt, un, full(s));
          load_tile<NB, SWAT>(st + P::TILE, tv, kt, un, full(s));
          if (++s == STAGES) { s = 0; ph ^= 1; }
        }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(P::CONSUMER_REGS));
  const int cw = wg - 1, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = tile_of(cw);
  const int ksteps = (pb.d + 15) / 16;
  float acc[DPAD / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < DPAD / 2; ++i) acc[i] = 0.f;
  fence_acc<DPAD / 2>(acc);
  // rows g and g + 8 of this warp's 16: lse (+inf past the last row, so p
  // = 0 there), delta; their tokens are found again for delta's store
  float lse[2], delta[2] = {0.f, 0.f};
  auto row_token = [&](int r, size_t& tok) {
    size_t at;
    return tile >= 0 &&
           token_of<SWAT>(pb, un, tile, 16 * wq + g + 8 * r, pb.n, at, tok);
  };
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    size_t tok;
    lse[r] = row_token(r, tok) ? bwd_lse(pb.lse[tok]) : INFINITY;
  }
  mbar_wait(own_full, 0);
  const uint32_t qs = sm.base + 2 * cw * P::TILE, gs = qs + P::TILE;

  // one pass over the visible key tiles; PASS 0: delta, PASS 1: dq.  A
  // stage is released once its products are done: in pass 0 right after
  // S and dP, in pass 1 one key tile later, when the wait for the next S
  // and dP shows the dq products of this one done as well.
  int s = 0, prev = -1;
  uint32_t ph = 0;
  auto visit = [&](auto pass_c) {
    constexpr int PASS = decltype(pass_c)::value;
    for (int kt = ct.vis; kt < ct.vis_end; ++kt) {
      mbar_wait(full(s), ph);
      const uint32_t kst = sm.ring + s * P::STAGE, vst = kst + P::TILE;
      const bool act = tile >= 0 && !(pb.causal && kt > tile);
      if (act) {  // S = Q K^T, dP = G V^T
        wgmma_fence();
        ss_product<DPAD>(sc, qs, kst, ksteps);
        ss_product<DPAD>(dp, gs, vst, ksteps);
        wgmma_commit();
      }
      wgmma_wait<0>();
      if (lane == 0) {
        if (PASS == 0) mbar_arrive(empty(s));
        if (PASS == 1 && prev >= 0) mbar_arrive(empty(prev));
      }
      if (act) {
        fence_acc<32>(sc);
        fence_acc<32>(dp);
        // sc[4 q + e]: row 16 wq + g + 8 (e >> 1), key 8 q + 2 t + (e & 1);
        // a masked score is -inf, so its p is ex2(-inf) = 0
        const int key0 = kt * BQ;
        const bool diag = pb.causal && kt == tile;
        if (diag || key0 + BQ > pb.m) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int row = 16 * wq + g + 8 * ((i >> 1) & 1);
            const int key = 8 * (i >> 2) + 2 * t + (i & 1);
            if ((diag && key > row) || key0 + key >= pb.m) sc[i] = -INFINITY;
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const float p = hat::ex2(fmaf(sc[i], pb.scale_log2, -lse[r]));
          if (PASS == 0)
            delta[r] = fmaf(p, dp[i], delta[r]);
          else
            dp[i] = p * (dp[i] - delta[r]) * pb.scale;
        }
        if (PASS == 1) {  // dq += ds K, ds as hi + lo, 16 keys a chunk
          fence_acc<32>(dp);  // ds formed before the first product
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            free_frags<P::IN_FLIGHT>(kc);
            uint32_t hi[4], lo[4];
            chunk_frags(dp, kc, hi, lo);
            hat::fence_regs<4>(hi);
            hat::fence_regs<4>(lo);
            wgmma_fence();
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              const uint64_t kd =
                  desc_sw128_mn(kst + b * BOX + kc * 16 * 128, BOX);
              wgmma_rs_n64_tb(acc + 32 * b, hi, kd);
              wgmma_rs_n64_tb(acc + 32 * b, lo, kd);
            }
            wgmma_commit();
          }
        }
      }
      prev = s;
      if (++s == STAGES) { s = 0; ph ^= 1; }
    }
  };
  visit(std::integral_constant<int, 0>{});
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    delta[r] = quad_sum(delta[r]);
    size_t tok;
    if (row_token(r, tok) && t == 0) pb.delta[tok] = delta[r];
  }
  if (passes == 1) return;  // delta alone
  prev = -1;  // pass 0 released its stages itself
  visit(std::integral_constant<int, 1>{});
  wgmma_wait<0>();
  fence_acc<DPAD / 2>(acc);
  if (tile >= 0)
    store_rows<DPAD, SWAT, DEROT>(acc, pb.dq, pb, un, tile, pb.n, wq, g, t);
}

// ------------------------------------------------------------ dk/dv kernel

template <int DPAD, int CWG, bool SWAT, int DEROT>
__device__ __forceinline__ void dkv_body(const CUtensorMap* tk,
                                         const CUtensorMap* tv,
                                         const CUtensorMap* tq,
                                         const CUtensorMap* tg,
                                         const CUtensorMap* tl,
                                         const CUtensorMap* td,
                                         const Problem& pb) {
  using P = Plan<DPAD, CWG, true>;
  constexpr int NB = P::NB, STAGES = P::STAGES;
  const Smem sm = smem_layout<P>();
  const uint32_t own_full = sm.bars;
  auto full = [&](int s) { return sm.bars + 8 + 8 * s; };
  auto empty = [&](int s) { return sm.bars + 8 + 8 * (STAGES + s); };

  const CtaTiles ct = cta_tiles(blockIdx.x, CWG, true, pb.units, pb.qtiles,
                                pb.ktiles, pb.causal);
  const Unit un = unit_of<SWAT>(pb, ct.unit);
  auto tile_of = [&](int k) {
    const int t = ct.own + k;
    return t < ct.own_end ? t : -1;
  };
  const int nvalid = ct.own_end - ct.own;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * CWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      tma_prefetch(tk);
      tma_prefetch(tv);
      tma_prefetch(tq);
      tma_prefetch(tg);
      tma_prefetch(tl);
      tma_prefetch(td);
      mbar_expect_tx(own_full, nvalid * 2 * P::TILE);
      for (int k = 0; k < CWG; ++k) {
        const int t = tile_of(k);
        if (t < 0) continue;
        load_tile<NB, SWAT>(sm.base + 2 * k * P::TILE, tk, t, un, own_full);
        load_tile<NB, SWAT>(sm.base + (2 * k + 1) * P::TILE, tv, t, un,
                            own_full);
      }
      int s = 0;
      uint32_t ph = 0;
      for (int qt = ct.vis; qt < ct.vis_end; ++qt) {
        mbar_wait(empty(s), ph ^ 1);
        mbar_expect_tx(full(s), 2 * P::TILE + 2 * SCALARS);
        const uint32_t st = sm.ring + s * P::STAGE;
        load_tile<NB, SWAT>(st, tq, qt, un, full(s));
        load_tile<NB, SWAT>(st + P::TILE, tg, qt, un, full(s));
        load_scalars<SWAT>(st + 2 * P::TILE, tl, qt, un, pb.n, full(s));
        load_scalars<SWAT>(st + 2 * P::TILE + SCALARS, td, qt, un, pb.n,
                           full(s));
        if (++s == STAGES) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(P::CONSUMER_REGS));
  const int cw = wg - 1, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = tile_of(cw);
  const int ksteps = (pb.d + 15) / 16;
  float dk[DPAD / 2], dv[DPAD / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < DPAD / 2; ++i) dk[i] = dv[i] = 0.f;
  // the zeros are set before the first products start (ptxas serialises
  // the wgmmas when a plain instruction defines an accumulator inside a
  // product's pipeline stage)
  fence_acc<DPAD / 2>(dk);
  fence_acc<DPAD / 2>(dv);
  mbar_wait(own_full, 0);
  const uint32_t ks = sm.base + 2 * cw * P::TILE, vs = ks + P::TILE;

  // a stage is released once its products are done: one query tile later
  // where the wait for the next S^T and dP^T shows them done (DEFER), else
  // at the end of its own
  constexpr bool DEFER = P::IN_FLIGHT == 2;
  int s = 0, prev = -1;
  uint32_t ph = 0;
  for (int qt = ct.vis; qt < ct.vis_end; ++qt) {
    mbar_wait(full(s), ph);
    const uint32_t qst = sm.ring + s * P::STAGE, gst = qst + P::TILE;
    const bool act = tile >= 0 && !(pb.causal && qt < tile);
    if (act) {  // S^T = K Q^T, dP^T = V G^T
      wgmma_fence();
      ss_product<DPAD>(sc, ks, qst, ksteps);
      ss_product<DPAD>(dp, vs, gst, ksteps);
      wgmma_commit();
    }
    // every wait on every path: ptxas follows the products' pipeline
    // stages across the branches
    wgmma_wait<0>();
    if (DEFER && prev >= 0 && lane == 0) mbar_arrive(empty(prev));
    if (act) {
      fence_acc<32>(sc);
      fence_acc<32>(dp);
      // sc[4 q + e]: key 16 wq + g + 8 (e >> 1), query 8 q + 2 t + (e & 1);
      // a masked score is -inf, so its p is ex2(-inf) = 0
      const unsigned char* sc_base =
          sm.gbase + (qst - sm.base) + 2 * P::TILE;
      const float* lse_s = reinterpret_cast<const float*>(sc_base);
      const float* delta_s = reinterpret_cast<const float*>(sc_base + SCALARS);
      const int q0 = qt * BQ;
      const bool diag = pb.causal && qt == tile;
      if (diag || q0 + BQ > pb.n) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = 16 * wq + g + 8 * ((i >> 1) & 1);
          const int qi = 8 * (i >> 2) + 2 * t + (i & 1);
          if ((diag && key > qi) || q0 + qi >= pb.n) sc[i] = -INFINITY;
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = 8 * q + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + col);
        const float nl[2] = {-bwd_lse(l2.x), -bwd_lse(l2.y)};
        const float dl[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float p = hat::ex2(fmaf(sc[i], pb.scale_log2, nl[e & 1]));
          sc[i] = p;
          dp[i] = p * (dp[i] - dl[e & 1]) * pb.scale;
        }
      }
      // p and ds are formed here, not sunk past the first product below
      // (they overwrite S^T's and dP^T's accumulators: C7515)
      fence_acc<32>(sc);
      fence_acc<32>(dp);
      // dv += p^T G, dk += ds^T Q, each as hi + lo, 16 queries a chunk
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        free_frags<P::IN_FLIGHT>(kc);
        uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
        chunk_frags(sc, kc, p_hi, p_lo);
        chunk_frags(dp, kc, ds_hi, ds_lo);
        hat::fence_regs<4>(p_hi);
        hat::fence_regs<4>(p_lo);
        hat::fence_regs<4>(ds_hi);
        hat::fence_regs<4>(ds_lo);
        wgmma_fence();
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const uint32_t off = b * BOX + kc * 16 * 128;
          const uint64_t gd = desc_sw128_mn(gst + off, BOX);
          const uint64_t qd = desc_sw128_mn(qst + off, BOX);
          wgmma_rs_n64_tb(dv + 32 * b, p_hi, gd);
          wgmma_rs_n64_tb(dv + 32 * b, p_lo, gd);
          wgmma_rs_n64_tb(dk + 32 * b, ds_hi, qd);
          wgmma_rs_n64_tb(dk + 32 * b, ds_lo, qd);
        }
        wgmma_commit();
      }
    }
    if (!DEFER) {
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty(s));
    }
    prev = s;
    if (++s == STAGES) { s = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
  fence_acc<DPAD / 2>(dk);
  fence_acc<DPAD / 2>(dv);
  if (tile < 0) return;
  store_rows<DPAD, SWAT, DEROT>(dk, pb.dk, pb, un, tile, pb.m, wq, g, t);
  store_rows<DPAD, SWAT, ROT_NONE>(dv, pb.dv, pb, un, tile, pb.m, wq, g, t);
}

// --------------------------------------------------------------------- host

// The consumer warpgroup counts built: dq two, or three at DPAD 64 (one
// accumulator, S and dP, two chunks of fragments in 160 registers); dk/dv
// two (two accumulators).
__host__ __forceinline__ bool cwg_ok(int dpad, int cwg, bool dkv) {
  return cwg == 2 || (!dkv && cwg == 3 && dpad == 64);
}

__host__ __forceinline__ int dpad_of(int d) {
  if (d <= 0 || d % 8 != 0 || d > BWD_MAX_D) return -1;
  return d <= 64 ? 64 : 128;
}

// One launch: the shared-memory limit raised once per instantiation, a
// one-dimensional grid of `ctas`; returns cudaGetLastError().
template <int DPAD, int CWG, bool DKV, auto KERNEL, typename... Maps>
static int launch(int ctas, const Problem& pb, cudaStream_t stream,
                  const Maps&... maps) {
  using P = Plan<DPAD, CWG, DKV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  KERNEL<<<ctas, P::THREADS, P::SMEM, stream>>>(maps..., pb);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a CTA; -1 when no instantiation takes it.
__host__ inline int smem_bytes(int d, int cwg, bool dkv) {
  const int dpad = dpad_of(d);
  if (dpad < 0 || !cwg_ok(dpad, cwg, dkv)) return -1;
  if (dkv) return dpad == 64 ? Plan<64, 2, true>::SMEM
                             : Plan<128, 2, true>::SMEM;
  if (dpad == 128) return Plan<128, 2, false>::SMEM;
  return cwg == 3 ? Plan<64, 3, false>::SMEM : Plan<64, 2, false>::SMEM;
}

}  // namespace hab
}  // namespace svl
