// Attention backward over one 64 x 64 (query x key) tile, per warp, with
// mma.sync.
//
// Shared by flash_attention.cu (K8) and swat_attention.cu (K7, K9); the
// forward kernels are in attn_fwd_hopper.cuh.  The forward kernels save
// lse = m + log2(l) per query row (log2 domain), so the backward needs no
// online softmax: p = exp2(s * scale_log2 - lse) exactly.  Two
// deterministic kernels, no atomics, the dq kernel first:
//
//   dq kernel     one CTA per 64-query tile, 16 query rows per warp; Q and G
//                 live in registers as A fragments, K/V tiles stream through
//                 shared memory.  Pass 1 (delta_tile): delta = rowsum(p * dp)
//                 over every visible key in fp32, as the TPU kernels form it
//                 (rowsum(g * o) over the bf16 forward output, whose p was
//                 rounded to bf16 for P V, is off by ~1e-3 relative, which
//                 the cancellation in dp - delta carries into dq and dk);
//                 written out for the dk/dv kernel.  Pass 2 (dq_tile), per
//                 16-key chunk: s = q k^T, dp = g v^T, ds = p * (dp - delta)
//                 * scale, dq += ds k.  With dq not wanted, pass 1 alone.
//   dk/dv kernel  one CTA per 64-key tile, 16 keys per warp; K and V live in
//                 registers as A fragments, Q/G tiles stream.  It computes
//                 the TRANSPOSED scores s^T = k q^T directly, so the C
//                 fragments of p^T and ds^T are the A fragments of the next
//                 products: dv += p^T g, dk += ds^T q.
//
// Rounding points: q, k, v, g are bf16 inputs (for K7, q and k are rotated
// in fp32 and rounded to bf16 on load, as in the forward).  s, p, dp, delta
// and ds are fp32, and so, nearly, are the operands of p^T g, ds k and
// ds^T q, which the TPU kernels run on fp32 p and ds: tensor cores take
// bf16, so each of p and ds enters as a pair hi = bf16(x), lo = bf16(x -
// hi), two MMAs against the same bf16 B operand (split_bf16x2), which keeps
// about 16 of fp32's 24 mantissa bits.  The pair is formed one 16-key chunk
// at a time, from the chunk's fp32 values in registers.  Every accumulator
// is fp32.
//
// Masked elements (key >= kv_len, key > query when causal) and rows whose
// lse is not finite (padding rows are given lse = +inf) have p = 0 exactly.
#pragma once

#include <math.h>

#include "common.cuh"

namespace svl {

constexpr int ATT_BQ = 64;       // query rows of a tile (4 warps x 16)
constexpr int ATT_BK = 64;       // keys of a tile
constexpr int ATT_THREADS = 128;

constexpr int BWD_MAX_D = 80;  // widest head dim the backward is built for

// Two fp32 values as a bf16 pair hi (returned, lo element in the low half)
// and the rounded remainder lo = bf16(x - hi): hi + lo holds x to about 16
// mantissa bits, so a product taken as two MMAs, hi and lo against the
// same B operand, carries an fp32 operand's precision to that depth.
__device__ __forceinline__ uint32_t split_bf16x2(float x0, float x1,
                                                 uint32_t& lo) {
  const uint32_t hi = pack_bf16x2(x0, x1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack_bf16x2(x0 - __low2float(h), x1 - __high2float(h));
  return hi;
}

// The A fragment of a 16-key chunk from the fp32 C fragments of its two
// 8-key halves v[0], v[1], as hi and lo (split_bf16x2).
__device__ __forceinline__ void split_frag(const float v[2][4], uint32_t hi[4],
                                           uint32_t lo[4]) {
  hi[0] = split_bf16x2(v[0][0], v[0][1], lo[0]);
  hi[1] = split_bf16x2(v[0][2], v[0][3], lo[1]);
  hi[2] = split_bf16x2(v[1][0], v[1][1], lo[2]);
  hi[3] = split_bf16x2(v[1][2], v[1][3], lo[3]);
}

// lse as saved by the forward -> the value the backward subtracts: a row
// with no visible key (lse = -inf) must give p = 0, not inf
__device__ __forceinline__ float bwd_lse(float lse) {
  return lse == -INFINITY ? INFINITY : lse;
}

template <int DP>
struct DqState {
  uint32_t qf[DP / 16][4];  // Q A-fragments, 16 rows x DP
  uint32_t gf[DP / 16][4];  // G (grad of the output) A-fragments
  float acc[DP / 8][4];     // dq accumulator
  float lse[2], delta[2];   // of rows g, g+8
};

// p and dp of one 16-key chunk (keys 16 c16 ... of the tile) for this
// warp's 16 query rows, as the C fragments of its two 8-key halves.  ks,
// vs: K and V tiles as rows [ATT_BK][DP + 8]; row0: absolute index of the
// warp's first query row; key0: of the tile's first key.
template <int DP>
__device__ __forceinline__ void p_dp_chunk(const DqState<DP>& st,
                                           const bf16* ks, const bf16* vs,
                                           float scale_log2, int row0,
                                           int key0, int kv_len, bool causal,
                                           int c16, int lane, float p[2][4],
                                           float dp[2][4]) {
  const int g = lane >> 2, t = lane & 3;
  float s[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[h][e] = dp[h][e] = 0.f;
    const int nt = 2 * c16 + h;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      uint32_t b0, b1;
      load_b_frag(b0, b1, ks, DP + 8, nt * 8, kc * 16, lane);
      mma_16816(s[h], st.qf[kc], b0, b1);
      load_b_frag(b0, b1, vs, DP + 8, nt * 8, kc * 16, lane);
      mma_16816(dp[h], st.gf[kc], b0, b1);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int row = row0 + g + (r << 3);
      const int col = key0 + (2 * c16 + h) * 8 + 2 * t + (e & 1);
      const bool masked = col >= kv_len || (causal && col > row);
      p[h][e] = masked ? 0.f : exp2f(s[h][e] * scale_log2 - st.lse[r]);
    }
}

// Pass 1 of the dq kernel over one key tile: this thread's share of
// rowsum(p * dp) for its rows g, g + 8, added to dsum.
template <int DP>
__device__ __forceinline__ void delta_tile(const DqState<DP>& st,
                                           const bf16* ks, const bf16* vs,
                                           float scale_log2, int row0,
                                           int key0, int kv_len, bool causal,
                                           int lane, float dsum[2]) {
#pragma unroll
  for (int c16 = 0; c16 < ATT_BK / 16; ++c16) {
    float p[2][4], dp[2][4];
    p_dp_chunk<DP>(st, ks, vs, scale_log2, row0, key0, kv_len, causal, c16,
                   lane, p, dp);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) dsum[e >> 1] += p[h][e] * dp[h][e];
  }
}

// Pass 2 of the dq kernel over one key tile.  kt: K transposed
// [DP][ATT_BK + 8]; the rest as p_dp_chunk.
template <int DP>
__device__ __forceinline__ void dq_tile(DqState<DP>& st, const bf16* ks,
                                        const bf16* kt, const bf16* vs,
                                        float scale, float scale_log2,
                                        int row0, int key0, int kv_len,
                                        bool causal, int lane) {
#pragma unroll
  for (int c16 = 0; c16 < ATT_BK / 16; ++c16) {
    float p[2][4], dp[2][4], ds[2][4];
    p_dp_chunk<DP>(st, ks, vs, scale_log2, row0, key0, kv_len, causal, c16,
                   lane, p, dp);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[h][e] = p[h][e] * (dp[h][e] - st.delta[e >> 1]) * scale;
    uint32_t a_hi[4], a_lo[4];
    split_frag(ds, a_hi, a_lo);
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      uint32_t b0, b1;
      load_b_frag(b0, b1, kt, ATT_BK + 8, nt * 8, c16 * 16, lane);
      mma_16816(st.acc[nt], a_hi, b0, b1);
      mma_16816(st.acc[nt], a_lo, b0, b1);
    }
  }
}

template <int DP>
struct DkvState {
  uint32_t kf[DP / 16][4];  // this warp's 16 keys as A-fragments
  uint32_t vf[DP / 16][4];  // and their values
  float dk[DP / 8][4];
  float dv[DP / 8][4];
};

// qs, gs: Q and G tiles as rows [ATT_BQ][DP + 8]; qt, gt: transposed
// [DP][ATT_BQ + 8]; lse_s, delta_s: the tile's 64 query rows.  key_row0:
// absolute index of this warp's first key; q0: of the tile's first query.
template <int DP>
__device__ __forceinline__ void dkv_tile(DkvState<DP>& st, const bf16* qs,
                                         const bf16* qt, const bf16* gs,
                                         const bf16* gt, const float* lse_s,
                                         const float* delta_s, float scale,
                                         float scale_log2, int key_row0,
                                         int q0, int kv_len, bool causal,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c16 = 0; c16 < ATT_BQ / 16; ++c16) {
    float sT[2][4], dpT[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[h][e] = dpT[h][e] = 0.f;
      const int nt = 2 * c16 + h;
#pragma unroll
      for (int kc = 0; kc < DP / 16; ++kc) {
        uint32_t b0, b1;
        load_b_frag(b0, b1, qs, DP + 8, nt * 8, kc * 16, lane);
        mma_16816(sT[h], st.kf[kc], b0, b1);
        load_b_frag(b0, b1, gs, DP + 8, nt * 8, kc * 16, lane);
        mma_16816(dpT[h], st.vf[kc], b0, b1);
      }
    }
    float pT[2][4], dsT[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_row0 + g + ((e >> 1) << 3);
        const int qi = (2 * c16 + h) * 8 + 2 * t + (e & 1);
        const bool masked = key >= kv_len || (causal && key > q0 + qi);
        const float p =
            masked ? 0.f : exp2f(sT[h][e] * scale_log2 - lse_s[qi]);
        pT[h][e] = p;
        dsT[h][e] = p * (dpT[h][e] - delta_s[qi]) * scale;
      }
    uint32_t ap_hi[4], ap_lo[4], ads_hi[4], ads_lo[4];
    split_frag(pT, ap_hi, ap_lo);
    split_frag(dsT, ads_hi, ads_lo);
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      uint32_t b0, b1;
      load_b_frag(b0, b1, gt, ATT_BQ + 8, nt * 8, c16 * 16, lane);
      mma_16816(st.dv[nt], ap_hi, b0, b1);
      mma_16816(st.dv[nt], ap_lo, b0, b1);
      load_b_frag(b0, b1, qt, ATT_BQ + 8, nt * 8, c16 * 16, lane);
      mma_16816(st.dk[nt], ads_hi, b0, b1);
      mma_16816(st.dk[nt], ads_lo, b0, b1);
    }
  }
}

template <int DP>
__device__ __forceinline__ void zero_acc(float acc[DP / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// Store this warp's 16 x DP fp32 accumulator as bf16: rows < n_rows,
// columns < d (padded head-dim columns are never written).  `row_ptr(row)`
// gives the output row's base pointer; `xform(row, c, v0, v1)` may change
// the pair (columns c, c + 1) in fp32 before it is rounded.
template <int DP, typename RowPtr, typename Xform>
__device__ __forceinline__ void store_acc(float acc[DP / 8][4], int row0,
                                          int n_rows, int d, RowPtr row_ptr,
                                          Xform xform, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
    bf16* out = row_ptr(row);
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < d) {
        float v0 = acc[nt][2 * r], v1 = acc[nt][2 * r + 1];
        xform(row, c, v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(out + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace svl
