// Online-softmax attention over one key tile, per warp, with mma.sync.
//
// Shared by flash_attention.cu (K2) and swat_attention.cu (K1); the
// backward kernels (K8, K7) are in attn_bwd_core.cuh.  A CTA of
// four warps owns a 64-row query tile (16 rows per warp, Q held in
// registers as A fragments); key/value tiles of 64 tokens stream through
// shared memory: K as rows (n-major, the B layout of q.k^T) and V
// transposed (d-major, the B layout of p.v).  The head dim is zero-padded
// to DP (a multiple of 16) in shared memory only.
//
// Numerics follow the TPU kernels: fp32 scores, fp32 running max and sum,
// probabilities rounded to bf16 for the p.v product, fp32 accumulator,
// normalisation after p.v with an l == 0 guard.  Scores are kept in the
// log2 domain (scale * log2(e) folded in) so exp2f does the exponent.
#pragma once

#include <math.h>

#include "common.cuh"

namespace svl {

constexpr int ATT_BQ = 64;       // query rows per CTA (4 warps x 16)
constexpr int ATT_BK = 64;       // keys per streamed tile
constexpr int ATT_THREADS = 128;

template <int DP>
struct AttnState {
  uint32_t qf[DP / 16][4];  // Q A-fragments, 16 rows x DP
  float o[DP / 8][4];       // output accumulator, 16 rows x DP
  float m[2];               // running max (log2 domain) of rows g, g+8
  float l[2];               // this thread's partial row sums
};

template <int DP>
__device__ __forceinline__ void attn_init(AttnState<DP>& st, const bf16* qs,
                                          int warp, int lane) {
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
    load_a_frag(st.qf[kc], qs, DP + 8, warp * 16, kc * 16, lane);
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[nt][e] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

// One 64-key tile.  ks: K tile [ATT_BK][DP + 8]; vt: V^T tile
// [DP][ATT_BK + 8].  row0: absolute index of this warp's first query row;
// key0: absolute index of the tile's first key.  Keys >= kv_len and, when
// causal, keys > row are masked.
template <int DP>
__device__ __forceinline__ void attn_tile(AttnState<DP>& st, const bf16* ks,
                                          const bf16* vt, float scale_log2,
                                          int row0, int key0, int kv_len,
                                          bool causal, int lane) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int NKT = ATT_BK / 8;
  float s[NKT][4];
#pragma unroll
  for (int nt = 0; nt < NKT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      uint32_t b0, b1;
      load_b_frag(b0, b1, ks, DP + 8, nt * 8, kc * 16, lane);
      mma_16816(s[nt], st.qf[kc], b0, b1);
    }
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + ((e >> 1) << 3);
      const int col = key0 + nt * 8 + 2 * t + (e & 1);
      float v = s[nt][e] * scale_log2;
      if (col >= kv_len || (causal && col > row)) v = -INFINITY;
      s[nt][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }

  float m_use[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(st.m[r], quad_max(mx[r]));
    // a row with every key so far masked keeps m = -inf: exponentiate
    // against 0 so its probabilities are exactly 0, not NaN
    m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;
    alpha[r] = exp2f(st.m[r] - m_use[r]);
    st.m[r] = m_new;
    st.l[r] *= alpha[r];
  }
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    st.o[nt][0] *= alpha[0];
    st.o[nt][1] *= alpha[0];
    st.o[nt][2] *= alpha[1];
    st.o[nt][3] *= alpha[1];
  }

  uint32_t pf[NKT][2];  // probabilities as bf16 pairs (rows g / g+8)
#pragma unroll
  for (int nt = 0; nt < NKT; ++nt) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2f(s[nt][e] - m_use[e >> 1]);
      st.l[e >> 1] += p[e];
    }
    pf[nt][0] = pack_bf16x2(p[0], p[1]);
    pf[nt][1] = pack_bf16x2(p[2], p[3]);
  }

  // o += p . v: the score C fragments of two 8-key tiles are exactly the
  // A fragment of one 16-key chunk
#pragma unroll
  for (int kc = 0; kc < ATT_BK / 16; ++kc) {
    const uint32_t a[4] = {pf[2 * kc][0], pf[2 * kc][1], pf[2 * kc + 1][0],
                           pf[2 * kc + 1][1]};
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      uint32_t b0, b1;
      load_b_frag(b0, b1, vt, ATT_BK + 8, nt * 8, kc * 16, lane);
      mma_16816(st.o[nt], a, b0, b1);
    }
  }
}

// Normalise and store this warp's 16 rows: out(row, c) for c < d, rows
// < n_rows; `row_ptr(row)` gives the output row's base pointer.  When
// `lse_ptr(row)` is not null it receives the row's log-sum-exp in the log2
// domain, m + log2(l) (-inf for a row with no visible key), which the
// backward kernels read.
template <int DP, typename RowPtr, typename LsePtr>
__device__ __forceinline__ void attn_store(AttnState<DP>& st, int row0,
                                           int n_rows, int d, RowPtr row_ptr,
                                           LsePtr lse_ptr, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float inv[2], lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = quad_sum(st.l[r]);
    inv[r] = 1.f / (l == 0.f ? 1.f : l);
    lse[r] = l == 0.f ? -INFINITY : st.m[r] + log2f(l);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
    if (t == 0) {
      float* lp = lse_ptr(row);
      if (lp != nullptr) *lp = lse[r];
    }
    bf16* out = row_ptr(row);
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < d) {
        *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
            st.o[nt][2 * r] * inv[r], st.o[nt][2 * r + 1] * inv[r]);
      }
    }
  }
}

}  // namespace svl
