// Attention backward over one 64 x 64 (query x key) tile, per warp, with
// mma.sync.
//
// Shared by flash_attention.cu (K8) and swat_attention.cu (K7).  The forward
// kernels save lse = m + log2(l) per query row (log2 domain), so the
// backward needs no online softmax: p = exp2(s * scale_log2 - lse) exactly.
// delta = rowsum(g * o) comes from a small prologue kernel (delta_kernel).
// Two deterministic kernels, no atomics:
//
//   dq kernel     one CTA per 64-query tile, 16 query rows per warp; Q and G
//                 live in registers as A fragments, K/V tiles stream through
//                 shared memory.  Per 16-key chunk: s = q k^T, dp = g v^T,
//                 ds = p * (dp - delta) * scale, dq += ds k.
//   dk/dv kernel  one CTA per 64-key tile, 16 keys per warp; K and V live in
//                 registers as A fragments, Q/G tiles stream.  It computes
//                 the TRANSPOSED scores s^T = k q^T directly, so the C
//                 fragments of p^T and ds^T are the A fragments of the next
//                 products: dv += p^T g, dk += ds^T q.
//
// Rounding points: q, k, v, g are bf16 inputs (for K7, q and k are rotated
// in fp32 and rounded to bf16 on load, as in the forward).  s, p, dp, delta
// and ds are fp32; p and ds are rounded to bf16 only as operands of their
// products (p^T g, ds k, ds^T q); every accumulator is fp32.  The TPU
// kernels ran those products on fp32 operands; tensor cores need bf16.
//
// Masked elements (key >= kv_len, key > query when causal) and rows whose
// lse is not finite (padding rows are given lse = +inf) have p = 0 exactly.
#pragma once

#include "attn_core.cuh"

namespace svl {

constexpr int BWD_MAX_D = 80;  // widest head dim the backward is built for

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

// ks, vs: K and V tiles as rows [ATT_BK][DP + 8]; kt: K transposed
// [DP][ATT_BK + 8].  row0: absolute index of this warp's first query row;
// key0: absolute index of the tile's first key.
template <int DP>
__device__ __forceinline__ void dq_tile(DqState<DP>& st, const bf16* ks,
                                        const bf16* kt, const bf16* vs,
                                        float scale, float scale_log2,
                                        int row0, int key0, int kv_len,
                                        bool causal, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c16 = 0; c16 < ATT_BK / 16; ++c16) {
    float s[2][4], dp[2][4];
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
    float ds[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int row = row0 + g + (r << 3);
        const int col = key0 + (2 * c16 + h) * 8 + 2 * t + (e & 1);
        const bool masked = col >= kv_len || (causal && col > row);
        const float p =
            masked ? 0.f : exp2f(s[h][e] * scale_log2 - st.lse[r]);
        ds[h][e] = p * (dp[h][e] - st.delta[r]) * scale;
      }
    const uint32_t a[4] = {
        pack_bf16x2(ds[0][0], ds[0][1]), pack_bf16x2(ds[0][2], ds[0][3]),
        pack_bf16x2(ds[1][0], ds[1][1]), pack_bf16x2(ds[1][2], ds[1][3])};
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      uint32_t b0, b1;
      load_b_frag(b0, b1, kt, ATT_BK + 8, nt * 8, c16 * 16, lane);
      mma_16816(st.acc[nt], a, b0, b1);
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
    const uint32_t ap[4] = {
        pack_bf16x2(pT[0][0], pT[0][1]), pack_bf16x2(pT[0][2], pT[0][3]),
        pack_bf16x2(pT[1][0], pT[1][1]), pack_bf16x2(pT[1][2], pT[1][3])};
    const uint32_t ads[4] = {
        pack_bf16x2(dsT[0][0], dsT[0][1]), pack_bf16x2(dsT[0][2], dsT[0][3]),
        pack_bf16x2(dsT[1][0], dsT[1][1]), pack_bf16x2(dsT[1][2], dsT[1][3])};
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      uint32_t b0, b1;
      load_b_frag(b0, b1, gt, ATT_BQ + 8, nt * 8, c16 * 16, lane);
      mma_16816(st.dv[nt], ap, b0, b1);
      load_b_frag(b0, b1, qt, ATT_BQ + 8, nt * 8, c16 * 16, lane);
      mma_16816(st.dk[nt], ads, b0, b1);
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

// delta[row] = sum_c g[row][c] * o[row][c] in fp32, rows of d bf16 values
// (d % 8 == 0): eight lanes per row, 16-byte loads.
__global__ void delta_kernel(const bf16* __restrict__ g,
                             const bf16* __restrict__ o,
                             float* __restrict__ delta, long long rows,
                             int d) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 8) + threadIdx.x / 8;
  const int sub = threadIdx.x & 7;
  float acc = 0.f;
  if (row < rows) {
    for (int c8 = sub; c8 * 8 < d; c8 += 8) {
      const uint4 gv = *reinterpret_cast<const uint4*>(g + row * d + c8 * 8);
      const uint4 ov = *reinterpret_cast<const uint4*>(o + row * d + c8 * 8);
      const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = __bfloat1622float2(gp[j]);
        const float2 b = __bfloat1622float2(op[j]);
        acc += a.x * b.x + a.y * b.y;
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (row < rows && sub == 0) delta[row] = acc;
}

static inline void launch_delta(const bf16* g, const bf16* o, float* delta,
                                long long rows, int d, cudaStream_t stream) {
  const int threads = 256, rows_per_block = threads / 8;
  const unsigned blocks =
      (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  delta_kernel<<<blocks, threads, 0, stream>>>(g, o, delta, rows, d);
}

}  // namespace svl
