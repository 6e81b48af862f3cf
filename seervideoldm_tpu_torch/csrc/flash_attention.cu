// K2: fused flash attention forward, softmax(q k^T * scale) v, and K8: its
// backward (dq, dk, dv), at the end of this file.
//
// Replaces seervideoldm_tpu/ops/pallas/flash_attention.py::flash_attention
// (_flash_forward: the single-shot _kernel_single for kv <= 4096 and the
// streamed _kernel beyond).  The TPU kernel keeps all of K/V for one
// batch*head row resident in VMEM (up to 4096 x d); 227 KB of shared memory
// cannot, so this kernel streams K/V in 64-key tiles with an online softmax
// and covers both TPU forms with one code path.
//
// What bounds it on an H100: at the main-path shape (192 x 1024 x 40,
// non-causal) the work is ~32 GFLOP against ~63 MB of q/k/v/o, so tensor
// core throughput bounds it (~0.03 ms at 989 TFLOP/s).  This first version
// uses mma.sync m16n8k16 from registers, one CTA of 4 warps per (batch*head,
// 64-query tile), synchronous tile loads; wgmma/TMA pipelining is later
// work.  d = 40 and 80 are zero-padded to 48 and 80 in shared memory only.
//
// Layout: q (B, n, d), k/v (B, m, d), o (B, n, d), bf16, contiguous, d a
// multiple of 8 (16-byte rows).  Causal = top-left tril (key <= query);
// key tiles wholly above the diagonal are skipped.
#include "attn_bwd_core.cuh"

namespace svl {

// Rows [r0, r0 + ATT_BK) of a (rows, d) bf16 array into shared memory: as
// a [ATT_BK][DP + 8] tile when ROWS, transposed into a [DP][ATT_BK + 8]
// tile when TRANS, or both from one read.  Rows >= n_rows and columns >= d
// are zero.  A load with a transposed store walks the rows fastest, so that
// those stores are contiguous.
template <int DP, bool ROWS, bool TRANS>
__device__ __forceinline__ void load_rows(bf16* rows, bf16* trans,
                                          const bf16* src, int r0, int n_rows,
                                          int d) {
  constexpr int VPR = DP / 8;  // 16-byte vectors per padded row
  for (int i = threadIdx.x; i < ATT_BK * VPR; i += ATT_THREADS) {
    const int r = TRANS ? i % ATT_BK : i / VPR;
    const int c8 = TRANS ? i / ATT_BK : i % VPR;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < n_rows && c8 * 8 < d)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c8 * 8);
    if (ROWS) *reinterpret_cast<uint4*>(rows + r * (DP + 8) + c8 * 8) = v;
    if (TRANS) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        trans[(c8 * 8 + j) * (ATT_BK + 8) + r] = e[j];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int n, int m, int d,
                     float scale_log2, int causal) {
  __shared__ __align__(16) bf16 ks[ATT_BK * (DP + 8)];
  __shared__ __align__(16) bf16 vt[DP * (ATT_BK + 8)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * ATT_BQ;
  const bf16* qb = q + bh * n * d;
  const bf16* kb = k + bh * m * d;
  const bf16* vb = v + bh * m * d;

  // the Q tile passes through the K buffer into registers
  load_rows<DP, true, false>(ks, nullptr, qb, q0, n, d);
  __syncthreads();
  AttnState<DP> st;
  attn_init<DP>(st, ks, warp, lane);

  const int kend = causal ? min(m, q0 + ATT_BQ) : m;
  for (int key0 = 0; key0 < kend; key0 += ATT_BK) {
    __syncthreads();
    load_rows<DP, true, false>(ks, nullptr, kb, key0, m, d);
    load_rows<DP, false, true>(nullptr, vt, vb, key0, m, d);
    __syncthreads();
    attn_tile<DP>(st, ks, vt, scale_log2, q0 + warp * 16, key0, m,
                  causal != 0, lane);
  }
  bf16* ob = o + bh * n * d;
  float* lb = lse == nullptr ? nullptr : lse + bh * n;
  attn_store<DP>(
      st, q0 + warp * 16, n, d, [&](int row) { return ob + (size_t)row * d; },
      [&](int row) { return lb == nullptr ? nullptr : lb + row; }, lane);
}

template <int DP>
static void launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   float* lse, int batch, int n, int m, int d,
                   float scale_log2, int causal, cudaStream_t stream) {
  dim3 grid((n + ATT_BQ - 1) / ATT_BQ, batch);
  flash_fwd_kernel<DP><<<grid, ATT_THREADS, 0, stream>>>(
      q, k, v, o, lse, n, m, d, scale_log2, causal);
}

// ---------------------------------------------------------------- K8
//
// Replaces seervideoldm_tpu/ops/pallas/flash_attention.py::_flash_backward
// (body _bwd_kernel) and, beyond kv = 4096, the einsum form _bwd_einsum.
// The TPU kernel kept a whole K/V row plus two fp32 (kv, d) scratch buffers
// in VMEM and recomputed the softmax from all of K; here the forward saves
// lse, and two kernels stream 64 x 64 tiles (attn_bwd_core.cuh): the dq
// kernel over key tiles, the dk/dv kernel over query tiles, so nothing is
// accumulated across CTAs and the result is deterministic.
//
// What bounds it on an H100: at the training shape (96 x 1024 x 40) the
// five products are ~40 GFLOP against ~63 MB of q/k/v/o/g/dq/dk/dv:
// tensor-core bound (~0.04 ms).  mma.sync m16n8k16, synchronous tile loads,
// each tile stored both as rows and transposed; pipelining is later work.

template <int DP>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int n, int m, int d,
                        float scale, float scale_log2, int causal) {
  __shared__ __align__(16) bf16 ks[ATT_BK * (DP + 8)];
  __shared__ __align__(16) bf16 kt[DP * (ATT_BK + 8)];
  __shared__ __align__(16) bf16 vs[ATT_BK * (DP + 8)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * ATT_BQ;
  const bf16* kb = k + bh * m * d;
  const bf16* vb = v + bh * m * d;

  // the Q and G tiles pass through the K and V buffers into registers
  load_rows<DP, true, false>(ks, nullptr, q + bh * n * d, q0, n, d);
  load_rows<DP, true, false>(vs, nullptr, g + bh * n * d, q0, n, d);
  __syncthreads();
  DqState<DP> st;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    load_a_frag(st.qf[kc], ks, DP + 8, warp * 16, kc * 16, lane);
    load_a_frag(st.gf[kc], vs, DP + 8, warp * 16, kc * 16, lane);
  }
  zero_acc<DP>(st.acc);
  const int row0 = q0 + warp * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    st.lse[r] = row < n ? bwd_lse(lse[bh * n + row]) : INFINITY;
    st.delta[r] = row < n ? delta[bh * n + row] : 0.f;
  }

  const int kend = causal ? min(m, q0 + ATT_BQ) : m;
  for (int key0 = 0; key0 < kend; key0 += ATT_BK) {
    __syncthreads();
    load_rows<DP, true, true>(ks, kt, kb, key0, m, d);
    load_rows<DP, true, false>(vs, nullptr, vb, key0, m, d);
    __syncthreads();
    dq_tile<DP>(st, ks, kt, vs, scale, scale_log2, row0, key0, m, causal != 0,
                lane);
  }
  bf16* ob = dq + bh * n * d;
  store_acc<DP>(
      st.acc, row0, n, d, [&](int row) { return ob + (size_t)row * d; },
      [](int, int, float&, float&) {}, lane);
}

template <int DP>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n,
                         int m, int d, float scale, float scale_log2,
                         int causal) {
  __shared__ __align__(16) bf16 qs[ATT_BQ * (DP + 8)];
  __shared__ __align__(16) bf16 qt[DP * (ATT_BQ + 8)];
  __shared__ __align__(16) bf16 gs[ATT_BQ * (DP + 8)];
  __shared__ __align__(16) bf16 gt[DP * (ATT_BQ + 8)];
  __shared__ float lse_s[ATT_BQ];
  __shared__ float delta_s[ATT_BQ];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = blockIdx.y;
  const int key0 = blockIdx.x * ATT_BK;
  const bf16* qb = q + bh * n * d;
  const bf16* gb = g + bh * n * d;

  // this CTA's K and V tiles pass through the Q and G buffers into registers
  load_rows<DP, true, false>(qs, nullptr, k + bh * m * d, key0, m, d);
  load_rows<DP, true, false>(gs, nullptr, v + bh * m * d, key0, m, d);
  __syncthreads();
  DkvState<DP> st;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    load_a_frag(st.kf[kc], qs, DP + 8, warp * 16, kc * 16, lane);
    load_a_frag(st.vf[kc], gs, DP + 8, warp * 16, kc * 16, lane);
  }
  zero_acc<DP>(st.dk);
  zero_acc<DP>(st.dv);

  // causal (n == m, key <= query): query tiles before this key tile see
  // none of its keys
  for (int q0 = causal ? key0 : 0; q0 < n; q0 += ATT_BQ) {
    __syncthreads();
    load_rows<DP, true, true>(qs, qt, qb, q0, n, d);
    load_rows<DP, true, true>(gs, gt, gb, q0, n, d);
    if (threadIdx.x < ATT_BQ) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < n ? bwd_lse(lse[bh * n + row]) : INFINITY;
      delta_s[threadIdx.x] = row < n ? delta[bh * n + row] : 0.f;
    }
    __syncthreads();
    dkv_tile<DP>(st, qs, qt, gs, gt, lse_s, delta_s, scale, scale_log2,
                 key0 + warp * 16, q0, m, causal != 0, lane);
  }
  bf16* dkb = dk + bh * m * d;
  bf16* dvb = dv + bh * m * d;
  auto keep = [](int, int, float&, float&) {};
  store_acc<DP>(
      st.dk, key0 + warp * 16, m, d,
      [&](int row) { return dkb + (size_t)row * d; }, keep, lane);
  store_acc<DP>(
      st.dv, key0 + warp * 16, m, d,
      [&](int row) { return dvb + (size_t)row * d; }, keep, lane);
}

template <int DP>
static void launch_bwd(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* g, const float* lse, const float* delta,
                       bf16* dq, bf16* dk, bf16* dv, int batch, int n, int m,
                       int d, float scale, float scale_log2, int causal,
                       cudaStream_t stream) {
  if (dq != nullptr) {
    dim3 grid((n + ATT_BQ - 1) / ATT_BQ, batch);
    flash_bwd_dq_kernel<DP><<<grid, ATT_THREADS, 0, stream>>>(
        q, k, v, g, lse, delta, dq, n, m, d, scale, scale_log2, causal);
  }
  if (dk != nullptr) {
    dim3 grid((m + ATT_BK - 1) / ATT_BK, batch);
    flash_bwd_dkv_kernel<DP><<<grid, ATT_THREADS, 0, stream>>>(
        q, k, v, g, lse, delta, dk, dv, n, m, d, scale, scale_log2, causal);
  }
}

}  // namespace svl

// Returns 0 on success, a cudaError_t code after a failed launch, or -1 for
// a head dim this build does not cover (d % 8 != 0 or d > 160).
// `lse` (batch, n) fp32 may be null: it is written only when a backward
// will need it.
extern "C" int svl_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int batch, int n, int m, int d,
                                       float scale, int causal,
                                       void* stream) {
  using svl::bf16;
  const float scale_log2 = scale * 1.4426950408889634f;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  float* ll = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0 || d > 160) return -1;
  const int dp = (d + 15) / 16 * 16;
  switch (dp) {
#define SVL_CASE(DPV) \
  case DPV: svl::launch<DPV>(qq, kk, vv, oo, ll, batch, n, m, d, scale_log2, causal, s); break;
    SVL_CASE(16) SVL_CASE(32) SVL_CASE(48) SVL_CASE(64) SVL_CASE(80)
    SVL_CASE(96) SVL_CASE(112) SVL_CASE(128) SVL_CASE(144) SVL_CASE(160)
#undef SVL_CASE
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// K8.  q/g/o/dq (batch, n, d), k/v/dk/dv (batch, m, d) bf16; lse (batch, n)
// fp32 as the forward wrote it; delta (batch, n) fp32 scratch.  dq may be
// null (no dq kernel); dk and dv are null together (no dk/dv kernel).
// Returns 0, a cudaError_t code, or -1 for a head dim the backward does
// not cover (d % 8 != 0 or d > 80).
extern "C" int svl_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* g, const void* lse,
                                       void* delta, void* dq, void* dk,
                                       void* dv, int batch, int n, int m,
                                       int d, float scale, int causal,
                                       void* stream) {
  using svl::bf16;
  if (d <= 0 || d % 8 != 0 || d > svl::BWD_MAX_D) return -1;
  if ((dk == nullptr) != (dv == nullptr)) return -1;
  const float scale_log2 = scale * 1.4426950408889634f;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const bf16* gg = static_cast<const bf16*>(g);
  const float* ll = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  svl::launch_delta(gg, static_cast<const bf16*>(o), dl,
                    (long long)batch * n, d, s);
  switch ((d + 15) / 16 * 16) {
#define SVL_CASE(DPV)                                                        \
  case DPV:                                                                  \
    svl::launch_bwd<DPV>(qq, kk, vv, gg, ll, dl, static_cast<bf16*>(dq),     \
                         static_cast<bf16*>(dk), static_cast<bf16*>(dv),     \
                         batch, n, m, d, scale, scale_log2, causal, s);      \
    break;
    SVL_CASE(16) SVL_CASE(32) SVL_CASE(48) SVL_CASE(64) SVL_CASE(80)
#undef SVL_CASE
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
