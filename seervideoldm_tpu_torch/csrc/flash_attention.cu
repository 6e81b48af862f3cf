// K2: fused flash attention forward, softmax(q k^T * scale) v.
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
#include "attn_core.cuh"

namespace svl {

// Rows [r0, r0 + ATT_BK) of a (rows, d) bf16 array into a [ATT_BK][DP + 8]
// tile; rows >= n_rows and columns >= d are zero.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int n_rows, int d) {
  constexpr int VPR = DP / 8;  // 16-byte vectors per padded row
  for (int i = threadIdx.x; i < ATT_BK * VPR; i += ATT_THREADS) {
    const int r = i / VPR, c8 = i % VPR;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < n_rows && c8 * 8 < d)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * (DP + 8) + c8 * 8) = v;
  }
}

// Same rows, stored transposed into a [DP][ATT_BK + 8] tile.
template <int DP>
__device__ __forceinline__ void load_rows_t(bf16* dst, const bf16* src,
                                            int r0, int n_rows, int d) {
  constexpr int VPR = DP / 8;
  for (int i = threadIdx.x; i < ATT_BK * VPR; i += ATT_THREADS) {
    const int r = i % ATT_BK, c8 = i / ATT_BK;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < n_rows && c8 * 8 < d)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c8 * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c8 * 8 + j) * (ATT_BK + 8) + r] = e[j];
  }
}

template <int DP>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int n,
                     int m, int d, float scale_log2, int causal) {
  __shared__ __align__(16) bf16 ks[ATT_BK * (DP + 8)];
  __shared__ __align__(16) bf16 vt[DP * (ATT_BK + 8)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * ATT_BQ;
  const bf16* qb = q + bh * n * d;
  const bf16* kb = k + bh * m * d;
  const bf16* vb = v + bh * m * d;

  // the Q tile passes through the K buffer into registers
  load_rows<DP>(ks, qb, q0, n, d);
  __syncthreads();
  AttnState<DP> st;
  attn_init<DP>(st, ks, warp, lane);

  const int kend = causal ? min(m, q0 + ATT_BQ) : m;
  for (int key0 = 0; key0 < kend; key0 += ATT_BK) {
    __syncthreads();
    load_rows<DP>(ks, kb, key0, m, d);
    load_rows_t<DP>(vt, vb, key0, m, d);
    __syncthreads();
    attn_tile<DP>(st, ks, vt, scale_log2, q0 + warp * 16, key0, m,
                  causal != 0, lane);
  }
  bf16* ob = o + bh * n * d;
  attn_store<DP>(st, q0 + warp * 16, n, d,
                 [&](int row) { return ob + (size_t)row * d; }, lane);
}

template <int DP>
static void launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   int batch, int n, int m, int d, float scale_log2,
                   int causal, cudaStream_t stream) {
  dim3 grid((n + ATT_BQ - 1) / ATT_BQ, batch);
  flash_fwd_kernel<DP><<<grid, ATT_THREADS, 0, stream>>>(q, k, v, o, n, m, d,
                                                         scale_log2, causal);
}

}  // namespace svl

// Returns 0 on success, a cudaError_t code after a failed launch, or -1 for
// a head dim this build does not cover (d % 8 != 0 or d > 160).
extern "C" int svl_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int batch,
                                       int n, int m, int d, float scale,
                                       int causal, void* stream) {
  using svl::bf16;
  const float scale_log2 = scale * 1.4426950408889634f;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0 || d > 160) return -1;
  const int dp = (d + 15) / 16 * 16;
  switch (dp) {
#define SVL_CASE(DPV) \
  case DPV: svl::launch<DPV>(qq, kk, vv, oo, batch, n, m, d, scale_log2, causal, s); break;
    SVL_CASE(16) SVL_CASE(32) SVL_CASE(48) SVL_CASE(64) SVL_CASE(80)
    SVL_CASE(96) SVL_CASE(112) SVL_CASE(128) SVL_CASE(144) SVL_CASE(160)
#undef SVL_CASE
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
