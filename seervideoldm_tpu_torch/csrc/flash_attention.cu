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
// What bounds it on an H100 (d = 40, non-causal): at (192, 1024, 40) the
// products are 32.2 GFLOP (0.0326 ms at 989 TFLOP/s), q/k/v/o 63 MB
// (0.0188 ms at 3.35 TB/s), and the softmax one MUFU ex2 per score, 201 M
// at 0.2391 ps each (K10's calibration on the card): 0.0481 ms.  So the
// exponential unit bounds it, then the tensor cores; at (192, 4096, 40)
// 0.770 ms against 0.521.  The design (attn_fwd_hopper.cuh): a CTA of 2
// or 3 consumer warpgroups (the host's plan) holds one 64-row query tile
// each, a producer warp streams 64-key K/V tiles through a TMA ring (one
// 3-D tensor map (d, rows, batch) each for q, k, v, boxes of 64 columns x
// 64 rows, zero fill past d and past the last row), wgmma computes S and
// P V, and the softmax of one warpgroup overlaps the products of another.  d is padded to 64 columns (128-byte rows): at
// d = 40, S takes 3 k steps of 16 where 2.5 would do and P V computes 64
// columns for 40 (1.4x the products, 0.046 ms), below the MUFU bound.
//
// Layout: q (B, n, d), k/v (B, m, d), o (B, n, d), bf16, contiguous, d a
// multiple of 8 (16-byte rows).  Causal = top-left tril (key <= query, n ==
// m); key tiles wholly above the diagonal are skipped.
#include "attn_bwd_core.cuh"
#include "attn_fwd_hopper.cuh"

namespace svl {

template <int DPAD, int CWG>
__global__ void __launch_bounds__(128 * (CWG + 1), 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const hat::Problem pb) {
  hat::attn_fwd_body<DPAD, CWG, false, ROT_NONE>(&tq, &tk, &tv, pb);
}

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

// A (rows, d) slab of `batch` bf16 rows as a 3-D tensor map (d, rows,
// batch), boxes of 64 columns x 64 rows.
static bool encode_rows(CUtensorMap* map, const void* p, int batch, int rows,
                        int d) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)hat::BQ, 1};
  return encode_bf16(map, p, 3, dims, strides, box);
}

// ---------------------------------------------------------------- K8
//
// Replaces seervideoldm_tpu/ops/pallas/flash_attention.py::_flash_backward
// (body _bwd_kernel) and, beyond kv = 4096, the einsum form _bwd_einsum.
// The TPU kernel kept a whole K/V row plus two fp32 (kv, d) scratch buffers
// in VMEM and recomputed the softmax from all of K; here the forward saves
// lse, and two kernels stream 64 x 64 tiles (attn_bwd_core.cuh): the dq
// kernel over key tiles (delta = rowsum(p * dp) first, then dq), the dk/dv
// kernel over query tiles, so nothing is accumulated across CTAs and the
// result is deterministic.
//
// What bounds it on an H100: at the training shape (96 x 1024 x 40) the
// five products are ~40 GFLOP (0.041 ms) against ~63 MB of q/k/v/g/dq/dk/
// dv, and p is recomputed once per score (one MUFU ex2, 0.024 ms).
// mma.sync m16n8k16, synchronous tile loads, each tile stored both as rows
// and transposed; p and dS enter their products as bf16 hi + lo pairs, and
// the dq kernel's delta pass recomputes s and dp once more; pipelining is
// later work.

template <int DP>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, bf16* __restrict__ dq,
                        int n, int m, int d, float scale, float scale_log2,
                        int causal) {
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
  }

  const int kend = causal ? min(m, q0 + ATT_BQ) : m;
  float dsum[2] = {0.f, 0.f};
  for (int key0 = 0; key0 < kend; key0 += ATT_BK) {
    __syncthreads();
    load_rows<DP, true, false>(ks, nullptr, kb, key0, m, d);
    load_rows<DP, true, false>(vs, nullptr, vb, key0, m, d);
    __syncthreads();
    delta_tile<DP>(st, ks, vs, scale_log2, row0, key0, m, causal != 0, lane,
                   dsum);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    st.delta[r] = quad_sum(dsum[r]);
    if ((lane & 3) == 0 && row < n) delta[bh * n + row] = st.delta[r];
  }
  if (dq == nullptr) return;

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
                       const bf16* g, const float* lse, float* delta,
                       bf16* dq, bf16* dk, bf16* dv, int batch, int n, int m,
                       int d, float scale, float scale_log2, int causal,
                       cudaStream_t stream) {
  {  // always: its first pass writes delta
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
// a shape this build does not cover (d % 8 != 0, d > 160, causal with n !=
// m, a cwg without an instantiation: hat::cwg_ok).  `lse` (batch, n) fp32
// may be null: it is written only when a backward will need it.  `cwg`:
// consumer warpgroups per CTA, each one 64-row query tile (ops/kernels/
// flash_attention.py::plan).
extern "C" int svl_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int batch, int n, int m, int d,
                                       float scale, int causal, int cwg,
                                       void* stream) {
  using namespace svl;
  const int dpad = hat::dpad_of(d);
  if (dpad < 0 || !hat::cwg_ok(dpad, cwg) || (causal && n != m) || n <= 0 ||
      m <= 0 || batch <= 0)
    return -1;
  CUtensorMap tq{}, tk{}, tv{};
  if (!encode_rows(&tq, q, batch, n, d) || !encode_rows(&tk, k, batch, m, d) ||
      !encode_rows(&tv, v, batch, m, d))
    return static_cast<int>(cudaErrorInvalidValue);
  hat::Problem pb{};
  pb.o = static_cast<bf16*>(o);
  pb.lse = static_cast<float*>(lse);
  pb.rows = n;
  pb.kv_len = m;
  pb.d = d;
  pb.qtiles = (n + hat::BQ - 1) / hat::BQ;
  pb.ktiles = (m + hat::BKV - 1) / hat::BKV;
  pb.causal = causal;
  pb.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((pb.qtiles + cwg - 1) / cwg, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVL_FWD(DP, CW)                                                       \
  if (dpad == DP && cwg == CW)                                                \
    return hat::launch<DP, CW, &flash_fwd_wgmma_kernel<DP, CW>>(grid, tq, tk, \
                                                                tv, pb, s);
  SVL_FWD(64, 2) SVL_FWD(64, 3) SVL_FWD(128, 2) SVL_FWD(128, 3)
  SVL_FWD(192, 2)
#undef SVL_FWD
  return -1;
}

// The dynamic shared memory a CTA of the attention forward (K1, K2, K6
// alike) takes at head dim d with cwg consumer warpgroups, and in `stages`
// its ring stages; -1 for a cwg without an instantiation.
extern "C" int svl_attn_fwd_smem(int d, int cwg, int* stages) {
  using namespace svl;
  const int dpad = hat::dpad_of(d);
  if (dpad < 0 || !hat::cwg_ok(dpad, cwg)) return -1;
  hat::Problem pb{};
  int bytes = -1;
#define SVL_SMEM(DP, CW) \
  if (dpad == DP && cwg == CW) hat::layout<DP, CW>(pb, bytes);
  SVL_SMEM(64, 2) SVL_SMEM(64, 3) SVL_SMEM(128, 2) SVL_SMEM(128, 3)
  SVL_SMEM(192, 2)
#undef SVL_SMEM
  *stages = pb.stages;
  return bytes;
}

// K8.  q/g/dq (batch, n, d), k/v/dk/dv (batch, m, d) bf16; lse (batch, n)
// fp32 as the forward wrote it; delta (batch, n) fp32 scratch.  dq may be
// null (the dq kernel then only forms delta); dk and dv are null together
// (no dk/dv kernel).  Returns 0, a cudaError_t code, or -1 for a head dim
// the backward does not cover (d % 8 != 0 or d > 80).
extern "C" int svl_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* g,
                                       const void* lse, void* delta, void* dq,
                                       void* dk, void* dv, int batch, int n,
                                       int m, int d, float scale, int causal,
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
