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
#include "attn_bwd_hopper.cuh"

namespace svl {

template <int DPAD, int CWG>
__global__ void __launch_bounds__(128 * (CWG + 1), 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const hat::Problem pb) {
  hat::attn_fwd_body<DPAD, CWG, false, ROT_NONE>(&tq, &tk, &tv, pb);
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
// lse, and the two Hopper kernels of attn_bwd_hopper.cuh stream 64 x 64
// tiles: the dq kernel over key tiles (delta = rowsum(p * dp) first, then
// dq), the dk/dv kernel over query tiles, so nothing is accumulated across
// CTAs and the result is deterministic.
//
// What bounds it on an H100: at the training shape (96 x 1024 x 40) the
// five products are ~40 GFLOP (0.041 ms at 989 TFLOP/s) against ~63 MB of
// q/k/v/g/dq/dk/dv (0.019 ms), and p is recomputed once per score (one
// MUFU ex2, 0.024 ms), so the tensor cores bound it.  What the kernels
// compute is more: d = 40 pads to 64 columns, p and dS enter their
// products as hi + lo pairs (twice the products), and s and dp are formed
// three times (the dq kernel's two passes and the dk/dv kernel), about
// 3.4x the bound's products; all of them are wgmma fed by a TMA ring.

template <int DPAD, int CWG>
__global__ void __launch_bounds__(128 * (CWG + 1), 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tg,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const hab::Problem pb) {
  hab::dq_body<DPAD, CWG, false, ROT_NONE>(&tq, &tg, &tk, &tv, pb);
}

template <int DPAD, int CWG>
__global__ void __launch_bounds__(128 * (CWG + 1), 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tg,
                         const __grid_constant__ CUtensorMap tl,
                         const __grid_constant__ CUtensorMap td,
                         const hab::Problem pb) {
  hab::dkv_body<DPAD, CWG, false, ROT_NONE>(&tk, &tv, &tq, &tg, &tl, &td, pb);
}

// (batch, n) fp32 row values as a tensor map over the batch * n values of
// one row (a 2-D map of one row: the stride of its outer dimension only has
// to be a multiple of 16 bytes), boxes of one 64-row tile.
static bool encode_row_scalars(CUtensorMap* map, const void* p, int batch,
                               int n) {
  const cuuint64_t len = (cuuint64_t)batch * n;
  const cuuint64_t dims[2] = {len, 1};
  const cuuint64_t strides[1] = {(len * 4 + 15) / 16 * 16};
  const cuuint32_t box[2] = {(cuuint32_t)hab::BQ, 1};
  return encode_f32(map, p, 2, dims, strides, box);
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
// (no dk/dv kernel).  cwg_dq, cwg_dkv: consumer warpgroups a CTA of each
// kernel (hab::cwg_ok; ops/kernels/flash_attention.py::bwd_plan).
// Returns 0, a cudaError_t code, -1 for a shape the backward does not
// cover (d % 8 != 0, d > 80, causal with n != m, a cwg without an
// instantiation), or -2 when cuTensorMapEncodeTiled refuses a map.
extern "C" int svl_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* g,
                                       const void* lse, void* delta, void* dq,
                                       void* dk, void* dv, int batch, int n,
                                       int m, int d, float scale, int causal,
                                       int cwg_dq, int cwg_dkv,
                                       void* stream) {
  using namespace svl;
  const int dpad = hab::dpad_of(d);
  if (dpad < 0 || (dk == nullptr) != (dv == nullptr) || (causal && n != m) ||
      n <= 0 || m <= 0 || batch <= 0 || !hab::cwg_ok(dpad, cwg_dq, false) ||
      (dk != nullptr && !hab::cwg_ok(dpad, cwg_dkv, true)))
    return -1;
  CUtensorMap tq{}, tk{}, tv{}, tg{}, tl{}, td{};
  if (!encode_rows(&tq, q, batch, n, d) || !encode_rows(&tg, g, batch, n, d) ||
      !encode_rows(&tk, k, batch, m, d) || !encode_rows(&tv, v, batch, m, d) ||
      !encode_row_scalars(&tl, lse, batch, n) ||
      !encode_row_scalars(&td, delta, batch, n))
    return -2;
  hab::Problem pb{};
  pb.lse = static_cast<const float*>(lse);
  pb.delta = static_cast<float*>(delta);
  pb.dq = static_cast<bf16*>(dq);
  pb.dk = static_cast<bf16*>(dk);
  pb.dv = static_cast<bf16*>(dv);
  pb.n = n;
  pb.m = m;
  pb.d = d;
  pb.qtiles = (n + hab::BQ - 1) / hab::BQ;
  pb.ktiles = (m + hab::BQ - 1) / hab::BQ;
  pb.units = batch;
  pb.windows = 1;
  pb.causal = causal;
  pb.scale = scale;
  pb.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = -1;
  const int dq_ctas = (pb.qtiles + cwg_dq - 1) / cwg_dq * batch;
#define SVL_DQ(DP, CW)                                                    \
  if (dpad == DP && cwg_dq == CW)                                         \
    err = hab::launch<DP, CW, false, &flash_bwd_dq_kernel<DP, CW>>(       \
        dq_ctas, pb, s, tq, tg, tk, tv);
  SVL_DQ(64, 2) SVL_DQ(64, 3) SVL_DQ(128, 2)
#undef SVL_DQ
  if (err != 0 || dk == nullptr) return err;
  const int dkv_ctas = (pb.ktiles + cwg_dkv - 1) / cwg_dkv * batch;
#define SVL_DKV(DP, CW)                                                   \
  if (dpad == DP && cwg_dkv == CW)                                        \
    err = hab::launch<DP, CW, true, &flash_bwd_dkv_kernel<DP, CW>>(       \
        dkv_ctas, pb, s, tk, tv, tq, tg, tl, td);
  SVL_DKV(64, 2) SVL_DKV(128, 2)
#undef SVL_DKV
  return err;
}

// The dynamic shared memory a CTA of the backward kernels (K7, K8, K9
// alike) takes at head dim d with cwg consumer warpgroups (dkv: the dk/dv
// kernel, else the dq kernel); -1 for no instantiation.
extern "C" int svl_attn_bwd_smem(int d, int cwg, int dkv) {
  return svl::hab::smem_bytes(d, cwg, dkv != 0);
}

// The tiles of CTA `block` of the backward kernels' grid (hab::cta_tiles,
// the map the kernels run): out = unit, own, own_end, vis, vis_end.
extern "C" void svl_attn_bwd_cta(int block, int cwg, int dkv, int units,
                                 int qtiles, int ktiles, int causal,
                                 int* out) {
  const svl::hab::CtaTiles c = svl::hab::cta_tiles(
      block, cwg, dkv != 0, units, qtiles, ktiles, causal != 0);
  const int vals[5] = {c.unit, c.own, c.own_end, c.vis, c.vis_end};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
}
