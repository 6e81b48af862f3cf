// K1: fused SWAT windowed causal spatio-temporal attention with rotary
// tables; K6: the same kernel on pre-rotated q/k or with the rotation
// computed in the kernel; K7 and K9: their backward (dq, dk, dv).  The
// source of the rotation is a compile-time parameter (ROT,
// attn_fwd_hopper.cuh), so the four TPU kernels are two CUDA kernels'
// instantiations.
//
// Replaces seervideoldm_tpu/ops/pallas/swat_attention.py::
// swat_attention_tables (_swat_forward_tab, body _kernel_tab) and
// swat_attention (_swat_forward, body _kernel; rot_dim 0 is the production
// call on the sequence-parallel path, rot_dim > 0 rotates in the kernel).
// For every ws x ws spatial window across all f frames (f * ws^2 tokens,
// f-major: t = frame * ws^2 + row * ws + col) it rotates q and k in fp32,
// rounds them to bf16, and computes causal (key t <= query t over the
// flattened window) softmax attention.  The window is read from and written
// back to the (B, f, h, w, d) layout directly, so no partition or reverse
// pass exists.
//
// What bounds it on an H100: at the 256 px main-path shape (16 x 12 x 32 x
// 32 x 40, ws 8, 768 tokens per window) q/k/v/o and the tables are 67 MB
// (0.0200 ms at 3.35 TB/s), the causal products 12.1 GFLOP (0.0122 ms),
// and the softmax 75.6 M visible scores, one MUFU ex2 each at 0.2391 ps
// (K10's calibration): 0.0181 ms.  Bytes and exponentials bound it about
// equally (the rotation pass adds q and k written and read once more).
// The TPU kernel held a window's whole fp32 score matrix (2.4 MB) in VMEM;
// here (attn_fwd_hopper.cuh) a CTA holds 2 or 3 consecutive query frames
// of one window, one a consumer warpgroup (the host's plan), and streams
// the window's key frames 0 .. (its last query frame) through a TMA ring
// once: each K/V frame is loaded once per CTA and serves every query frame
// the CTA holds.  The loads are TMA boxes of a 5-D
// tensor map over (d, w, h, f, B), box (64, 8, 8, 1, 1): one box is one
// window frame, 64 tokens x 64 columns in the 128-byte swizzle, zero-filled
// past d.  S and P V are wgmma products (see the header).
//
// The rotation.  K1 rotates q and k once, in rotate_qk_kernel, a
// memory-bound pass (q, k and the tables read once, the rotated q and k
// written once, each pair in fp32 and rounded to bf16 as the plain version
// rounds it), and then runs the attention body unrotated (ROT_NONE), as K6
// with rot_dim 0 does.  The fp32 tables are twice the bytes of K and V a
// token, and a CTA sees each key frame it holds; rotating key tiles in
// shared memory after they land made every CTA fetch the tables of every
// such frame from L2 again, and that traffic, not the products, bounded
// the kernel.  K6 with rot_dim > 0 computes its cos/sin (no tables), so it
// rotates in shared memory: the producer's warps 1-3 rotate each key tile
// once per CTA after it lands, each consumer warpgroup its query tiles.
// The backward (K7, K9 with rot_dim > 0) runs the same pass
// (swat_bwd_rotate_kernel, tables or trig) and then its body unrotated.
//
// Layout: q/k/v/o (B, f, h, w, d) bf16 contiguous, cos/sin (f, h, w, d)
// fp32 contiguous, ws = 8, h % 8 == w % 8 == 0, d a multiple of 8.
#include "attn_bwd_hopper.cuh"

namespace svl {

template <int DPAD, int CWG, int ROT>
__global__ void __launch_bounds__(128 * (CWG + 1), 1)
    swat_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const hat::Problem pb) {
  hat::attn_fwd_body<DPAD, CWG, true, ROT>(&tq, &tk, &tv, pb);
}

// The rotation pass: qr = rot(q), kr = rot(k) over (B, f, h, w, d), t *
// cos + rotate_half(t) * sin in fp32 and rounded to bf16 (rotate_pair), cos
// and sin from the (f, h, w, d) fp32 tables (ROT_TABLES: 32-byte loads of
// each) or from the token's position and the rotary frequencies
// (ROT_TRIG: rot_cs, the formula K6's forward rotates with in shared
// memory, so the backward's p is recomputed on the very q and k the
// forward's lse was formed from; lanes >= rot_dim pass through).  One
// thread takes 8 columns of one token (16-byte loads of q and k),
// grid-stride.
template <int ROT>
__device__ __forceinline__ void rotate_qk(const bf16* __restrict__ q,
                                          const bf16* __restrict__ k,
                                          const RotSrc& rs,
                                          bf16* __restrict__ qr,
                                          bf16* __restrict__ kr,
                                          long long vecs, long long vol_vecs,
                                          int d) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < vecs; i += (long long)gridDim.x * blockDim.x) {
    const long long t = i % vol_vecs;  // the vector's place in the volume
    float2 cs[4], sn[4];
    bool pass_through[4] = {false, false, false, false};
    if (ROT == ROT_TABLES) {
      const float4* c4 = reinterpret_cast<const float4*>(rs.cos_t) + 2 * t;
      const float4* s4 = reinterpret_cast<const float4*>(rs.sin_t) + 2 * t;
      const float4 ca = c4[0], cb = c4[1], sa = s4[0], sb = s4[1];
      cs[0] = make_float2(ca.x, ca.y);
      cs[1] = make_float2(ca.z, ca.w);
      cs[2] = make_float2(cb.x, cb.y);
      cs[3] = make_float2(cb.z, cb.w);
      sn[0] = make_float2(sa.x, sa.y);
      sn[1] = make_float2(sa.z, sa.w);
      sn[2] = make_float2(sb.x, sb.y);
      sn[3] = make_float2(sb.z, sb.w);
    } else {
      const int vpt = d / 8;  // vectors a token
      const size_t tok = (size_t)(t / vpt);
      const int c0 = (int)(t % vpt) * 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pass_through[j] = c0 + 2 * j >= rs.rot_dim;
        rot_cs<ROT_TRIG>(rs, tok, d, c0 + 2 * j, cs[j], sn[j]);
      }
    }
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const uint4 u = reinterpret_cast<const uint4*>(which ? k : q)[i];
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
      uint32_t out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 x = __bfloat1622float2(e[j]);
        rotate_pair(x.x, x.y, cs[j], sn[j]);
        out[j] = pass_through[j] ? reinterpret_cast<const uint32_t*>(&u)[j]
                                 : pack_bf16x2(x.x, x.y);
      }
      reinterpret_cast<uint4*>(which ? kr : qr)[i] =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

// K1's rotation pass (tables).
__global__ void rotate_qk_kernel(const bf16* __restrict__ q,
                                 const bf16* __restrict__ k, const RotSrc rs,
                                 bf16* __restrict__ qr, bf16* __restrict__ kr,
                                 long long vecs, long long vol_vecs, int d) {
  rotate_qk<ROT_TABLES>(q, k, rs, qr, kr, vecs, vol_vecs, d);
}

// K7's (tables) and K9's (trig) rotation pass: the forward's rotation of q
// and k, once a call, before the backward body runs unrotated.
template <int ROT>
__global__ void swat_bwd_rotate_kernel(const bf16* __restrict__ q,
                                       const bf16* __restrict__ k,
                                       const RotSrc rs, bf16* __restrict__ qr,
                                       bf16* __restrict__ kr, long long vecs,
                                       long long vol_vecs, int d) {
  rotate_qk<ROT>(q, k, rs, qr, kr, vecs, vol_vecs, d);
}

// Launch a rotation pass over (batch, f, h, w, d): 256 threads a block, at
// most 16 blocks an SM.
template <typename Kernel>
static int launch_rotate(Kernel kernel, const void* q, const void* k,
                         const RotSrc& rs, void* qr, void* kr, int batch,
                         int f, int h, int w, int d, cudaStream_t s) {
  const long long vol_vecs = (long long)f * h * w * d / 8;
  const long long vecs = vol_vecs * batch;
  const int threads = 256;
  const long long blocks = (vecs + threads - 1) / threads;
  kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), threads, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), rs,
      static_cast<bf16*>(qr), static_cast<bf16*>(kr), vecs, vol_vecs, d);
  return static_cast<int>(cudaGetLastError());
}

// A (B, f, h, w, d) bf16 volume as a 5-D tensor map (d, w, h, f, B), boxes
// of one window frame: 64 columns x 8 x 8 tokens.
static bool encode_windows(CUtensorMap* map, const void* p, int batch, int f,
                           int h, int w, int d) {
  const cuuint64_t dims[5] = {(cuuint64_t)d, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)f, (cuuint64_t)batch};
  const cuuint64_t row = (cuuint64_t)d * 2;
  const cuuint64_t strides[4] = {row, row * w, row * w * h, row * w * h * f};
  const cuuint32_t box[5] = {64, SW_WS, SW_WS, 1, 1};
  return encode_bf16(map, p, 5, dims, strides, box);
}

// A (B, f, h, w) fp32 volume of per-token values (lse, delta) as a 4-D
// tensor map (w, h, f, B), boxes of one window frame (8 x 8 tokens, in
// token order).
static bool encode_window_scalars(CUtensorMap* map, const void* p, int batch,
                                  int f, int h, int w) {
  const cuuint64_t dims[4] = {(cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)f,
                              (cuuint64_t)batch};
  const cuuint64_t row = (cuuint64_t)w * 4;
  const cuuint64_t strides[3] = {row, row * h, row * h * f};
  const cuuint32_t box[4] = {SW_WS, SW_WS, 1, 1};
  return encode_f32(map, p, 4, dims, strides, box);
}

// ---------------------------------------------------------------- K7
//
// Replaces seervideoldm_tpu/ops/pallas/swat_attention.py::
// _swat_backward_tab (body _bwd_kernel_tab).  The TPU kernel held a
// window's fp32 score matrix and five fp32 (tokens, d) temporaries in VMEM;
// here the forward saves lse, one rotation pass (swat_bwd_rotate_kernel,
// tables) writes the rotated q and k once, and the two Hopper kernels of
// attn_bwd_hopper.cuh run over them unrotated, through the 5-D window maps
// of K1: the dq kernel's consumer owns one query frame of a window and
// visits key frames 0 .. that frame twice (delta = rowsum(p * dp), then
// dq); the dk/dv kernel's consumer owns one key frame and visits query
// frames from it to f - 1, so tiles above the causal diagonal are never
// touched.  dq and dk are de-rotated in the store epilogue with the
// adjoint t * cos - rotate_half(t) * sin (derotate_pair; one thread holds
// columns 2t, 2t + 1 of a row in the accumulator layout, one rotary pair),
// reading cos / sin once an output element.  dv is not rotated.
//
// What bounds it on an H100: at the training shape (8 x 12 x 32 x 32 x 40,
// ws 8, 768 tokens per window) the causal products are ~15 GFLOP (0.015
// ms) against ~50 MB (0.015 ms) and 37.8 M visible scores, p recomputed
// once each (one MUFU ex2, 0.009 ms).  The kernels run 78 of the 144
// window tiles, padded to 64 columns, with p and dS as hi + lo pairs and
// s and dp formed three times, as K8.
//
// ---------------------------------------------------------------- K9
//
// Replaces _swat_backward (body _bwd_kernel), the backward of K6: the same
// kernels, with no rotation pass and no adjoint for rot_dim 0 (q/k arrive
// rotated; dq and dk leave un-derotated and the caller's autograd through
// its pre-rotation supplies the adjoint, as the TPU kernel leaves it to
// XLA), or with the rotation pass and the adjoint from in-kernel fp32 trig
// (rot_dim > 0, as the TPU body does).  Same bound as K7.

template <int DPAD, int CWG, int DEROT>
__global__ void __launch_bounds__(128 * (CWG + 1), 1)
    swat_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tg,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const hab::Problem pb) {
  hab::dq_body<DPAD, CWG, true, DEROT>(&tq, &tg, &tk, &tv, pb);
}

template <int DPAD, int CWG, int DEROT>
__global__ void __launch_bounds__(128 * (CWG + 1), 1)
    swat_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tg,
                        const __grid_constant__ CUtensorMap tl,
                        const __grid_constant__ CUtensorMap td,
                        const hab::Problem pb) {
  hab::dkv_body<DPAD, CWG, true, DEROT>(&tk, &tv, &tq, &tg, &tl, &td, pb);
}

// The forward for one rotation mode, dispatched on the padded head width
// and the consumer warpgroups per CTA.
template <int ROT>
static int fwd(const void* q, const void* k, const void* v, const RotSrc& rs,
               void* o, void* lse, int batch, int f, int h, int w, int d,
               float scale, int causal, int cwg, void* stream) {
  const int dpad = hat::dpad_of(d);
  if (dpad < 0 || !hat::cwg_ok(dpad, cwg) || batch <= 0 || f <= 0) return -1;
  CUtensorMap tq{}, tk{}, tv{};
  if (!encode_windows(&tq, q, batch, f, h, w, d) ||
      !encode_windows(&tk, k, batch, f, h, w, d) ||
      !encode_windows(&tv, v, batch, f, h, w, d))
    return static_cast<int>(cudaErrorInvalidValue);
  hat::Problem pb{};
  pb.o = static_cast<bf16*>(o);
  pb.lse = static_cast<float*>(lse);
  pb.rs = rs;
  pb.rows = f * h * w;
  pb.kv_len = f * SW_WS * SW_WS;
  pb.d = d;
  pb.qtiles = pb.ktiles = f;
  pb.f = f;
  pb.h = h;
  pb.w = w;
  pb.causal = causal;
  pb.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((f + cwg - 1) / cwg, (h / SW_WS) * (w / SW_WS), batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVL_FWD(DP, CW)                                                    \
  if (dpad == DP && cwg == CW)                                             \
    return hat::launch<DP, CW, &swat_fwd_wgmma_kernel<DP, CW, ROT>>(       \
        grid, tq, tk, tv, pb, s);
  SVL_FWD(64, 2) SVL_FWD(64, 3) SVL_FWD(128, 2) SVL_FWD(128, 3)
  SVL_FWD(192, 2)
#undef SVL_FWD
  return -1;
}

// The backward for one rotation mode: the rotation pass into qr, kr (ROT
// != ROT_NONE), the dq kernel (delta first), then the dk/dv kernel, each
// dispatched on the padded head width and its consumer warpgroups.
template <int ROT>
static int bwd(const void* q, const void* k, const void* v, const RotSrc& rs,
               const void* g, const void* lse, void* qr, void* kr,
               void* delta, void* dq, void* dk, void* dv, int batch, int f,
               int h, int w, int d, float scale, int causal, int cwg_dq,
               int cwg_dkv, void* stream) {
  const int dpad = hab::dpad_of(d);
  if (dpad < 0 || (dk == nullptr) != (dv == nullptr) || batch <= 0 ||
      f <= 0 || !hab::cwg_ok(dpad, cwg_dq, false) ||
      (dk != nullptr && !hab::cwg_ok(dpad, cwg_dkv, true)))
    return -1;
  if (ROT != ROT_NONE && (qr == nullptr || kr == nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (ROT != ROT_NONE) {
    const int err = launch_rotate(swat_bwd_rotate_kernel<ROT>, q, k, rs, qr,
                                  kr, batch, f, h, w, d, s);
    if (err != 0) return err;
    q = qr;
    k = kr;
  }
  CUtensorMap tq{}, tk{}, tv{}, tg{}, tl{}, td{};
  if (!encode_windows(&tq, q, batch, f, h, w, d) ||
      !encode_windows(&tk, k, batch, f, h, w, d) ||
      !encode_windows(&tv, v, batch, f, h, w, d) ||
      !encode_windows(&tg, g, batch, f, h, w, d) ||
      !encode_window_scalars(&tl, lse, batch, f, h, w) ||
      !encode_window_scalars(&td, delta, batch, f, h, w))
    return -2;
  hab::Problem pb{};
  pb.lse = static_cast<const float*>(lse);
  pb.delta = static_cast<float*>(delta);
  pb.dq = static_cast<bf16*>(dq);
  pb.dk = static_cast<bf16*>(dk);
  pb.dv = static_cast<bf16*>(dv);
  pb.rs = rs;
  pb.n = pb.m = f * SW_WS * SW_WS;
  pb.d = d;
  pb.qtiles = pb.ktiles = f;
  pb.f = f;
  pb.h = h;
  pb.w = w;
  pb.windows = (h / SW_WS) * (w / SW_WS);
  pb.units = pb.windows * batch;
  pb.causal = causal;
  pb.scale = scale;
  pb.scale_log2 = scale * 1.4426950408889634f;
  int err = -1;
  const int dq_ctas = (f + cwg_dq - 1) / cwg_dq * pb.units;
#define SVL_DQ(DP, CW)                                                    \
  if (dpad == DP && cwg_dq == CW)                                         \
    err = hab::launch<DP, CW, false, &swat_bwd_dq_kernel<DP, CW, ROT>>(   \
        dq_ctas, pb, s, tq, tg, tk, tv);
  SVL_DQ(64, 2) SVL_DQ(64, 3) SVL_DQ(128, 2)
#undef SVL_DQ
  if (err != 0 || dk == nullptr) return err;
  const int dkv_ctas = (f + cwg_dkv - 1) / cwg_dkv * pb.units;
#define SVL_DKV(DP, CW)                                                   \
  if (dpad == DP && cwg_dkv == CW)                                        \
    err = hab::launch<DP, CW, true, &swat_bwd_dkv_kernel<DP, CW, ROT>>(   \
        dkv_ctas, pb, s, tk, tv, tq, tg, tl, td);
  SVL_DKV(64, 2) SVL_DKV(128, 2)
#undef SVL_DKV
  return err;
}

// Shapes every entry point covers: ws 8, h and w multiples of 8, d a
// multiple of 8 up to `max_d`; for K6/K9 an even rot_dim in [0, d].
static bool covered(int h, int w, int d, int ws, int max_d) {
  return ws == SW_WS && h % ws == 0 && w % ws == 0 && d > 0 && d % 8 == 0 &&
         d <= max_d;
}

static RotSrc tables(const void* cos_t, const void* sin_t) {
  return RotSrc{static_cast<const float*>(cos_t),
                static_cast<const float*>(sin_t), nullptr, 0};
}

static RotSrc trig(const void* inv_freq, int rot_dim) {
  return RotSrc{nullptr, nullptr, static_cast<const float*>(inv_freq),
                rot_dim};
}

}  // namespace svl

// K1: the rotation pass into qr, kr (scratch of q's shape), then the
// attention over qr, kr, v.  Returns 0 on success, a cudaError_t code after
// a failed launch, or -1 for a shape this build does not cover (ws != 8, h
// or w not a multiple of 8, d % 8 != 0 or d > 160, a cwg without an
// instantiation: hat::cwg_ok).  `lse` (batch, f, h, w) fp32 may be null:
// it is written only when a backward will need it.  `cwg`: consumer
// warpgroups per CTA, each one query frame of the window (ops/kernels/
// swat_attention.py::plan).
extern "C" int svl_swat_attention_tab_fwd(const void* q, const void* k,
                                          const void* v, const void* cos_t,
                                          const void* sin_t, void* qr,
                                          void* kr, void* o, void* lse,
                                          int batch, int f, int h, int w,
                                          int d, int ws, float scale,
                                          int causal, int cwg, void* stream) {
  if (!svl::covered(h, w, d, ws, 160)) return -1;
  const int err = svl::launch_rotate(
      svl::rotate_qk_kernel, q, k, svl::tables(cos_t, sin_t), qr, kr, batch,
      f, h, w, d, static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  return svl::fwd<svl::ROT_NONE>(qr, kr, v, svl::trig(nullptr, 0), o, lse,
                                 batch, f, h, w, d, scale, causal, cwg,
                                 stream);
}

// K6.  q/k/v/o (batch, f, h, w, d) bf16; rot_dim 0: q and k arrive rotated
// (inv_freq may be null); rot_dim > 0: `inv_freq` holds rot_dim / 2 fp32
// frequencies and q/k are rotated in the kernel at the positions of the
// (f, h, w) volume.  Returns as K1, and -1 for an odd rot_dim or one > d.
extern "C" int svl_swat_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* inv_freq,
                                      void* o, void* lse, int batch, int f,
                                      int h, int w, int d, int ws,
                                      int rot_dim, float scale, int causal,
                                      int cwg, void* stream) {
  if (!svl::covered(h, w, d, ws, 160)) return -1;
  if (rot_dim < 0 || rot_dim > d || rot_dim % 2 != 0) return -1;
  const svl::RotSrc rs = svl::trig(inv_freq, rot_dim);
  if (rot_dim == 0)
    return svl::fwd<svl::ROT_NONE>(q, k, v, rs, o, lse, batch, f, h, w, d,
                                   scale, causal, cwg, stream);
  return svl::fwd<svl::ROT_TRIG>(q, k, v, rs, o, lse, batch, f, h, w, d,
                                 scale, causal, cwg, stream);
}

// K7.  q/k/v/g/dq/dk/dv (batch, f, h, w, d) bf16, q and k UN-rotated;
// cos/sin (f, h, w, d) fp32; lse (batch, f, h, w) fp32 as the forward wrote
// it; delta the same shape, fp32 scratch; qr, kr scratch of q's shape (the
// rotated q and k).  dq may be null (the dq kernel then only forms delta);
// dk and dv are null together.  cwg_dq, cwg_dkv as K8's
// (svl_flash_attention_bwd).  Returns 0, a cudaError_t code, or -1 for a
// shape the backward does not cover (ws != 8, h or w not a multiple of 8,
// d % 8 != 0 or d > 80, a cwg without an instantiation), or -2 when
// cuTensorMapEncodeTiled refuses a map.
extern "C" int svl_swat_attention_tab_bwd(
    const void* q, const void* k, const void* v, const void* cos_t,
    const void* sin_t, const void* g, const void* lse, void* qr, void* kr,
    void* delta, void* dq, void* dk, void* dv, int batch, int f, int h, int w,
    int d, int ws, float scale, int causal, int cwg_dq, int cwg_dkv,
    void* stream) {
  if (!svl::covered(h, w, d, ws, svl::BWD_MAX_D)) return -1;
  return svl::bwd<svl::ROT_TABLES>(q, k, v, svl::tables(cos_t, sin_t), g, lse,
                                   qr, kr, delta, dq, dk, dv, batch, f, h, w,
                                   d, scale, causal, cwg_dq, cwg_dkv, stream);
}

// K9.  As K7 with the rotation of K6: rot_dim 0 takes rotated q/k and
// returns dq/dk un-derotated (qr, kr and inv_freq may be null); rot_dim > 0
// rotates q/k into qr, kr and de-rotates dq/dk from in-kernel trig over
// `inv_freq`.
extern "C" int svl_swat_attention_bwd(
    const void* q, const void* k, const void* v, const void* inv_freq,
    const void* g, const void* lse, void* qr, void* kr, void* delta, void* dq,
    void* dk, void* dv, int batch, int f, int h, int w, int d, int ws,
    int rot_dim, float scale, int causal, int cwg_dq, int cwg_dkv,
    void* stream) {
  if (!svl::covered(h, w, d, ws, svl::BWD_MAX_D)) return -1;
  if (rot_dim < 0 || rot_dim > d || rot_dim % 2 != 0) return -1;
  const svl::RotSrc rs = svl::trig(inv_freq, rot_dim);
  if (rot_dim == 0)
    return svl::bwd<svl::ROT_NONE>(q, k, v, rs, g, lse, qr, kr, delta, dq, dk,
                                   dv, batch, f, h, w, d, scale, causal,
                                   cwg_dq, cwg_dkv, stream);
  return svl::bwd<svl::ROT_TRIG>(q, k, v, rs, g, lse, qr, kr, delta, dq, dk,
                                 dv, batch, f, h, w, d, scale, causal, cwg_dq,
                                 cwg_dkv, stream);
}
