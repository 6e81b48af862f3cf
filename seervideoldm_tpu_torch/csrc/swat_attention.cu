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
//
// Layout: q/k/v/o (B, f, h, w, d) bf16 contiguous, cos/sin (f, h, w, d)
// fp32 contiguous, ws = 8, h % 8 == w % 8 == 0, d a multiple of 8.
#include "attn_bwd_core.cuh"
#include "attn_fwd_hopper.cuh"

namespace svl {

template <int DPAD, int CWG, int ROT>
__global__ void __launch_bounds__(128 * (CWG + 1), 1)
    swat_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const hat::Problem pb) {
  hat::attn_fwd_body<DPAD, CWG, true, ROT>(&tq, &tk, &tv, pb);
}

// K1's rotation pass: qr = rot(q), kr = rot(k) over (B, f, h, w, d) with
// the (f, h, w, d) fp32 tables, t * cos + rotate_half(t) * sin in fp32 and
// rounded to bf16 (rotate_pair).  One thread takes 8 columns of one token
// (16-byte loads of q and k, 32-byte loads of each table), grid-stride.
__global__ void rotate_qk_kernel(const bf16* __restrict__ q,
                                 const bf16* __restrict__ k,
                                 const float* __restrict__ cos_t,
                                 const float* __restrict__ sin_t,
                                 bf16* __restrict__ qr, bf16* __restrict__ kr,
                                 long long vecs, long long vol_vecs) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < vecs; i += (long long)gridDim.x * blockDim.x) {
    const long long t = i % vol_vecs;  // the vector's place in the volume
    const float4* c4 = reinterpret_cast<const float4*>(cos_t) + 2 * t;
    const float4* s4 = reinterpret_cast<const float4*>(sin_t) + 2 * t;
    const float4 ca = c4[0], cb = c4[1], sa = s4[0], sb = s4[1];
    const float2 cs[4] = {{ca.x, ca.y}, {ca.z, ca.w}, {cb.x, cb.y}, {cb.z, cb.w}};
    const float2 sn[4] = {{sa.x, sa.y}, {sa.z, sa.w}, {sb.x, sb.y}, {sb.z, sb.w}};
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const uint4 u = reinterpret_cast<const uint4*>(which ? k : q)[i];
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
      uint32_t out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 x = __bfloat1622float2(e[j]);
        rotate_pair(x.x, x.y, cs[j], sn[j]);
        out[j] = pack_bf16x2(x.x, x.y);
      }
      reinterpret_cast<uint4*>(which ? kr : qr)[i] =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
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

// One frame of one window (64 tokens) into shared memory: as rows
// [64][DP + 8] when ROWS, transposed [DP][64 + 8] when TRANS, or both from
// one read.  ROT != ROT_NONE applies the rotation in fp32 and then rounds
// to bf16 (t * cos + rotate_half(t) * sin, interleaved pairs:
// rotate_half(t)[2i] = -t[2i+1], rotate_half(t)[2i+1] = t[2i]).  Columns
// >= d are zero.  A transposed-only load walks the tokens fastest, so that
// its shared-memory stores are contiguous.
template <int DP, int ROT, bool ROWS, bool TRANS>
__device__ __forceinline__ void load_window_frame(
    bf16* rows, bf16* trans, const bf16* src, const RotSrc& rs, int frame,
    int wy, int wx, int h, int w, int d) {
  constexpr int PPR = DP / 2;  // bf16 pairs per padded row
  constexpr bool TOKEN_FASTEST = TRANS && !ROWS;
  for (int i = threadIdx.x; i < ATT_BK * PPR; i += ATT_THREADS) {
    const int r = TOKEN_FASTEST ? i % ATT_BK : i / PPR;
    const int c = 2 * (TOKEN_FASTEST ? i / ATT_BK : i % PPR);
    float x0 = 0.f, x1 = 0.f;
    if (c < d) {
      const size_t tok = window_token(frame, wy, wx, r, h, w);
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(src + tok * d + c);
      x0 = __low2float(xv);
      x1 = __high2float(xv);
      if (ROT != ROT_NONE) {
        float2 cs, sn;
        rot_cs<ROT>(rs, tok, d, c, cs, sn);
        rotate_pair(x0, x1, cs, sn);
      }
    }
    const __nv_bfloat16 b0 = __float2bfloat16_rn(x0);
    const __nv_bfloat16 b1 = __float2bfloat16_rn(x1);
    if (ROWS)
      *reinterpret_cast<__nv_bfloat162*>(rows + r * (DP + 8) + c) =
          __halves2bfloat162(b0, b1);
    if (TRANS) {
      trans[c * (ATT_BK + 8) + r] = b0;
      trans[(c + 1) * (ATT_BK + 8) + r] = b1;
    }
  }
}

// ---------------------------------------------------------------- K7
//
// Replaces seervideoldm_tpu/ops/pallas/swat_attention.py::
// _swat_backward_tab (body _bwd_kernel_tab).  The TPU kernel held a
// window's fp32 score matrix and five fp32 (tokens, d) temporaries in VMEM;
// here the forward saves lse and the two tile kernels of attn_bwd_core.cuh
// run with the window gather of K1: q and k are rotated in fp32 on load and
// rounded to bf16, v and g are not rotated.  The dq kernel's CTA owns
// (query frame, window, batch*head) and visits key frames 0..fq twice
// (delta = rowsum(p * dp), then dq); the dk/dv
// kernel's CTA owns (key frame, window, batch*head) and visits query frames
// fk..f-1, so tiles above the causal diagonal are never touched.  Before
// the store dq and dk are de-rotated in fp32 with the adjoint
// t * cos - rotate_half(t) * sin (cos/sin are pair-constant); one thread
// holds columns 2t, 2t+1 of a row in the mma C layout, i.e. one rotary
// pair, so this needs no shuffle.  dv is not rotated.
//
// What bounds it on an H100: at the training shape (8 x 12 x 32 x 32 x 40,
// ws 8, 768 tokens per window) the causal work is ~15 GFLOP (0.015 ms)
// against ~50 MB (0.015 ms) and 37.8 M visible scores, p recomputed once
// each (one MUFU ex2, 0.009 ms).  As K8: mma.sync, p and dS as bf16 hi +
// lo pairs, a delta pass in the dq kernel.
//
// ---------------------------------------------------------------- K9
//
// Replaces _swat_backward (body _bwd_kernel), the backward of K6: the same
// two kernels with ROT = ROT_NONE (q/k arrive rotated; dq and dk leave
// un-derotated and the caller's autograd through its pre-rotation supplies
// the adjoint, as the TPU kernel leaves it to XLA) or ROT = ROT_TRIG (the
// rotation and its adjoint from in-kernel fp32 trig, as the TPU body does
// for rot_dim > 0).  Same bound as K7.

// The adjoint of the rotation on one pair (columns c, c + 1) of token
// `tok`: t * cos - rotate_half(t) * sin.
template <int ROT>
__device__ __forceinline__ void derotate_pair(const RotSrc& rs, size_t tok,
                                              int d, int c, float& v0,
                                              float& v1) {
  if (ROT == ROT_NONE) return;
  float2 cs, sn;
  rot_cs<ROT>(rs, tok, d, c, cs, sn);
  // rounded as the plain version's t * cos - rotate_half(t) * sin
  const float r0 = __fsub_rn(__fmul_rn(v0, cs.x), __fmul_rn(-v1, sn.x));
  const float r1 = __fsub_rn(__fmul_rn(v1, cs.y), __fmul_rn(v0, sn.y));
  v0 = r0;
  v1 = r1;
}

template <int DP, int ROT>
__global__ void __launch_bounds__(ATT_THREADS)
    swat_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ g,
                       const RotSrc rs, const float* __restrict__ lse,
                       float* __restrict__ delta, bf16* __restrict__ dq,
                       int f, int h, int w, int d, float scale,
                       float scale_log2, int causal) {
  __shared__ __align__(16) bf16 ks[ATT_BK * (DP + 8)];
  __shared__ __align__(16) bf16 kt[DP * (ATT_BK + 8)];
  __shared__ __align__(16) bf16 vs[ATT_BK * (DP + 8)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fq = blockIdx.x;
  const int wins_x = w / SW_WS;
  const int wy = blockIdx.y / wins_x, wx = blockIdx.y % wins_x;
  const size_t vol = (size_t)blockIdx.z * f * h * w;
  const size_t base = vol * d;

  load_window_frame<DP, ROT, true, false>(ks, nullptr, q + base, rs, fq, wy,
                                          wx, h, w, d);
  load_window_frame<DP, ROT_NONE, true, false>(vs, nullptr, g + base, rs, fq,
                                               wy, wx, h, w, d);
  __syncthreads();
  DqState<DP> st;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    load_a_frag(st.qf[kc], ks, DP + 8, warp * 16, kc * 16, lane);
    load_a_frag(st.gf[kc], vs, DP + 8, warp * 16, kc * 16, lane);
  }
  zero_acc<DP>(st.acc);
  size_t toks[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    toks[r] =
        vol + window_token(fq, wy, wx, warp * 16 + (lane >> 2) + 8 * r, h, w);
    st.lse[r] = bwd_lse(lse[toks[r]]);
  }

  constexpr int T = SW_WS * SW_WS;
  const int last = causal ? fq : f - 1;
  float dsum[2] = {0.f, 0.f};
  for (int fk = 0; fk <= last; ++fk) {
    __syncthreads();
    load_window_frame<DP, ROT, true, false>(ks, nullptr, k + base, rs, fk, wy,
                                            wx, h, w, d);
    load_window_frame<DP, ROT_NONE, true, false>(vs, nullptr, v + base, rs,
                                                 fk, wy, wx, h, w, d);
    __syncthreads();
    delta_tile<DP>(st, ks, vs, scale_log2, fq * T + warp * 16, fk * T, f * T,
                   causal != 0, lane, dsum);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.delta[r] = quad_sum(dsum[r]);
    if ((lane & 3) == 0) delta[toks[r]] = st.delta[r];
  }
  if (dq == nullptr) return;

  for (int fk = 0; fk <= last; ++fk) {
    __syncthreads();
    load_window_frame<DP, ROT, true, true>(ks, kt, k + base, rs, fk, wy, wx,
                                           h, w, d);
    load_window_frame<DP, ROT_NONE, true, false>(vs, nullptr, v + base, rs,
                                                 fk, wy, wx, h, w, d);
    __syncthreads();
    dq_tile<DP>(st, ks, kt, vs, scale, scale_log2, fq * T + warp * 16, fk * T,
                f * T, causal != 0, lane);
  }
  bf16* ob = dq + base;
  store_acc<DP>(
      st.acc, warp * 16, T, d,
      [&](int r) { return ob + window_token(fq, wy, wx, r, h, w) * d; },
      [&](int r, int c, float& v0, float& v1) {
        derotate_pair<ROT>(rs, window_token(fq, wy, wx, r, h, w), d, c, v0,
                           v1);
      },
      lane);
}

template <int DP, int ROT>
__global__ void __launch_bounds__(ATT_THREADS)
    swat_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        const RotSrc rs, const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int f,
                        int h, int w, int d, float scale, float scale_log2,
                        int causal) {
  __shared__ __align__(16) bf16 qs[ATT_BQ * (DP + 8)];
  __shared__ __align__(16) bf16 qt[DP * (ATT_BQ + 8)];
  __shared__ __align__(16) bf16 gs[ATT_BQ * (DP + 8)];
  __shared__ __align__(16) bf16 gt[DP * (ATT_BQ + 8)];
  __shared__ float lse_s[ATT_BQ];
  __shared__ float delta_s[ATT_BQ];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fk = blockIdx.x;
  const int wins_x = w / SW_WS;
  const int wy = blockIdx.y / wins_x, wx = blockIdx.y % wins_x;
  const size_t vol = (size_t)blockIdx.z * f * h * w;
  const size_t base = vol * d;

  load_window_frame<DP, ROT, true, false>(qs, nullptr, k + base, rs, fk, wy,
                                          wx, h, w, d);
  load_window_frame<DP, ROT_NONE, true, false>(gs, nullptr, v + base, rs, fk,
                                               wy, wx, h, w, d);
  __syncthreads();
  DkvState<DP> st;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    load_a_frag(st.kf[kc], qs, DP + 8, warp * 16, kc * 16, lane);
    load_a_frag(st.vf[kc], gs, DP + 8, warp * 16, kc * 16, lane);
  }
  zero_acc<DP>(st.dk);
  zero_acc<DP>(st.dv);

  constexpr int T = SW_WS * SW_WS;
  for (int fq = causal ? fk : 0; fq < f; ++fq) {
    __syncthreads();
    load_window_frame<DP, ROT, true, true>(qs, qt, q + base, rs, fq, wy, wx,
                                           h, w, d);
    load_window_frame<DP, ROT_NONE, true, true>(gs, gt, g + base, rs, fq, wy,
                                                wx, h, w, d);
    if (threadIdx.x < ATT_BQ) {
      const size_t tok = vol + window_token(fq, wy, wx, threadIdx.x, h, w);
      lse_s[threadIdx.x] = bwd_lse(lse[tok]);
      delta_s[threadIdx.x] = delta[tok];
    }
    __syncthreads();
    dkv_tile<DP>(st, qs, qt, gs, gt, lse_s, delta_s, scale, scale_log2,
                 fk * T + warp * 16, fq * T, f * T, causal != 0, lane);
  }
  bf16* dkb = dk + base;
  bf16* dvb = dv + base;
  store_acc<DP>(
      st.dk, warp * 16, T, d,
      [&](int r) { return dkb + window_token(fk, wy, wx, r, h, w) * d; },
      [&](int r, int c, float& v0, float& v1) {
        derotate_pair<ROT>(rs, window_token(fk, wy, wx, r, h, w), d, c, v0,
                           v1);
      },
      lane);
  store_acc<DP>(
      st.dv, warp * 16, T, d,
      [&](int r) { return dvb + window_token(fk, wy, wx, r, h, w) * d; },
      [](int, int, float&, float&) {}, lane);
}

template <int DP, int ROT>
static void launch_bwd(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* g, const RotSrc& rs, const float* lse,
                       float* delta, bf16* dq, bf16* dk, bf16* dv, int batch,
                       int f, int h, int w, int d, float scale,
                       float scale_log2, int causal, cudaStream_t stream) {
  dim3 grid(f, (h / SW_WS) * (w / SW_WS), batch);
  // always: its first pass writes delta
  swat_bwd_dq_kernel<DP, ROT><<<grid, ATT_THREADS, 0, stream>>>(
      q, k, v, g, rs, lse, delta, dq, f, h, w, d, scale, scale_log2, causal);
  if (dk != nullptr)
    swat_bwd_dkv_kernel<DP, ROT><<<grid, ATT_THREADS, 0, stream>>>(
        q, k, v, g, rs, lse, delta, dk, dv, f, h, w, d, scale, scale_log2,
        causal);
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

// The backward for one rotation mode: the dq kernel (delta first) and the
// dk/dv kernel, dispatched on the padded head width.
template <int ROT>
static int bwd(const void* q, const void* k, const void* v, const RotSrc& rs,
               const void* g, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int batch, int f, int h, int w, int d,
               float scale, int causal, void* stream) {
  if ((dk == nullptr) != (dv == nullptr)) return -1;
  const float scale_log2 = scale * 1.4426950408889634f;
  const bf16* gg = static_cast<const bf16*>(g);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
#define SVL_CASE(DPV)                                                        \
  case DPV:                                                                  \
    launch_bwd<DPV, ROT>(                                                    \
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),            \
        static_cast<const bf16*>(v), gg, rs, static_cast<const float*>(lse), \
        dl, static_cast<bf16*>(dq), static_cast<bf16*>(dk),                  \
        static_cast<bf16*>(dv), batch, f, h, w, d, scale, scale_log2,        \
        causal, s);                                                          \
    break;
    SVL_CASE(16) SVL_CASE(32) SVL_CASE(48) SVL_CASE(64) SVL_CASE(80)
#undef SVL_CASE
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
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
  using svl::bf16;
  if (!svl::covered(h, w, d, ws, 160)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long vol_vecs = (long long)f * h * w * d / 8;
  const long long vecs = vol_vecs * batch;
  const int threads = 256;
  const long long blocks = (vecs + threads - 1) / threads;
  svl::rotate_qk_kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16),
                          threads, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<bf16*>(qr), static_cast<bf16*>(kr), vecs, vol_vecs);
  const int err = static_cast<int>(cudaGetLastError());
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
// it; delta the same shape, fp32 scratch.  dq may be null (the dq kernel
// then only forms delta); dk and dv are null together.  Returns 0, a
// cudaError_t code, or -1 for a shape the backward does not cover (ws !=
// 8, h or w not a multiple of 8, d % 8 != 0 or d > 80).
extern "C" int svl_swat_attention_tab_bwd(
    const void* q, const void* k, const void* v, const void* cos_t,
    const void* sin_t, const void* g, const void* lse, void* delta, void* dq,
    void* dk, void* dv, int batch, int f, int h, int w, int d, int ws,
    float scale, int causal, void* stream) {
  if (!svl::covered(h, w, d, ws, svl::BWD_MAX_D)) return -1;
  return svl::bwd<svl::ROT_TABLES>(q, k, v, svl::tables(cos_t, sin_t), g, lse,
                                   delta, dq, dk, dv, batch, f, h, w, d,
                                   scale, causal, stream);
}

// K9.  As K7 with the rotation of K6: rot_dim 0 takes rotated q/k and
// returns dq/dk un-derotated; rot_dim > 0 rotates q/k and de-rotates dq/dk
// from in-kernel trig over `inv_freq`.
extern "C" int svl_swat_attention_bwd(
    const void* q, const void* k, const void* v, const void* inv_freq,
    const void* g, const void* lse, void* delta, void* dq, void* dk, void* dv,
    int batch, int f, int h, int w, int d, int ws, int rot_dim, float scale,
    int causal, void* stream) {
  if (!svl::covered(h, w, d, ws, svl::BWD_MAX_D)) return -1;
  if (rot_dim < 0 || rot_dim > d || rot_dim % 2 != 0) return -1;
  const svl::RotSrc rs = svl::trig(inv_freq, rot_dim);
  if (rot_dim == 0)
    return svl::bwd<svl::ROT_NONE>(q, k, v, rs, g, lse, delta, dq, dk, dv,
                                   batch, f, h, w, d, scale, causal, stream);
  return svl::bwd<svl::ROT_TRIG>(q, k, v, rs, g, lse, delta, dq, dk, dv,
                                 batch, f, h, w, d, scale, causal, stream);
}
