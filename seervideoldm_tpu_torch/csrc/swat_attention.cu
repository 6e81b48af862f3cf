// K1: fused SWAT windowed causal spatio-temporal attention with rotary
// tables; K6: the same kernel on pre-rotated q/k or with the rotation
// computed in the kernel; K7 and K9: their backward (dq, dk, dv).  The
// source of the rotation is a compile-time parameter (ROT below), so the
// four TPU kernels are two CUDA kernels' instantiations.
//
// Replaces seervideoldm_tpu/ops/pallas/swat_attention.py::
// swat_attention_tables (_swat_forward_tab, body _kernel_tab) and
// swat_attention (_swat_forward, body _kernel; rot_dim 0 is the production
// call on the sequence-parallel path, rot_dim > 0 rotates in the kernel).
// For every ws x ws spatial window across all f frames (f * ws^2 tokens,
// f-major: t = frame * ws^2 + row * ws + col) it rotates q and k in fp32,
// rounds them to bf16, and computes causal (key t <= query t over the
// flattened window) softmax attention.  The window is gathered from and
// written back to the (B, f, h, w, d) layout with strides, so no partition
// or reverse pass exists.
//
// What bounds it on an H100: at the 256px main-path shape (16 x 12 x 32 x
// 32 x 40, ws 8, 768 tokens per window) the causal work is ~12 GFLOP
// against ~67 MB of q/k/v/o/tables: tensor-core bound (~0.02 ms).  The TPU
// kernel held a window's whole fp32 score matrix (768^2 x 4 = 2.4 MB) in
// VMEM; shared memory cannot, so one CTA of 4 warps owns one query frame of
// one window (64 tokens) and streams the key frames 0..frame through shared
// memory with an online softmax: tiles wholly above the diagonal are never
// visited.  mma.sync m16n8k16; rotation is done once per tile load.  K6
// with rot_dim 0 reads no tables at all; with rot_dim > 0 it spends one
// sincosf per rotated pair on load instead of two table reads.
//
// Layout: q/k/v/o (B, f, h, w, d) bf16 contiguous, cos/sin (f, h, w, d)
// fp32 contiguous, ws = 8, h % 8 == w % 8 == 0, d a multiple of 8.
#include "attn_bwd_core.cuh"

namespace svl {

constexpr int SW_WS = 8;  // window side; ws^2 = 64 = ATT_BQ = ATT_BK

// Index, within one (f, h, w) volume, of token r (row-major in its ws x ws
// window) of window (wy, wx) in `frame`.
__device__ __forceinline__ size_t window_token(int frame, int wy, int wx,
                                               int r, int h, int w) {
  return ((size_t)frame * h + wy * SW_WS + r / SW_WS) * w + wx * SW_WS +
         r % SW_WS;
}

// The source of the rotation of q and k, a compile-time parameter of the
// loader and of every kernel below: ROT_NONE (v, g, or q/k that arrive
// rotated: K6/K9 with rot_dim = 0), ROT_TABLES (the fp32 cos/sin tables:
// K1/K7), ROT_TRIG (fp32 cos/sin computed from the token's position and the
// rotary frequencies: K6/K9 with rot_dim > 0).
constexpr int ROT_NONE = 0;
constexpr int ROT_TABLES = 1;
constexpr int ROT_TRIG = 2;

struct RotSrc {
  const float* cos_t;     // ROT_TABLES: (f, h, w, d)
  const float* sin_t;
  const float* inv_freq;  // ROT_TRIG: rot_dim / 2 fp32 frequencies
  int rot_dim;            // ROT_TRIG: lanes >= rot_dim pass through
};

// cos and sin of the rotation of the pair (columns c, c + 1) of token `tok`
// (its index in the (f, h, w) volume, which is also its rotary position
// frame * h * w + row * w + col).  ROT_TRIG forms the phase as one fp32
// product pos * inv_freq, as the plain version does, and takes the
// full-range sincosf (phases reach 1e4 rad).
template <int ROT>
__device__ __forceinline__ void rot_cs(const RotSrc& rs, size_t tok, int d,
                                       int c, float2& cs, float2& sn) {
  if (ROT == ROT_TABLES) {
    cs = *reinterpret_cast<const float2*>(rs.cos_t + tok * d + c);
    sn = *reinterpret_cast<const float2*>(rs.sin_t + tok * d + c);
  } else if (c < rs.rot_dim) {
    float s, co;
    sincosf((float)tok * rs.inv_freq[c >> 1], &s, &co);
    cs = make_float2(co, co);
    sn = make_float2(s, s);
  } else {
    cs = make_float2(1.f, 1.f);
    sn = make_float2(0.f, 0.f);
  }
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
        const float r0 = x0 * cs.x + (-x1) * sn.x;
        const float r1 = x1 * cs.y + x0 * sn.y;
        x0 = r0;
        x1 = r1;
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

template <int DP, int ROT>
__global__ void __launch_bounds__(ATT_THREADS)
    swat_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const RotSrc rs,
                    bf16* __restrict__ o, float* __restrict__ lse, int f,
                    int h, int w, int d, float scale_log2, int causal) {
  __shared__ __align__(16) bf16 ks[ATT_BK * (DP + 8)];
  __shared__ __align__(16) bf16 vt[DP * (ATT_BK + 8)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fq = blockIdx.x;
  const int wins_x = w / SW_WS;
  const int wy = blockIdx.y / wins_x, wx = blockIdx.y % wins_x;
  const size_t base = (size_t)blockIdx.z * f * h * w * d;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  load_window_frame<DP, ROT, true, false>(ks, nullptr, qb, rs, fq, wy, wx, h,
                                          w, d);
  __syncthreads();
  AttnState<DP> st;
  attn_init<DP>(st, ks, warp, lane);

  constexpr int T = SW_WS * SW_WS;
  const int last = causal ? fq : f - 1;
  for (int fk = 0; fk <= last; ++fk) {
    __syncthreads();
    load_window_frame<DP, ROT, true, false>(ks, nullptr, kb, rs, fk, wy, wx,
                                            h, w, d);
    load_window_frame<DP, ROT_NONE, false, true>(nullptr, vt, vb, rs, fk, wy,
                                                 wx, h, w, d);
    __syncthreads();
    attn_tile<DP>(st, ks, vt, scale_log2, fq * T + warp * 16, fk * T, f * T,
                  causal != 0, lane);
  }
  bf16* ob = o + base;
  float* lb = lse == nullptr ? nullptr : lse + (size_t)blockIdx.z * f * h * w;
  attn_store<DP>(
      st, warp * 16, T, d,
      [&](int r) { return ob + window_token(fq, wy, wx, r, h, w) * d; },
      [&](int r) {
        return lb == nullptr ? nullptr : lb + window_token(fq, wy, wx, r, h, w);
      },
      lane);
}

template <int DP, int ROT>
static void launch(const bf16* q, const bf16* k, const bf16* v,
                   const RotSrc& rs, bf16* o, float* lse, int batch, int f,
                   int h, int w, int d, float scale_log2, int causal,
                   cudaStream_t stream) {
  dim3 grid(f, (h / SW_WS) * (w / SW_WS), batch);
  swat_fwd_kernel<DP, ROT><<<grid, ATT_THREADS, 0, stream>>>(
      q, k, v, rs, o, lse, f, h, w, d, scale_log2, causal);
}

// ---------------------------------------------------------------- K7
//
// Replaces seervideoldm_tpu/ops/pallas/swat_attention.py::
// _swat_backward_tab (body _bwd_kernel_tab).  The TPU kernel held a
// window's fp32 score matrix and five fp32 (tokens, d) temporaries in VMEM;
// here the forward saves lse and the two tile kernels of attn_bwd_core.cuh
// run with the window gather of K1: q and k are rotated in fp32 on load and
// rounded to bf16, v and g are not rotated.  The dq kernel's CTA owns
// (query frame, window, batch*head) and visits key frames 0..fq; the dk/dv
// kernel's CTA owns (key frame, window, batch*head) and visits query frames
// fk..f-1, so tiles above the causal diagonal are never touched.  Before
// the store dq and dk are de-rotated in fp32 with the adjoint
// t * cos - rotate_half(t) * sin (cos/sin are pair-constant); one thread
// holds columns 2t, 2t+1 of a row in the mma C layout, i.e. one rotary
// pair, so this needs no shuffle.  dv is not rotated.
//
// What bounds it on an H100: at the training shape (8 x 12 x 32 x 32 x 40,
// ws 8, 768 tokens per window) the causal work is ~15 GFLOP against ~50 MB:
// tensor-core bound (~0.015 ms).
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
  const float r0 = v0 * cs.x + v1 * sn.x;
  const float r1 = v1 * cs.y - v0 * sn.y;
  v0 = r0;
  v1 = r1;
}

template <int DP, int ROT>
__global__ void __launch_bounds__(ATT_THREADS)
    swat_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ g,
                       const RotSrc rs, const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dq, int f, int h, int w, int d,
                       float scale, float scale_log2, int causal) {
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t tok =
        vol + window_token(fq, wy, wx, warp * 16 + (lane >> 2) + 8 * r, h, w);
    st.lse[r] = bwd_lse(lse[tok]);
    st.delta[r] = delta[tok];
  }

  constexpr int T = SW_WS * SW_WS;
  const int last = causal ? fq : f - 1;
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
                       const float* delta, bf16* dq, bf16* dk, bf16* dv,
                       int batch, int f, int h, int w, int d, float scale,
                       float scale_log2, int causal, cudaStream_t stream) {
  dim3 grid(f, (h / SW_WS) * (w / SW_WS), batch);
  if (dq != nullptr)
    swat_bwd_dq_kernel<DP, ROT><<<grid, ATT_THREADS, 0, stream>>>(
        q, k, v, g, rs, lse, delta, dq, f, h, w, d, scale, scale_log2, causal);
  if (dk != nullptr)
    swat_bwd_dkv_kernel<DP, ROT><<<grid, ATT_THREADS, 0, stream>>>(
        q, k, v, g, rs, lse, delta, dk, dv, f, h, w, d, scale, scale_log2,
        causal);
}

// The forward for one rotation mode, dispatched on the padded head width.
template <int ROT>
static int fwd(const void* q, const void* k, const void* v, const RotSrc& rs,
               void* o, void* lse, int batch, int f, int h, int w, int d,
               float scale, int causal, void* stream) {
  const float scale_log2 = scale * 1.4426950408889634f;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  float* ll = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
#define SVL_CASE(DPV)                                                     \
  case DPV:                                                               \
    launch<DPV, ROT>(qq, kk, vv, rs, oo, ll, batch, f, h, w, d,           \
                     scale_log2, causal, s);                              \
    break;
    SVL_CASE(16) SVL_CASE(32) SVL_CASE(48) SVL_CASE(64) SVL_CASE(80)
    SVL_CASE(96) SVL_CASE(112) SVL_CASE(128) SVL_CASE(144) SVL_CASE(160)
#undef SVL_CASE
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward for one rotation mode: the delta prologue, then the dq and
// dk/dv kernels, dispatched on the padded head width.
template <int ROT>
static int bwd(const void* q, const void* k, const void* v, const RotSrc& rs,
               const void* o, const void* g, const void* lse, void* delta,
               void* dq, void* dk, void* dv, int batch, int f, int h, int w,
               int d, float scale, int causal, void* stream) {
  if ((dk == nullptr) != (dv == nullptr)) return -1;
  const float scale_log2 = scale * 1.4426950408889634f;
  const bf16* gg = static_cast<const bf16*>(g);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_delta(gg, static_cast<const bf16*>(o), dl,
               (long long)batch * f * h * w, d, s);
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

// K1.  Returns 0 on success, a cudaError_t code after a failed launch, or
// -1 for a shape this build does not cover (ws != 8, h or w not a multiple
// of 8, d % 8 != 0 or d > 160).  `lse` (batch, f, h, w) fp32 may be null:
// it is written only when a backward will need it.
extern "C" int svl_swat_attention_tab_fwd(const void* q, const void* k,
                                          const void* v, const void* cos_t,
                                          const void* sin_t, void* o,
                                          void* lse, int batch, int f, int h,
                                          int w, int d, int ws, float scale,
                                          int causal, void* stream) {
  if (!svl::covered(h, w, d, ws, 160)) return -1;
  return svl::fwd<svl::ROT_TABLES>(q, k, v, svl::tables(cos_t, sin_t), o, lse,
                                   batch, f, h, w, d, scale, causal, stream);
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
                                      void* stream) {
  if (!svl::covered(h, w, d, ws, 160)) return -1;
  if (rot_dim < 0 || rot_dim > d || rot_dim % 2 != 0) return -1;
  const svl::RotSrc rs = svl::trig(inv_freq, rot_dim);
  if (rot_dim == 0)
    return svl::fwd<svl::ROT_NONE>(q, k, v, rs, o, lse, batch, f, h, w, d,
                                   scale, causal, stream);
  return svl::fwd<svl::ROT_TRIG>(q, k, v, rs, o, lse, batch, f, h, w, d,
                                 scale, causal, stream);
}

// K7.  q/k/v/o/g/dq/dk/dv (batch, f, h, w, d) bf16, q and k UN-rotated;
// cos/sin (f, h, w, d) fp32; lse (batch, f, h, w) fp32 as the forward wrote
// it; delta the same shape, fp32 scratch.  dq may be null; dk and dv are
// null together.  Returns 0, a cudaError_t code, or -1 for a shape the
// backward does not cover (ws != 8, h or w not a multiple of 8, d % 8 != 0
// or d > 80).
extern "C" int svl_swat_attention_tab_bwd(
    const void* q, const void* k, const void* v, const void* cos_t,
    const void* sin_t, const void* o, const void* g, const void* lse,
    void* delta, void* dq, void* dk, void* dv, int batch, int f, int h, int w,
    int d, int ws, float scale, int causal, void* stream) {
  if (!svl::covered(h, w, d, ws, svl::BWD_MAX_D)) return -1;
  return svl::bwd<svl::ROT_TABLES>(q, k, v, svl::tables(cos_t, sin_t), o, g,
                                   lse, delta, dq, dk, dv, batch, f, h, w, d,
                                   scale, causal, stream);
}

// K9.  As K7 with the rotation of K6: rot_dim 0 takes rotated q/k and
// returns dq/dk un-derotated; rot_dim > 0 rotates q/k and de-rotates dq/dk
// from in-kernel trig over `inv_freq`.
extern "C" int svl_swat_attention_bwd(
    const void* q, const void* k, const void* v, const void* inv_freq,
    const void* o, const void* g, const void* lse, void* delta, void* dq,
    void* dk, void* dv, int batch, int f, int h, int w, int d, int ws,
    int rot_dim, float scale, int causal, void* stream) {
  if (!svl::covered(h, w, d, ws, svl::BWD_MAX_D)) return -1;
  if (rot_dim < 0 || rot_dim > d || rot_dim % 2 != 0) return -1;
  const svl::RotSrc rs = svl::trig(inv_freq, rot_dim);
  if (rot_dim == 0)
    return svl::bwd<svl::ROT_NONE>(q, k, v, rs, o, g, lse, delta, dq, dk, dv,
                                   batch, f, h, w, d, scale, causal, stream);
  return svl::bwd<svl::ROT_TRIG>(q, k, v, rs, o, g, lse, delta, dq, dk, dv,
                                 batch, f, h, w, d, scale, causal, stream);
}
