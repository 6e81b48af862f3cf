// K1: fused SWAT windowed causal spatio-temporal attention with rotary
// tables.
//
// Replaces seervideoldm_tpu/ops/pallas/swat_attention.py::
// swat_attention_tables (_swat_forward_tab, body _kernel_tab).  For every
// ws x ws spatial window across all f frames (f * ws^2 tokens, f-major:
// t = frame * ws^2 + row * ws + col) it rotates q and k from the fp32
// cos/sin tables in fp32, rounds them to bf16, and computes causal
// (key t <= query t over the flattened window) softmax attention.  The
// window is gathered from and written back to the (B, f, h, w, d) layout
// with strides, so no partition or reverse pass exists.
//
// What bounds it on an H100: at the 256px main-path shape (16 x 12 x 32 x
// 32 x 40, ws 8, 768 tokens per window) the causal work is ~12 GFLOP
// against ~67 MB of q/k/v/o/tables: tensor-core bound (~0.02 ms).  The TPU
// kernel held a window's whole fp32 score matrix (768^2 x 4 = 2.4 MB) in
// VMEM; shared memory cannot, so one CTA of 4 warps owns one query frame of
// one window (64 tokens) and streams the key frames 0..frame through shared
// memory with an online softmax: tiles wholly above the diagonal are never
// visited.  mma.sync m16n8k16; rotation is done once per tile load.
//
// Layout: q/k/v/o (B, f, h, w, d) bf16 contiguous, cos/sin (f, h, w, d)
// fp32 contiguous, ws = 8, h % 8 == w % 8 == 0, d a multiple of 8.
#include "attn_core.cuh"

namespace svl {

constexpr int SW_WS = 8;  // window side; ws^2 = 64 = ATT_BQ = ATT_BK

// One frame of one window (64 tokens) into a tile.  rotate: apply the
// table rotation in fp32 then round to bf16 (t * cos + rotate_half(t) *
// sin, interleaved pairs: rotate_half(t)[2i] = -t[2i+1],
// rotate_half(t)[2i+1] = t[2i]).  transpose: store [DP][64] instead of
// [64][DP].  Columns >= d are zero.
template <int DP, bool ROTATE, bool TRANSPOSE>
__device__ __forceinline__ void load_window_frame(
    bf16* dst, const bf16* src, const float* cos_t, const float* sin_t,
    int frame, int wy, int wx, int h, int w, int d) {
  constexpr int PPR = DP / 2;  // bf16 pairs per padded row
  for (int i = threadIdx.x; i < ATT_BK * PPR; i += ATT_THREADS) {
    const int r = TRANSPOSE ? i % ATT_BK : i / PPR;
    const int p = TRANSPOSE ? i / ATT_BK : i % PPR;
    const int c = 2 * p;
    float x0 = 0.f, x1 = 0.f;
    if (c < d) {
      const size_t tok = ((size_t)frame * h + wy * SW_WS + r / SW_WS) * w +
                         wx * SW_WS + r % SW_WS;
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(src + tok * d + c);
      x0 = __low2float(xv);
      x1 = __high2float(xv);
      if (ROTATE) {
        const float2 cs = *reinterpret_cast<const float2*>(cos_t + tok * d + c);
        const float2 sn = *reinterpret_cast<const float2*>(sin_t + tok * d + c);
        const float r0 = x0 * cs.x + (-x1) * sn.x;
        const float r1 = x1 * cs.y + x0 * sn.y;
        x0 = r0;
        x1 = r1;
      }
    }
    const __nv_bfloat16 b0 = __float2bfloat16_rn(x0);
    const __nv_bfloat16 b1 = __float2bfloat16_rn(x1);
    if (TRANSPOSE) {
      dst[c * (ATT_BK + 8) + r] = b0;
      dst[(c + 1) * (ATT_BK + 8) + r] = b1;
    } else {
      *reinterpret_cast<__nv_bfloat162*>(dst + r * (DP + 8) + c) =
          __halves2bfloat162(b0, b1);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(ATT_THREADS)
    swat_tab_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t, bf16* __restrict__ o,
                        int f, int h, int w, int d, float scale_log2,
                        int causal) {
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

  load_window_frame<DP, true, false>(ks, qb, cos_t, sin_t, fq, wy, wx, h, w, d);
  __syncthreads();
  AttnState<DP> st;
  attn_init<DP>(st, ks, warp, lane);

  constexpr int T = SW_WS * SW_WS;
  const int last = causal ? fq : f - 1;
  for (int fk = 0; fk <= last; ++fk) {
    __syncthreads();
    load_window_frame<DP, true, false>(ks, kb, cos_t, sin_t, fk, wy, wx, h, w, d);
    load_window_frame<DP, false, true>(vt, vb, nullptr, nullptr, fk, wy, wx, h, w, d);
    __syncthreads();
    attn_tile<DP>(st, ks, vt, scale_log2, fq * T + warp * 16, fk * T, f * T,
                  causal != 0, lane);
  }
  bf16* ob = o + base;
  attn_store<DP>(
      st, warp * 16, T, d,
      [&](int r) {
        const size_t tok = ((size_t)fq * h + wy * SW_WS + r / SW_WS) * w +
                           wx * SW_WS + r % SW_WS;
        return ob + tok * d;
      },
      lane);
}

template <int DP>
static void launch(const bf16* q, const bf16* k, const bf16* v,
                   const float* cs, const float* sn, bf16* o, int batch,
                   int f, int h, int w, int d, float scale_log2, int causal,
                   cudaStream_t stream) {
  dim3 grid(f, (h / SW_WS) * (w / SW_WS), batch);
  swat_tab_fwd_kernel<DP><<<grid, ATT_THREADS, 0, stream>>>(
      q, k, v, cs, sn, o, f, h, w, d, scale_log2, causal);
}

}  // namespace svl

// Returns 0 on success, a cudaError_t code after a failed launch, or -1 for
// a shape this build does not cover (ws != 8, h or w not a multiple of 8,
// d % 8 != 0 or d > 160).
extern "C" int svl_swat_attention_tab_fwd(const void* q, const void* k,
                                          const void* v, const void* cos_t,
                                          const void* sin_t, void* o,
                                          int batch, int f, int h, int w,
                                          int d, int ws, float scale,
                                          int causal, void* stream) {
  using svl::bf16;
  if (ws != svl::SW_WS || h % ws != 0 || w % ws != 0) return -1;
  if (d <= 0 || d % 8 != 0 || d > 160) return -1;
  const float scale_log2 = scale * 1.4426950408889634f;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const float* cs = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  bf16* oo = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
#define SVL_CASE(DPV)                                                       \
  case DPV:                                                                 \
    svl::launch<DPV>(qq, kk, vv, cs, sn, oo, batch, f, h, w, d, scale_log2, \
                     causal, s);                                            \
    break;
    SVL_CASE(16) SVL_CASE(32) SVL_CASE(48) SVL_CASE(64) SVL_CASE(80)
    SVL_CASE(96) SVL_CASE(112) SVL_CASE(128) SVL_CASE(144) SVL_CASE(160)
#undef SVL_CASE
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
