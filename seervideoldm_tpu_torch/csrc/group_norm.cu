// K11: GroupNorm (+ SiLU) over a channels-last tensor, two kernels launched
// back to back on one stream: a moments kernel and an apply kernel.
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA
// (seervideoldm_tpu/ops/norms.py::GroupNorm), which fused the fp32 chain on
// the TPU.  The port ran it as about 13 eager PyTorch kernels a norm (an
// fp32 copy, a strided var_mean, rsqrt, two repeat_interleave, the affine
// as two broadcast passes, the bf16 cast) and one more for the SiLU: ~36
// bytes of HBM traffic an element.  The UNet runs 77 GroupNorms a call, 45
// of them followed by SiLU.
//
// Function (ops/norms.py::group_norm_moments_plain, group_norm_apply_plain):
// x (B, N, C), N the product of the middle axes (frames x pixels of a video,
// pixels of an image); groups of C / groups neighbouring channels; per
// (b, group) the mean and biased variance over N x C / groups elements in
// fp32, rstd = 1 / sqrt(var + eps);
//   scale[c] = rstd * w[c],  shift[c] = b[c] - mean * scale[c],
//   y = round(x * scale + shift)             (a multiply and an add, as two
//                                             roundings: the plain chain's)
//   y = round(y / (1 + exp(-y)))             (SiLU, when asked, on the
//                                             rounded y: F.silu's formula)
// `round` is to bf16, the input's dtype (the port computes in bf16 on the
// card).
//
// Bound on an H100: HBM, 4 B an element (x read once, y written once);
// the UNet's largest norm at serving (98304 x 960 bf16, 189 MB read and
// 189 MB written) 0.113 ms at 3.35 TB/s.
//
// Design.  Each thread owns one fixed 8-channel chunk (one 16-byte vector)
// and walks down rows; a CTA is `rpi` row slices
// x C / 8 chunks (<= 512 threads), so neighbouring threads read
// neighbouring 16-byte vectors of a row.  A grid of (ctas per batch
// element, B) gives each CTA one contiguous range of rows of one batch
// element; the host picks ~2 CTAs per SM in all (ops/kernels/
// group_norm.py::plan), one resident wave.
//   moments: per-channel Welford sums (count, mean, M2) in registers over
//            the thread's rows, four 16-byte loads in flight; the CTA's
//            per-channel sums go to shared memory and one warp per group
//            merges them (Chan: the weighted mean first, then the M2s plus
//            the spread of the partial means about it), so a chunk of 8
//            that straddles two groups (C / groups of 4, 10, 20, 30, 60)
//            needs nothing special.  Each CTA writes its per-group partial
//            (n, mean, M2); the last CTA of each batch element (a
//            __threadfence, then an atomic ticket, reset by that CTA for
//            the next call) merges the partials the same way into mean and
//            rstd (B, groups) fp32.
//   apply:   the same grid and chunks; each thread computes its 8 scales
//            and shifts once, then walks its rows in the reverse of the
//            moments pass's order, so the rows read last by the moments
//            pass (the newest ~40 MB of the 50 MB L2) are read first: a
//            norm of up to ~40 MB reads x from HBM once.
#include <math.h>

#include "common.cuh"

namespace svl {
namespace gn {

constexpr int VEC = 8;            // channels a thread owns
constexpr int MAX_THREADS = 512;  // a CTA: rpi x C / VEC threads
constexpr int UNROLL = 4;         // rows in flight a thread

// one 16-byte vector: a chunk's VEC channels of one row
__device__ __forceinline__ uint4 load(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store(bf16* p, uint4 r) {
  *reinterpret_cast<uint4*>(p) = r;
}

__device__ __forceinline__ void to_float(uint4 r, float (&v)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 from_float(const float (&v)[VEC]) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j)
    h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One thread's place: its chunk's first channel, its row slice and the
// CTA's row range [r0, r1) of batch element blockIdx.y.
struct Place {
  int ch, slice, r0, r1;
  __device__ Place(int n, int c) {
    const int chunks = c / VEC;
    ch = (threadIdx.x % chunks) * VEC;
    slice = threadIdx.x / chunks;
    const int rows = (n + gridDim.x - 1) / gridDim.x;
    r0 = blockIdx.x * rows;
    r1 = min(n, r0 + rows);
  }
};

// Weighted mean and M2 of `count` partials (n_k, mean_k, M2_k) read through
// get(k) by one warp: Chan's merge, the weighted mean first, then
// sum M2_k + n_k (mean_k - mean)^2.  Returns (n, mean, M2) on every lane.
template <typename Get>
__device__ __forceinline__ float3 warp_merge(int count, int lane, Get get) {
  float sn = 0.f, sm = 0.f;
  for (int k = lane; k < count; k += 32) {
    const float3 p = get(k);
    sn += p.x;
    sm += p.x * p.y;
  }
  sn = warp_sum(sn);
  sm = warp_sum(sm);
  const float mu = sn > 0.f ? sm / sn : 0.f;
  float sq = 0.f;
  for (int k = lane; k < count; k += 32) {
    const float3 p = get(k);
    const float d = p.y - mu;
    sq += p.z + p.x * d * d;
  }
  return make_float3(sn, mu, warp_sum(sq));
}

__global__ void __launch_bounds__(MAX_THREADS, 2)
moments_kernel(const bf16* __restrict__ x, int n, int c, int groups, int rpi,
               float eps, float* __restrict__ part,
               unsigned* __restrict__ ticket, float* __restrict__ mean,
               float* __restrict__ rstd) {
  extern __shared__ float smem[];  // [rpi][c] means, [rpi][c] M2s, [rpi] n
  float* s_mean = smem;
  float* s_m2 = smem + rpi * c;
  float* s_n = smem + 2 * rpi * c;
  __shared__ int last;
  const Place at(n, c);
  const int b = blockIdx.y, per_b = gridDim.x;
  const bf16* base = x + (size_t)b * n * c + at.ch;

  // Welford over this thread's rows: one reciprocal of the count a row
  // serves all 8 channels
  float m[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) m[j] = q[j] = 0.f;
  int cnt = 0;
  auto update = [&](uint4 raw) {
    float v[VEC];
    to_float(raw, v);
    ++cnt;
    const float inv = 1.f / (float)cnt;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = v[j] - m[j];
      m[j] = fmaf(d, inv, m[j]);
      q[j] = fmaf(d, v[j] - m[j], q[j]);
    }
  };
  int r = at.r0 + at.slice;
  for (; r + (UNROLL - 1) * rpi < at.r1; r += UNROLL * rpi) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      raw[u] = load(base + (size_t)(r + u * rpi) * c);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) update(raw[u]);
  }
  for (; r < at.r1; r += rpi) update(load(base + (size_t)r * c));
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s_mean[at.slice * c + at.ch + j] = m[j];
    s_m2[at.slice * c + at.ch + j] = q[j];
  }
  if (at.ch == 0) s_n[at.slice] = (float)cnt;
  __syncthreads();

  // the CTA's partial of each group: one warp a group over its
  // (c / groups) x rpi per-channel sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // (a CTA whose size is no multiple of 32 leaves its last, partial warp
  // out of the merges: the shuffles take whole warps)
  const int warps = blockDim.x >> 5, gc = c / groups;
  const int merge_groups = warp < warps ? groups : 0;
  float* p_n = part;
  float* p_mean = part + (size_t)gridDim.y * per_b * groups;
  float* p_m2 = p_mean + (size_t)gridDim.y * per_b * groups;
  for (int g = warp; g < merge_groups; g += warps) {
    const float3 t = warp_merge(gc * rpi, lane, [&](int e) {
      const int s = e / gc, i = s * c + g * gc + e % gc;
      return make_float3(s_n[s], s_mean[i], s_m2[i]);
    });
    if (lane == 0) {
      const size_t i = ((size_t)b * per_b + blockIdx.x) * groups + g;
      p_n[i] = t.x;
      p_mean[i] = t.y;
      p_m2[i] = t.z;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&ticket[b], 1u) == (unsigned)per_b - 1;
  __syncthreads();
  if (!last) return;

  // the last CTA of batch element b: every CTA's partials, read past L1
  __threadfence();
  for (int g = warp; g < merge_groups; g += warps) {
    const float3 t = warp_merge(per_b, lane, [&](int k) {
      const size_t i = ((size_t)b * per_b + k) * groups + g;
      return make_float3(__ldcg(p_n + i), __ldcg(p_mean + i), __ldcg(p_m2 + i));
    });
    if (lane == 0) {
      mean[b * groups + g] = t.y;
      rstd[b * groups + g] = 1.f / sqrtf(t.z / t.x + eps);
    }
  }
  if (threadIdx.x == 0) ticket[b] = 0u;
}

template <bool SILU>
__global__ void __launch_bounds__(MAX_THREADS, 2)
apply_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int n, int c,
             int groups, int rpi, const float* __restrict__ mean,
             const float* __restrict__ rstd, const float* __restrict__ weight,
             const float* __restrict__ bias) {
  const Place at(n, c);
  const int b = blockIdx.y, gc = c / groups;
  float scale[VEC], shift[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int ch = at.ch + j, g = b * groups + ch / gc;
    scale[j] = __fmul_rn(rstd[g], weight[ch]);
    shift[j] = __fsub_rn(bias[ch], __fmul_rn(mean[g], scale[j]));
  }
  const size_t off = (size_t)b * n * c + at.ch;
  const bf16* src = x + off;
  bf16* dst = y + off;
  auto row = [&](uint4 raw) {
    float v[VEC];
    to_float(raw, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float t = bf16r(__fadd_rn(__fmul_rn(v[j], scale[j]), shift[j]));
      if constexpr (SILU) t = bf16r(t / (1.f + expf(-t)));
      v[j] = t;
    }
    return from_float(v);
  };
  const int first = at.r0 + at.slice;
  if (first >= at.r1) return;
  // this slice's rows are first + k rpi, k < rows; walked from the last
  int k = (at.r1 - 1 - first) / rpi;
  for (; k >= UNROLL - 1; k -= UNROLL) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      raw[u] = load(src + (size_t)(first + (k - u) * rpi) * c);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      store(dst + (size_t)(first + (k - u) * rpi) * c, row(raw[u]));
  }
  for (; k >= 0; --k) {
    const size_t at_row = (size_t)(first + k * rpi) * c;
    store(dst + at_row, row(load(src + at_row)));
  }
}

// The launch shape both kernels share, or false for arguments they do not
// take.
inline bool shape(int b, int n, int c, int groups, int rpi, int per_b,
                  dim3* grid, dim3* block) {
  if (b < 1 || b > 65535 || n < 1 || c < VEC || c % VEC || groups < 1 ||
      c % groups || rpi < 1 || per_b < 1 || per_b > n)
    return false;
  const int threads = rpi * (c / VEC);
  if (threads < 32 || threads > MAX_THREADS) return false;
  *grid = dim3(per_b, b);
  *block = dim3(threads);
  return true;
}

}  // namespace gn
}  // namespace svl

// x (b, n, c) bf16, contiguous, 16-byte aligned; part (3, b * per_b *
// groups) fp32 scratch; ticket (b) uint32, zero before the call and zero
// again after it; mean, rstd (b, groups) fp32.  Returns 0, a cudaError_t
// code, or -1 for arguments the kernel does not take.
extern "C" int svl_group_norm_moments(const void* x, int b, int n, int c,
                                      int groups, int rpi, int per_b,
                                      float eps, void* part, void* ticket,
                                      void* mean, void* rstd, void* stream) {
  using namespace svl::gn;
  dim3 grid, block;
  if (!shape(b, n, c, groups, rpi, per_b, &grid, &block)) return -1;
  const size_t smem = sizeof(float) * (2 * (size_t)rpi * c + rpi);
  moments_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const svl::bf16*>(x), n, c, groups, rpi, eps,
      static_cast<float*>(part), static_cast<unsigned*>(ticket),
      static_cast<float*>(mean), static_cast<float*>(rstd));
  return static_cast<int>(cudaGetLastError());
}

// y like x; mean, rstd (b, groups) fp32; weight, bias (c) fp32; silu 0 / 1.
extern "C" int svl_group_norm_apply(const void* x, void* y, int b, int n,
                                    int c, int groups, int rpi, int per_b,
                                    const void* mean, const void* rstd,
                                    const void* weight, const void* bias,
                                    int silu, void* stream) {
  using namespace svl::gn;
  dim3 grid, block;
  if (!shape(b, n, c, groups, rpi, per_b, &grid, &block)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const svl::bf16* xp = static_cast<const svl::bf16*>(x);
  svl::bf16* yp = static_cast<svl::bf16*>(y);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  const float* w = static_cast<const float*>(weight);
  const float* bb = static_cast<const float*>(bias);
  if (silu)
    apply_kernel<true><<<grid, block, 0, s>>>(xp, yp, n, c, groups, rpi, mu,
                                              rs, w, bb);
  else
    apply_kernel<false><<<grid, block, 0, s>>>(xp, yp, n, c, groups, rpi, mu,
                                               rs, w, bb);
  return static_cast<int>(cudaGetLastError());
}
