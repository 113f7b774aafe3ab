// Fused kNN-MAD statistics kernel for the outlier filter.
//
// Replaces ptv_interpolation_tpu/ops/fused_mad.py::_mad_kernel, the Pallas
// TPU kernel of the fused panel MAD filter. Its wrapper and plain PyTorch
// version are _mad_eval and _mad_eval_plain in
// ptv_interpolation_tpu_torch/ops/fused_mad.py.
//
// What it computes, for each query (a point of the cloud) of one scatter
// block, over the block's compacted candidate panel of C slots, with
// k1 = k + 1 (the selection holds the query itself):
//   d²       = ((qx-cx)² + (qy-cy)²) + (qz-cz)²
//   covered  = #{d² ≤ m2} ≥ k1                      (m2 = margin²)
//   τ²       = 24 halvings of [0, m2] on #{d² ≤ mid} < k1
//   sel      = d² ≤ τ²
//   smax     = max(0, max speed over sel)          (bisection bound)
//   t_j(v)   = 24 halvings of [0, smax] on #{sel ∧ v ≤ mid} − [v₀ ≤ mid] < j
//              — the j-th smallest of the neighbour values v, self
//              excluded by subtracting the query's own indicator
//   med      = t at j = ⌈k/2⌉ (k odd), or the mean of j = k/2 and k/2+1
//   mad      = the same on |s − med|, own value |s₀ − med|
//   keep     = |s₀ − med| ≤ thr·(mad + 1e-6)
//   covered &= | |s₀ − med| − thr·(mad + 1e-6) | > 4(1+thr)·smax·2⁻²⁴
// Output rows (n_blocks, 8, Bt): keep + 2·covered; √τ² (+inf where
// qx ≥ 1e18, a padding slot); med; mad; zeros.
//
// Layouts: cand is (4, n_blocks·C) f32 with rows x, y, z, speed; empty
// slots hold 1e19 coordinates and speed 0. qx/qy/qz/qs are (n_blocks, Bt)
// f32; padding slots sit at 1e19 with speed 0: their d² to the sentinel
// candidates is 0, so they run harmlessly and are masked by row 1.
//
// Design. One CTA per (scatter block, sub-tile of ≤ 256 queries), one
// thread per query. The CTA stages its block's candidates once in dynamic
// shared memory as float4 (x, y, z, speed: 16·C bytes, 72 KB at C = 4608,
// 128 KB at the 8192 cap); every statistic lives in registers, and d² is
// recomputed on each pass, since no (Bt, C) panel fits on an SM. A query
// makes 1 + 24 + 1 passes for coverage, τ and smax, then 24 per order
// statistic: 48 + 48 more at even k, 24 + 24 at odd k (122 or 74 passes).
// All threads of a warp read the same candidate at once, a shared-memory
// broadcast.
//
// Bound: fp32 issue — ~12 operations per candidate per pass (3 sub, 3 mul,
// 2 add, 2 compare, select, add) over ~122·C candidates per query; HBM
// traffic is the panel's 16·C bytes per CTA, read once.
//
// Bit-equal decisions. Products and sums use __fmul_rn/__fadd_rn/__fsub_rn
// so that nvcc contracts nothing into FMAs: d², τ², the bisection
// midpoints and the decision bound are then bit-equal to the plain
// version, and counts are integers compared as floats as the Pallas kernel
// does. Build without --use_fast_math; sqrtf stays IEEE.

#include <cuda_runtime.h>

namespace {

constexpr int kBisect = 24;
constexpr float kRes = 5.9604644775390625e-08f;  // 2^-24
constexpr float kMadEps = 1e-6f;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float4 c) {
  const float dx = __fsub_rn(qx, c.x);
  const float dy = __fsub_rn(qy, c.y);
  const float dz = __fsub_rn(qz, c.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ int count_le(const float4* pts, int C, float qx,
                                        float qy, float qz, float t) {
  int n = 0;
  for (int i = 0; i < C; ++i) n += sq_dist(qx, qy, qz, pts[i]) <= t;
  return n;
}

// The j-th smallest neighbour value by 24 halvings of [0, smax]. With
// kShifted the counted values are |s − shift|, else the speeds s.
template <bool kShifted>
__device__ float order_stat(const float4* pts, int C, float qx, float qy,
                            float qz, float tau2, float own_val, float shift,
                            float jf, float smax) {
  float lo = 0.0f;
  float hi = smax;
  for (int it = 0; it < kBisect; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
    for (int i = 0; i < C; ++i) {
      const float4 p = pts[i];
      const float v = kShifted ? fabsf(__fsub_rn(p.w, shift)) : p.w;
      c += (sq_dist(qx, qy, qz, p) <= tau2) & (v <= mid);
    }
    c -= own_val <= mid;
    if (static_cast<float>(c) < jf) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return hi;
}

template <bool kShifted>
__device__ float middle_pair(const float4* pts, int C, float qx, float qy,
                             float qz, float tau2, float own_val, float shift,
                             int k, float smax) {
  const int jlo = (k + 1) / 2;
  const int jhi = k / 2 + 1;
  const float t_lo = order_stat<kShifted>(pts, C, qx, qy, qz, tau2, own_val,
                                          shift, static_cast<float>(jlo),
                                          smax);
  if (jlo == jhi) return t_lo;
  const float t_hi = order_stat<kShifted>(pts, C, qx, qy, qz, tau2, own_val,
                                          shift, static_cast<float>(jhi),
                                          smax);
  return __fmul_rn(0.5f, __fadd_rn(t_lo, t_hi));
}

__global__ void __launch_bounds__(256)
mad_kernel(const float* __restrict__ cand, const float* __restrict__ qx_all,
           const float* __restrict__ qy_all, const float* __restrict__ qz_all,
           const float* __restrict__ qs_all, float* __restrict__ out,
           int n_blocks, int C, int Bt, int n_sub, int k, float thr,
           float m2) {
  extern __shared__ float4 pts[];  // (C,): x, y, z, speed
  const int blk = blockIdx.x / n_sub;
  const int j = (blockIdx.x % n_sub) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(n_blocks) * C;
  const long long base = static_cast<long long>(blk) * C;

  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    pts[i] = make_float4(cand[base + i], cand[stride + base + i],
                         cand[2 * stride + base + i],
                         cand[3 * stride + base + i]);
  }
  __syncthreads();
  if (j >= Bt) return;  // the last sub-tile of a block may be partial

  const long long q = static_cast<long long>(blk) * Bt + j;
  const float qx = qx_all[q];
  const float qy = qy_all[q];
  const float qz = qz_all[q];
  const float own = qs_all[q];
  const float k1f = static_cast<float>(k + 1);

  bool covered = static_cast<float>(count_le(pts, C, qx, qy, qz, m2)) >= k1f;

  float lo = 0.0f;
  float hi = m2;
  for (int it = 0; it < kBisect; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (static_cast<float>(count_le(pts, C, qx, qy, qz, mid)) < k1f) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const float tau2 = hi;

  float smax = 0.0f;
  for (int i = 0; i < C; ++i) {
    const float4 p = pts[i];
    if (sq_dist(qx, qy, qz, p) <= tau2) smax = fmaxf(smax, p.w);
  }

  const float med = middle_pair<false>(pts, C, qx, qy, qz, tau2, own, 0.0f,
                                       k, smax);
  const float own_dev = fabsf(__fsub_rn(own, med));
  const float mad = middle_pair<true>(pts, C, qx, qy, qz, tau2, own_dev, med,
                                      k, smax);

  const float bound = __fmul_rn(thr, __fadd_rn(mad, kMadEps));
  const bool keep = own_dev <= bound;
  const float delta = __fmul_rn(__fmul_rn(4.0f, __fadd_rn(1.0f, thr)),
                                __fmul_rn(smax, kRes));
  covered = covered && (fabsf(__fsub_rn(own_dev, bound)) > delta);

  float* o = out + static_cast<long long>(blk) * 8 * Bt + j;
  o[0] = (keep ? 1.0f : 0.0f) + (covered ? 2.0f : 0.0f);
  o[Bt] = qx >= 1e18f ? __int_as_float(0x7f800000) : __fsqrt_rn(tau2);
  o[2 * Bt] = med;
  o[3 * Bt] = mad;
#pragma unroll
  for (int c = 4; c < 8; ++c) o[c * Bt] = 0.0f;
}

}  // namespace

// Launches the kernel over n_blocks·⌈Bt/sub⌉ CTAs of `sub` threads on
// `stream` (a cudaStream_t). Returns the cudaError_t of the launch; 0 is
// success.
extern "C" int fused_mad_launch(const float* cand, const float* qx,
                                const float* qy, const float* qz,
                                const float* qs, float* out, int n_blocks,
                                int C, int Bt, int sub, int k, float thr,
                                float m2, void* stream) {
  if (sub <= 0 || sub > 256) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(C) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      mad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_sub = (Bt + sub - 1) / sub;
  const unsigned n_ctas = static_cast<unsigned>(n_blocks) * n_sub;
  mad_kernel<<<n_ctas, sub, smem, static_cast<cudaStream_t>(stream)>>>(
      cand, qx, qy, qz, qs, out, n_blocks, C, Bt, n_sub, k, thr, m2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_mad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
