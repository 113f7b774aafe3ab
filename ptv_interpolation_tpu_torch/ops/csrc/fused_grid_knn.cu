// Fused τ-bisection weighted-sum kernel for regular grids (IDW / sibson).
//
// Replaces ptv_interpolation_tpu/ops/fused_grid_knn.py::_fused_kernel, the
// Pallas TPU kernel of the fused grid kNN path. Its wrapper and plain
// PyTorch version are _fused_eval and _fused_eval_plain in
// ptv_interpolation_tpu_torch/ops/fused_grid_knn.py.
//
// What it computes, for each grid node of one (block, sub-tile) row, over
// the block's compacted candidate panel of C slots:
//   d²       = ((qx-cx)² + (qy-cy)²) + (qz-cz)²
//   covered  = #{d² ≤ margin²} ≥ k
//   τ²       = 24 halvings of [0, margin²] on the count #{d² ≤ mid} < k
//   sel      = d² ≤ τ²  (squared domain: a mask taken after sqrt dropped the
//              k-th neighbour for 1.4% of queries)
//   w        = IDW 1/(dᵖ+ε) (p = 2: 1/(d·d+ε)), or sibson
//              (1/(d+ε))·exp(-(d-dmin)/(std+ε)) with the masked mean, a
//              two-pass ddof=0 std (the one-pass form cost two decades of
//              parity) and dmin (sentinel 3.4e38 → 0 when nothing is selected)
//   out[c]   = Σw·v_c / max(Σw, 1e-37) for the V channels,
//   out[V]   = covered ? Σw : 0, out[V+1..7] = 0.
//
// Layouts (those of the JAX package): cand is (8, n_blocks·C) f32 with rows
// x, y, z, v_0..v_{V-1}; empty slots hold 1e19 coordinates. qx/qy/qz are
// (n_blocks·n_sub, Bt) f32; out is (n_blocks·n_sub, 8, Bt) f32.
//
// Design. One CTA per (block, sub-tile) row, one thread per node (Bt ≤ 1024
// threads). The CTA stages its block's candidate coordinates once in
// dynamic shared memory as float4 (16·C bytes: 22 KB at C = 1408, 128 KB at
// the 8192 cap), then each thread makes about 28 passes over them — 1
// coverage, 24 bisection, 2 sibson statistics, 1 weights-and-sums — and
// recomputes d² on every pass instead of storing a (Bt, C) panel, which has
// no room on an SM. All threads of a warp read the same candidate at the
// same time, a shared-memory broadcast; τ and the statistics live in
// registers. The value rows are read only in the last pass, straight from
// global memory (the same address across the warp, served from cache).
//
// Bound: the fp32 subtract/multiply/add/compare issue rate of ~28·C passes
// per node, with one 16-byte shared load per candidate per pass — not HBM:
// each CTA reads its 12·C bytes of coordinates once.
//
// Bit-equal d². The products and sums use __fmul_rn/__fadd_rn/__fsub_rn, so
// nvcc does not contract them into FMAs; d² and τ² are then bit-equal to the
// plain PyTorch version on the same card and the bisection makes the same
// choices. Counts are integers. Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kBisectIters = 24;
constexpr float kEps = 1e-10f;
constexpr int kMaxV = 5;
constexpr int kIdw = 0;

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

__global__ void __launch_bounds__(1024)
fused_kernel(const float* __restrict__ cand, const float* __restrict__ qx_all,
             const float* __restrict__ qy_all,
             const float* __restrict__ qz_all, float* __restrict__ out,
             int n_blocks, int C, int n_sub, int k, int V, int mode,
             float power, float m2) {
  extern __shared__ float4 pts[];  // (C,): x, y, z, unused
  const int row = blockIdx.x;
  const int Bt = blockDim.x;
  const int t = threadIdx.x;
  const long long stride = static_cast<long long>(n_blocks) * C;
  const long long base = static_cast<long long>(row / n_sub) * C;

  for (int i = t; i < C; i += Bt) {
    pts[i] = make_float4(cand[base + i], cand[stride + base + i],
                         cand[2 * stride + base + i], 0.0f);
  }
  __syncthreads();

  const long long q = static_cast<long long>(row) * Bt + t;
  const float qx = qx_all[q];
  const float qy = qy_all[q];
  const float qz = qz_all[q];

  const bool covered = count_le(pts, C, qx, qy, qz, m2) >= k;

  float lo = 0.0f;
  float hi = m2;
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (count_le(pts, C, qx, qy, qz, mid) < k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const float tau2 = hi;

  float dmin = 0.0f;
  float std_eps = 0.0f;
  if (mode != kIdw) {
    float n_ok = 0.0f;
    float s1 = 0.0f;
    float dmn = 3.4e38f;
    for (int i = 0; i < C; ++i) {
      const float d2 = sq_dist(qx, qy, qz, pts[i]);
      if (d2 <= tau2) {
        const float d = __fsqrt_rn(fmaxf(d2, 0.0f));
        n_ok += 1.0f;
        s1 = __fadd_rn(s1, d);
        dmn = fminf(dmn, d);
      }
    }
    n_ok = fmaxf(n_ok, 1.0f);
    const float mean = __fdiv_rn(s1, n_ok);
    float ss = 0.0f;
    for (int i = 0; i < C; ++i) {
      const float d2 = sq_dist(qx, qy, qz, pts[i]);
      if (d2 <= tau2) {
        const float e = __fsub_rn(__fsqrt_rn(fmaxf(d2, 0.0f)), mean);
        ss = __fadd_rn(ss, __fmul_rn(e, e));
      }
    }
    std_eps = __fadd_rn(__fsqrt_rn(__fdiv_rn(ss, n_ok)), kEps);
    dmin = dmn > 1e18f ? 0.0f : dmn;
  }

  const float* vals = cand + 3 * stride + base;
  float den = 0.0f;
  float num[kMaxV];
#pragma unroll
  for (int c = 0; c < kMaxV; ++c) num[c] = 0.0f;
  for (int i = 0; i < C; ++i) {
    const float d2 = sq_dist(qx, qy, qz, pts[i]);
    if (d2 <= tau2) {
      const float d = __fsqrt_rn(fmaxf(d2, 0.0f));
      float w;
      if (mode == kIdw) {
        const float p = power == 2.0f ? __fmul_rn(d, d) : powf(d, power);
        w = __frcp_rn(__fadd_rn(p, kEps));
      } else {
        w = __fmul_rn(__frcp_rn(__fadd_rn(d, kEps)),
                      expf(__fdiv_rn(-__fsub_rn(d, dmin), std_eps)));
      }
      den = __fadd_rn(den, w);
#pragma unroll
      for (int c = 0; c < kMaxV; ++c) {
        if (c < V) num[c] = __fadd_rn(num[c], __fmul_rn(w, vals[c * stride + i]));
      }
    }
  }

  const float inv_den = __frcp_rn(fmaxf(den, 1e-37f));
  float* o = out + static_cast<long long>(row) * 8 * Bt + t;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float v = 0.0f;
    if (c < V && c < kMaxV) {
      v = __fmul_rn(num[c], inv_den);
    } else if (c == V) {
      v = covered ? den : 0.0f;
    }
    o[c * Bt] = v;
  }
}

}  // namespace

// Launches the kernel over n_blocks·n_sub CTAs of Bt threads on `stream`
// (a cudaStream_t). Returns the cudaError_t of the launch; 0 is success.
extern "C" int fused_grid_knn_launch(const float* cand, const float* qx,
                                     const float* qy, const float* qz,
                                     float* out, int n_blocks, int C,
                                     int n_sub, int Bt, int k, int V,
                                     int mode, float power, float m2,
                                     void* stream) {
  const size_t smem = static_cast<size_t>(C) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned n_rows = static_cast<unsigned>(n_blocks) * n_sub;
  fused_kernel<<<n_rows, Bt, smem, static_cast<cudaStream_t>(stream)>>>(
      cand, qx, qy, qz, out, n_blocks, C, n_sub, k, V, mode, power, m2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_grid_knn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
