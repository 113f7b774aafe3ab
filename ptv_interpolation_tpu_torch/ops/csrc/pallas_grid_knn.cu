// One-phase τ-threshold weighted-sum kernel for regular grids (IDW / sibson)
// over a gapped candidate store.
//
// Replaces ptv_interpolation_tpu/ops/pallas_grid_knn.py::_kernel, the Pallas
// TPU kernel of backend='pallas'. Its wrapper and plain PyTorch version are
// _pallas_eval and _pallas_eval_plain in
// ptv_interpolation_tpu_torch/ops/pallas_grid_knn.py.
//
// What it computes, for each node of one grid block of B = bz·by·bx nodes,
// over the block's R windows of L store columns (C = R·L slots; window r
// starts at (starts[r] / 128)·128, a superset of the candidate row):
//   d²   = ((qx-cx)² + (qy-cy)²) + (qz-cz)²
//   hi   = max{d² : d² < 5e18}·1.000001 + 1e-30   (sentinels excluded)
//   τ²   = `iters` halvings of [0, hi]: #{d² ≤ mid} ≥ k → hi, else → lo
//          (k is not clamped to C; τ² stays hi when fewer than k exist)
//   sel  = d² ≤ τ²
//   w    = IDW 1/(d²+ε) at p = 2, 1/((d²)^(p/2)+ε) otherwise; or sibson
//          (1/(d+ε))·exp(-(d-dmin)/(std+ε)) with the selected set's mean,
//          a ONE-pass variance s2 − s1² (the TPU kernel's, kept) and dmin
//   out  = Σw·v_c / max(Σw, 1e-37) for c = u, v, w; out[3] = τ².
// Unselected slots are skipped, never multiplied by 0: for a node with
// nothing selected, exp(...) of an unselected slot is inf. An empty window
// set gives exactly 0.
//
// Layouts: store is (8, store_w) f32, rows x, y, z, u, v, w, 0, 0, with 1e19
// in every row of the gap columns. starts is (n, R) int32, ids (n,) int32
// flat block indices into the (nbz, nby, nbx) lattice; ax_x/ax_y/ax_z are
// the block-padded axes, from which each thread derives its node:
// (tz, ty, tx) = (t / (by·bx), (t / bx) % by, t % bx). out is (n, B, 4) f32.
//
// Design. One CTA per grid block, one thread per node. The CTA stages its
// slots' x, y, z and store column as float4 in dynamic shared memory — once
// when C fits the staged width (`chunk` slots, ≤ 14 336 = 224 KB), else
// chunk by chunk on every pass — and each thread makes iters + 2 (IDW) or
// iters + 3 (sibson) passes, recomputing d² each time instead of holding a
// (B, C) panel (6 144 slots × 128 nodes at the 1M → 256³ headline, 3 MB).
// All threads of a warp read the same slot together: a shared-memory
// broadcast. The value rows are read in the last pass only, and only for
// the selected slots, from global memory at the staged column.
//
// Bound: the fp32 subtract/multiply/add/compare issue rate of (iters + 3)·C
// slot visits per node; each CTA reads its 12·C bytes of coordinates from
// device memory once (or once per pass when chunked).
//
// Bit-equal d², hi, midpoints and τ² with the plain version: products and
// sums use __fmul_rn/__fadd_rn/__fsub_rn, so nvcc does not contract them
// into FMAs; counts are integers. Build without --use_fast_math. The sums
// over the selected slots (s1, s2, Σw, Σw·v) accumulate in f64 and round
// once to f32, as the plain version's do: the one-pass variance cancels,
// and f32 sums taken in two different orders would disagree by more than
// the kernel's tolerance. Only ~k of the C slots are selected, so the f64
// adds are few.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-10f;
constexpr float kHalfBig = 5e18f;  // d² at or above this is a sentinel's
constexpr int kIdw = 0;
constexpr int kMaxRows = 128;

struct Panel {
  float4* pts;             // (chunk,): x, y, z, store column as int bits
  const int* win;          // (R,) 128-aligned window starts
  const float* store;
  int store_w, L, C, chunk;
  bool staged_once;
};

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float4 c) {
  const float dx = __fsub_rn(qx, c.x);
  const float dy = __fsub_rn(qy, c.y);
  const float dz = __fsub_rn(qz, c.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Stages slots [c0, c0 + n) into shared memory; all threads take part.
__device__ void stage(const Panel& p, int c0, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s = c0 + i;
    const int r = s / p.L;
    const int j = p.win[r] + (s - r * p.L);
    const long long w = p.store_w;
    p.pts[i] = make_float4(p.store[j], p.store[w + j], p.store[2 * w + j],
                           __int_as_float(j));
  }
}

// Opens the chunk of slots starting at c0 and returns its length; restages
// when the panel does not fit the staged width. Every thread of the CTA
// calls it the same number of times (the loop bounds are uniform).
__device__ __forceinline__ int open_chunk(const Panel& p, int c0) {
  const int n = min(p.chunk, p.C - c0);
  if (!p.staged_once) {
    __syncthreads();
    stage(p, c0, n);
    __syncthreads();
  }
  return n;
}

__device__ int count_le(const Panel& p, float qx, float qy, float qz,
                        float t) {
  int cnt = 0;
  for (int c0 = 0; c0 < p.C; c0 += p.chunk) {
    const int n = open_chunk(p, c0);
#pragma unroll 4
    for (int i = 0; i < n; ++i) cnt += sq_dist(qx, qy, qz, p.pts[i]) <= t;
  }
  return cnt;
}

__global__ void __launch_bounds__(1024)
pallas_grid_knn_kernel(const int* __restrict__ starts,
                       const int* __restrict__ ids,
                       const float* __restrict__ ax_x,
                       const float* __restrict__ ax_y,
                       const float* __restrict__ ax_z,
                       const float* __restrict__ store,
                       float* __restrict__ out, int store_w, int R, int L,
                       int chunk, int by, int bx, int nby, int nbx, int k,
                       int mode, int iters, float power) {
  extern __shared__ float4 pts[];
  __shared__ int win[kMaxRows];
  const int row = blockIdx.x;
  const int B = blockDim.x;
  const int t = threadIdx.x;
  const int bz = B / (by * bx);

  const int ib = ids[row];
  const int ibz = ib / (nby * nbx);
  const int iby = (ib / nbx) % nby;
  const int ibx = ib % nbx;
  const float qx = ax_x[ibx * bx + t % bx];
  const float qy = ax_y[iby * by + (t / bx) % by];
  const float qz = ax_z[ibz * bz + t / (by * bx)];

  for (int r = t; r < R; r += B) {
    win[r] = (starts[static_cast<long long>(row) * R + r] / 128) * 128;
  }
  __syncthreads();

  Panel p{pts, win, store, store_w, L, R * L, chunk, chunk >= R * L};
  if (p.staged_once) {
    stage(p, 0, p.C);
    __syncthreads();
  }

  // upper bound: the farthest real slot of the windows
  float mx = 0.0f;
  for (int c0 = 0; c0 < p.C; c0 += p.chunk) {
    const int n = open_chunk(p, c0);
    for (int i = 0; i < n; ++i) {
      const float d2 = sq_dist(qx, qy, qz, p.pts[i]);
      if (d2 < kHalfBig) mx = fmaxf(mx, d2);
    }
  }
  float lo = 0.0f;
  float hi = __fadd_rn(__fmul_rn(mx, 1.000001f), 1e-30f);
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (count_le(p, qx, qy, qz, mid) >= k) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  const float tau2 = hi;

  float dmin = 0.0f;
  float std_eps = 0.0f;
  if (mode != kIdw) {
    float n_sel = 0.0f;
    double s1 = 0.0;
    double s2 = 0.0;
    float dmn = 1e19f;
    for (int c0 = 0; c0 < p.C; c0 += p.chunk) {
      const int n = open_chunk(p, c0);
      for (int i = 0; i < n; ++i) {
        const float d2 = sq_dist(qx, qy, qz, p.pts[i]);
        if (d2 <= tau2) {
          const float d = __fsqrt_rn(fmaxf(d2, 0.0f));
          n_sel += 1.0f;
          s1 += d;
          s2 += __fmul_rn(d, d);
          dmn = fminf(dmn, d);
        }
      }
    }
    n_sel = fmaxf(n_sel, 1.0f);
    const float m1 = __fdiv_rn(__double2float_rn(s1), n_sel);
    const float m2 = __fdiv_rn(__double2float_rn(s2), n_sel);
    const float var = fmaxf(__fsub_rn(m2, __fmul_rn(m1, m1)), 0.0f);
    std_eps = __fadd_rn(__fsqrt_rn(var), kEps);
    dmin = dmn;
  }

  double den = 0.0;
  double num[3] = {0.0, 0.0, 0.0};
  const float half_p = 0.5f * power;
  for (int c0 = 0; c0 < p.C; c0 += p.chunk) {
    const int n = open_chunk(p, c0);
    for (int i = 0; i < n; ++i) {
      const float4 c = p.pts[i];
      const float d2 = sq_dist(qx, qy, qz, c);
      if (d2 <= tau2) {
        float w;
        if (mode == kIdw) {
          const float pw = power == 2.0f ? d2 : powf(d2, half_p);
          w = __frcp_rn(__fadd_rn(pw, kEps));
        } else {
          const float d = __fsqrt_rn(fmaxf(d2, 0.0f));
          w = __fmul_rn(__frcp_rn(__fadd_rn(d, kEps)),
                        expf(__fdiv_rn(-__fsub_rn(d, dmin), std_eps)));
        }
        const int j = __float_as_int(c.w);
        den += w;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float v = store[(3 + ch) * static_cast<long long>(store_w) + j];
          num[ch] += __fmul_rn(w, v);
        }
      }
    }
  }

  const float den_c = fmaxf(__double2float_rn(den), 1e-37f);
  float* o = out + (static_cast<long long>(row) * B + t) * 4;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    o[ch] = __fdiv_rn(__double2float_rn(num[ch]), den_c);
  }
  o[3] = tau2;
}

}  // namespace

// Launches the kernel over n CTAs of B threads on `stream` (a cudaStream_t).
// Returns the cudaError_t of the launch; 0 is success.
extern "C" int pallas_grid_knn_launch(const int* starts, const int* ids,
                                      const float* ax_x, const float* ax_y,
                                      const float* ax_z, const float* store,
                                      float* out, int store_w, int n, int R,
                                      int L, int chunk, int B, int by, int bx,
                                      int nby, int nbx, int k, int mode,
                                      int iters, float power, void* stream) {
  if (R < 1 || R > kMaxRows || B < 1 || B > 1024 || B % (by * bx) != 0 ||
      chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(chunk) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      pallas_grid_knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pallas_grid_knn_kernel<<<static_cast<unsigned>(n), B, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      starts, ids, ax_x, ax_y, ax_z, store, out, store_w, R, L, chunk, by, bx,
      nby, nbx, k, mode, iters, power);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pallas_grid_knn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
