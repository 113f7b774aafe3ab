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
//   out[V]   = covered ? Σw : 0, out[V+1..7] = 0;
//   tau2[q]  = τ² when the caller passes a tau2 array (tests), else nothing.
//
// Layouts (those of the JAX package): cand is (8, n_blocks·C) f32 with rows
// x, y, z, v_0..v_{V-1}; empty slots hold 1e19 coordinates. qx/qy/qz are
// (n_blocks·n_sub, Bt) f32; out is (n_blocks·n_sub, 8, Bt) f32.
//
// Bound (NVIDIA H100 80GB HBM3, 700.00 W: its published peaks). A candidate
// beyond the margin counts toward no coverage, halving or sum, so the
// function needs the d² of the (node, candidate) pairs within the margin
// only: at the headline (16 384 blocks × 1 024 nodes,
// C = 1 920 slots, ~1 570 real candidates per block) 146 per node, 2.4e9
// pairs of 8 fp32 operations, 0.58 ms at 33.5e12/s (the 67 TFLOP/s peak
// counts an FMA as two, and these operations are not fused); the bytes
// (the panel's x, y, z, u, v, w once, the queries, the output: 1.5 GB)
// take 0.45 ms at 3.35 TB/s (chip_smoke.py phase 3 reckons both). So it
// is bound by fp32 issue, and the design's aim is to evaluate each d² as
// few times as it can, and as few d² beyond the margin as it can.
//
// Design. One CTA per (block, sub-tile) row, one thread per node. The CTA
// stages its block's coordinates once in dynamic shared memory as float4
// (16·C bytes) with the bounding box of every chunk of 32 slots (C bytes).
// Each thread then makes two passes over the panel and runs everything
// else on a shortlist of its own:
//   pass A  d² of every slot, counted against the coverage bound and the
//           15 midpoints of the first 4 halvings at once: the midpoints are
//           the same f32 values the sequential loop forms down each branch
//           (0.5·(lo+hi) with __fmul_rn/__fadd_rn), so walking the tree
//           with the 16 counts lands on the (lo, hi] the loop reaches after
//           4 steps, and gives #{d² ≤ hi};
//   pass B  d² again, writing the slot index (u16) of every slot with
//           d² ≤ hi, in slot order, to the thread's list in shared memory
//           (capacity S, planned by the wrapper as k + 32, stored
//           column-major so that the threads of a warp hit distinct
//           banks), and the open ones among them (lo < d² ≤ hi; the
//           settled ones, d² ≤ lo, are selected whatever comes next) once
//           more in the entries left at the list's tail;
//   list    the last 20 halvings (5 more tree visits) over the open slots
//           only, ~5 at the headline, with the settled ones counted once
//           (every count is exact: every slot with d² ≤ hi is listed);
//           then the sibson statistics and the weighted sums over the
//           ~k + 5 listed slots instead of C, in slot order as the
//           all-slot passes summed them before: the values do not change.
// Both passes skip a chunk whose box lies beyond the bound (margin², then
// hi) for every node of the warp: the gap to a box, squared and summed in
// d²'s op order, is never above the d² of a slot inside it, so no slot
// that could count is skipped; the panel is in cell order, so its chunks
// are compact and many lie beyond the margin of all of a warp's 32 nodes
// (the sentinel tail of a block's panel always does). When #{d² ≤ hi} > S
// (ties, duplicated points, a coarse interval), or the wrapper planned
// S = 0 because no list fits beside the panel, the thread runs the same
// steps over all C slots instead — the same result — and adds one to
// *overflow. Passes over the panel: 2 (and
// 5 visits of the open slots and 3 of the list), against ~28 before
// (1 coverage, 24 halvings, 2 statistics, 1 sums).
//
// Bit-equal d². The products and sums use __fmul_rn/__fadd_rn/__fsub_rn, so
// nvcc does not contract them into FMAs; d² and τ² are then bit-equal to the
// plain PyTorch version on the same card and the bisection makes the same
// choices. Counts are integers. Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kBisectIters = 24;
constexpr int kLevels = 4;                  // halvings resolved per visit
constexpr int kNodes = 1 << kLevels;        // tree heap 1..15; [0] is hi
constexpr float kEps = 1e-10f;
constexpr int kMaxV = 5;
constexpr int kIdw = 0;
constexpr int kChunk = 32;                  // panel slots per cull box
static_assert(kBisectIters % kLevels == 0, "whole tree visits");

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float4 c) {
  const float dx = __fsub_rn(qx, c.x);
  const float dy = __fsub_rn(qy, c.y);
  const float dz = __fsub_rn(qz, c.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The slots a thread visits: n entries of a shortlist at stride `stride`,
// or, with list == nullptr, every slot 0..n-1 of the panel, in chunks of
// kChunk slots with their bounding boxes (lo, hi corners) in `boxes`.
struct Slots {
  const unsigned short* list;
  int n;
  int stride;
  const float4* boxes;
  __device__ __forceinline__ int at(int e) const {
    return list != nullptr ? static_cast<int>(list[e * stride]) : e;
  }
};

// d² from a query to a staged candidate, and a lower bound of it over a
// box: the gap beyond the box on each axis, squared and summed in d²'s op
// order, which rounding (monotone) keeps at or below the d² of every slot
// inside.
struct Dist2 {
  const float4* pts;
  float qx, qy, qz;
  __device__ __forceinline__ float operator()(int i) const {
    return sq_dist(qx, qy, qz, pts[i]);
  }
  __device__ __forceinline__ float gap2(float4 lo, float4 hi) const {
    const float gx = fmaxf(fmaxf(__fsub_rn(lo.x, qx), __fsub_rn(qx, hi.x)),
                           0.0f);
    const float gy = fmaxf(fmaxf(__fsub_rn(lo.y, qy), __fsub_rn(qy, hi.y)),
                           0.0f);
    const float gz = fmaxf(fmaxf(__fsub_rn(lo.z, qz), __fsub_rn(qz, hi.z)),
                           0.0f);
    return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                     __fmul_rn(gz, gz));
  }
};

// Adds one to the count of every tree midpoint t[n] ≥ v. Every midpoint
// lies at or below hi = t[0]: a d² above it counts nowhere, and the branch
// skips the tally.
__device__ __forceinline__ void tally(float v, const float (&t)[kNodes],
                                      int (&c)[kNodes]) {
  if (v <= t[0]) {
#pragma unroll
    for (int n = 0; n < kNodes; ++n) c[n] += (v <= t[n]) ? 1 : 0;
  }
}

// kLevels halvings of [lo, hi] on #{d² ≤ mid} < k from one visit: counts
// at every midpoint of the halving tree (the midpoints the sequential loop
// would form down each branch), then the walk down it. `base` slots not
// visited lie at d² ≤ lo and count at every midpoint. Returns the count at
// the entry hi; n_hi becomes the count at the exit hi.
__device__ __forceinline__ int halve(const Slots& slots, const Dist2& d2,
                                     int base, int k, float& lo, float& hi,
                                     int& n_hi) {
  float t[kNodes];
  float l[kNodes];
  float h[kNodes];
  t[0] = hi;
  l[1] = lo;
  h[1] = hi;
#pragma unroll
  for (int n = 1; n < kNodes; ++n) {
    if (n > 1) {
      const int p = n >> 1;
      l[n] = (n & 1) ? t[p] : l[p];
      h[n] = (n & 1) ? h[p] : t[p];
    }
    t[n] = __fmul_rn(0.5f, __fadd_rn(l[n], h[n]));
  }
  int c[kNodes];
#pragma unroll
  for (int n = 0; n < kNodes; ++n) c[n] = base;
  if (slots.list != nullptr) {
    for (int e = 0; e < slots.n; ++e) tally(d2(slots.at(e)), t, c);
  } else {
    // a chunk whose box lies beyond hi is skipped whole (by the warp when
    // all its nodes skip it)
    for (int i0 = 0, ch = 0; i0 < slots.n; i0 += kChunk, ++ch) {
      if (d2.gap2(slots.boxes[2 * ch], slots.boxes[2 * ch + 1]) > t[0]) {
        continue;
      }
      const int i1 = min(i0 + kChunk, slots.n);
      for (int i = i0; i < i1; ++i) tally(d2(i), t, c);
    }
  }
  // the walk: a child's heap index exceeds its parent's, so one pass over
  // the nodes in heap order meets the path's nodes in turn (constant
  // indices only: the arrays stay in registers)
  n_hi = c[0];
  int node = 1;
#pragma unroll
  for (int n = 1; n < kNodes; ++n) {
    if (n == node) {
      if (c[n] < k) {
        lo = t[n];
        node = 2 * n + 1;
      } else {
        hi = t[n];
        n_hi = c[n];
        node = 2 * n;
      }
    }
  }
  return c[0];
}

// kThreads/kMinBlocks bound the registers: 256-thread sub-tiles (the
// wrapper's usual Bt) get up to 85 registers, so that 3 CTAs share an SM;
// wider sub-tiles, up to 1 024 threads, get 64.
template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_kernel(const float* __restrict__ cand, const float* __restrict__ qx_all,
             const float* __restrict__ qy_all,
             const float* __restrict__ qz_all, float* __restrict__ out,
             float* __restrict__ tau2_out, int* __restrict__ overflow,
             int n_blocks, int C, int n_sub, int k, int V, int mode,
             float power, float m2, int S) {
  // dynamic shared memory: the panel (C float4: x, y, z, unused), the
  // chunks' boxes (2 float4 each), then the shortlists
  extern __shared__ float4 pts[];
  const int n_chunks = (C + kChunk - 1) / kChunk;
  float4* boxes = pts + C;
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
  for (int ch = t; ch < n_chunks; ch += Bt) {
    float4 lo = pts[ch * kChunk];
    float4 hi = lo;
    for (int i = ch * kChunk + 1; i < min(ch * kChunk + kChunk, C); ++i) {
      const float4 p = pts[i];
      lo = make_float4(fminf(lo.x, p.x), fminf(lo.y, p.y), fminf(lo.z, p.z),
                       0.0f);
      hi = make_float4(fmaxf(hi.x, p.x), fmaxf(hi.y, p.y), fmaxf(hi.z, p.z),
                       0.0f);
    }
    boxes[2 * ch] = lo;
    boxes[2 * ch + 1] = hi;
  }
  __syncthreads();

  const long long q = static_cast<long long>(row) * Bt + t;
  const Dist2 d2_at{pts, qx_all[q], qy_all[q], qz_all[q]};

  // pass A: coverage and the first kLevels halvings
  const Slots panel{nullptr, C, 0, boxes};
  float lo = 0.0f;
  float hi = m2;
  int n_hi = 0;
  const bool covered = halve(panel, d2_at, 0, k, lo, hi, n_hi) >= k;

  // pass B: the shortlist of every slot with d² ≤ hi, in slot order from
  // the list's head; and, in the S − n_hi entries left at its tail, the
  // open ones among them (lo < d² ≤ hi: the settled ones, d² ≤ lo, are
  // selected whatever the later halvings do)
  Slots listed = panel;
  Slots open = panel;
  int n_settled = 0;
  if (S > 0 && n_hi <= S) {
    unsigned short* list =
        reinterpret_cast<unsigned short*>(boxes + 2 * n_chunks) + t;
    int n = 0;
    int n_open = 0;
    bool open_fits = true;
    for (int i0 = 0, ch = 0; i0 < C; i0 += kChunk, ++ch) {
      if (d2_at.gap2(boxes[2 * ch], boxes[2 * ch + 1]) > hi) continue;
      const int i1 = min(i0 + kChunk, C);
      for (int i = i0; i < i1; ++i) {
        const float d2 = d2_at(i);
        if (d2 <= hi && n < n_hi) {
          list[(n++) * Bt] = static_cast<unsigned short>(i);
          if (d2 > lo) {
            if (n_open < S - n_hi) {
              list[(S - 1 - n_open++) * Bt] = static_cast<unsigned short>(i);
            } else {
              open_fits = false;
            }
          }
        }
      }
    }
    listed = Slots{list, n, Bt, nullptr};
    if (open_fits) {
      open = Slots{list + (S - n_open) * Bt, n_open, Bt, nullptr};
      n_settled = n - n_open;
    } else {
      open = listed;
    }
  } else if (overflow != nullptr) {
    atomicAdd(overflow, 1);
  }

  // the other halvings visit only the open slots (~k/10 at the headline)
  for (int it = kLevels; it < kBisectIters; it += kLevels) {
    halve(open, d2_at, n_settled, k, lo, hi, n_hi);
  }
  const float tau2 = hi;
  if (tau2_out != nullptr) tau2_out[q] = tau2;

  float dmin = 0.0f;
  float std_eps = 0.0f;
  if (mode != kIdw) {
    float n_ok = 0.0f;
    float s1 = 0.0f;
    float dmn = 3.4e38f;
    for (int e = 0; e < listed.n; ++e) {
      const float d2 = d2_at(listed.at(e));
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
    for (int e = 0; e < listed.n; ++e) {
      const float d2 = d2_at(listed.at(e));
      if (d2 <= tau2) {
        const float dev = __fsub_rn(__fsqrt_rn(fmaxf(d2, 0.0f)), mean);
        ss = __fadd_rn(ss, __fmul_rn(dev, dev));
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
  for (int e = 0; e < listed.n; ++e) {
    const int i = listed.at(e);
    const float d2 = d2_at(i);
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
// (a cudaStream_t), with 16·C + 32·⌈C/32⌉ + 2·S·Bt bytes of dynamic shared
// memory (the panel, the chunks' boxes and a u16 shortlist of S entries
// per thread; S = 0: no lists).
// tau2 (n_blocks·n_sub·Bt f32) and overflow (one int, incremented once per
// thread that ran over the whole panel) may be null. Returns the
// cudaError_t of the launch; 0 is success.
extern "C" int fused_grid_knn_launch(const float* cand, const float* qx,
                                     const float* qy, const float* qz,
                                     float* out, float* tau2, int* overflow,
                                     int n_blocks, int C, int n_sub, int Bt,
                                     int k, int V, int mode, float power,
                                     float m2, int S, void* stream) {
  if (C > 65536 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n_chunks = (static_cast<size_t>(C) + kChunk - 1) / kChunk;
  const size_t smem = (C + 2 * n_chunks) * sizeof(float4) +
                      static_cast<size_t>(S) * Bt * sizeof(unsigned short);
  auto kernel = Bt <= 256 ? fused_kernel<256, 3> : fused_kernel<1024, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned n_rows = static_cast<unsigned>(n_blocks) * n_sub;
  kernel<<<n_rows, Bt, smem, static_cast<cudaStream_t>(stream)>>>(
      cand, qx, qy, qz, out, tau2, overflow, n_blocks, C, n_sub, k, V, mode,
      power, m2, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_grid_knn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
