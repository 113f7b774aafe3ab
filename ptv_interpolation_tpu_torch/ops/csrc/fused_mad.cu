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
// Bound (NVIDIA H100 80GB HBM3, 700.00 W: its published peaks). A candidate
// beyond the margin counts toward no coverage, halving or statistic, so
// the function needs the d² of the (real query, candidate) pairs within
// the margin only: at the production panel
// (1 935 blocks × 512 query slots × C = 4 608; 648 700 real queries) 212
// per query, 1.4e8 pairs of 8 unfused fp32 operations, 0.033 ms at
// 33.5e12/s; the panel (143 MB), the queries and the output (48 MB) take
// 0.057 ms at 3.35 TB/s (chip_smoke.py phase 5 reckons both). So the
// bound is the bytes; each thread still forms the d² of all ~3 600 real
// slots of its block's panel, and the design's aim is to form each of
// them as few times as it can.
//
// Design. One CTA per (scatter block, sub-tile of ≤ 256 queries), one
// thread per query. The CTA stages its block's candidates once in dynamic
// shared memory as float4 (x, y, z, speed: 16·C bytes, 72 KB at C = 4 608).
// Each thread then makes two passes over the C slots and runs everything
// else on a shortlist of its own:
//   pass A  d² of every slot, counted against m2 and the 15 midpoints of
//           the first 4 τ halvings at once (the same f32 midpoints the
//           sequential loop forms down each branch; a d² above m2 counts
//           nowhere and skips the tally), then a walk down the tree to the
//           (lo, hi] the loop reaches after 4 steps;
//   pass B  d² again, appending the slot index (u16) of every slot with
//           d² ≤ hi to the thread's list in shared memory (capacity S,
//           planned by the wrapper as k1 + 32, column-major so that the
//           threads of a warp hit distinct banks);
//   list    the last 20 τ halvings (5 tree visits, exact counts: every
//           slot with d² ≤ hi is listed), then one visit that keeps only
//           the selected entries (d² ≤ τ², exactly k1 of them but for
//           ties), smax, and the 2 or 4 order statistics, each 24 halvings
//           in 6 tree visits of ~k1 speeds instead of 24 passes over C.
// Bisections stay bisections: the plain version and the JAX kernel return
// bisection grid points, not exact order statistics. When
// #{d² ≤ hi} > S (ties, duplicated points), or the wrapper planned S = 0
// because no list fits beside the panel, the thread runs the same steps
// over all C slots — the same result — and, for a real query, adds one to
// *overflow. Padding slots always take that path (their d² to every
// sentinel slot ties at 0) and stay cheap: ≥ k1 ties at d² = 0 leave only
// hi to move, and a selection of zero speeds makes every order statistic
// +0 with no visit. Passes over C: 2, against 122 (even k) or 74 (odd k)
// before.
//
// Bit-equal decisions. Products and sums use __fmul_rn/__fadd_rn/__fsub_rn
// so that nvcc contracts nothing into FMAs: d², τ², the bisection
// midpoints and the decision bound are then bit-equal to the plain
// version, and counts are integers. Build without --use_fast_math; sqrtf
// stays IEEE.

#include <cuda_runtime.h>

namespace {

constexpr int kBisect = 24;
constexpr int kLevels = 4;                  // halvings resolved per visit
constexpr int kNodes = 1 << kLevels;        // tree heap 1..15; [0] is hi
constexpr float kRes = 5.9604644775390625e-08f;  // 2^-24
constexpr float kMadEps = 1e-6f;
static_assert(kBisect % kLevels == 0, "whole tree visits");

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float4 c) {
  const float dx = __fsub_rn(qx, c.x);
  const float dy = __fsub_rn(qy, c.y);
  const float dz = __fsub_rn(qz, c.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The slots a thread visits: its shortlist (n entries at stride `stride`)
// or, with list == nullptr, every slot 0..n-1 of the panel.
struct Slots {
  unsigned short* list;
  int n;
  int stride;
  __device__ __forceinline__ int at(int e) const {
    return list != nullptr ? static_cast<int>(list[e * stride]) : e;
  }
};

// d² from a query to a staged candidate.
struct Dist2 {
  const float4* pts;
  float qx, qy, qz;
  __device__ __forceinline__ float operator()(int i) const {
    return sq_dist(qx, qy, qz, pts[i]);
  }
};

// kLevels halvings of [lo, hi] on #{v ≤ mid} − [self ≤ mid] < k over the
// values value(i) of the visited slots, from one visit: counts at every
// midpoint of the halving tree (the midpoints the sequential loop would
// form down each branch), then the walk down it. Returns the count at the
// entry hi; n_lo becomes the count at the entry lo, n_hi the count at the
// exit hi.
template <class Value>
__device__ __forceinline__ int halve(const Slots& slots, const Value& value,
                                     int k, float self, float& lo, float& hi,
                                     int& n_lo, int& n_hi) {
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
  // every midpoint and lo lie at or below hi = t[0]: a value above it
  // counts nowhere, and the branch skips the tally (most panel slots lie
  // beyond the margin of every node of a warp)
  const float lo0 = lo;
  int c_lo = (self <= lo0) ? -1 : 0;
  int c[kNodes];
#pragma unroll
  for (int n = 0; n < kNodes; ++n) c[n] = (self <= t[n]) ? -1 : 0;
  for (int e = 0; e < slots.n; ++e) {
    const float v = value(slots.at(e));
    if (v <= t[0]) {
      c_lo += (v <= lo0) ? 1 : 0;
#pragma unroll
      for (int n = 0; n < kNodes; ++n) c[n] += (v <= t[n]) ? 1 : 0;
    }
  }
  n_lo = c_lo;
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

// The halvings `done`..kBisect-1 of [lo, hi] on #{v ≤ mid} − [self ≤ mid]
// < k: tree visits of the values, until ≥ k of them lie at ≤ lo (ties
// there, such as slots at the query itself): every later midpoint then
// keeps the count ≥ k, so only hi moves and no visit is needed. n_lo < 0:
// the count at lo is not known yet.
template <class Value>
__device__ __forceinline__ void bisect(const Slots& slots, const Value& value,
                                       int k, float self, int done, float& lo,
                                       float& hi, int& n_lo, int& n_hi) {
  while (done < kBisect) {
    if (n_lo >= k) {
      hi = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      ++done;
    } else {
      halve(slots, value, k, self, lo, hi, n_lo, n_hi);
      done += kLevels;
    }
  }
}

// A selected neighbour's speed (kShifted: |speed − shift|), and +inf for
// a slot outside the selection, which no midpoint (≤ smax) counts.
template <bool kShifted>
struct SelectedValue {
  Dist2 d2;
  float tau2;
  bool all_selected;  // the visited slots are the selection itself
  float shift;
  __device__ __forceinline__ float operator()(int i) const {
    const float s = d2.pts[i].w;
    const float v = kShifted ? fabsf(__fsub_rn(s, shift)) : s;
    return (all_selected || d2(i) <= tau2) ? v : __int_as_float(0x7f800000);
  }
};

// The j-th smallest value (self excluded) by 24 halvings of [0, smax].
// Every midpoint of [+0, +0] is +0: a query whose selection has no speed
// above 0 (a padding slot among sentinels) needs no visit.
template <class Value>
__device__ __forceinline__ float order_stat(const Slots& slots,
                                            const Value& value, int j,
                                            float self, float smax) {
  if (__float_as_int(smax) == 0) return smax;
  float lo = 0.0f;
  float hi = smax;
  int n_lo = -1;
  int n_hi = 0;
  bisect(slots, value, j, self, 0, lo, hi, n_lo, n_hi);
  return hi;
}

// np.median of the k neighbour values: the middle order statistic, or the
// mean of the two middle ones at even k.
template <class Value>
__device__ __forceinline__ float middle_pair(const Slots& slots,
                                             const Value& value, float self,
                                             int k, float smax) {
  const int jlo = (k + 1) / 2;
  const int jhi = k / 2 + 1;
  const float t_lo = order_stat(slots, value, jlo, self, smax);
  if (jlo == jhi) return t_lo;
  const float t_hi = order_stat(slots, value, jhi, self, smax);
  return __fmul_rn(0.5f, __fadd_rn(t_lo, t_hi));
}

// Up to 128 registers: 2 CTAs of 256 threads share an SM at the
// production panel's 104 KB of shared memory.
__global__ void __launch_bounds__(256, 2)
mad_kernel(const float* __restrict__ cand, const float* __restrict__ qx_all,
           const float* __restrict__ qy_all, const float* __restrict__ qz_all,
           const float* __restrict__ qs_all, float* __restrict__ out,
           int* __restrict__ overflow, int n_blocks, int C, int Bt, int n_sub,
           int k, float thr, float m2, int S) {
  extern __shared__ float4 pts[];  // (C,): x, y, z, speed; then the lists
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
  const Dist2 d2_at{pts, qx, qy_all[q], qz_all[q]};
  const float own = qs_all[q];
  const int k1 = k + 1;
  const float no_self = __int_as_float(0x7f800000);  // +inf: never counted

  // pass A: coverage and the first kLevels τ halvings
  Slots slots{nullptr, C, 0};
  float lo = 0.0f;
  float hi = m2;
  int n_lo = 0;
  int n_hi = 0;
  bool covered = halve(slots, d2_at, k1, no_self, lo, hi, n_lo, n_hi) >= k1;

  // pass B: the shortlist of every slot with d² ≤ hi
  if (S > 0 && n_hi <= S) {
    unsigned short* list =
        reinterpret_cast<unsigned short*>(pts + C) + threadIdx.x;
    int n = 0;
    for (int i = 0; i < C; ++i) {
      if (d2_at(i) <= hi && n < S) {
        list[(n++) * blockDim.x] = static_cast<unsigned short>(i);
      }
    }
    slots = Slots{list, n, static_cast<int>(blockDim.x)};
  } else if (overflow != nullptr && qx < 1e18f) {  // padding not counted
    atomicAdd(overflow, 1);
  }

  bisect(slots, d2_at, k1, no_self, kLevels, lo, hi, n_lo, n_hi);
  const float tau2 = hi;

  // the selection: a shortlist keeps only its selected entries, in order
  bool all_selected = false;
  if (slots.list != nullptr) {
    int n = 0;
    for (int e = 0; e < slots.n; ++e) {
      const int i = slots.list[e * slots.stride];
      if (d2_at(i) <= tau2) {
        slots.list[(n++) * slots.stride] = static_cast<unsigned short>(i);
      }
    }
    slots.n = n;
    all_selected = true;
  }

  float smax = 0.0f;
  for (int e = 0; e < slots.n; ++e) {
    const int i = slots.at(e);
    if (all_selected || d2_at(i) <= tau2) smax = fmaxf(smax, pts[i].w);
  }

  const SelectedValue<false> speed{d2_at, tau2, all_selected, 0.0f};
  const float med = middle_pair(slots, speed, own, k, smax);
  const float own_dev = fabsf(__fsub_rn(own, med));
  const SelectedValue<true> dev{d2_at, tau2, all_selected, med};
  const float mad = middle_pair(slots, dev, own_dev, k, smax);

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
// `stream` (a cudaStream_t), with 16·C + 2·S·sub bytes of dynamic shared
// memory (the panel and a u16 shortlist of S entries per thread; S = 0: no
// lists). overflow (one int, incremented once per thread that ran over the
// whole panel; padding slots are not counted) may be null. Returns the
// cudaError_t of the launch; 0 is success.
extern "C" int fused_mad_launch(const float* cand, const float* qx,
                                const float* qy, const float* qz,
                                const float* qs, float* out, int* overflow,
                                int n_blocks, int C, int Bt, int sub, int k,
                                float thr, float m2, int S, void* stream) {
  if (sub <= 0 || sub > 256 || C > 65536 || S < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(C) * sizeof(float4) +
                      static_cast<size_t>(S) * sub * sizeof(unsigned short);
  cudaError_t err = cudaFuncSetAttribute(
      mad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_sub = (Bt + sub - 1) / sub;
  const unsigned n_ctas = static_cast<unsigned>(n_blocks) * n_sub;
  mad_kernel<<<n_ctas, sub, smem, static_cast<cudaStream_t>(stream)>>>(
      cand, qx, qy, qz, qs, out, overflow, n_blocks, C, Bt, n_sub, k, thr, m2,
      S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_mad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
