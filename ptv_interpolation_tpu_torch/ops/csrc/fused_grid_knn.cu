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
// stages its block's coordinates once in dynamic shared memory as three
// f32 arrays x, y, z (12·C bytes) with the bounding box of every chunk of
// 32 slots (C bytes). Threads map to nodes so that each warp takes a
// 4 × 4 × 2 (x, y, z) brick of the sub-tile where the sub-tile's shape
// allows (the sub-tile's own order elsewhere). Each warp then lists, once,
// the slots (u16, in slot order, capacity L planned by the wrapper from the
// shared memory left over) whose gap to the bounding box of its 32 nodes
// is within the margin: ~250 of the ~1 630 real candidates at the headline,
// against ~1 070 in the 32-slot chunks whose boxes lie within the margin
// of a warp on a 16 × 2 line of nodes (a chunk spans ~1.8 CSR rows, so its
// box spans the panel's width in x).
// Each thread makes two passes over its warp's list (all lanes read the
// same entry: a broadcast) and runs everything else on a shortlist of its
// own. The bisection's outcome rests on one number: #{d² ≤ mid} < k holds
// exactly where mid < d₍ₖ₎, the k-th smallest d² (ties change nothing), so
// covered and τ² follow from d₍ₖ₎ and m2 alone:
//   pass A  d² of every listed slot, counted into 16 buckets over [0, m2]
//           (min(⌊d²·16/m2⌋, 15) in f32, monotone in d²; u16 counts in the
//           thread's shortlist area, column-major) and none above m2; a
//           prefix over the counts gives covered, the bucket b_k that holds
//           d₍ₖ₎ and the count of every slot in buckets ≤ b_k;
//   pass B  d² again, over the warp's list narrowed (in place, in slot
//           order) to the slots within the largest bound of its nodes on
//           τ² (b_k's upper edge and the bisection's last step), writing
//           the slot index (u16) of every slot of bucket ≤ b_k, in slot
//           order, to the thread's list in shared memory (capacity S,
//           planned by the wrapper as k + 32, stored column-major so that
//           the threads of a warp hit distinct banks), and those of bucket
//           b_k (the open ones: the others lie below d₍ₖ₎) once more in the
//           entries left at the list's tail;
//   list    d₍ₖ₎ by rank among the open slots (~11 at the headline; by
//           the radix select below where they did not fit at the tail,
//           as at the repair's wider margin), the 24 halvings replayed on
//           it as scalars (the same f32 midpoints: τ² bit-equal to the
//           sequential loop's), then the sibson statistics and the
//           weighted sums over the ~k + 5 listed slots with d² ≤ τ²
//           instead of C, in slot order as the all-slot passes summed them
//           before: the values do not change.
// τ² lies up to ~3·m2·2⁻²⁴ above d₍ₖ₎; where that crosses into the next
// bucket (a few nodes in a million), a slot of d² ≤ τ² may lie off the
// shortlist, and the thread runs the statistics and the sums over its
// warp's narrowed list (or the panel) instead — the same result.
// The gap from a slot to a box, squared and summed in d²'s op order, is
// never above the slot's d² from a node inside the box (rounding is
// monotone), so the warp's list holds every slot within the margin of
// any of its nodes and every count is exact. A warp whose list would
// exceed L (a dense cluster), or every warp where the wrapper planned
// L = 0, passes over the panel instead, skipping each chunk whose box
// lies beyond the bound for every node of the warp — the same result.
// When the slots of buckets ≤ b_k number more than S (ties, duplicated
// points), or the wrapper planned S = 0 because no shortlist fits, the
// thread finds d₍ₖ₎ among the slots of bucket b_k on its warp's list (or
// the panel) by a radix select, 4 bits of the f32 pattern a pass (the
// counts in its shortlist area, or in registers where S = 0), and runs
// the same steps over that list — the same result. Counters: the warps'
// list lengths, the warps that passed over the panel, the threads without
// a shortlist, the threads whose τ² crossed b_k's edge. Passes over the
// list: 2 (and a rank among the open slots and 3 visits of the
// shortlist), against ~28 over the panel for the sequential steps (1
// coverage, 24 halvings, 2 statistics, 1 sums).
//
// Bit-equal d². The products and sums use __fmul_rn/__fadd_rn/__fsub_rn, so
// nvcc does not contract them into FMAs; d² and τ² are then bit-equal to the
// plain PyTorch version on the same card and the bisection makes the same
// choices. Counts are integers. Build without --use_fast_math.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBisectIters = 24;
constexpr int kBuckets = 16;                // pass A's buckets over [0, m2]
constexpr int kRadixBits = 4;               // d² bits a radix pass resolves
static_assert(kBuckets == 1 << kRadixBits, "one set of counts for both");
constexpr float kEps = 1e-10f;
constexpr int kMaxV = 5;
constexpr int kIdw = 0;
constexpr int kChunk = 32;                  // panel slots per cull box
constexpr int kWarp = 32;
constexpr unsigned kAllLanes = 0xffffffffu;
// the brick of nodes a warp takes: 4 × 4 × 2 (x, y, z)
constexpr int kBrickX = 4;
constexpr int kBrickY = 4;
constexpr int kBrickZ = 2;
static_assert(kBrickX * kBrickY * kBrickZ == kWarp, "a brick per warp");
// the counters a launch adds to
enum Counter {
  kOverflow = 0,
  kListSlots = 1,
  kListOverflow = 2,
  kEdgeSpill = 3
};

__device__ __forceinline__ float sum_sq(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// How far v lies beyond [lo, hi]: max(lo − v, v − hi, 0).
__device__ __forceinline__ float gap(float v, float lo, float hi) {
  return fmaxf(fmaxf(__fsub_rn(lo, v), __fsub_rn(v, hi)), 0.0f);
}

// The slots a thread visits, in slot order: n entries of a list at stride
// `stride` (a thread's shortlist, or its warp's list at stride 1), or,
// with list == nullptr, every slot 0..n-1 of the panel, in chunks of
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
  const float* px;
  const float* py;
  const float* pz;
  float qx, qy, qz;
  __device__ __forceinline__ float operator()(int i) const {
    return sum_sq(__fsub_rn(qx, px[i]), __fsub_rn(qy, py[i]),
                  __fsub_rn(qz, pz[i]));
  }
  __device__ __forceinline__ float gap2(float4 lo, float4 hi) const {
    return sum_sq(gap(qx, lo.x, hi.x), gap(qy, lo.y, hi.y),
                  gap(qz, lo.z, hi.z));
  }
};

// Calls f(i, d²) for the slots of `s` in slot order. Over the panel it
// skips a chunk whose box lies beyond `bound` (by the warp, when all its
// nodes skip it): no slot in it lies within the bound.
template <typename F>
__device__ __forceinline__ void visit(const Slots& s, const Dist2& d2,
                                      float bound, F&& f) {
  if (s.list != nullptr && s.n > 0) {
    // the next entry's d² is formed before f runs on this one, so that a
    // store of f (pass A's counts) does not hold its loads back
    int i = s.at(0);
    float v = d2(i);
    for (int e = 1; e <= s.n; ++e) {
      const int j = s.at(min(e, s.n - 1));
      const float w = d2(j);
      f(i, v);
      i = j;
      v = w;
    }
  } else if (s.list == nullptr) {
    for (int i0 = 0, ch = 0; i0 < s.n; i0 += kChunk, ++ch) {
      if (d2.gap2(s.boxes[2 * ch], s.boxes[2 * ch + 1]) > bound) continue;
      const int i1 = min(i0 + kChunk, s.n);
      for (int i = i0; i < i1; ++i) f(i, d2(i));
    }
  }
}

// The bounding box of the warp's 32 nodes (lo, hi corners), and the gap
// beyond it of a staged slot, squared and summed in d²'s op order: never
// above the slot's d² from any of the nodes. All 32 lanes of the warp
// call warp_box.
struct Box {
  float lo[3];
  float hi[3];
  __device__ __forceinline__ float gap2(const Dist2& d2, int i) const {
    return sum_sq(gap(d2.px[i], lo[0], hi[0]), gap(d2.py[i], lo[1], hi[1]),
                  gap(d2.pz[i], lo[2], hi[2]));
  }
};

__device__ __forceinline__ Box warp_box(const Dist2& d2) {
  Box b{{d2.qx, d2.qy, d2.qz}, {d2.qx, d2.qy, d2.qz}};
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      b.lo[a] = fminf(b.lo[a], __shfl_xor_sync(kAllLanes, b.lo[a], off));
      b.hi[a] = fmaxf(b.hi[a], __shfl_xor_sync(kAllLanes, b.hi[a], off));
    }
  }
  return b;
}

// The warp's list: the slots (u16, in slot order) whose gap to the warp's
// box is at most m2 — every slot within m2 of one of its nodes. Lanes take
// 32 consecutive slots per step; a ballot gives each kept slot its place.
// Returns the count, or -1 where more than L slots qualify. All 32 lanes
// of the warp call it.
__device__ __forceinline__ int warp_list(const Dist2& d2, const Box& box,
                                         int C, float m2,
                                         unsigned short* list, int L) {
  const unsigned below = (1u << (threadIdx.x % kWarp)) - 1u;
  int n = 0;
  for (int i0 = 0; i0 < C; i0 += kWarp) {
    const int i = i0 + static_cast<int>(threadIdx.x % kWarp);
    const bool keep = i < C && box.gap2(d2, i) <= m2;
    const unsigned mask = __ballot_sync(kAllLanes, keep);
    const int at = n + __popc(mask & below);
    if (keep && at < L) list[at] = static_cast<unsigned short>(i);
    n += __popc(mask);
    if (n > L) return -1;                   // the same on every lane
  }
  __syncwarp();
  return n;
}

// Keeps, in place and in slot order, the n entries of the warp's list
// whose gap to the warp's box is at most `bound`; returns their count.
// An entry moves only to a place at or before its own, which every lane
// has read before the ballot. All 32 lanes of the warp call it.
__device__ __forceinline__ int warp_narrow(const Dist2& d2, const Box& box,
                                           float bound, unsigned short* list,
                                           int n) {
  const unsigned below = (1u << (threadIdx.x % kWarp)) - 1u;
  int m = 0;
  for (int e0 = 0; e0 < n; e0 += kWarp) {
    const int e = e0 + static_cast<int>(threadIdx.x % kWarp);
    const int i = e < n ? static_cast<int>(list[e]) : 0;
    const bool keep = e < n && box.gap2(d2, i) <= bound;
    const unsigned mask = __ballot_sync(kAllLanes, keep);
    if (keep) list[m + __popc(mask & below)] = static_cast<unsigned short>(i);
    m += __popc(mask);
  }
  __syncwarp();
  return m;
}

// Pass A's buckets: d² ≤ m2 goes to min(⌊d²·inv⌋, 15), inv = 16/m2 in
// f32 (the floor as a round-toward-zero add of 2²³), d² > m2 to kBuckets.
// Rounding, the floor and the min keep the order, so each bucket holds a
// range of d² and bucket(v) ≤ bucket(w) wherever v ≤ w.
struct Buckets {
  float m2;
  float inv;
  __device__ __forceinline__ int of(float v) const {
    if (v > m2) return kBuckets;
    const float x = fminf(__fmul_rn(v, inv), kBuckets - 1.0f);
    return __float_as_int(__fadd_rz(x, 8388608.0f)) - 0x4b000000;
  }
  // At or above every d² of buckets ≤ b: there v·inv < b + 1 (an f32,
  // and rounding is monotone), so v < (b + 1)/inv.
  __device__ __forceinline__ float upper(int b) const {
    if (b >= kBuckets - 1) return m2;
    return fminf(__fdiv_ru(static_cast<float>(b + 1), inv), m2);
  }
};

// Sixteen counts in the thread's shortlist area: u16 entries, column-major
// (`stride` = the CTA's threads). A count (here and in RegCounts) never
// exceeds the slots a thread visits, C ≤ 17 880 where the panel fits in
// shared memory.
struct SmemCounts {
  unsigned short* p;
  int stride;
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < kBuckets; ++j) p[j * stride] = 0;
  }
  __device__ __forceinline__ void add(int b) { ++p[b * stride]; }
  __device__ __forceinline__ int get(int j) const { return p[j * stride]; }
};

// Sixteen counts in registers, two u16 to a register, read with constant
// indices only: for the selections that have no shared memory to spare.
struct RegCounts {
  unsigned c[kBuckets / 2];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < kBuckets / 2; ++j) c[j] = 0;
  }
  __device__ __forceinline__ void add(int b) {
    const unsigned one = 1u << ((b & 1) * 16);
#pragma unroll
    for (int j = 0; j < kBuckets / 2; ++j) c[j] += (b >> 1 == j) ? one : 0u;
  }
  __device__ __forceinline__ int get(int j) const {
    return static_cast<int>((c[j >> 1] >> ((j & 1) * 16)) & 0xffffu);
  }
};

// The bucket that holds the rank-th smallest counted value (kBuckets
// where fewer are counted), the count below it and its own count.
struct Pick {
  int bucket;
  int below;
  int in;
};

template <typename Counts>
__device__ __forceinline__ Pick pick(const Counts& c, int rank) {
  Pick p{kBuckets, 0, 0};
#pragma unroll
  for (int j = 0; j < kBuckets; ++j) {
    if (p.bucket == kBuckets) {
      const int n = c.get(j);
      if (p.below + n >= rank) {
        p.bucket = j;
        p.in = n;
      } else {
        p.below += n;
      }
    }
  }
  return p;
}

// Pass A: the slots of `s` counted by bucket, and the bucket of the k-th.
template <typename Counts>
__device__ __forceinline__ Pick count_buckets(const Slots& s,
                                              const Dist2& d2,
                                              const Buckets& bu, int k,
                                              Counts& c) {
  c.clear();
  visit(s, d2, bu.m2, [&](int, float v) {
    const int b = bu.of(v);
    if (b < kBuckets) c.add(b);
  });
  return pick(c, k);
}

// The rank-th smallest d² of bucket bk over the slots of `s` (rank ≤ the
// bucket's count): over a shortlist whose open slots did not fit at its
// tail, or over the slots of a thread without a shortlist. One visit
// finds the bucket's least and greatest d² (one value where they agree:
// ties, duplicated points), and every d² between them lies in bucket bk;
// then a radix select over their f32 patterns (which order d² ≥ 0 as the
// values), kRadixBits a pass from the first bit in which the two differ;
// where one slot is left before the last pass, one more visit fetches
// it. Its visits are linear in the slots, whatever their ties.
template <typename Counts>
__device__ __forceinline__ float kth_radix(const Slots& s, const Dist2& d2,
                                           const Buckets& bu, int bk,
                                           int rank, Counts& c) {
  const float bound = bu.upper(bk);
  float lo = CUDART_INF_F;
  float hi = 0.0f;
  visit(s, d2, bound, [&](int, float v) {
    if (bu.of(v) == bk) {
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  });
  if (lo == hi) return lo;
  const unsigned ulo = __float_as_uint(lo);
  const int first = 31 - __clz(ulo ^ __float_as_uint(hi));
  int shift = first / kRadixBits * kRadixBits;
  unsigned prefix = shift + kRadixBits >= 32
                        ? 0u
                        : ulo & (~0u << (shift + kRadixBits));
  for (; shift >= 0; shift -= kRadixBits) {
    const unsigned high = shift + kRadixBits >= 32
                              ? 0u
                              : ~0u << (shift + kRadixBits);
    c.clear();
    visit(s, d2, bound, [&](int, float v) {
      const unsigned u = __float_as_uint(v);
      if (v >= lo && v <= hi && (u & high) == prefix) {
        c.add(static_cast<int>((u >> shift) & (kBuckets - 1u)));
      }
    });
    const Pick p = pick(c, rank);
    prefix |= static_cast<unsigned>(p.bucket) << shift;
    rank -= p.below;
    if (p.in == 1 && shift > 0) {
      const unsigned mask = ~0u << shift;
      float kth = CUDART_INF_F;
      visit(s, d2, bound, [&](int, float v) {
        if (v >= lo && v <= hi && (__float_as_uint(v) & mask) == prefix) {
          kth = v;
        }
      });
      return kth;
    }
  }
  return __uint_as_float(prefix);
}

// The rank-th smallest d² over the slots of `s` and `base` smaller ones
// off it: the d² of a slot with base + #{< v} < rank ≤ base + #{≤ v}.
// Quadratic in the slots: for the few open ones of a shortlist.
__device__ __forceinline__ float kth_ranked(const Slots& s, const Dist2& d2,
                                            int base, int rank) {
  for (int a = 0; a < s.n; ++a) {
    const float va = d2(s.at(a));
    int less = base;
    int leq = base;
    for (int b = 0; b < s.n; ++b) {
      const float vb = d2(s.at(b));
      less += (vb < va) ? 1 : 0;
      leq += (vb <= va) ? 1 : 0;
    }
    if (less < rank && rank <= leq) return va;
  }
  return CUDART_INF_F;                      // not reached: the list is exact
}

// τ²: the 24 halvings of [0, m2] on #{d² ≤ mid} < k, that is on mid < dk
// (+∞ where fewer than k slots lie within m2), with the sequential loop's
// midpoints in its f32 ops.
__device__ __forceinline__ float bisect(float dk, float m2) {
  float lo = 0.0f;
  float hi = m2;
#pragma unroll
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (mid < dk) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return hi;
}

// The node (index in the sub-tile's (tz, ty, tx) order) of thread t: warp
// w takes brick w of the sub-tile's bricks in (z, y, x) order, lane l the
// node (l % 4, l / 4 % 4, l / 16) of it, where the sub-tile (sz, sy, sx)
// divides into bricks; elsewhere the node t.
__device__ __forceinline__ int node_of(int t, int Bt, int sz, int sy,
                                       int sx) {
  if (sz % kBrickZ != 0 || sy % kBrickY != 0 || sx % kBrickX != 0 ||
      sz * sy * sx != Bt) {
    return t;
  }
  const int w = t / kWarp;
  const int l = t % kWarp;
  const int wx = sx / kBrickX;
  const int wy = sy / kBrickY;
  const int x = (w % wx) * kBrickX + l % kBrickX;
  const int y = (w / wx % wy) * kBrickY + l / kBrickX % kBrickY;
  const int z = (w / (wx * wy)) * kBrickZ + l / (kBrickX * kBrickY);
  return (z * sy + y) * sx + x;
}

// kThreads/kMinBlocks bound the registers: 256-thread sub-tiles (the
// wrapper's usual Bt) get up to 85 registers, so that 3 CTAs share an SM;
// wider sub-tiles, up to 1 024 threads, get 64.
template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_kernel(const float* __restrict__ cand, const float* __restrict__ qx_all,
             const float* __restrict__ qy_all,
             const float* __restrict__ qz_all, float* __restrict__ out,
             float* __restrict__ tau2_out,
             unsigned long long* __restrict__ counts, int n_blocks, int C,
             int n_sub, int k, int V, int mode, float power, float m2, int S,
             int L, int sz, int sy, int sx) {
  // dynamic shared memory: the chunks' boxes (2 float4 each), the panel's
  // x, y and z (C f32 each), the threads' shortlists, the warps' lists
  extern __shared__ float4 boxes[];
  const int n_chunks = (C + kChunk - 1) / kChunk;
  float* px = reinterpret_cast<float*>(boxes + 2 * n_chunks);
  float* py = px + C;
  float* pz = py + C;
  const int row = blockIdx.x;
  const int Bt = blockDim.x;
  const int t = threadIdx.x;
  unsigned short* lists = reinterpret_cast<unsigned short*>(pz + C);
  unsigned short* warp_lists = lists + S * Bt;
  const long long stride = static_cast<long long>(n_blocks) * C;
  const long long base = static_cast<long long>(row / n_sub) * C;

  for (int i = t; i < C; i += Bt) {
    px[i] = cand[base + i];
    py[i] = cand[stride + base + i];
    pz[i] = cand[2 * stride + base + i];
  }
  __syncthreads();
  for (int ch = t; ch < n_chunks; ch += Bt) {
    const int j = ch * kChunk;
    float4 lo = make_float4(px[j], py[j], pz[j], 0.0f);
    float4 hi = lo;
    for (int i = j + 1; i < min(j + kChunk, C); ++i) {
      lo = make_float4(fminf(lo.x, px[i]), fminf(lo.y, py[i]),
                       fminf(lo.z, pz[i]), 0.0f);
      hi = make_float4(fmaxf(hi.x, px[i]), fmaxf(hi.y, py[i]),
                       fmaxf(hi.z, pz[i]), 0.0f);
    }
    boxes[2 * ch] = lo;
    boxes[2 * ch + 1] = hi;
  }
  __syncthreads();

  const int node = node_of(t, Bt, sz, sy, sx);
  const long long q = static_cast<long long>(row) * Bt + node;
  const Dist2 d2_at{px, py, pz, qx_all[q], qy_all[q], qz_all[q]};

  // the slots passes A and B visit: the warp's list, or the panel
  Slots src{nullptr, C, 0, boxes};
  unsigned short* mine = warp_lists + (t / kWarp) * L;
  if (L > 0 && Bt % kWarp == 0) {
    const int n = warp_list(d2_at, warp_box(d2_at), C, m2, mine, L);
    if (n >= 0) src = Slots{mine, n, 1, nullptr};
    if (t % kWarp == 0 && counts != nullptr) {
      if (n >= 0) {
        atomicAdd(counts + kListSlots, static_cast<unsigned long long>(n));
      } else {
        atomicAdd(counts + kListOverflow, 1ull);
      }
    }
  }

  // pass A: the slots counted by bucket, in the thread's shortlist area
  // where it has one (pass B overwrites them), and the bucket of d₍ₖ₎
  const Buckets bu{m2, __fdiv_rn(static_cast<float>(kBuckets), m2)};
  unsigned short* list = lists + t;
  const bool shortlist = S >= kBuckets;
  Pick p;
  if (shortlist) {
    SmemCounts c{list, Bt};
    p = count_buckets(src, d2_at, bu, k, c);
  } else {
    RegCounts c;
    p = count_buckets(src, d2_at, bu, k, c);
  }
  const bool covered = p.bucket < kBuckets;
  const int bk = min(p.bucket, kBuckets - 1);
  const int n_le = p.below + p.in;          // the slots of buckets ≤ bk

  // what comes next needs only the slots within τ² of the node, and τ²
  // lies less than 3·m2·2⁻²⁴ above d₍ₖ₎ ≤ upper(bk) (each halving's
  // midpoint is off by at most half an ulp of m2): the warp's list keeps
  // those within the largest such bound of its nodes (the box is formed
  // again rather than held in registers through pass A)
  if (src.list != nullptr) {
    float warp_hi = __fadd_ru(bu.upper(bk), __fmul_ru(m2, 0x1p-21f));
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      warp_hi = fmaxf(warp_hi, __shfl_xor_sync(kAllLanes, warp_hi, off));
    }
    src.n = warp_narrow(d2_at, warp_box(d2_at), warp_hi, mine, src.n);
  }

  // pass B: the shortlist of every slot of bucket ≤ bk, in slot order from
  // the list's head; and, in the S − n_le entries left at its tail, the
  // open ones (bucket bk: the others lie below d₍ₖ₎); then d₍ₖ₎ among
  // them, or among the whole shortlist where they do not fit there
  Slots listed = src;
  const bool on_shortlist = shortlist && n_le <= S;
  float dk = CUDART_INF_F;
  if (on_shortlist) {
    int n = 0;
    int n_open = 0;
    bool open_fits = true;
    visit(src, d2_at, bu.upper(bk), [&](int i, float d2) {
      const int b = bu.of(d2);
      if (b <= bk && n < n_le) {
        list[(n++) * Bt] = static_cast<unsigned short>(i);
        if (b == bk && covered) {
          if (n_open < S - n_le) {
            list[(S - 1 - n_open++) * Bt] = static_cast<unsigned short>(i);
          } else {
            open_fits = false;
          }
        }
      }
    });
    listed = Slots{list, n, Bt, nullptr};
    if (covered && open_fits) {
      const Slots open{list + (S - n_open) * Bt, n_open, Bt, nullptr};
      dk = kth_ranked(open, d2_at, p.below, k);
    } else if (covered) {
      RegCounts c;
      dk = kth_radix(listed, d2_at, bu, bk, k - p.below, c);
    }
  } else {
    if (counts != nullptr) atomicAdd(counts + kOverflow, 1ull);
    if (covered && shortlist) {
      SmemCounts c{list, Bt};
      dk = kth_radix(src, d2_at, bu, bk, k - p.below, c);
    } else if (covered) {
      RegCounts c;
      dk = kth_radix(src, d2_at, bu, bk, k - p.below, c);
    }
  }
  const float tau2 = bisect(dk, m2);
  // τ² past bk's edge: a slot of d² ≤ τ² may lie off the shortlist
  if (on_shortlist && bu.of(tau2) > bk) {
    listed = src;
    if (counts != nullptr) atomicAdd(counts + kEdgeSpill, 1ull);
  }
  if (tau2_out != nullptr) tau2_out[q] = tau2;

  float dmin = 0.0f;
  float std_eps = 0.0f;
  if (mode != kIdw) {
    float n_ok = 0.0f;
    float s1 = 0.0f;
    float dmn = 3.4e38f;
    visit(listed, d2_at, tau2, [&](int, float d2) {
      if (d2 <= tau2) {
        const float d = __fsqrt_rn(fmaxf(d2, 0.0f));
        n_ok += 1.0f;
        s1 = __fadd_rn(s1, d);
        dmn = fminf(dmn, d);
      }
    });
    n_ok = fmaxf(n_ok, 1.0f);
    const float mean = __fdiv_rn(s1, n_ok);
    float ss = 0.0f;
    visit(listed, d2_at, tau2, [&](int, float d2) {
      if (d2 <= tau2) {
        const float dev = __fsub_rn(__fsqrt_rn(fmaxf(d2, 0.0f)), mean);
        ss = __fadd_rn(ss, __fmul_rn(dev, dev));
      }
    });
    std_eps = __fadd_rn(__fsqrt_rn(__fdiv_rn(ss, n_ok)), kEps);
    dmin = dmn > 1e18f ? 0.0f : dmn;
  }

  const float* vals = cand + 3 * stride + base;
  float den = 0.0f;
  float num[kMaxV];
#pragma unroll
  for (int c = 0; c < kMaxV; ++c) num[c] = 0.0f;
  visit(listed, d2_at, tau2, [&](int i, float d2) {
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
        if (c < V) {
          num[c] = __fadd_rn(num[c], __fmul_rn(w, vals[c * stride + i]));
        }
      }
    }
  });

  const float inv_den = __frcp_rn(fmaxf(den, 1e-37f));
  float* o = out + static_cast<long long>(row) * 8 * Bt + node;
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

size_t shared_bytes(int C, int Bt, int S, int L) {
  const size_t n_chunks = (static_cast<size_t>(C) + kChunk - 1) / kChunk;
  const size_t warps = (static_cast<size_t>(Bt) + kWarp - 1) / kWarp;
  return 2 * n_chunks * sizeof(float4) +
         3 * static_cast<size_t>(C) * sizeof(float) +
         (static_cast<size_t>(S) * Bt + static_cast<size_t>(L) * warps) *
             sizeof(unsigned short);
}

}  // namespace

// Launches the kernel over n_blocks·n_sub CTAs of Bt threads on `stream`
// (a cudaStream_t), with 32·⌈C/32⌉ + 12·C + 2·S·Bt + 2·L·⌈Bt/32⌉ bytes of
// dynamic shared memory (the chunks' boxes, the panel, a u16 shortlist of
// S entries per thread and a u16 list of L entries per warp; S < 16: no
// shortlists, L = 0: no warp lists). (sz, sy, sx) is the sub-tile's shape
// in nodes, Bt = sz·sy·sx in the (tz, ty, tx) order of the queries and
// the output. tau2 (n_blocks·n_sub·Bt f32) and counts (four u64: threads
// without a shortlist, the slots on the warps' lists, warps that passed
// over the panel, threads whose τ² crossed their shortlist's last bucket)
// may be null. Returns the cudaError_t of the launch; 0 is
// success.
extern "C" int fused_grid_knn_launch(const float* cand, const float* qx,
                                     const float* qy, const float* qz,
                                     float* out, float* tau2,
                                     unsigned long long* counts, int n_blocks,
                                     int C, int n_sub, int Bt, int k, int V,
                                     int mode, float power, float m2, int S,
                                     int L, int sz, int sy, int sx,
                                     void* stream) {
  if (C > 65536 || S < 0 || L < 0 || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = shared_bytes(C, Bt, S, L);
  auto kernel = Bt <= 256 ? fused_kernel<256, 3> : fused_kernel<1024, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned n_rows = static_cast<unsigned>(n_blocks) * n_sub;
  kernel<<<n_rows, Bt, smem, static_cast<cudaStream_t>(stream)>>>(
      cand, qx, qy, qz, out, tau2, counts, n_blocks, C, n_sub, k, V, mode,
      power, m2, S, L, sz, sy, sx);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs of Bt threads with the launch's shared memory for (C, S, L)
// that one SM of the current device holds at once, in *ctas. Returns the
// cudaError_t; 0 is success.
extern "C" int fused_grid_knn_ctas_per_sm(int C, int Bt, int S, int L,
                                          int* ctas) {
  const size_t smem = shared_bytes(C, Bt, S, L);
  auto kernel = Bt <= 256 ? fused_kernel<256, 3> : fused_kernel<1024, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, Bt, smem));
}

extern "C" const char* fused_grid_knn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
