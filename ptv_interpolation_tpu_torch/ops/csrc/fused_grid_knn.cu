// Fused τ-bisection weighted-sum kernel for regular grids (IDW / sibson).
//
// Replaces ptv_interpolation_tpu/ops/fused_grid_knn.py::_fused_kernel, the
// Pallas TPU kernel of the fused grid kNN path. Its wrapper is
// _fused_eval_cells in ptv_interpolation_tpu_torch/ops/fused_grid_knn.py;
// its plain PyTorch version is phase 1 (_compact_gather, _build_queries)
// and _fused_eval_plain there.
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
// Inputs. The cell list of the JAX package's layout: `starts` (the CSR
// offsets of its cells, z-major), the cell-sorted points (n + pad, 3) and
// values (n + pad, V), the cell grid's origin, inverse cell size and dims;
// the grid's axes padded to whole blocks; optionally the ids of the blocks
// to evaluate (the repair's). out is (n_blocks·n_sub, 8, Bt) f32, rows in
// (block, sub-tile) order and each row's nodes in (tz, ty, tx) order, as
// the plain version's phase 1 (_compact_gather, _build_queries) lays out
// its panel and query rows.
//
// Bound (NVIDIA H100 80GB HBM3, 700.00 W: its published peaks). A candidate
// beyond the margin counts toward no coverage, halving or sum, so the
// function needs the d² of the (node, candidate) pairs within the margin
// only: at the headline (16 384 blocks × 1 024 nodes,
// C = 1 920 slots, ~1 570 real candidates per block) 146 per node, 2.4e9
// pairs of 8 fp32 operations, 0.58 ms at 33.5e12/s (the 67 TFLOP/s peak
// counts an FMA as two, and these operations are not fused); the bytes
// (the store's points and values once, 24 MB, and the output, 0.54 GB)
// take 0.17 ms at 3.35 TB/s (chip_smoke.py phase 3 reckons both). So it
// is bound by fp32 issue, and the design's aim is to evaluate each d² as
// few times as it can, and as few d² beyond the margin as it can.
//
// Design. One CTA per (block, sub-tile) row, one thread per node. The CTA
// stages its block's candidates itself, from the cell list. A block's
// candidate region is mcz·mcy rows of mcx cells starting `margin` below
// its low corner, and each row is one contiguous run of the sorted store:
// a thread a row forms the row's [start, end) from `starts` (the base cell
// as floor(((lo − margin) − origin)·inv) in f32, rows outside the cell
// grid empty, x clipped to it), a scan over the warps gives each run its
// first slot (row jz·mcy + jy, then the store's order within the row: the
// slot order of phase 1's panel, C slots with 1e19 coordinates past the
// block's count), and the threads copy the runs' x, y, z into three f32
// arrays (12·C bytes), 8 slots a thread with their loads in flight
// together, then form the bounding box of every chunk of 32 slots (32
// bytes a chunk, 8 lanes a chunk). A table of the non-empty runs (the
// offset from slot to sorted index, 4 bytes each) and, per chunk, the run
// that holds its first slot and a bit for each run begun inside it (6
// bytes) map a slot to its sorted index without a search; the sums read
// the values there, and the values are never staged. Each node's
// coordinates come from the padded axes. So the slots, their order, every
// d² and every sum are those of the panel phase 1 gathers.
// Threads map to nodes so that each warp takes a
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
// a shortlist, the threads whose τ² crossed b_k's edge, the real
// candidates staged (once per block, by its first sub-tile). Passes over the
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

// Where a launch's blocks find their candidates and nodes (device
// pointers; ids may be null). This and Geometry are the C interface's
// arguments, outside the unnamed namespace so that the entry points that
// take them keep external linkage.
struct Inputs {
  const int* starts;          // (n_cells + 1) CSR offsets, cells z-major
  const float* points;        // (n + pad, 3) the cell-sorted points
  const float* values;        // (n + pad, V) their values
  const float* x_ax;          // the grid's axes, padded to whole blocks
  const float* y_ax;
  const float* z_ax;
  const float* origin;        // (3,) the cell grid's low corner, x y z
  const float* inv_cell;      // (3,) its inverse cell size
  const long long* ids;       // the flat ids of the blocks evaluated, or
                              // null: block b is CTA row b / n_sub
};

// A launch's shapes and parameters.
struct Geometry {
  int n_blocks;               // blocks evaluated: CTAs n_blocks · n_sub
  int nby, nbx;               // the grid's blocks along y and x
  int n_sub;                  // sub-tiles per block, along z
  int sz, sy, sx;             // a sub-tile's nodes along z, y and x
  int ncx, ncy, ncz;          // the cell grid
  int mcz, mcy, mcx;          // a block's candidate region, in cells
  int C;                      // panel slots per block
  int k, V, mode;
  int S;                      // shortlist entries per thread
  int L;                      // list entries per warp
  float power;
  float margin;               // the f32 margin of the candidate region
  float m2;                   // the f32 margin² of coverage and halvings
};

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
constexpr float kSentinel = 1e19f;          // coordinate of an empty slot
constexpr int kStageBatch = 8;              // slots a thread stages at once
constexpr int kBoxLanes = 8;                // lanes that form a chunk's box
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
  kEdgeSpill = 3,
  kStagedSlots = 4
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

// The block's candidates as runs of the sorted store, in slot order: the
// slots of non-empty run e lie at sorted indices slot + delta[e]; first[c]
// is the run that holds slot kChunk·c, and bit b > 0 of starts[c] is set
// where a run begins at slot kChunk·c + b, so a slot's run is first[c]
// and the runs begun after it up to the slot. n slots are filled (≤ C),
// the rest are empty.
struct Runs {
  const int* delta;
  const unsigned short* first;
  const unsigned* starts;
  int n;
  __device__ __forceinline__ long long sorted(int i) const {
    const int c = i / kChunk;
    const unsigned upto = (2u << (i % kChunk)) - 2u;  // bits 1 .. i % kChunk
    return static_cast<long long>(i) +
           delta[first[c] + __popc(starts[c] & upto)];
  }
};

// Stages the candidates of the block with low corner lo (x, y, z) into
// px, py, pz and the chunks' bounding boxes: its mcz·mcy rows of mcx
// cells, starting `margin` below lo (the base cell floor(((lo − margin) −
// origin)·inv) in f32, as phase 1 forms it; rows outside the cell grid
// are empty and x is clipped to it), row jz·mcy + jy after row jz·mcy +
// jy − 1, each in the store's order, then 1e19 up to C (a multiple of
// kChunk). Returns the runs' table, in delta (R = mcz·mcy entries),
// starts and first (one entry a chunk). All threads of the CTA call it.
__device__ Runs stage_runs(const Inputs& in, const Geometry& g,
                           const float lo[3], int* delta, unsigned* starts,
                           unsigned short* first, float* px, float* py,
                           float* pz, float4* boxes) {
  const int t = threadIdx.x;
  const int Bt = blockDim.x;
  const int lane = t % kWarp;
  const int warp = t / kWarp;
  const int n_warps = (Bt + kWarp - 1) / kWarp;
  const bool full = (warp + 1) * kWarp <= Bt;   // a whole warp
  const unsigned lanes = full ? kAllLanes : (1u << (Bt % kWarp)) - 1u;
  const int last = full ? kWarp - 1 : Bt % kWarp - 1;
  const int R = g.mcz * g.mcy;
  const int n_chunks = g.C / kChunk;
  int base[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    base[a] = static_cast<int>(
        floorf(__fmul_rn(__fsub_rn(__fsub_rn(lo[a], g.margin), in.origin[a]),
                         in.inv_cell[a])));
  }
  const int x0 = min(max(base[0], 0), g.ncx);
  const int x1 = min(max(base[0] + g.mcx, 0), g.ncx);
  for (int c = t; c < n_chunks; c += Bt) starts[c] = 0u;
  // Bt rows a round, a thread a row: its [start, end) in the store, a scan
  // of the counts and of the non-empty rows over the warp, then over the
  // warps (their totals in px, which is staged only after), then its run's
  // entries
  int* totals = reinterpret_cast<int*>(px);
  int slots = 0;                            // of the rounds before
  int runs = 0;
  for (int r0 = 0; r0 < R; r0 += Bt) {
    const int r = r0 + t;
    int s = 0;
    int cnt = 0;
    if (r < R) {
      const int cz = base[2] + r / g.mcy;
      const int cy = base[1] + r % g.mcy;
      if (cz >= 0 && cz < g.ncz && cy >= 0 && cy < g.ncy) {
        const int row = (cz * g.ncy + cy) * g.ncx;
        s = in.starts[row + x0];
        cnt = in.starts[row + x1] - s;
      }
    }
    int incl = cnt;
    int nz = cnt > 0 ? 1 : 0;
    for (int off = 1; off < kWarp; off <<= 1) {
      const int a = __shfl_up_sync(lanes, incl, off);
      const int b = __shfl_up_sync(lanes, nz, off);
      if (lane >= off) {
        incl += a;
        nz += b;
      }
    }
    if (lane == last) {
      totals[2 * warp] = incl;
      totals[2 * warp + 1] = nz;
    }
    __syncthreads();
    int begin = slots + incl - cnt;
    int e = runs + nz - 1;
    for (int w = 0; w < n_warps; ++w) {
      const int a = totals[2 * w];
      const int b = totals[2 * w + 1];
      if (w < warp) {
        begin += a;
        e += b;
      }
      slots += a;
      runs += b;
    }
    if (cnt > 0) {
      delta[e] = s - begin;
      if (begin % kChunk != 0 && begin < g.C) {
        atomicOr(starts + begin / kChunk, 1u << (begin % kChunk));
      }
      for (int c = (begin + kChunk - 1) / kChunk;
           c < n_chunks && c * kChunk < begin + cnt; ++c) {
        first[c] = static_cast<unsigned short>(e);
      }
    }
    __syncthreads();
  }
  // the slots, kStageBatch a thread at a time: their sorted indices, then
  // all their loads, then the stores
  const Runs table{delta, first, starts, min(slots, g.C)};
  for (int i0 = t; i0 < g.C; i0 += kStageBatch * Bt) {
    int j[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * Bt;
      j[u] = i < table.n ? static_cast<int>(table.sorted(i)) : -1;
    }
    float x[kStageBatch];
    float y[kStageBatch];
    float z[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      x[u] = y[u] = z[u] = kSentinel;
      if (j[u] >= 0) {
        const float* p = in.points + 3 * static_cast<long long>(j[u]);
        x[u] = p[0];
        y[u] = p[1];
        z[u] = p[2];
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * Bt;
      if (i < g.C) {
        px[i] = x[u];
        py[i] = y[u];
        pz[i] = z[u];
      }
    }
  }
  __syncthreads();
  // the chunks' boxes: kBoxLanes lanes a chunk where the threads fill whole
  // warps (each takes kChunk / kBoxLanes slots, then the lanes combine),
  // else a thread a chunk; a lane's slots start at an offset that puts the
  // lanes of a warp on distinct banks
  const int group = Bt % kWarp == 0 ? kBoxLanes : 1;
  const int per = kChunk / group;
  for (int k0 = t - lane; k0 < n_chunks * group; k0 += Bt) {
    const int k = min(k0 + lane, n_chunks * group - 1);  // the same on a warp
    const int ch = k / group;
    const int q = k % group;
    float4 box_lo = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                                0.0f);
    float4 box_hi = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                                0.0f);
    for (int u = 0; u < per; ++u) {
      const int i = ch * kChunk + q * per + (u + ch) % per;
      box_lo = make_float4(fminf(box_lo.x, px[i]), fminf(box_lo.y, py[i]),
                           fminf(box_lo.z, pz[i]), 0.0f);
      box_hi = make_float4(fmaxf(box_hi.x, px[i]), fmaxf(box_hi.y, py[i]),
                           fmaxf(box_hi.z, pz[i]), 0.0f);
    }
    for (int off = group / 2; off > 0; off >>= 1) {
      box_lo.x = fminf(box_lo.x, __shfl_xor_sync(kAllLanes, box_lo.x, off));
      box_lo.y = fminf(box_lo.y, __shfl_xor_sync(kAllLanes, box_lo.y, off));
      box_lo.z = fminf(box_lo.z, __shfl_xor_sync(kAllLanes, box_lo.z, off));
      box_hi.x = fmaxf(box_hi.x, __shfl_xor_sync(kAllLanes, box_hi.x, off));
      box_hi.y = fmaxf(box_hi.y, __shfl_xor_sync(kAllLanes, box_hi.y, off));
      box_hi.z = fmaxf(box_hi.z, __shfl_xor_sync(kAllLanes, box_hi.z, off));
    }
    if (q == 0 && k0 + lane < n_chunks * group) {
      boxes[2 * ch] = box_lo;
      boxes[2 * ch + 1] = box_hi;
    }
  }
  __syncthreads();
  return table;
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
fused_kernel(const Inputs in, const Geometry g, float* __restrict__ out,
             float* __restrict__ tau2_out,
             unsigned long long* __restrict__ counts) {
  // dynamic shared memory: the chunks' boxes (2 float4 each), the panel's
  // x, y and z (C f32 each), the runs' table (R ints, R = mcz·mcy), the
  // chunks' run starts (u32 each) and first runs (u16 each), the threads'
  // shortlists, the warps' lists
  extern __shared__ float4 boxes[];
  const int C = g.C;
  const int k = g.k;
  const int V = g.V;
  const int S = g.S;
  const int L = g.L;
  const float m2 = g.m2;
  const int n_chunks = C / kChunk;
  float* px = reinterpret_cast<float*>(boxes + 2 * n_chunks);
  float* py = px + C;
  float* pz = py + C;
  int* run_delta = reinterpret_cast<int*>(pz + C);
  unsigned* run_starts =
      reinterpret_cast<unsigned*>(run_delta + g.mcz * g.mcy);
  unsigned short* run_first =
      reinterpret_cast<unsigned short*>(run_starts + n_chunks);
  const int row = blockIdx.x;
  const int Bt = blockDim.x;
  const int t = threadIdx.x;
  unsigned short* lists = run_first + n_chunks;
  unsigned short* warp_lists = lists + S * Bt;

  // the block of this row, and its low corner
  const int sub = row % g.n_sub;
  const long long id = in.ids != nullptr ? in.ids[row / g.n_sub]
                                         : row / g.n_sub;
  const int ibx = static_cast<int>(id % g.nbx);
  const int iby = static_cast<int>(id / g.nbx % g.nby);
  const int ibz = static_cast<int>(id / g.nbx / g.nby);
  const int bz = g.n_sub * g.sz;
  const float corner[3] = {in.x_ax[ibx * g.sx], in.y_ax[iby * g.sy],
                           in.z_ax[ibz * bz]};
  const Runs runs = stage_runs(in, g, corner, run_delta, run_starts,
                               run_first, px, py, pz, boxes);
  if (sub == 0 && t == 0 && counts != nullptr) {
    atomicAdd(counts + kStagedSlots, static_cast<unsigned long long>(runs.n));
  }
  // the thread's node and its coordinates
  const int node = node_of(t, Bt, g.sz, g.sy, g.sx);
  const long long q = static_cast<long long>(row) * Bt + node;
  const int nx = node % g.sx;
  const int ny = node / g.sx % g.sy;
  const int nz = node / (g.sx * g.sy);
  const Dist2 d2_at{px,
                    py,
                    pz,
                    in.x_ax[ibx * g.sx + nx],
                    in.y_ax[iby * g.sy + ny],
                    in.z_ax[ibz * bz + sub * g.sz + nz]};

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
  if (g.mode != kIdw) {
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

  float den = 0.0f;
  float num[kMaxV];
#pragma unroll
  for (int c = 0; c < kMaxV; ++c) num[c] = 0.0f;
  visit(listed, d2_at, tau2, [&](int i, float d2) {
    if (d2 <= tau2) {
      // the slot's values (an empty slot's are 0), loaded ahead of the
      // weight that they are summed with
      float v[kMaxV];
#pragma unroll
      for (int c = 0; c < kMaxV; ++c) v[c] = 0.0f;
      if (i < runs.n) {
        const float* p = in.values + runs.sorted(i) * V;
#pragma unroll
        for (int c = 0; c < kMaxV; ++c) {
          if (c < V) v[c] = p[c];
        }
      }
      const float d = __fsqrt_rn(fmaxf(d2, 0.0f));
      float w;
      if (g.mode == kIdw) {
        const float p = g.power == 2.0f ? __fmul_rn(d, d) : powf(d, g.power);
        w = __frcp_rn(__fadd_rn(p, kEps));
      } else {
        w = __fmul_rn(__frcp_rn(__fadd_rn(d, kEps)),
                      expf(__fdiv_rn(-__fsub_rn(d, dmin), std_eps)));
      }
      den = __fadd_rn(den, w);
#pragma unroll
      for (int c = 0; c < kMaxV; ++c) {
        if (c < V) num[c] = __fadd_rn(num[c], __fmul_rn(w, v[c]));
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

size_t shared_bytes(int C, int Bt, int S, int L, int R) {
  const size_t n_chunks = (static_cast<size_t>(C) + kChunk - 1) / kChunk;
  const size_t warps = (static_cast<size_t>(Bt) + kWarp - 1) / kWarp;
  return 2 * n_chunks * sizeof(float4) +
         3 * static_cast<size_t>(C) * sizeof(float) +
         static_cast<size_t>(R) * sizeof(int) +
         n_chunks * sizeof(unsigned) +
         (n_chunks + static_cast<size_t>(S) * Bt +
          static_cast<size_t>(L) * warps) *
             sizeof(unsigned short);
}

}  // namespace

// Launches the kernel over g->n_blocks·g->n_sub CTAs of sz·sy·sx threads
// on `stream` (a cudaStream_t), with 32·C/32 + 12·C + 4·R + 6·C/32 +
// 2·S·Bt + 2·L·⌈Bt/32⌉ bytes of dynamic shared memory (C a multiple of
// 32, R = mcz·mcy: the chunks' boxes, the panel, the runs' table, the
// chunks' run starts and first runs, a u16 shortlist of S entries per
// thread and a u16 list of L entries per warp; S < 16: no shortlists, L =
// 0: no warp lists). out is
// (n_blocks·n_sub, 8, Bt) f32, Bt = sz·sy·sx in the (tz, ty, tx) order.
// tau2 (n_blocks·n_sub·Bt f32) and counts (five u64: threads without a
// shortlist, the slots on the warps' lists, warps that passed over the
// panel, threads whose τ² crossed their shortlist's last bucket, the real
// candidates staged, once per block) may be null. Returns the cudaError_t
// of the launch; 0 is success.
extern "C" int fused_grid_knn_launch(const Inputs* in, const Geometry* g,
                                     float* out, float* tau2,
                                     unsigned long long* counts,
                                     void* stream) {
  const int Bt = g->sz * g->sy * g->sx;
  const int R = g->mcz * g->mcy;
  if (g->C <= 0 || g->C > 65536 || g->C % kChunk != 0 || g->S < 0 ||
      g->L < 0 || g->k < 1 ||
      Bt < 1 || Bt > 1024 || R < 1 || R > 65536 || g->n_sub < 1 ||
      g->V < 1 || g->V > kMaxV) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = shared_bytes(g->C, Bt, g->S, g->L, R);
  auto kernel = Bt <= 256 ? fused_kernel<256, 3> : fused_kernel<1024, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned n_rows = static_cast<unsigned>(g->n_blocks) * g->n_sub;
  kernel<<<n_rows, Bt, smem, static_cast<cudaStream_t>(stream)>>>(
      *in, *g, out, tau2, counts);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs of Bt threads with the launch's shared memory for (C, S, L, R)
// that one SM of the current device holds at once, in *ctas. Returns the
// cudaError_t; 0 is success.
extern "C" int fused_grid_knn_ctas_per_sm(int C, int Bt, int S, int L, int R,
                                          int* ctas) {
  const size_t smem = shared_bytes(C, Bt, S, L, R);
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
