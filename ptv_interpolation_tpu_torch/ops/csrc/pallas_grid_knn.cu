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
// Bound: hi needs the d² of every real slot of the windows, so the function
// needs (real slots)·B d² of 8 unfused fp32 operations per block, whatever
// the design (chip_smoke.py phase 7 reckons it on the headline's slice).
// The kernel is bound by instruction issue: each pass over the panel costs
// every node the d² of every slot, and a tree pass adds 16 compares and 16
// adds for each slot it tallies.
//
// Design. One CTA per grid block, one thread per node. The CTA stages its
// slots' x, y, z as three f32 planes in dynamic shared memory (12 bytes a
// slot, 72 KiB at the headline's C = 6 144, so that two CTAs share an SM
// with their shortlists; a slot's store column is derived where it is
// needed, as win[s / L] + s % L). All threads of a warp read the same slots
// together (a broadcast), four at a time. Each thread then forms d² over the
// whole panel 5 times at the headline's 14 halvings (17 before):
//   pass 0     the largest valid d², which sets hi;
//   passes 1-3 each counts every slot against the 15 midpoints of a 4-level
//              halving tree — the same f32 values the sequential loop forms
//              down each branch, 0.5·(lo+hi) with __fmul_rn/__fadd_rn — and
//              walks it: 12 halvings (`list_after`). A slot above hi counts
//              nowhere: a warp skips four slots when all of its lanes find
//              them above their hi, and tallies them otherwise without a
//              branch, in f32 counts, so that the adds issue on the FMA pipe
//              and four slots' compares interleave;
//   pass 4     writes the u16 index of every slot with d² ≤ hi, in slot
//              order, to the thread's list in shared memory (S entries,
//              column-major so that the threads of a warp hit distinct
//              banks), and the open ones among them (lo < d² ≤ hi; the
//              settled ones, d² ≤ lo, are selected whatever comes next)
//              once more at the list's tail;
//   list       the other halvings (2 at the headline, one 2-level visit)
//              count the open slots only, the settled ones as a base; then
//              the sibson statistics and the weighted sums run over the
//              listed slots in slot order, so the f64 accumulations see the
//              same terms in the same order as an all-slot pass would.
// Fewer than 12 halvings stop on the panel at `iters` (the last visit walks
// fewer levels). A thread whose list does not fit — #{d² ≤ hi} > S after the
// panel's halvings (ties, duplicated points), S = 0 from the wrapper's
// plan, or a panel staged chunk by chunk (wider than the staged width) —
// runs those steps over every slot instead, with the same result, and adds
// one to *overflow. A chunked panel is restaged on every pass, so there
// every thread overflows and the passes stay uniform across the CTA.
//
// Bit-equal d², hi, midpoints and τ² with the plain version: products and
// sums use __fmul_rn/__fadd_rn/__fsub_rn, so nvcc does not contract them
// into FMAs; counts are whole numbers, exact in f32. Build without
// --use_fast_math. The sums over the selected slots (s1, s2, Σw, Σw·v)
// accumulate in f64 and round once to f32, as the plain version's do: the
// one-pass variance cancels, and f32 sums taken in two different orders
// would disagree by more than the kernel's tolerance. Only ~k of the C
// slots are selected, so the f64 adds are few.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-10f;
constexpr float kBig = 1e19f;      // sentinel coordinate of the padding
constexpr float kHalfBig = 5e18f;  // d² at or above this is a sentinel's
constexpr int kIdw = 0;
constexpr int kMaxRows = 128;
constexpr int kLevels = 4;               // halvings resolved per tree visit
constexpr int kNodes = 1 << kLevels;     // tree heap 1..15; [0] is hi
constexpr int kMaxListSlots = 65536;     // what a u16 list entry indexes

// The staged slots: three planes of `width` f32 (the slots of one chunk,
// padded to a multiple of 4 with sentinel coordinates, which are never
// counted, listed or selected), the window starts and the store.
struct Panel {
  float* xs;
  float* ys;
  float* zs;
  const int* win;          // (R,) 128-aligned window starts
  const float* store;
  long long store_w;
  int L, C, chunk, width;  // width: padded length of a staged chunk
  bool staged_once;

  __device__ __forceinline__ int column(int s) const {
    const int r = s / L;
    return win[r] + (s - r * L);
  }
};

struct Query {
  float x, y, z;

  __device__ __forceinline__ float d2(float cx, float cy, float cz) const {
    const float dx = __fsub_rn(x, cx);
    const float dy = __fsub_rn(y, cy);
    const float dz = __fsub_rn(z, cz);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
  }
  __device__ __forceinline__ float d2_at(const Panel& p, int i) const {
    return d2(p.xs[i], p.ys[i], p.zs[i]);
  }
  // d² to the staged slots i..i+3 (i a multiple of 4): one 16-byte read of
  // each plane
  __device__ __forceinline__ void d2x4(const Panel& p, int i,
                                       float (&d)[4]) const {
    const float4 cx = *reinterpret_cast<const float4*>(p.xs + i);
    const float4 cy = *reinterpret_cast<const float4*>(p.ys + i);
    const float4 cz = *reinterpret_cast<const float4*>(p.zs + i);
    d[0] = d2(cx.x, cy.x, cz.x);
    d[1] = d2(cx.y, cy.y, cz.y);
    d[2] = d2(cx.z, cy.z, cz.z);
    d[3] = d2(cx.w, cy.w, cz.w);
  }
};

// Stages slots [c0, c0 + n) and their padding; all threads take part.
// Returns the padded length.
__device__ int stage(const Panel& p, int c0, int n) {
  const int n4 = (n + 3) & ~3;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    float x = kBig;
    float y = kBig;
    float z = kBig;
    if (i < n) {
      const int j = p.column(c0 + i);
      x = p.store[j];
      y = p.store[p.store_w + j];
      z = p.store[2 * p.store_w + j];
    }
    p.xs[i] = x;
    p.ys[i] = y;
    p.zs[i] = z;
  }
  return n4;
}

// Opens the chunk of slots starting at c0 and returns its padded length;
// restages when the panel does not fit the staged width. Every thread of
// the CTA calls it the same number of times (the loop bounds are uniform).
__device__ __forceinline__ int open_chunk(const Panel& p, int c0) {
  if (p.staged_once) return p.width;
  __syncthreads();
  const int n = stage(p, c0, min(p.chunk, p.C - c0));
  __syncthreads();
  return n;
}

// The midpoints the sequential loop would form over kLevels halvings of
// [lo, hi], as a heap: node n's children are 2n ([lo_n, t_n]) and 2n+1
// ([t_n, hi_n]); t[0] = hi.
__device__ __forceinline__ void tree(float lo, float hi, float (&t)[kNodes]) {
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
}

// Counts v at the midpoints t[n] ≥ v, without a branch. The counts are
// f32 (whole numbers, exact up to 2^24), so that their adds issue on the
// FMA pipe beside the compares.
__device__ __forceinline__ void tally(float v, const float (&t)[kNodes],
                                      float (&c)[kNodes]) {
#pragma unroll
  for (int n = 0; n < kNodes; ++n) {
    if (v <= t[n]) c[n] += 1.0f;
  }
}

// `levels` (≤ kLevels) halvings on #{d² ≤ mid} ≥ k from the counts at the
// tree's midpoints: the walk down it, which lands on the (lo, hi] the
// sequential loop reaches. A child's heap index exceeds its parent's, so
// one pass over the nodes in heap order meets the path's nodes in turn
// (constant indices only: the arrays stay in registers). n_hi becomes the
// count at the exit hi.
__device__ __forceinline__ void walk(const float (&c)[kNodes],
                                     const float (&t)[kNodes], int levels,
                                     int k, float& lo, float& hi, int& n_hi) {
  const int end = 1 << levels;
  n_hi = static_cast<int>(c[0]);
  int node = 1;
#pragma unroll
  for (int n = 1; n < kNodes; ++n) {
    if (n == node && n < end) {
      if (static_cast<int>(c[n]) < k) {
        lo = t[n];
        node = 2 * n + 1;
      } else {
        hi = t[n];
        n_hi = static_cast<int>(c[n]);
        node = 2 * n;
      }
    }
  }
}

// `levels` halvings from one sweep of the panel.
__device__ __forceinline__ void halve_panel(const Panel& p, const Query& q,
                                            int levels, int k, float& lo,
                                            float& hi, int& n_hi) {
  float t[kNodes];
  tree(lo, hi, t);
  float c[kNodes];
#pragma unroll
  for (int n = 0; n < kNodes; ++n) c[n] = 0.0f;
  for (int c0 = 0; c0 < p.C; c0 += p.chunk) {
    const int n = open_chunk(p, c0);
    for (int i = 0; i < n; i += 4) {
      float d[4];
      q.d2x4(p, i, d);
      // every midpoint lies at or below hi = t[0]: four slots above it
      // count nowhere, and the warp skips them when all its lanes do (each
      // lane votes for its own slots, so the lanes that vote together
      // need not be the whole warp)
      const float near = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
      if (__any_sync(__activemask(), near <= t[0])) {
#pragma unroll
        for (int j = 0; j < 4; ++j) tally(d[j], t, c);
      }
    }
  }
  walk(c, t, levels, k, lo, hi, n_hi);
}

// `levels` halvings from one visit of n listed slots (entries at `stride`);
// `base` slots not visited lie at d² ≤ lo and count at every midpoint.
__device__ __forceinline__ void halve_list(const Panel& p, const Query& q,
                                           const unsigned short* list, int n,
                                           int stride, int base, int levels,
                                           int k, float& lo, float& hi,
                                           int& n_hi) {
  float t[kNodes];
  tree(lo, hi, t);
  float c[kNodes];
#pragma unroll
  for (int m = 0; m < kNodes; ++m) c[m] = static_cast<float>(base);
  for (int e = 0; e < n; ++e) tally(q.d2_at(p, list[e * stride]), t, c);
  walk(c, t, levels, k, lo, hi, n_hi);
}

// The sibson statistics of the selected slots, added in slot order.
struct Moments {
  float n_sel = 0.0f;
  double s1 = 0.0;
  double s2 = 0.0;
  float dmin = 1e19f;

  __device__ __forceinline__ void add(float d2) {
    const float d = __fsqrt_rn(fmaxf(d2, 0.0f));
    n_sel += 1.0f;
    s1 += d;
    s2 += __fmul_rn(d, d);
    dmin = fminf(dmin, d);
  }
};

// The weighted sums of the selected slots, added in slot order; the value
// rows are read from global memory at the slot's store column.
struct Sums {
  const float* store;
  long long store_w;
  int mode;
  float power, dmin, std_eps;
  double den = 0.0;
  double num[3] = {0.0, 0.0, 0.0};

  __device__ __forceinline__ void add(float d2, int j) {
    float w;
    if (mode == kIdw) {
      const float pw = power == 2.0f ? d2 : powf(d2, 0.5f * power);
      w = __frcp_rn(__fadd_rn(pw, kEps));
    } else {
      const float d = __fsqrt_rn(fmaxf(d2, 0.0f));
      w = __fmul_rn(__frcp_rn(__fadd_rn(d, kEps)),
                    expf(__fdiv_rn(-__fsub_rn(d, dmin), std_eps)));
    }
    den += w;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      num[ch] += __fmul_rn(w, store[(3 + ch) * store_w + j]);
    }
  }
};

// kThreads/kMinBlocks bound the registers: blocks of up to 256 nodes (the
// headline's 128) get up to 128, wider ones, up to 1 024 threads, get 64.
template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pallas_grid_knn_kernel(const int* __restrict__ starts,
                       const int* __restrict__ ids,
                       const float* __restrict__ ax_x,
                       const float* __restrict__ ax_y,
                       const float* __restrict__ ax_z,
                       const float* __restrict__ store,
                       float* __restrict__ out, int* __restrict__ overflow,
                       int store_w, int R, int L, int chunk, int S, int by,
                       int bx, int nby, int nbx, int k, int mode, int iters,
                       int list_after, float power) {
  // dynamic shared memory: the x, y, z planes of `width` slots each, then
  // the shortlists (S u16 entries per thread, entry e of thread t at
  // e·B + t)
  extern __shared__ float4 smem[];
  __shared__ int win[kMaxRows];
  const int row = blockIdx.x;
  const int B = blockDim.x;
  const int t = threadIdx.x;
  const int bz = B / (by * bx);

  const int ib = ids[row];
  const int ibz = ib / (nby * nbx);
  const int iby = (ib / nbx) % nby;
  const int ibx = ib % nbx;
  const Query q{ax_x[ibx * bx + t % bx], ax_y[iby * by + (t / bx) % by],
                ax_z[ibz * bz + t / (by * bx)]};

  for (int r = t; r < R; r += B) {
    win[r] = (starts[static_cast<long long>(row) * R + r] / 128) * 128;
  }
  __syncthreads();

  const int C = R * L;
  const int width = (min(chunk, C) + 3) & ~3;
  float* xs = reinterpret_cast<float*>(smem);
  Panel p{xs,    xs + width, xs + 2 * width, win,  store, store_w,
          L,     C,          chunk,          width, chunk >= C};
  if (p.staged_once) {
    stage(p, 0, C);
    __syncthreads();
  }

  // pass 0: the upper bound, the farthest real slot of the windows
  float mx = 0.0f;
  for (int c0 = 0; c0 < C; c0 += chunk) {
    const int n = open_chunk(p, c0);
    for (int i = 0; i < n; i += 4) {
      float d[4];
      q.d2x4(p, i, d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (d[j] < kHalfBig) mx = fmaxf(mx, d[j]);
      }
    }
  }
  float lo = 0.0f;
  float hi = __fadd_rn(__fmul_rn(mx, 1.000001f), 1e-30f);

  // passes 1-3: the first list_after halvings, kLevels per sweep (one sweep
  // with no halving when iters is 0, for the count at hi)
  const int on_panel = min(iters, list_after);
  int done = 0;
  int n_hi = 0;
  do {
    const int levels = min(kLevels, on_panel - done);
    halve_panel(p, q, levels, k, lo, hi, n_hi);
    done += levels;
  } while (done < on_panel);

  // pass 4: the shortlist of every slot with d² ≤ hi, in slot order from
  // the list's head; and, in the S − n_hi entries left at its tail, the
  // open ones among them
  const bool on_list = S > 0 && p.staged_once && n_hi <= S;
  const unsigned short* listed = nullptr;
  const unsigned short* open_list = nullptr;
  int n_listed = 0;
  int n_open = 0;
  int n_settled = 0;
  if (on_list) {
    unsigned short* list =
        reinterpret_cast<unsigned short*>(xs + 3 * width) + t;
    bool open_fits = true;
    for (int i = 0; i < width; i += 4) {
      float d[4];
      q.d2x4(p, i, d);
      const float near = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
      if (!__any_sync(__activemask(), near <= hi)) continue;  // none listed
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (d[j] <= hi && n_listed < n_hi) {
          const unsigned short s = static_cast<unsigned short>(i + j);
          list[(n_listed++) * B] = s;
          if (d[j] > lo) {
            if (n_open < S - n_hi) {
              list[(S - 1 - n_open++) * B] = s;
            } else {
              open_fits = false;
            }
          }
        }
      }
    }
    listed = list;
    if (open_fits) {
      open_list = list + (S - n_open) * B;
      n_settled = n_listed - n_open;
    } else {
      open_list = list;
      n_open = n_listed;
    }
  } else if (overflow != nullptr) {
    atomicAdd(overflow, 1);
  }

  // the other halvings: the open slots only, or the panel on overflow
  while (done < iters) {
    const int levels = min(kLevels, iters - done);
    if (on_list) {
      halve_list(p, q, open_list, n_open, B, n_settled, levels, k, lo, hi,
                 n_hi);
    } else {
      halve_panel(p, q, levels, k, lo, hi, n_hi);
    }
    done += levels;
  }
  const float tau2 = hi;

  Sums sums{store, store_w, mode, power, 0.0f, 0.0f};
  if (mode != kIdw) {
    Moments m;
    if (on_list) {
      for (int e = 0; e < n_listed; ++e) {
        const float d2 = q.d2_at(p, listed[e * B]);
        if (d2 <= tau2) m.add(d2);
      }
    } else {
      for (int c0 = 0; c0 < C; c0 += chunk) {
        const int n = open_chunk(p, c0);
        for (int i = 0; i < n; i += 4) {
          float d[4];
          q.d2x4(p, i, d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (d[j] <= tau2) m.add(d[j]);
          }
        }
      }
    }
    const float n_sel = fmaxf(m.n_sel, 1.0f);
    const float m1 = __fdiv_rn(__double2float_rn(m.s1), n_sel);
    const float m2 = __fdiv_rn(__double2float_rn(m.s2), n_sel);
    const float var = fmaxf(__fsub_rn(m2, __fmul_rn(m1, m1)), 0.0f);
    sums.std_eps = __fadd_rn(__fsqrt_rn(var), kEps);
    sums.dmin = m.dmin;
  }

  if (on_list) {
    for (int e = 0; e < n_listed; ++e) {
      const int s = listed[e * B];
      const float d2 = q.d2_at(p, s);
      if (d2 <= tau2) sums.add(d2, p.column(s));
    }
  } else {
    for (int c0 = 0; c0 < C; c0 += chunk) {
      const int n = open_chunk(p, c0);
      for (int i = 0; i < n; i += 4) {
        float d[4];
        q.d2x4(p, i, d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (d[j] <= tau2) sums.add(d[j], p.column(c0 + i + j));
        }
      }
    }
  }

  const float den_c = fmaxf(__double2float_rn(sums.den), 1e-37f);
  float* o = out + (static_cast<long long>(row) * B + t) * 4;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    o[ch] = __fdiv_rn(__double2float_rn(sums.num[ch]), den_c);
  }
  o[3] = tau2;
}

}  // namespace

// Launches the kernel over n CTAs of B threads on `stream` (a cudaStream_t)
// with 12·⌈min(chunk, R·L)/4⌉·4 + 2·S·B bytes of dynamic shared memory: the
// staged x, y, z planes and a u16 shortlist of S entries per thread (S = 0:
// no lists; S > 0 needs R·L ≤ 65 536, what a u16 entry indexes).
// `list_after` halvings run on the panel before the lists are written.
// overflow (one int, incremented once per thread that ran over the whole
// panel) may be null. Returns the cudaError_t of the launch; 0 is success.
extern "C" int pallas_grid_knn_launch(const int* starts, const int* ids,
                                      const float* ax_x, const float* ax_y,
                                      const float* ax_z, const float* store,
                                      float* out, int* overflow, int store_w,
                                      int n, int R, int L, int chunk, int S,
                                      int B, int by, int bx, int nby, int nbx,
                                      int k, int mode, int iters,
                                      int list_after, float power,
                                      void* stream) {
  const long long C = static_cast<long long>(R) * L;
  if (R < 1 || R > kMaxRows || L < 1 || C > 0x7fffffffLL || B < 1 ||
      B > 1024 || B % (by * bx) != 0 || chunk < 1 || S < 0 || iters < 0 ||
      list_after < 0 || (S > 0 && C > kMaxListSlots)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t width = (static_cast<size_t>(chunk < C ? chunk : C) + 3) & ~3;
  const size_t smem = 3 * width * sizeof(float) +
                      static_cast<size_t>(S) * B * sizeof(unsigned short);
  auto kernel = B <= 256 ? pallas_grid_knn_kernel<256, 2>
                         : pallas_grid_knn_kernel<1024, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n), B, smem,
           static_cast<cudaStream_t>(stream)>>>(
      starts, ids, ax_x, ax_y, ax_z, store, out, overflow, store_w, R, L,
      chunk, S, by, bx, nby, nbx, k, mode, iters, list_after, power);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pallas_grid_knn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
