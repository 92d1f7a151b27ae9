// CRAFT's post-process on the card (sm_90a): connected components of the
// thresholded region and affinity maps, and a minimum-area rectangle per
// kept component.
//
// No TPU counterpart: the JAX package runs CTPN only, and CRAFT's own code
// (clovaai/CRAFT-pytorch craft_utils.py::getDetBoxes_core) runs this on the
// host with OpenCV. The contracts are those of ops/ccl.py and
// ops/craft_boxes.py, whose plain versions give the same bits.
//
// ccl_label: a pixel inside the image's extent is on when its region score
// is over low_text or its affinity over link_threshold (both strict; maps
// of one channel, DBNet's probability map, have no affinity). The
// components are those of 4-connectivity (CRAFT) or 8-connectivity (DB),
// each labelled by its least raster index, so the labels do not depend on
// the order in which threads run. The channels and the connectivity are
// template parameters: each instantiation is its own kernels. Union-find in
// four kernels:
//   ccl_label_runs_kernel: a warp per row; each on pixel's label is the
//     first pixel of its horizontal run (ballots over 32 pixels a step);
//     a run's first pixel also sets its statistics slot to empty;
//   ccl_label_union_kernel: a thread per pixel; where a run touches the
//     run above it (the first pixel of each touching stretch), the two
//     runs' trees are joined, the larger root under the smaller by
//     atomicMin (Playne and Hawick's union), so every root is the least
//     index of its component; with 8-connectivity a pixel whose upper
//     neighbour is off also joins its upper-left neighbour (unless its left
//     neighbour, which meets that one from below, is on) and its
//     upper-right one (unless its right neighbour is on);
//   ccl_label_stats_kernel: a thread per pixel writes its root as its
//     label; the first pixel of each run adds the run's length, extent and
//     largest region score to its root's statistics (atomics: sums, minima
//     and maxima, whose results do not depend on the order);
//   ccl_label_compact_kernel: a block per image walks the roots in raster
//     order and keeps those with area >= min_area and largest region score
//     >= text_threshold, up to the cap (the rest are counted), and counts
//     the pixels on and the components.
//
// craft_boxes: a block per kept component. Its text pixels (its pixels
// whose region score is over low_text: the link-only pixels are left out)
// are dilated by the (1 + niter)-square rectangle, niter = int(sqrt(area *
// min(w, h) / (w * h)) * 2), anchor at its centre as cv2.dilate sets it,
// inside the window [x - niter, x + w + niter + 1) (likewise y) clipped to
// the extent. Only each row's leftmost and rightmost pixels are kept: the
// dilation of a row's extremes gives the dilated row's extremes. Their
// convex hull (Andrew's monotone chain over the points in (y, x) order,
// collinear points dropped), then rotating calipers: for each hull edge e
// the rectangle along it, its area compared exactly in integers (a
// rectangle's area times |e|^2 is (max - min of e.p) * (max - min of n.p),
// n = e turned a quarter), the first smallest kept. Its corners, (u e + v
// n) / |e|^2 in double rounded to float, run clockwise on the image from
// (min u, min v). Where the sides differ by at most 10 %, the box is the
// axis-aligned box of the dilated pixels. The corners are rolled to start
// at the least x + y (float sums) and scaled by `scale`.
//
// db_boxes: a block per kept component of DB's map (no dilation): the
// same row extremes, hull and calipers over its own pixels, then DB's
// tests (MhLiao/DB seg_detector_representer.py::boxes_from_bitmap): the
// short side, the box's mean probability, the closed-form unclip and the
// second short side, and the corners mapped to the original image. The
// contract is ops/db_boxes.py's.
//
// Bit-identity with the plain versions: integer arithmetic where it can be
// exact; each double operation rounds on its own (-fmad=false).

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kCompactThreads = 1024;
constexpr int kBoxThreads = 128;
constexpr int kStats = 6;  // area, min x, min y, max x, max y, max score (ordered)

// float <-> int with the floats' order (no NaN on these maps)
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

template <int kCh>
__device__ __forceinline__ bool pixel_on(const float* px, float low, float link) {
  return kCh == 1 ? px[0] > low : (px[0] > low || px[1] > link);
}

template <int kCh>
__global__ void ccl_label_runs_kernel(const float* __restrict__ maps,
                                      const int* __restrict__ extent, int* __restrict__ labels,
                                      int* __restrict__ stats, int batch, int h, int w,
                                      float low, float link) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)batch * h) return;
  const int b = (int)(warp / h), y = (int)(warp % h);
  const int eh = extent[2 * b], ew = extent[2 * b + 1];
  int* row = labels + ((size_t)b * h + y) * w;
  int* st = stats + (size_t)b * h * w * kStats;
  const float* m = maps + ((size_t)b * h + y) * w * kCh;
  int open = -1;  // first pixel of a run still open at the chunk's start
  for (int x0 = 0; x0 < w; x0 += 32) {
    const int x = x0 + lane;
    const bool on = x < w && y < eh && x < ew && pixel_on<kCh>(m + kCh * (size_t)x, low, link);
    const unsigned onm = __ballot_sync(kAll, on);
    const unsigned off_below = ~onm & ((1u << lane) - 1u);
    const int start = off_below ? x0 + (32 - __clz(off_below)) : (open >= 0 ? open : x0);
    if (x < w) row[x] = on ? y * w + start : -1;
    if (on && start == x) {
      int* s = st + ((size_t)y * w + x) * kStats;
      s[0] = 0;
      s[1] = s[2] = 0x7fffffff;
      s[3] = s[4] = s[5] = (int)0x80000000;
    }
    const int last = __shfl_sync(kAll, start, 31);
    open = (onm >> 31) ? last : -1;
  }
}

__device__ __forceinline__ int find_root(const volatile int* L, int x) {
  int y;
  while ((y = L[x]) != x) x = y;
  return x;
}

__device__ void unite(int* L, int a, int b) {
  const volatile int* V = L;
  while (true) {
    a = find_root(V, a);
    b = find_root(V, b);
    if (a == b) return;
    if (a < b) {
      const int old = atomicMin(L + b, a);
      if (old == b) return;
      b = old;
    } else {
      const int old = atomicMin(L + a, b);
      if (old == a) return;
      a = old;
    }
  }
}

template <bool kEight>
__global__ void ccl_label_union_kernel(int* __restrict__ labels, int batch, int h, int w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)batch * h * w) return;
  const int hw = h * w;
  const int b = (int)(i / hw), p = (int)(i % hw);
  const int y = p / w, x = p % w;
  if (y == 0) return;
  int* L = labels + (size_t)b * hw;
  const volatile int* V = L;
  if (V[p] < 0) return;
  if (V[p - w] >= 0) {
    // the runs of this pixel and of the one above, once per touching stretch
    if (x > 0 && V[p - 1] >= 0 && V[p - 1 - w] >= 0) return;
    unite(L, V[p], V[p - w]);
    return;
  }
  if (!kEight) return;
  // the diagonals, each unless a neighbour in this row meets it from below
  if (x > 0 && V[p - 1 - w] >= 0 && V[p - 1] < 0) unite(L, V[p], V[p - 1 - w]);
  if (x + 1 < w && V[p + 1 - w] >= 0 && V[p + 1] < 0) unite(L, V[p], V[p + 1 - w]);
}

template <int kCh>
__global__ void ccl_label_stats_kernel(const float* __restrict__ maps, int* __restrict__ labels,
                                       int* __restrict__ stats, int batch, int h, int w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)batch * h * w) return;
  const int hw = h * w;
  const int b = (int)(i / hw), p = (int)(i % hw);
  int* L = labels + (size_t)b * hw;
  const volatile int* V = L;
  const int own = V[p];
  if (own < 0) return;
  const int x = p % w, y = p / w;
  const bool first = x == 0 || V[p - 1] < 0;  // off pixels keep -1 throughout
  const int root = find_root(V, own);
  if (first) {
    const float* m = maps + (size_t)b * hw * kCh;
    int n = 0, best = (int)0x80000000;
    for (int q = p; x + n < w && V[q] >= 0; ++q, ++n) best = max(best, ordered(m[kCh * (size_t)q]));
    int* s = stats + ((size_t)b * hw + root) * kStats;
    atomicAdd(s, n);
    atomicMin(s + 1, x);
    atomicMin(s + 2, y);
    atomicMax(s + 3, x + n - 1);
    atomicMax(s + 4, y);
    atomicMax(s + 5, best);
  }
  L[p] = root;  // a shortcut to the root: every path through p stays whole
}

// one block per image: the roots in raster order, kept ones compacted
__global__ void __launch_bounds__(kCompactThreads)
ccl_label_compact_kernel(const int* __restrict__ labels, const int* __restrict__ stats,
                         const float* __restrict__ maps, int* __restrict__ out_stats,
                         float* __restrict__ out_score, int* __restrict__ count,
                         int* __restrict__ over, int* __restrict__ on_count,
                         int* __restrict__ labelled, int h, int w, int min_area,
                         float text, int cap) {
  __shared__ int warp_kept[kCompactThreads / 32];
  __shared__ int sums[3];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hw = h * w;
  const int* L = labels + (size_t)b * hw;
  const int* st = stats + (size_t)b * hw * kStats;
  int* os = out_stats + (size_t)b * cap * kStats;
  float* sc = out_score + (size_t)b * cap;
  int kept_before = 0, on_n = 0, roots_n = 0;
  for (int base = 0; base < hw; base += kCompactThreads) {
    const int p = base + tid;
    const int lab = p < hw ? L[p] : -1;
    const bool root = lab == p;
    bool keep = false;
    if (root) {
      const int* s = st + (size_t)p * kStats;
      keep = s[0] >= min_area && unordered(s[5]) >= text;
    }
    on_n += lab >= 0;
    roots_n += root;
    const unsigned km = __ballot_sync(kAll, keep);
    if (lane == 0) warp_kept[warp] = __popc(km);
    __syncthreads();
    int before = kept_before;
    for (int k = 0; k < warp; ++k) before += warp_kept[k];
    before += __popc(km & ((1u << lane) - 1u));
    if (keep && before < cap) {
      const int* s = st + (size_t)p * kStats;
      int* o = os + (size_t)before * kStats;
      o[0] = p;
      o[1] = s[0];
      o[2] = s[1];
      o[3] = s[2];
      o[4] = s[3] - s[1] + 1;
      o[5] = s[4] - s[2] + 1;
      sc[before] = unordered(s[5]);
    }
    int total = 0;
    for (int k = 0; k < kCompactThreads / 32; ++k) total += warp_kept[k];
    kept_before += total;
    __syncthreads();
  }
  if (tid < 3) sums[tid] = 0;
  __syncthreads();
  atomicAdd(&sums[0], on_n);
  atomicAdd(&sums[1], roots_n);
  __syncthreads();
  if (tid == 0) {
    const int k = kept_before < cap ? kept_before : cap;
    count[b] = k;
    over[b] = kept_before - k;
    on_count[b] = sums[0];
    labelled[b] = sums[1];
  }
}

// ------------------------------------------------------------- boxes

__device__ __forceinline__ long long cross3(int ox, int oy, int ax, int ay, int bx, int by) {
  return (long long)(ax - ox) * (by - oy) - (long long)(ay - oy) * (bx - ox);
}

// dynamic shared memory of one block, in ints: the source rows of the
// component's box and the dilated rows of its window (at most h each), the
// points (at most 2 h) and the chain (at most twice the points, and one)
__host__ __device__ constexpr int box_smem_ints(int h) { return 4 * h + 2 * (2 * h) + 2 * (4 * h + 2); }

struct BoxShared {
  int* src_lo;
  int* src_hi;
  int* dil_lo;
  int* dil_hi;
  int* px;
  int* py;
  int* hx;
  int* hy;
};

__device__ BoxShared box_shared(int* smem, int h) {
  BoxShared S;
  S.src_lo = smem;
  S.src_hi = S.src_lo + h;
  S.dil_lo = S.src_hi + h;
  S.dil_hi = S.dil_lo + h;
  S.px = S.dil_hi + h;
  S.py = S.px + 2 * h;
  S.hx = S.py + 2 * h;
  S.hy = S.hx + (4 * h + 2);
  return S;
}

// thread 0: the leftmost and rightmost pixels of rows y_first .. y_first +
// rows - 1 (lo[r], hi[r]; hi < 0: an empty row) as points in (y, x) order,
// then their convex hull by Andrew's monotone chain, collinear points
// dropped, into S.hx, S.hy; returns its size
__device__ int row_hull(const int* lo, const int* hi, int y_first, int rows, BoxShared S) {
  int* px = S.px;
  int* py = S.py;
  int n = 0;
  for (int r = 0; r < rows; ++r) {
    if (hi[r] < 0) continue;
    px[n] = lo[r];
    py[n] = y_first + r;
    ++n;
    if (hi[r] != lo[r]) {
      px[n] = hi[r];
      py[n] = y_first + r;
      ++n;
    }
  }
  int nh = 0;
  if (n == 0) {
    nh = 0;
  } else if (n == 1) {
    S.hx[0] = px[0];
    S.hy[0] = py[0];
    nh = 1;
  } else {
    for (int i = 0; i < n; ++i) {
      while (nh >= 2 && cross3(S.hx[nh - 2], S.hy[nh - 2], S.hx[nh - 1], S.hy[nh - 1],
                               px[i], py[i]) <= 0)
        --nh;
      S.hx[nh] = px[i];
      S.hy[nh] = py[i];
      ++nh;
    }
    const int t = nh + 1;
    for (int i = n - 2; i >= 0; --i) {
      while (nh >= t && cross3(S.hx[nh - 2], S.hy[nh - 2], S.hx[nh - 1], S.hy[nh - 1],
                               px[i], py[i]) <= 0)
        --nh;
      S.hx[nh] = px[i];
      S.hy[nh] = py[i];
      ++nh;
    }
    --nh;  // the last point is the first
  }
  return nh;
}

// every thread of the block: the hull edge of least area * |e|^2 / |e|^2
// (compared exactly), the first on ties; the answer is thread 0's (-1 for
// a hull of one point or none)
__device__ int best_edge(const int* hx, const int* hy, int nh) {
  __shared__ long long best_a[kBoxThreads], best_l[kBoxThreads];
  __shared__ int best_i[kBoxThreads];
  const int tid = threadIdx.x;
  long long ba = -1, bl = 1;
  int bi = -1;
  if (nh > 1) {
    for (int e = tid; e < nh; e += kBoxThreads) {
      const int j = e + 1 < nh ? e + 1 : 0;
      const long long dx = hx[j] - hx[e], dy = hy[j] - hy[e];
      long long umin = LLONG_MAX, umax = LLONG_MIN, vmin = LLONG_MAX, vmax = LLONG_MIN;
      for (int q = 0; q < nh; ++q) {
        const long long u = dx * hx[q] + dy * hy[q];
        const long long v = dx * hy[q] - dy * hx[q];
        umin = min(umin, u);
        umax = max(umax, u);
        vmin = min(vmin, v);
        vmax = max(vmax, v);
      }
      const long long ar = (umax - umin) * (vmax - vmin), l = dx * dx + dy * dy;
      if (bi < 0 || ar * bl < ba * l) {
        ba = ar;
        bl = l;
        bi = e;
      }
    }
  }
  best_a[tid] = ba;
  best_l[tid] = bl;
  best_i[tid] = bi;
  __syncthreads();
  if (tid != 0) return -1;
  for (int t = 1; t < kBoxThreads; ++t) {
    if (best_i[t] < 0) continue;
    const long long lhs = best_a[t] * bl, rhs = ba * best_l[t];
    if (bi < 0 || lhs < rhs || (lhs == rhs && best_i[t] < bi)) {
      ba = best_a[t];
      bl = best_l[t];
      bi = best_i[t];
    }
  }
  return bi;
}

// the rectangle along hull edge bi: its corners (u e + v n) / |e|^2 in
// double rounded to float at (min u, min v), (max u, min v), (max u, max
// v), (min u, max v); its sides U / |e| and V / |e| in double
__device__ void edge_rect(const int* hx, const int* hy, int nh, int bi, float* cx, float* cy,
                          double* side_u, double* side_v) {
  const int j = bi + 1 < nh ? bi + 1 : 0;
  const long long dx = hx[j] - hx[bi], dy = hy[j] - hy[bi];
  long long umin = LLONG_MAX, umax = LLONG_MIN, vmin = LLONG_MAX, vmax = LLONG_MIN;
  for (int q = 0; q < nh; ++q) {
    const long long u = dx * hx[q] + dy * hy[q];
    const long long v = dx * hy[q] - dy * hx[q];
    umin = min(umin, u);
    umax = max(umax, u);
    vmin = min(vmin, v);
    vmax = max(vmax, v);
  }
  const double l = (double)(dx * dx + dy * dy);
  const long long us[4] = {umin, umax, umax, umin}, vs[4] = {vmin, vmin, vmax, vmax};
  for (int c = 0; c < 4; ++c) {
    cx[c] = (float)__ddiv_rn((double)(us[c] * dx - vs[c] * dy), l);
    cy[c] = (float)__ddiv_rn((double)(us[c] * dy + vs[c] * dx), l);
  }
  const double root_l = __dsqrt_rn(l);
  *side_u = __ddiv_rn((double)(umax - umin), root_l);
  *side_v = __ddiv_rn((double)(vmax - vmin), root_l);
}

__global__ void __launch_bounds__(kBoxThreads)
craft_boxes_kernel(const float* __restrict__ maps, const int* __restrict__ labels,
                   const int* __restrict__ cstats, const float* __restrict__ score,
                   const int* __restrict__ count, const int* __restrict__ extent,
                   float* __restrict__ recs, int h, int w, int cap, float low, float scale) {
  extern __shared__ int smem[];
  __shared__ int nh_s;
  const int b = blockIdx.y, slot = blockIdx.x, tid = threadIdx.x;
  if (slot >= count[b]) return;
  const int* cs = cstats + ((size_t)b * cap + slot) * kStats;
  const int root = cs[0], area = cs[1], x0 = cs[2], y0 = cs[3], cw = cs[4], ch = cs[5];
  const int eh = extent[2 * b], ew = extent[2 * b + 1];
  const BoxShared S = box_shared(smem, h);

  const int niter = (int)(sqrt((double)(area * min(cw, ch)) / (double)(cw * ch)) * 2.0);
  const int k = 1 + niter, a = k / 2, back = k - 1 - a;
  const int sx = max(x0 - niter, 0), ex = min(x0 + cw + niter + 1, ew);
  const int sy = max(y0 - niter, 0), ey = min(y0 + ch + niter + 1, eh);

  for (int r = tid; r < ch; r += kBoxThreads) {
    S.src_lo[r] = 0x7fffffff;
    S.src_hi[r] = -1;
  }
  __syncthreads();
  const int* L = labels + (size_t)b * h * w;
  const float* m = maps + (size_t)b * h * w * 2;
  for (int i = tid; i < cw * ch; i += kBoxThreads) {
    const int y = y0 + i / cw, x = x0 + i % cw;
    const size_t p = (size_t)y * w + x;
    if (L[p] == root && m[2 * p] > low) {
      atomicMin(&S.src_lo[y - y0], x);
      atomicMax(&S.src_hi[y - y0], x);
    }
  }
  __syncthreads();
  // each dilated row: the source rows y - a .. y + back
  for (int y = sy + tid; y < ey; y += kBoxThreads) {
    int lo = 0x7fffffff, hi = -1;
    const int q0 = max(y - a, y0), q1 = min(y + back, y0 + ch - 1);
    for (int q = q0; q <= q1; ++q) {
      lo = min(lo, S.src_lo[q - y0]);
      hi = max(hi, S.src_hi[q - y0]);
    }
    S.dil_lo[y - sy] = hi >= 0 ? max(lo - back, sx) : 0x7fffffff;
    S.dil_hi[y - sy] = hi >= 0 ? min(hi + a, ex - 1) : -1;
  }
  __syncthreads();
  if (tid == 0) nh_s = row_hull(S.dil_lo, S.dil_hi, sy, ey - sy, S);
  __syncthreads();
  const int nh = nh_s;
  const int bi = best_edge(S.hx, S.hy, nh);
  if (tid != 0) return;
  float cx[4], cy[4];
  if (nh <= 1) {  // one point, or none (no text pixel): zeros
    for (int c = 0; c < 4; ++c) {
      cx[c] = nh ? (float)S.hx[0] : 0.0f;
      cy[c] = nh ? (float)S.hy[0] : 0.0f;
    }
  } else {
    double sw, sh;
    edge_rect(S.hx, S.hy, nh, bi, cx, cy, &sw, &sh);
    const double ratio = __ddiv_rn(fmax(sw, sh), __dadd_rn(fmin(sw, sh), 1e-5));
    if (fabs(__dsub_rn(1.0, ratio)) <= 0.1) {
      int l0 = 0x7fffffff, r0 = -1, t0 = -1, b0 = -1;
      for (int y = sy; y < ey; ++y) {
        if (S.dil_hi[y - sy] < 0) continue;
        l0 = min(l0, S.dil_lo[y - sy]);
        r0 = max(r0, S.dil_hi[y - sy]);
        if (t0 < 0) t0 = y;
        b0 = y;
      }
      cx[0] = cx[3] = (float)l0;
      cx[1] = cx[2] = (float)r0;
      cy[0] = cy[1] = (float)t0;
      cy[2] = cy[3] = (float)b0;
    }
  }
  int start = 0;
  float least = __fadd_rn(cx[0], cy[0]);
  for (int c = 1; c < 4; ++c) {
    const float s = __fadd_rn(cx[c], cy[c]);
    if (s < least) {
      least = s;
      start = c;
    }
  }
  float* rec = recs + ((size_t)b * cap + slot) * 9;
  for (int c = 0; c < 4; ++c) {
    const int from = (start + c) & 3;
    rec[2 * c] = __fmul_rn(cx[from], scale);
    rec[2 * c + 1] = __fmul_rn(cy[from], scale);
  }
  rec[8] = score[(size_t)b * cap + slot];
}

// MhLiao's get_mini_boxes' order of four corners: sorted by x (stable),
// the upper of the left two, the upper of the right two, the lower of the
// right two, the lower of the left two (the later of a pair on equal y)
__device__ void mini_order(const float* x, const float* y, float* ox, float* oy) {
  int idx[4] = {0, 1, 2, 3};
  for (int i = 1; i < 4; ++i)
    for (int j = i; j > 0 && x[idx[j]] < x[idx[j - 1]]; --j) {
      const int t = idx[j];
      idx[j] = idx[j - 1];
      idx[j - 1] = t;
    }
  const bool left = y[idx[1]] > y[idx[0]], right = y[idx[3]] > y[idx[2]];
  const int order[4] = {left ? idx[0] : idx[1], right ? idx[2] : idx[3],
                        right ? idx[3] : idx[2], left ? idx[1] : idx[0]};
  for (int c = 0; c < 4; ++c) {
    ox[c] = x[order[c]];
    oy[c] = y[order[c]];
  }
}

// the length of (ax, ay) -> (bx, by) in double
__device__ __forceinline__ double edge_len(double ax, double ay, double bx, double by) {
  const double dx = __dsub_rn(bx, ax), dy = __dsub_rn(by, ay);
  return __dsqrt_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)));
}

__global__ void __launch_bounds__(kBoxThreads)
db_boxes_kernel(const float* __restrict__ prob, const int* __restrict__ labels,
                const int* __restrict__ cstats, const int* __restrict__ count,
                const int* __restrict__ extent, const float* __restrict__ dest,
                float* __restrict__ recs, int* __restrict__ keep, int h, int w, int cap,
                double box_thresh, double unclip, double min_size) {
  extern __shared__ int smem[];
  __shared__ int nh_s, go_s, bbox_s[4], poly_s[8];
  __shared__ float box_s[8];
  __shared__ double part[kBoxThreads];
  __shared__ int part_n[kBoxThreads];
  const int b = blockIdx.y, slot = blockIdx.x, tid = threadIdx.x;
  if (slot >= count[b]) return;
  const int* cs = cstats + ((size_t)b * cap + slot) * kStats;
  const int root = cs[0], x0 = cs[2], y0 = cs[3], cw = cs[4], ch = cs[5];
  const int eh = extent[2 * b], ew = extent[2 * b + 1];
  const BoxShared S = box_shared(smem, h);
  for (int r = tid; r < ch; r += kBoxThreads) {
    S.src_lo[r] = 0x7fffffff;
    S.src_hi[r] = -1;
  }
  __syncthreads();
  const int* L = labels + (size_t)b * h * w;
  const float* pm = prob + (size_t)b * h * w;
  for (int i = tid; i < cw * ch; i += kBoxThreads) {
    const int y = y0 + i / cw, x = x0 + i % cw;
    if (L[(size_t)y * w + x] == root) {
      atomicMin(&S.src_lo[y - y0], x);
      atomicMax(&S.src_hi[y - y0], x);
    }
  }
  __syncthreads();
  if (tid == 0) nh_s = row_hull(S.src_lo, S.src_hi, y0, ch, S);
  __syncthreads();
  const int nh = nh_s;
  const int bi = best_edge(S.hx, S.hy, nh);
  if (tid == 0) {
    int go = 0;
    if (nh > 1) {
      float cx[4], cy[4], ox[4], oy[4];
      double su, sv;
      edge_rect(S.hx, S.hy, nh, bi, cx, cy, &su, &sv);
      if (fmin(su, sv) >= min_size) {
        mini_order(cx, cy, ox, oy);
        float lx = ox[0], hx = ox[0], ly = oy[0], hy = oy[0];
        for (int c = 1; c < 4; ++c) {
          lx = fminf(lx, ox[c]);
          hx = fmaxf(hx, ox[c]);
          ly = fminf(ly, oy[c]);
          hy = fmaxf(hy, oy[c]);
        }
        const int xmin = min(max((int)floorf(lx), 0), ew - 1);
        const int xmax = min(max((int)ceilf(hx), 0), ew - 1);
        const int ymin = min(max((int)floorf(ly), 0), eh - 1);
        const int ymax = min(max((int)ceilf(hy), 0), eh - 1);
        bbox_s[0] = xmin;
        bbox_s[1] = ymin;
        bbox_s[2] = xmax - xmin + 1;
        bbox_s[3] = ymax - ymin + 1;
        for (int c = 0; c < 4; ++c) {
          box_s[2 * c] = ox[c];
          box_s[2 * c + 1] = oy[c];
          poly_s[2 * c] = (int)__fsub_rn(ox[c], (float)xmin);
          poly_s[2 * c + 1] = (int)__fsub_rn(oy[c], (float)ymin);
        }
        go = 1;
      }
    }
    go_s = go;
  }
  __syncthreads();
  if (!go_s) return;
  // the box's score: the mean probability over the pixels of its clipped
  // bounding box inside or on the quad of its truncated corners; each
  // thread sums the pixels t, t + 128, ... in raster order, thread 0 the
  // threads in order (double)
  const int bx0 = bbox_s[0], by0 = bbox_s[1], bw = bbox_s[2], bh = bbox_s[3];
  double acc = 0.0;
  int n = 0;
  for (int i = tid; i < bw * bh; i += kBoxThreads) {
    const int lx = i % bw, ly = i / bw;
    bool neg = false, pos = false;
    for (int c = 0; c < 4; ++c) {
      const int d = (c + 1) & 3;
      const long long cr = cross3(poly_s[2 * c], poly_s[2 * c + 1], poly_s[2 * d],
                                  poly_s[2 * d + 1], lx, ly);
      neg |= cr < 0;
      pos |= cr > 0;
    }
    if (!(neg && pos)) {
      acc = __dadd_rn(acc, (double)pm[(size_t)(by0 + ly) * w + bx0 + lx]);
      ++n;
    }
  }
  part[tid] = acc;
  part_n[tid] = n;
  __syncthreads();
  if (tid != 0) return;
  double total = 0.0;
  int total_n = 0;
  for (int t = 0; t < kBoxThreads; ++t) {
    total = __dadd_rn(total, part[t]);
    total_n += part_n[t];
  }
  const double score = total_n ? __ddiv_rn(total, (double)total_n) : 0.0;
  if (score < box_thresh) return;
  // the unclip: the rectangle grown by d = area * unclip / perimeter on
  // every side (the round-joined offset's minimum-area rectangle)
  double x[4], y[4];
  for (int c = 0; c < 4; ++c) {
    x[c] = (double)box_s[2 * c];
    y[c] = (double)box_s[2 * c + 1];
  }
  double twice = 0.0, perim = 0.0;
  for (int c = 0; c < 4; ++c) {
    const int d = (c + 1) & 3;
    twice = __dadd_rn(twice, __dsub_rn(__dmul_rn(x[c], y[d]), __dmul_rn(x[d], y[c])));
    perim = __dadd_rn(perim, edge_len(x[c], y[c], x[d], y[d]));
  }
  const double dist = __ddiv_rn(__dmul_rn(__dmul_rn(fabs(twice), 0.5), unclip), perim);
  double gx[4], gy[4];
  for (int c = 0; c < 4; ++c) {
    const int nx = (c + 1) & 3, pv = (c + 3) & 3;
    const double lu = edge_len(x[nx], y[nx], x[c], y[c]), lv = edge_len(x[pv], y[pv], x[c], y[c]);
    gx[c] = __dadd_rn(__dadd_rn(x[c], __ddiv_rn(__dmul_rn(dist, __dsub_rn(x[c], x[nx])), lu)),
                      __ddiv_rn(__dmul_rn(dist, __dsub_rn(x[c], x[pv])), lv));
    gy[c] = __dadd_rn(__dadd_rn(y[c], __ddiv_rn(__dmul_rn(dist, __dsub_rn(y[c], y[nx])), lu)),
                      __ddiv_rn(__dmul_rn(dist, __dsub_rn(y[c], y[pv])), lv));
  }
  const double side = fmin(edge_len(gx[0], gy[0], gx[1], gy[1]),
                           edge_len(gx[0], gy[0], gx[3], gy[3]));
  if (side < __dadd_rn(min_size, 2.0)) return;
  float fx[4], fy[4], ox[4], oy[4];
  for (int c = 0; c < 4; ++c) {
    fx[c] = (float)gx[c];
    fy[c] = (float)gy[c];
  }
  mini_order(fx, fy, ox, oy);
  // to the original image: round(v / size * original), clipped to [0, original]
  const float dh = dest[2 * b], dw = dest[2 * b + 1];
  float* rec = recs + ((size_t)b * cap + slot) * 9;
  for (int c = 0; c < 4; ++c) {
    const float vx = rintf(__fmul_rn(__fdiv_rn(ox[c], (float)ew), dw));
    const float vy = rintf(__fmul_rn(__fdiv_rn(oy[c], (float)eh), dh));
    rec[2 * c] = fminf(fmaxf(vx, 0.0f), dw);
    rec[2 * c + 1] = fminf(fmaxf(vy, 0.0f), dh);
  }
  rec[8] = (float)score;
  keep[(size_t)b * cap + slot] = 1;
}

template <int kCh, bool kEight>
int ccl_label(const void* maps, const void* extent, void* labels, void* stats, void* out_stats,
              void* out_score, void* count, void* over, void* on_count, void* labelled,
              int batch, int h, int w, float low, float link, float text, int min_area, int cap,
              cudaStream_t s) {
  const long long rows = (long long)batch * h, pixels = rows * w;
  const unsigned row_blocks = (unsigned)((rows * 32 + kThreads - 1) / kThreads);
  const unsigned px_blocks = (unsigned)((pixels + kThreads - 1) / kThreads);
  ccl_label_runs_kernel<kCh><<<row_blocks, kThreads, 0, s>>>(
      (const float*)maps, (const int*)extent, (int*)labels, (int*)stats, batch, h, w, low, link);
  ccl_label_union_kernel<kEight><<<px_blocks, kThreads, 0, s>>>((int*)labels, batch, h, w);
  ccl_label_stats_kernel<kCh><<<px_blocks, kThreads, 0, s>>>((const float*)maps, (int*)labels,
                                                            (int*)stats, batch, h, w);
  ccl_label_compact_kernel<<<batch, kCompactThreads, 0, s>>>(
      (const int*)labels, (const int*)stats, (const float*)maps, (int*)out_stats,
      (float*)out_score, (int*)count, (int*)over, (int*)on_count, (int*)labelled, h, w,
      min_area, text, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// maps (batch, h, w, channels) float32, channels 2 [region, affinity] or 1
// [probability]; extent (batch, 2) int32 [rows, cols] of the map read;
// connectivity 4 or 8; labels (batch, h, w) int32 out; stats (batch, h, w,
// 6) int32 workspace; out_stats (batch, cap, 6) int32 and out_score (batch,
// cap) float32, zeroed by the caller; count, over, on_count, labelled
// (batch,) int32 out.
int ctpn_ccl_label(const void* maps, const void* extent, void* labels, void* stats,
                   void* out_stats, void* out_score, void* count, void* over, void* on_count,
                   void* labelled, int batch, int h, int w, float low, float link, float text,
                   int min_area, int cap, int channels, int connectivity, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define CTPN_CCL(CH, EIGHT)                                                                   \
  ccl_label<CH, EIGHT>(maps, extent, labels, stats, out_stats, out_score, count, over,       \
                       on_count, labelled, batch, h, w, low, link, text, min_area, cap, s)
  if (channels == 2 && connectivity == 4) return CTPN_CCL(2, false);
  if (channels == 2 && connectivity == 8) return CTPN_CCL(2, true);
  if (channels == 1 && connectivity == 4) return CTPN_CCL(1, false);
  if (channels == 1 && connectivity == 8) return CTPN_CCL(1, true);
#undef CTPN_CCL
  return (int)cudaErrorInvalidValue;
}

// maps and labels as ccl_label's; cstats (batch, cap, 6), score (batch,
// cap), count (batch,) its kept components; extent (batch, 2); recs
// (batch, cap, 9) float32 out, zeroed by the caller.
int ctpn_craft_boxes(const void* maps, const void* labels, const void* cstats, const void* score,
                     const void* count, const void* extent, void* recs, int batch, int h, int w,
                     int cap, float low, float scale, void* stream) {
  if (batch == 0 || cap == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)box_smem_ints(h) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        craft_boxes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)cap, (unsigned)batch);
  craft_boxes_kernel<<<grid, kBoxThreads, smem, (cudaStream_t)stream>>>(
      (const float*)maps, (const int*)labels, (const int*)cstats, (const float*)score,
      (const int*)count, (const int*)extent, (float*)recs, h, w, cap, low, scale);
  return (int)cudaGetLastError();
}

// prob (batch, h, w) float32; labels, cstats, count and extent as
// craft_boxes'; dest (batch, 2) float32 [rows, cols] of each original image;
// recs (batch, cap, 9) float32 and keep (batch, cap) int32 out, zeroed by
// the caller.
int ctpn_db_boxes(const void* prob, const void* labels, const void* cstats, const void* count,
                  const void* extent, const void* dest, void* recs, void* keep, int batch, int h,
                  int w, int cap, double box_thresh, double unclip, double min_size,
                  void* stream) {
  if (batch == 0 || cap == 0) return (int)cudaSuccess;
  // the kernel's static shared memory (about 4 KB) comes on top of this:
  // at h 736 the two pass the 48 KB a launch gets unless it asks for more
  const size_t smem = (size_t)box_smem_ints(h) * sizeof(int);
  const cudaError_t err = cudaFuncSetAttribute(
      db_boxes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)cap, (unsigned)batch);
  db_boxes_kernel<<<grid, kBoxThreads, smem, (cudaStream_t)stream>>>(
      (const float*)prob, (const int*)labels, (const int*)cstats, (const int*)count,
      (const int*)extent, (const float*)dest, (float*)recs, (int*)keep, h, w, cap, box_thresh,
      unclip, min_size);
  return (int)cudaGetLastError();
}

}  // extern "C"
