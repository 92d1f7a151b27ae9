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
// is over low_text or its affinity over link_threshold (both strict). The
// components are those of 4-connectivity, each labelled by its least
// raster index, so the labels do not depend on the order in which threads
// run. Union-find in four kernels:
//   ccl_label_runs_kernel: a warp per row; each on pixel's label is the
//     first pixel of its horizontal run (ballots over 32 pixels a step);
//     a run's first pixel also sets its statistics slot to empty;
//   ccl_label_union_kernel: a thread per pixel; where a run touches the
//     run above it (the first pixel of each touching stretch), the two
//     runs' trees are joined, the larger root under the smaller by
//     atomicMin (Playne and Hawick's union), so every root is the least
//     index of its component;
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

__device__ __forceinline__ bool pixel_on(const float* px, float low, float link) {
  return px[0] > low || px[1] > link;
}

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
  const float* m = maps + ((size_t)b * h + y) * w * 2;
  int open = -1;  // first pixel of a run still open at the chunk's start
  for (int x0 = 0; x0 < w; x0 += 32) {
    const int x = x0 + lane;
    const bool on = x < w && y < eh && x < ew && pixel_on(m + 2 * (size_t)x, low, link);
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

__global__ void ccl_label_union_kernel(int* __restrict__ labels, int batch, int h, int w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)batch * h * w) return;
  const int hw = h * w;
  const int b = (int)(i / hw), p = (int)(i % hw);
  const int y = p / w, x = p % w;
  if (y == 0) return;
  int* L = labels + (size_t)b * hw;
  const volatile int* V = L;
  // the runs of this pixel and of the one above, once per touching stretch
  if (V[p] < 0 || V[p - w] < 0) return;
  if (x > 0 && V[p - 1] >= 0 && V[p - 1 - w] >= 0) return;
  unite(L, V[p], V[p - w]);
}

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
    const float* m = maps + (size_t)b * hw * 2;
    int n = 0, best = (int)0x80000000;
    for (int q = p; x + n < w && V[q] >= 0; ++q, ++n) best = max(best, ordered(m[2 * (size_t)q]));
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

__global__ void __launch_bounds__(kBoxThreads)
craft_boxes_kernel(const float* __restrict__ maps, const int* __restrict__ labels,
                   const int* __restrict__ cstats, const float* __restrict__ score,
                   const int* __restrict__ count, const int* __restrict__ extent,
                   float* __restrict__ recs, int h, int w, int cap, float low, float scale) {
  extern __shared__ int smem[];
  __shared__ long long best_a[kBoxThreads], best_l[kBoxThreads];
  __shared__ int best_i[kBoxThreads];
  __shared__ int nh_s;
  const int b = blockIdx.y, slot = blockIdx.x, tid = threadIdx.x;
  if (slot >= count[b]) return;
  const int* cs = cstats + ((size_t)b * cap + slot) * kStats;
  const int root = cs[0], area = cs[1], x0 = cs[2], y0 = cs[3], cw = cs[4], ch = cs[5];
  const int eh = extent[2 * b], ew = extent[2 * b + 1];
  BoxShared S;
  S.src_lo = smem;
  S.src_hi = S.src_lo + h;
  S.dil_lo = S.src_hi + h;
  S.dil_hi = S.dil_lo + h;
  S.px = S.dil_hi + h;
  S.py = S.px + 2 * h;
  S.hx = S.py + 2 * h;
  S.hy = S.hx + (4 * h + 2);

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
  if (tid == 0) {
    // the points in (y, x) order, then the monotone chain
    int* px = S.px;
    int* py = S.py;
    int n = 0;
    for (int y = sy; y < ey; ++y) {
      const int lo = S.dil_lo[y - sy], hi = S.dil_hi[y - sy];
      if (hi < 0) continue;
      px[n] = lo;
      py[n] = y;
      ++n;
      if (hi != lo) {
        px[n] = hi;
        py[n] = y;
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
    nh_s = nh;
  }
  __syncthreads();
  const int nh = nh_s;
  // each thread's best edge: least area * |e|^2 / |e|^2, the first on ties
  long long ba = -1, bl = 1;
  int bi = -1;
  if (nh > 1) {
    for (int e = tid; e < nh; e += kBoxThreads) {
      const int j = e + 1 < nh ? e + 1 : 0;
      const long long dx = S.hx[j] - S.hx[e], dy = S.hy[j] - S.hy[e];
      long long umin = LLONG_MAX, umax = LLONG_MIN, vmin = LLONG_MAX, vmax = LLONG_MIN;
      for (int q = 0; q < nh; ++q) {
        const long long u = dx * S.hx[q] + dy * S.hy[q];
        const long long v = dx * S.hy[q] - dy * S.hx[q];
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
  if (tid != 0) return;
  for (int t = 1; t < kBoxThreads; ++t) {
    if (best_i[t] < 0) continue;
    const long long lhs = best_a[t] * bl, rhs = ba * best_l[t];
    if (bi < 0 || lhs < rhs || (lhs == rhs && best_i[t] < bi)) {
      ba = best_a[t];
      bl = best_l[t];
      bi = best_i[t];
    }
  }
  float cx[4], cy[4];
  if (nh <= 1) {  // one point, or none (no text pixel): zeros
    for (int c = 0; c < 4; ++c) {
      cx[c] = nh ? (float)S.hx[0] : 0.0f;
      cy[c] = nh ? (float)S.hy[0] : 0.0f;
    }
  } else {
    const int j = bi + 1 < nh ? bi + 1 : 0;
    const long long dx = S.hx[j] - S.hx[bi], dy = S.hy[j] - S.hy[bi];
    long long umin = LLONG_MAX, umax = LLONG_MIN, vmin = LLONG_MAX, vmax = LLONG_MIN;
    for (int q = 0; q < nh; ++q) {
      const long long u = dx * S.hx[q] + dy * S.hy[q];
      const long long v = dx * S.hy[q] - dy * S.hx[q];
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
    const double sw = __ddiv_rn((double)(umax - umin), root_l);
    const double sh = __ddiv_rn((double)(vmax - vmin), root_l);
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

}  // namespace

extern "C" {

// maps (batch, h, w, 2) float32 [region, affinity]; extent (batch, 2) int32
// [rows, cols] of the map read; labels (batch, h, w) int32 out; stats
// (batch, h, w, 6) int32 workspace; out_stats (batch, cap, 6) int32 and
// out_score (batch, cap) float32, zeroed by the caller; count, over,
// on_count, labelled (batch,) int32 out.
int ctpn_ccl_label(const void* maps, const void* extent, void* labels, void* stats,
                   void* out_stats, void* out_score, void* count, void* over, void* on_count,
                   void* labelled, int batch, int h, int w, float low, float link, float text,
                   int min_area, int cap, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)batch * h, pixels = rows * w;
  const unsigned row_blocks = (unsigned)((rows * 32 + kThreads - 1) / kThreads);
  const unsigned px_blocks = (unsigned)((pixels + kThreads - 1) / kThreads);
  ccl_label_runs_kernel<<<row_blocks, kThreads, 0, s>>>(
      (const float*)maps, (const int*)extent, (int*)labels, (int*)stats, batch, h, w, low, link);
  ccl_label_union_kernel<<<px_blocks, kThreads, 0, s>>>((int*)labels, batch, h, w);
  ccl_label_stats_kernel<<<px_blocks, kThreads, 0, s>>>((const float*)maps, (int*)labels,
                                                       (int*)stats, batch, h, w);
  ccl_label_compact_kernel<<<batch, kCompactThreads, 0, s>>>(
      (const int*)labels, (const int*)stats, (const float*)maps, (int*)out_stats,
      (float*)out_score, (int*)count, (int*)over, (int*)on_count, (int*)labelled, h, w,
      min_area, text, cap);
  return (int)cudaGetLastError();
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

}  // extern "C"
