// EAST's two quad kernels (sm_90a): the locality-aware NMS walk and the
// quad suppression bitmask, sharing one convex-quad IoU device function.
//
// No TPU counterpart: the JAX package runs CTPN, whose NMS tests
// axis-aligned boxes. The contracts are those of ops/lanms.py and
// ops/quad_nms.py, whose plain PyTorch versions follow the same float32
// arithmetic step for step:
//
//   quad_iou(a, b): Sutherland-Hodgman clipping of quad a by quad b (b
//   convex; its orientation from the sign of its shoelace sum), each edge
//   emitting, for vertex i and its predecessor, the crossing if they lie on
//   opposite sides and then vertex i if it is inside (side >= 0); the
//   shoelace sum of the clipped polygon from vertex 0 up; areas |sum| / 2;
//   inter / (area_a + area_b - inter), 0 where the union is not positive.
//
// Bit-identity with the plain version: every add, subtract, multiply and
// divide uses the _rn intrinsics, which nvcc never contracts into FMAs, and
// the library is built with -fmad=false.
//
// lanms_walk_kernel: the walk is sequential by definition (each cell is
// tested against the quad that the cells before it merged), but a text
// row's cells mostly fold, run after run: a CTA of four warps per image (so
// the images spread over the SMs) tests 128 cells at once, each against the
// open quad as the cells before it would leave it, and keeps the prefix
// that folds. What bounds it is the latency of one IoU per step.
//
// quad_bitmask_kernel: a thread per (row, word) of the mask, consecutive
// threads on consecutive words of a row, so the stores coalesce. A thread
// whose row is invalid or whose word lies left of the diagonal only stores
// a zero; the others test the row quad against the word's 32 column quads,
// the full IoU only where the axis-aligned extents meet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxV = 16;  // vertices a clipped polygon may hold
constexpr int kThreads = 256;
constexpr int kWalkWarps = 4;  // warps that walk one image
constexpr int kWalkLanes = 32 * kWalkWarps;  // cells a step of the walk tests

__device__ __forceinline__ float signed2(const float* xs, const float* ys, int n) {
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1 < n) ? i + 1 : 0;
    acc = __fadd_rn(acc, __fsub_rn(__fmul_rn(xs[i], ys[j]), __fmul_rn(xs[j], ys[i])));
  }
  return acc;
}

__device__ __forceinline__ float side(float ex, float ey, float ax, float ay, float px,
                                      float py, bool flip) {
  const float c = __fsub_rn(__fmul_rn(ex, __fsub_rn(py, ay)), __fmul_rn(ey, __fsub_rn(px, ax)));
  return flip ? -c : c;
}

// IoU of quads a and b ([x1, y1, ..., x4, y4]), a clipped by b
__device__ float quad_iou(const float* a, const float* b) {
  float ax[4], ay[4], bx[4], by[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ax[k] = a[2 * k];
    ay[k] = a[2 * k + 1];
    bx[k] = b[2 * k];
    by[k] = b[2 * k + 1];
  }
  const bool flip = signed2(bx, by, 4) < 0.0f;
  float sx[kMaxV], sy[kMaxV], tx[kMaxV], ty[kMaxV];
  int n = 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sx[k] = ax[k];
    sy[k] = ay[k];
  }
  for (int e = 0; e < 4 && n > 0; ++e) {
    const float x0 = bx[e], y0 = by[e];
    const float ex = __fsub_rn(bx[(e + 1) & 3], x0), ey = __fsub_rn(by[(e + 1) & 3], y0);
    float px = sx[n - 1], py = sy[n - 1];
    float cp = side(ex, ey, x0, y0, px, py, flip);
    int m = 0;
    for (int i = 0; i < n; ++i) {
      const float qx = sx[i], qy = sy[i];
      const float cq = side(ex, ey, x0, y0, qx, qy, flip);
      const bool cin = cq >= 0.0f, pin = cp >= 0.0f;
      if (cin != pin) {
        const float t = __fdiv_rn(cp, __fsub_rn(cp, cq));
        if (m < kMaxV) {
          tx[m] = __fadd_rn(px, __fmul_rn(t, __fsub_rn(qx, px)));
          ty[m] = __fadd_rn(py, __fmul_rn(t, __fsub_rn(qy, py)));
        }
        ++m;
      }
      if (cin) {
        if (m < kMaxV) {
          tx[m] = qx;
          ty[m] = qy;
        }
        ++m;
      }
      px = qx;
      py = qy;
      cp = cq;
    }
    n = m < kMaxV ? m : kMaxV;
    for (int k = 0; k < n; ++k) {
      sx[k] = tx[k];
      sy[k] = ty[k];
    }
  }
  const float inter = __fmul_rn(fabsf(signed2(sx, sy, n)), 0.5f);
  const float uni = __fsub_rn(__fadd_rn(__fmul_rn(fabsf(signed2(ax, ay, 4)), 0.5f),
                                        __fmul_rn(fabsf(signed2(bx, by, 4)), 0.5f)),
                              inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

// A CTA of kWalkWarps warps walks each image, kWalkLanes cells a step. The
// open quad is held as sums (W, the score-weighted vertices, and S, the
// scores) of the cells it folds. Thread k takes cell i + k and the open quad
// as it would be had cells i .. i + k - 1 all folded: (W + P) / (S + P_s),
// P the exclusive prefix sum of s * q over the threads before it: a
// Hillis-Steele scan in each warp, then the warps' totals added in warp
// order. The first thread whose cell does not fold (a ballot per warp) ends
// the step: the cells before it fold (their tests were against the true
// open quad), its cell closes the open quad and opens its own, and the next
// step starts after it; a step in which every cell folds moves on by
// kWalkLanes.
__global__ void __launch_bounds__(kWalkLanes)
lanms_walk_kernel(const float* __restrict__ cells, const int32_t* __restrict__ count,
                  float* __restrict__ merged, int32_t* __restrict__ ncells,
                  int32_t* __restrict__ kept, int32_t* __restrict__ over, int m_cells, int cap,
                  float t) {
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ float tot[kWalkWarps][9];  // each warp's sums: s, then the vertices
  __shared__ unsigned stops[kWalkWarps];
  __shared__ float pick[2][9];  // the sums through the last fold; the closing cell
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = count[b];
  const float* c = cells + (size_t)b * m_cells * 9;
  float* out = merged + (size_t)b * cap * 9;
  int32_t* out_n = ncells + (size_t)b * cap;
  int closed = 0;
  if (n > 0) {
    float S = c[0], W[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) W[k] = __fmul_rn(S, c[1 + k]);
    int cnt = 1;
    int i = 1;
    while (i < n) {
      const int j = i + tid;
      const bool live = j < n;
      float s = 0.0f, q[8], v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) q[k] = 0.0f;
      if (live) {
        s = c[(size_t)j * 9];
#pragma unroll
        for (int k = 0; k < 8; ++k) q[k] = c[(size_t)j * 9 + 1 + k];
      }
      float vs = s;
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __fmul_rn(s, q[k]);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float us = __shfl_up_sync(kAll, vs, off);
        if (lane >= off) vs = __fadd_rn(vs, us);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float u = __shfl_up_sync(kAll, v[k], off);
          if (lane >= off) v[k] = __fadd_rn(v[k], u);
        }
      }
      if (lane == 31) {
        tot[warp][0] = vs;
#pragma unroll
        for (int k = 0; k < 8; ++k) tot[warp][1 + k] = v[k];
      }
      __syncthreads();
      // the warps before this one, summed in warp order
      float ps = 0.0f, pv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) pv[k] = 0.0f;
      for (int w = 0; w < warp; ++w) {
        ps = w == 0 ? tot[0][0] : __fadd_rn(ps, tot[w][0]);
#pragma unroll
        for (int k = 0; k < 8; ++k) pv[k] = w == 0 ? tot[0][1 + k] : __fadd_rn(pv[k], tot[w][1 + k]);
      }
      if (warp > 0) {
        vs = __fadd_rn(vs, ps);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = __fadd_rn(v[k], pv[k]);
      }
      float es = __shfl_up_sync(kAll, vs, 1), oq[8];
      if (lane == 0) es = ps;
      const float os = __fadd_rn(S, es);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float e = __shfl_up_sync(kAll, v[k], 1);
        if (lane == 0) e = pv[k];
        oq[k] = __fdiv_rn(__fadd_rn(W[k], e), os);
      }
      const bool fold = live && quad_iou(q, oq) > t;
      const unsigned stop = __ballot_sync(kAll, !fold);
      if (lane == 0) stops[warp] = stop;
      __syncthreads();
      int f = kWalkLanes;
      for (int w = 0; w < kWalkWarps; ++w) {
        if (stops[w]) {
          f = w * 32 + __ffs(stops[w]) - 1;
          break;
        }
      }
      if (tid == f - 1) {
        pick[0][0] = vs;
#pragma unroll
        for (int k = 0; k < 8; ++k) pick[0][1 + k] = v[k];
      }
      if (tid == f) {
        pick[1][0] = s;
#pragma unroll
        for (int k = 0; k < 8; ++k) pick[1][1 + k] = q[k];
      }
      __syncthreads();
      float fs = 0.0f, fv[8], ns = 0.0f, nq[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        fv[k] = f > 0 ? pick[0][1 + k] : 0.0f;
        nq[k] = f < kWalkLanes ? pick[1][1 + k] : 0.0f;
      }
      if (f > 0) fs = pick[0][0];
      if (f < kWalkLanes) ns = pick[1][0];
      __syncthreads();  // shared memory is free for the next step
      if (f > 0) {
        S = __fadd_rn(S, fs);
#pragma unroll
        for (int k = 0; k < 8; ++k) W[k] = __fadd_rn(W[k], fv[k]);
        cnt += f;
      }
      if (f == kWalkLanes) {
        i += kWalkLanes;
        continue;
      }
      if (i + f >= n) break;  // every live cell folded
      if (tid == 0 && closed < cap) {
        out[closed * 9] = S;
#pragma unroll
        for (int k = 0; k < 8; ++k) out[closed * 9 + 1 + k] = __fdiv_rn(W[k], S);
        out_n[closed] = cnt;
      }
      ++closed;
      S = ns;
#pragma unroll
      for (int k = 0; k < 8; ++k) W[k] = __fmul_rn(S, nq[k]);
      cnt = 1;
      i += f + 1;
    }
    if (tid == 0 && closed < cap) {
      out[closed * 9] = S;
#pragma unroll
      for (int k = 0; k < 8; ++k) out[closed * 9 + 1 + k] = __fdiv_rn(W[k], S);
      out_n[closed] = cnt;
    }
    ++closed;
  }
  if (tid == 0) {
    const int k = closed < cap ? closed : cap;
    kept[b] = k;
    over[b] = closed - k;
  }
}

__global__ void quad_bitmask_kernel(const float* __restrict__ quads,
                                    const bool* __restrict__ valid,
                                    int32_t* __restrict__ mask, int k, int words, float t) {
  const int b = blockIdx.y;
  const long long flat = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (flat >= (long long)k * words) return;
  const int i = (int)(flat / words), w = (int)(flat % words);
  const float* q = quads + (size_t)b * k * 8;
  const bool* v = valid + (size_t)b * k;
  const int j0 = w * 32;
  uint32_t bits = 0;
  if (v[i] && j0 + 31 > i) {
    float a[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) a[c] = q[(size_t)i * 8 + c];
    const float ax0 = fminf(fminf(a[0], a[2]), fminf(a[4], a[6]));
    const float ax1 = fmaxf(fmaxf(a[0], a[2]), fmaxf(a[4], a[6]));
    const float ay0 = fminf(fminf(a[1], a[3]), fminf(a[5], a[7]));
    const float ay1 = fmaxf(fmaxf(a[1], a[3]), fmaxf(a[5], a[7]));
    const int j1 = min(j0 + 32, k);
    for (int j = max(j0, i + 1); j < j1; ++j) {
      if (!v[j]) continue;
      const float* bq = q + (size_t)j * 8;
      const float bx0 = fminf(fminf(bq[0], bq[2]), fminf(bq[4], bq[6]));
      const float bx1 = fmaxf(fmaxf(bq[0], bq[2]), fmaxf(bq[4], bq[6]));
      const float by0 = fminf(fminf(bq[1], bq[3]), fminf(bq[5], bq[7]));
      const float by1 = fmaxf(fmaxf(bq[1], bq[3]), fmaxf(bq[5], bq[7]));
      if (ax0 > bx1 || bx0 > ax1 || ay0 > by1 || by0 > ay1) continue;
      if (quad_iou(a, bq) > t) bits |= 1u << (j - j0);
    }
  }
  mask[((size_t)b * k + i) * words + w] = (int32_t)bits;
}

}  // namespace

extern "C" int ctpn_lanms_walk(const void* cells, const void* count, void* merged,
                               void* ncells, void* kept, void* over, int batch, int m_cells,
                               int cap, float t, void* stream) {
  lanms_walk_kernel<<<batch, kWalkLanes, 0, (cudaStream_t)stream>>>(
      (const float*)cells, (const int32_t*)count, (float*)merged, (int32_t*)ncells,
      (int32_t*)kept, (int32_t*)over, m_cells, cap, t);
  return (int)cudaGetLastError();
}

extern "C" int ctpn_quad_bitmask(const void* quads, const void* valid, void* mask, int batch,
                                 int k, float t, void* stream) {
  const int words = (k + 31) / 32;
  const long long total = (long long)k * words;
  const dim3 grid((unsigned)((total + kThreads - 1) / kThreads), (unsigned)batch);
  quad_bitmask_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)quads, (const bool*)valid, (int32_t*)mask, k, words, t);
  return (int)cudaGetLastError();
}
