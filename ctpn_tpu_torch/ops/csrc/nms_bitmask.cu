// NMS suppression bitmask over score-sorted boxes (sm_90a).
//
// Replaces the TPU kernel ctpn_tpu/ops/nms_pallas.py::_bitmask_kernel
// (reached through suppression_bitmask_pallas, pl.pallas_call at
// nms_pallas.py:129). Same function as ctpn_tpu/ops/nms.py::
// suppression_bitmask_jnp: boxes (B, N, 4) f32 and valid (B, N) bool,
// sorted by score descending, give mask (B, N, W) 32-bit words with
// W = ceil(N / 32). Bit j % 32 of word j / 32 in row i is set iff j > i,
// both boxes are valid, and inter >= t * max(area_i + area_j - inter,
// 1e-10) with +1-pixel areas. Every other bit is 0, including all words
// below the diagonal. The words are stored as int32 carrying these bits.
//
// What bounds it on the H100: operations, counted as instructions issued.
// At N = 12000 the upper triangle is 72 million pair tests of 16 float
// operations each, none of which can fuse (bit-identity, below), and half
// of those are min, max or compare, which issue at half the rate of add
// and multiply; the output is 18 MB (5 us at 3.35 TB/s). Running all
// sixteen on every pair, however lean the rest (lanes over columns,
// __ballot_sync as the word), gains little over a thread per row. So this
// design does not run them on every pair:
//   1. prefilter. Two boxes whose +1-pixel extents do not overlap in x or
//      in y have inter = 0 and cannot suppress. Lanes run over columns: a
//      warp owns kLaneWords words (128 columns) of a tile, each lane holds
//      its kLaneWords column boxes in registers, and the CTA's kRows rows
//      stream past as one broadcast read of shared memory each. A pair
//      costs four compares and one OR into a lane-local bit set
//      (hits[q][h], bit r: row 32h + r may meet my column of word q). The
//      compares are conservative: they use x2 + 1 and y2 + 1 rounded up, so
//      a pair they drop has iw <= 0 or ih <= 0 in the rounded arithmetic
//      too. They are taken only when t * 1e-10 > 0 in f32, so that
//      0 >= t * union is false for every union; else every pair is a hit;
//   2. validity and order are masks on the bit sets, not per-pair tests:
//      the lane's column flag, one word of row flags, and, only in warps
//      whose columns meet the CTA's rows, the rows before the lane's column;
//   3. exact tests. Each lane walks its own hits (a text detector's anchor
//      grid leaves one pair in a few hundred) and runs the full test of
//      suppression_bitmask_jnp in its order, into a second lane-local bit
//      set. Lanes diverge here; with few hits that is cheap. If every pair
//      is a hit (all boxes identical) the lanes run all tests serially,
//      about 1.6 times the instructions of the all-pairs design;
//   4. transposition. A row's output word is the ballot of its bit over
//      the lanes. One warp-wide OR finds the rows that have a bit at all,
//      and only those are balloted; lane r keeps row r's word and stores
//      it into a shared tile (row stride 33 words: no bank conflict);
//   5. a CTA owns kRows rows and walks tiles of kTileWords words (1024
//      columns, kWarps x kLaneWords) with a stride of gridDim.x. Tiles left
//      of the diagonal are zero-filled straight to global memory; computed
//      tiles go through the double-buffered shared tile, so that a warp
//      stores a row's 32 consecutive words (128 bytes) at a time and one
//      __syncthreads per tile is enough. The launcher deals the tiles of a
//      row band over several CTAs when the bands alone would be too few to
//      overlap the stores of one CTA with the tests of another.
//
// Bit-identity: the IoU arithmetic must round exactly as the plain PyTorch
// version and as numpy/XLA do. Every add, subtract and multiply of the
// exact test uses the _rn intrinsics, which nvcc never contracts into FMAs;
// the library is also built with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                        // rows per CTA
constexpr int kHalves = kRows / 32;              // 32-row bit sets per column
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLaneWords = 4;                    // words per warp, columns per lane
constexpr int kWarpCols = kLaneWords * 32;       // columns per warp: 128
constexpr int kTileWords = kWarps * kLaneWords;  // words per tile: 32
constexpr int kTileCols = kTileWords * 32;       // columns per tile: 1024
constexpr int kTileLd = kTileWords + 1;          // padded row stride of the tile
constexpr int kTargetCtas = 8192;                // the launcher's aim
constexpr uint32_t kFull = 0xffffffffu;
static_assert(kRows % 32 == 0 && kRows <= kThreads, "rows load in whole warps");
static_assert(kTileWords == 32, "a warp stores one tile row per instruction");

__device__ __forceinline__ float side(float lo, float hi) {
  return __fadd_rn(__fsub_rn(hi, lo), 1.0f);
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(side(b.x, b.z), side(b.y, b.w));
}

// True iff row box `a` and column box `b` overlap with IoU >= t
// (divide-free, +1 areas), in the order of suppression_bitmask_jnp.
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float area_b, float t) {
  float iw = __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f);
  float ih = __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f);
  float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  float uni = fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-10f);
  return inter >= __fmul_rn(t, uni);
}

// One warp's kLaneWords words of every row of the CTA, into its strip of
// the shared tile (`out`: row stride kTileLd). kDiag: the warp's columns
// meet the CTA's rows, so each column keeps only the rows before it.
template <bool kDiag>
__device__ __forceinline__ void warp_tile(const float4* __restrict__ rows,
                                          const float* __restrict__ row_area,
                                          const float4* __restrict__ row_pre,
                                          const uint32_t* __restrict__ row_ok,
                                          const float4* __restrict__ boxes,
                                          const uint8_t* __restrict__ valid,
                                          int n, int row0, int col0, float t,
                                          bool prefilter, int lane,
                                          uint32_t* __restrict__ out) {
  float4 col[kLaneWords];
  float col_x2[kLaneWords], col_y2[kLaneWords];  // x2 + 1, y2 + 1, rounded up
  bool col_ok[kLaneWords];
#pragma unroll
  for (int q = 0; q < kLaneWords; ++q) {
    const int j = col0 + 32 * q + lane;
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    bool ok = false;
    if (j < n) {
      b = boxes[j];
      ok = valid[j] != 0;
    }
    col[q] = b;
    col_ok[q] = ok;
    col_x2[q] = __fadd_ru(b.z, 1.0f);
    col_y2[q] = __fadd_ru(b.w, 1.0f);
  }

  // 1. prefilter: hits[q][h] bit r = row 32h + r may overlap column q
  uint32_t hits[kLaneWords][kHalves];
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
#pragma unroll
    for (int q = 0; q < kLaneWords; ++q) hits[q][h] = prefilter ? 0u : kFull;
    if (prefilter) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const float4 p = row_pre[h * 32 + r];  // x1, y1, ru(x2 + 1), ru(y2 + 1)
#pragma unroll
        for (int q = 0; q < kLaneWords; ++q) {
          if (col[q].x < p.z && p.x < col_x2[q] && col[q].y < p.w &&
              p.y < col_y2[q]) {
            hits[q][h] |= 1u << r;
          }
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kLaneWords; ++q) {
    const int j = col0 + 32 * q + lane;
    const float area_b = area(col[q]);
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      // 2. both boxes valid, and the row before the column
      uint32_t m = col_ok[q] ? hits[q][h] & row_ok[h] : 0u;
      if (kDiag) {
        const int lim = j - (row0 + 32 * h);  // local rows below lim precede j
        m &= lim <= 0 ? 0u : (lim >= 32 ? kFull : (1u << lim) - 1u);
      }
      // 3. the exact test on this lane's hits
      uint32_t bits = 0u;
      while (m != 0u) {
        const int r = __ffs(m) - 1;
        m &= m - 1u;
        if (suppresses(rows[h * 32 + r], row_area[h * 32 + r], col[q], area_b, t)) {
          bits |= 1u << r;
        }
      }
      // 4. row r's word is the ballot of bit r over the lanes
      uint32_t some = __reduce_or_sync(kFull, bits);
      uint32_t word = 0u;
      while (some != 0u) {  // uniform
        const int r = __ffs(some) - 1;
        some &= some - 1u;
        const uint32_t w = __ballot_sync(kFull, (bits >> r) & 1u);
        if (lane == r) word = w;
      }
      out[(h * 32 + lane) * kTileLd + q] = word;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
nms_bitmask_kernel(const float4* __restrict__ boxes,
                   const uint8_t* __restrict__ valid,
                   uint32_t* __restrict__ mask,
                   int n, int words, float thresh) {
  __shared__ float4 rows[kRows];
  __shared__ float4 row_pre[kRows];
  __shared__ float row_area[kRows];
  __shared__ uint32_t row_ok[kHalves];
  __shared__ uint32_t tile[2][kRows * kTileLd];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.y * kRows;
  const size_t img = blockIdx.z;
  boxes += img * n;
  valid += img * n;
  mask += img * n * static_cast<size_t>(words);
  const int n_rows = min(kRows, n - row0);
  const bool prefilter = __fmul_rn(thresh, 1e-10f) > 0.0f;

  if (tid < kRows) {
    const int i = row0 + tid;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    bool ok = false;
    if (i < n) {
      a = boxes[i];
      ok = valid[i] != 0;
    }
    rows[tid] = a;
    row_area[tid] = area(a);
    row_pre[tid] =
        make_float4(a.x, a.y, __fadd_ru(a.z, 1.0f), __fadd_ru(a.w, 1.0f));
    const uint32_t oks = __ballot_sync(kFull, ok);
    if (lane == 0) row_ok[warp] = oks;
  }
  __syncthreads();

  const int tiles = (words + kTileWords - 1) / kTileWords;
  int parity = 0;
  for (int ct = blockIdx.x; ct < tiles; ct += gridDim.x) {
    const int w0 = ct * kTileWords;
    const int nw = min(kTileWords, words - w0);
    uint32_t* dst = mask + static_cast<size_t>(row0) * words + w0;
    // a bit needs a column j above a row i: some j of the tile > row0
    if (min(w0 * 32 + kTileCols, n) - 1 <= row0) {  // uniform over the CTA
      for (int r = warp; r < n_rows; r += kWarps) {
        if (lane < nw) dst[static_cast<size_t>(r) * words + lane] = 0u;
      }
      continue;
    }

    uint32_t* out = tile[parity] + warp * kLaneWords;
    const int col0 = w0 * 32 + warp * kWarpCols;  // this warp's first column
    if (col0 >= n || col0 + kWarpCols - 1 <= row0) {  // uniform over the warp
      for (int r = lane; r < kRows; r += 32) {
#pragma unroll
        for (int q = 0; q < kLaneWords; ++q) out[r * kTileLd + q] = 0u;
      }
    } else if (col0 > row0 + kRows - 1) {
      warp_tile<false>(rows, row_area, row_pre, row_ok, boxes, valid, n, row0,
                       col0, thresh, prefilter, lane, out);
    } else {
      warp_tile<true>(rows, row_area, row_pre, row_ok, boxes, valid, n, row0,
                      col0, thresh, prefilter, lane, out);
    }
    __syncthreads();
    // a warp stores one row's 32 consecutive words at a time; the other
    // buffer takes the next tile meanwhile
    for (int r = warp; r < n_rows; r += kWarps) {
      if (lane < nw) {
        dst[static_cast<size_t>(r) * words + lane] =
            tile[parity][r * kTileLd + lane];
      }
    }
    parity ^= 1;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and writes every word of `mask` (batch * n * words
// 32-bit words, words = ceil(n / 32)). Returns cudaGetLastError() so that
// the caller sees a refused launch.
int ctpn_nms_bitmask(const void* boxes, const void* valid, void* mask,
                     int batch, int n, float thresh, void* stream) {
  const int words = (n + 31) / 32;
  const int tiles = (words + kTileWords - 1) / kTileWords;
  const int bands = (n + kRows - 1) / kRows;
  // one CTA walks all tiles of its row band (its rows loaded once) unless
  // that leaves fewer than about kTargetCtas CTAs: then the band's tiles
  // are dealt over up to `tiles` CTAs
  const int split = max(1, min(tiles, kTargetCtas / max(1, bands * batch)));
  dim3 grid(split, bands, batch);
  nms_bitmask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint32_t*>(mask), n, words, thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
