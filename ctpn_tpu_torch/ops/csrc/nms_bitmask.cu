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
// What bounds it on the H100: operations. At N = 12000 the upper triangle
// is 72 million pair tests (about 1.2e9 f32 operations, 17 us at the
// card's 67 TFLOP/s), while the output is 18 MB (5 us at 3.35 TB/s). The
// TPU kernel tiled the pair relation into VPU-shaped blocks and packed
// bits with an MXU matmul because the VPU cannot shuffle lanes; here the
// reference's CUDA design fits (lib/utils/nms_kernel.cu):
//   1. a CTA owns 128 rows and 16 words (512 columns) of one image;
//   2. the column boxes, their areas and flags are staged in shared memory;
//   3. one thread per row computes its 16 words, 32 pair tests each, with
//      the column box broadcast to the whole warp;
//   4. the words go through a padded shared tile so that the global store
//      is coalesced along the row (word index fastest).
// Tiles wholly below the diagonal skip steps 2-3 and only write zeros.
//
// Bit-identity: the IoU arithmetic must round exactly as the plain PyTorch
// version and as numpy/XLA do. Every add, subtract and multiply below uses
// the _rn intrinsics, which nvcc never contracts into FMAs; the library is
// also built with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;               // rows per CTA = threads per CTA
constexpr int kWords = 16;               // 32-bit words per CTA
constexpr int kCols = kWords * 32;       // columns per CTA
constexpr int kTileLd = kWords + 1;      // padded stride of the word tile

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

__global__ void __launch_bounds__(kRows)
nms_bitmask_kernel(const float4* __restrict__ boxes,
                   const uint8_t* __restrict__ valid,
                   uint32_t* __restrict__ mask,
                   int n, int words, float thresh) {
  __shared__ float4 cols[kCols];
  __shared__ float col_area[kCols];
  __shared__ uint8_t col_ok[kCols];
  __shared__ uint32_t tile[kRows * kTileLd];

  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * kWords;
  const int row0 = blockIdx.y * kRows;
  const size_t img = blockIdx.z;
  boxes += img * n;
  valid += img * n;
  mask += img * n * static_cast<size_t>(words);

  const int c0 = w0 * 32;
  const int c_end = min(c0 + kCols, n);
  // a bit needs a column j above a row i: some j in [c0, c_end) > row0
  const bool live = c_end - 1 > row0;  // uniform over the CTA

  if (live) {
    for (int c = tid; c < kCols; c += kRows) {
      const int j = c0 + c;
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      bool ok = false;
      if (j < n) {
        b = boxes[j];
        ok = valid[j] != 0;
      }
      cols[c] = b;
      col_area[c] = area(b);
      col_ok[c] = ok;
    }
    __syncthreads();

    const int i = row0 + tid;
    bool row_ok = false;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n) {
      a = boxes[i];
      row_ok = valid[i] != 0;
    }
    const float area_a = area(a);
    for (int w = 0; w < kWords; ++w) {
      uint32_t bits = 0u;
      const int base = c0 + w * 32;
      if (row_ok && base + 31 > i && base < n) {
        for (int l = 0; l < 32; ++l) {
          const int c = w * 32 + l;
          if (base + l > i && col_ok[c] &&
              suppresses(a, area_a, cols[c], col_area[c], thresh)) {
            bits |= 1u << l;
          }
        }
      }
      tile[tid * kTileLd + w] = bits;
    }
    __syncthreads();
  }

  // store the tile with the word index fastest: a warp writes two rows'
  // 16 consecutive words at a time
  const int nw = min(kWords, words - w0);
  for (int k = tid; k < kRows * kWords; k += kRows) {
    const int r = k / kWords;
    const int w = k % kWords;
    const int i = row0 + r;
    if (i < n && w < nw) {
      mask[static_cast<size_t>(i) * words + w0 + w] =
          live ? tile[r * kTileLd + w] : 0u;
    }
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
  dim3 grid((words + kWords - 1) / kWords, (n + kRows - 1) / kRows, batch);
  nms_bitmask_kernel<<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint32_t*>(mask), n, words, thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
