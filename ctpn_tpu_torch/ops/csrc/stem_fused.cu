// VGG block 1 fused: conv1_1 + ReLU + conv1_2 + ReLU + 2x2/2 max-pool
// (sm_90a).
//
// Replaces the TPU kernel ctpn_tpu/ops/stem_pallas.py::_stem_kernel
// (reached through fused_stem_block, pl.pallas_call at stem_pallas.py:140).
// Same function: x (N, H, W, 3) bf16 (NHWC in memory, i.e. an NCHW tensor
// in channels_last) gives out (N, H/2, W/2, 64) bf16:
//   1. conv1_1 (3x3 SAME) with bf16 operands and f32 accumulation, plus the
//      f32 bias, then ReLU;
//   2. conv1 values centred outside the image are zero (they are conv1_2's
//      SAME padding, not relu(bias + partial window));
//   3. round to bf16;
//   4. conv1_2 (3x3 SAME, 64 -> 64) with the same numerics, ReLU, bf16;
//   5. 2x2/2 max-pool.
// The 64-channel full-resolution conv1 activation (568 MB at batch 8 on
// 608x912) never goes to device memory: only x and the pooled output do.
//
// What bounds it on the H100: operations. Each pixel takes 27 * 64 +
// 576 * 64 multiply-adds (77,184 FLOP); at 8 x 608 x 912 that is 3.4e11
// FLOP, 0.35 ms at the tensor cores' 989 TFLOP/s, while the bytes (27 MB
// in, 142 MB out) take 0.05 ms. The TPU kernel ran conv1_1 as a K = 27
// im2col matmul and conv1_2 as nine K = 64 tap matmuls over a row strip in
// VMEM. Here one CTA of 8 warps owns a 16 x 16 tile of conv1_2 outputs:
//   a. the CTA stages w2 (576 x 64 bf16) and the 20 x 20 x 3 input halo in
//      shared memory;
//   b. the SIMT cores compute conv1_1 on the 18 x 18 tile with its one-pixel
//      ring, one output channel per thread (its 27 weights in registers),
//      zero outside the image, bf16 into shared memory. The 27 products
//      (exact in f32) are added to zero in (ky, kx, ci) order, then the
//      bias, as the plain version does: conv1 agrees bit for bit, so a
//      bf16 rounding flip of a large conv1 value cannot reach conv1_2;
//   c. conv1_2 is an implicit GEMM on the tensor cores (WMMA bf16
//      16x16x16, f32 accumulators): M = 256 pixels, N = 64, K = 576, the A
//      fragments read straight from the conv1 tile (a tap shifts the tile
//      by one pixel row or column, which is a fixed pointer offset);
//   d. warp w owns output rows 2w and 2w + 1, so it pools its own rows:
//      accumulators go through shared memory (the w2 region, free after
//      the GEMM), bias + ReLU + max in f32, one bf16 rounding (rounding is
//      monotonic, so max-then-round equals round-then-max), and 128-byte
//      stores of 64 channels per pooled pixel.
// wgmma, TMA and a persistent tile loop are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kCh = 64;             // channels of conv1_1 and conv1_2
constexpr int kCin = 3;             // input channels (BGR)
constexpr int kTaps1 = 9 * kCin;    // conv1_1 weights per output channel
constexpr int kK = 9 * kCh;         // conv1_2 GEMM depth
constexpr int kTile = 16;           // conv1_2 outputs per CTA: 16 x 16
constexpr int kMid = kTile + 2;     // conv1 tile with its ring: 18 x 18
constexpr int kIn = kTile + 4;      // input halo: 20 x 20
constexpr int kThreads = 256;       // 8 warps
constexpr int kWarps = kThreads / 32;
// bf16 row stride of the conv1 and w2 tiles: 64 + 16 pad. 160 B keeps
// WMMA's 32-B pointer alignment at every pixel and spreads the rows over
// the shared-memory banks.
constexpr int kLd = 80;
constexpr int kAccLd = 68;          // f32 row stride of the epilogue staging

constexpr int kMidBytes = kMid * kMid * kLd * 2;            // 51,840
constexpr int kW2Bytes = kK * kLd * 2;                      // 92,160
constexpr int kInBytes = kIn * kIn * kCin * 4;              // 4,800
constexpr int kSmem = kMidBytes + kW2Bytes + kInBytes;      // 148,800
static_assert(kWarps * 2 * kTile * kAccLd * 4 <= kW2Bytes,
              "the epilogue staging must fit in the w2 region");
static_assert(kWarps * 2 == kTile, "a warp owns two conv1_2 rows");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(kThreads)
stem_fused_kernel(const __nv_bfloat16* __restrict__ x,   // (N, H, W, 3)
                  const float* __restrict__ w1,          // (64, 27)
                  const float* __restrict__ b1,          // (64)
                  const __nv_bfloat16* __restrict__ w2,  // (576, 64)
                  const float* __restrict__ b2,          // (64)
                  __nv_bfloat16* __restrict__ out,       // (N, H/2, W/2, 64)
                  int h, int w) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* mid = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + kMidBytes);
  float* xin = reinterpret_cast<float*>(smem + kMidBytes + kW2Bytes);
  float* stage = reinterpret_cast<float*>(smem + kMidBytes);  // after GEMM

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const size_t img = blockIdx.z;
  x += img * h * w * kCin;

  // a. w2 rows (ky, kx, ci) x 64 output channels, 16-byte vectors
  const uint4* w2v = reinterpret_cast<const uint4*>(w2);
  for (int v = tid; v < kK * (kCh / 8); v += kThreads) {
    const int r = v / (kCh / 8);
    const int c = v % (kCh / 8);
    *reinterpret_cast<uint4*>(w2s + r * kLd + c * 8) = w2v[v];
  }
  // input halo: image rows y0-2 .. y0+17 and columns x0-2 .. x0+17, zero
  // outside the image (conv1_1's SAME padding)
  for (int v = tid; v < kIn * kIn * kCin; v += kThreads) {
    const int p = v / kCin;
    const int ci = v % kCin;
    const int gy = y0 - 2 + p / kIn;
    const int gx = x0 - 2 + p % kIn;
    float val = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      val = __bfloat162float(x[(static_cast<size_t>(gy) * w + gx) * kCin + ci]);
    }
    xin[v] = val;
  }
  __syncthreads();

  // b. conv1_1 on the 18 x 18 tile; tile (r, c) is image (y0-1+r, x0-1+c)
  {
    const int co = tid % kCh;
    float wr[kTaps1];
#pragma unroll
    for (int k = 0; k < kTaps1; ++k) wr[k] = w1[co * kTaps1 + k];
    const float bias = b1[co];
    for (int p = tid / kCh; p < kMid * kMid; p += kThreads / kCh) {
      const int r = p / kMid;
      const int c = p % kMid;
      const int gy = y0 - 1 + r;
      const int gx = x0 - 1 + c;
      float v = 0.f;  // centred outside the image: conv1_2's zero padding
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        float acc = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float* px = xin + ((r + ky) * kIn + c + kx) * kCin;
#pragma unroll
            for (int ci = 0; ci < kCin; ++ci) {
              acc = __fmaf_rn(px[ci], wr[(ky * 3 + kx) * kCin + ci], acc);
            }
          }
        }
        v = fmaxf(__fadd_rn(acc, bias), 0.f);
      }
      mid[p * kLd + co] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();

  // c. conv1_2: warp w computes rows 2w, 2w+1 (16 pixels each) x 64 channels
  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3;
    const int kx = tap % 3;
#pragma unroll
    for (int c0 = 0; c0 < kCh; c0 += 16) {
      FragA a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int py = 2 * warp + i;
        // pixel m of row py reads conv1 tile (py + ky, m + kx)
        wmma::load_matrix_sync(a[i], mid + ((py + ky) * kMid + kx) * kLd + c0,
                               kLd);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, w2s + (tap * kCh + c0) * kLd + j * 16, kLd);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
  }
  __syncthreads();  // every warp is done with w2s: the staging reuses it

  // d. bias + ReLU + 2x2 max-pool of the warp's two rows, one bf16 rounding
  float* st = stage + warp * 2 * kTile * kAccLd;  // [32 pixels][64 channels]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st + i * kTile * kAccLd + j * 16, acc[i][j],
                              kAccLd, wmma::mem_row_major);
    }
  }
  __syncwarp();
  const int ho = h / 2;
  const int wo = w / 2;
  const int oy = y0 / 2 + warp;
  const int co = 2 * lane;
  const float bias0 = b2[co];
  const float bias1 = b2[co + 1];
  if (oy < ho) {
    for (int q = 0; q < kTile / 2; ++q) {
      const int ox = x0 / 2 + q;
      if (ox >= wo) break;
      float m0 = 0.f;  // ReLU outputs are >= 0
      float m1 = 0.f;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float2 s = *reinterpret_cast<const float2*>(
              st + (dy * kTile + 2 * q + dx) * kAccLd + co);
          m0 = fmaxf(m0, __fadd_rn(s.x, bias0));
          m1 = fmaxf(m1, __fadd_rn(s.y, bias1));
        }
      }
      const size_t o = ((img * ho + oy) * wo + ox) * kCh + co;
      *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(m0, m1);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`. x: (n, h, w, 3) bf16; w1: (64, 27) f32 holding
// bf16 values, taps in (ky, kx, ci) order; b1, b2: (64) f32; w2: (576, 64)
// bf16, rows in (ky, kx, ci) order; out: (n, h/2, w/2, 64) bf16. h and w
// must be multiples of 8 (checked by the caller). Returns
// cudaGetLastError() so that the caller sees a refused launch.
int ctpn_stem_fused(const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, int n, int h,
                    int w, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  stem_fused_kernel<<<grid, kThreads, kSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
