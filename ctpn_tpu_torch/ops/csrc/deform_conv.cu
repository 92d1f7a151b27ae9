// DCNv2's modulated deformable 3x3 conv on the card (sm_90a): the sampling
// half. DBNet's ResNet-50 (MhLiao/DB backbones/resnet.py, layer2-layer4) runs
// 13 of them; ops/deform_conv.py holds the contract and the plain version.
//
// No TPU counterpart: the JAX package runs CTPN only. The sampling is a
// gather whose addresses the data decides (the offsets that a small conv
// predicts for every output pixel), so no conv library computes it.
//
// deform_sample_kernel writes the column buffer col (n * ho * wo, 9 * c)
// bf16, tap-major within a row (col[p, k * c + ch]): a thread per (output
// pixel p, tap k, vector of 8 channels), consecutive threads on
// consecutive vectors of one row, so the writes and the corner reads (the
// input is channels_last) are whole 16-byte vectors side by side. For tap
// k = 3 i + j of output pixel (yo, xo):
//   py = (yo * stride - 1 + i) + om[p, 2k], px = (xo * stride - 1 + j) +
//   om[p, 2k + 1], m = 1 / (1 + exp(-om[p, 18 + k]));
//   outside (py <= -1, px <= -1, py >= h or px >= w) the value is 0; else
//   the bilinear blend of the four corners around (py, px), a corner
//   outside the map reading 0 (DCNv2's dmcn_im2col_bilinear), in float32:
//   ((w1 v1 + w2 v2) + w3 v3) + w4 v4 with w1 = (1 - ly)(1 - lx), w2 = (1 -
//   ly) lx, w3 = ly (1 - lx), w4 = ly lx, times m, rounded to bf16.
// Each float operation rounds on its own (-fmad=false), as the plain
// version's do; only the sigmoid's exp may differ from PyTorch's by an ulp.
// The product with the weights, col times W^T, is a bf16 GEMM that the
// wrapper runs per image (cuBLAS).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;  // bf16 channels per 16-byte vector
constexpr int kTaps = 9;
constexpr int kOffsets = 27;  // 9 (dy, dx) pairs, then 9 mask logits
constexpr int kThreads = 256;

__device__ __forceinline__ void unpack(const uint4 v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 p = __bfloat1622float2(h[k]);
    f[2 * k] = p.x;
    f[2 * k + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return v;
}

__device__ __forceinline__ void corner(const __nv_bfloat16* base, bool ok, float* f) {
  if (ok) {
    unpack(__ldg(reinterpret_cast<const uint4*>(base)), f);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
deform_sample_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ om,
                     __nv_bfloat16* __restrict__ col, long long total, int c, int h, int w,
                     int ho, int wo, int stride) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int cv = c / kVec;
  const int v = (int)(t % cv);
  const long long pk = t / cv;
  const int k = (int)(pk % kTaps);
  const long long p = pk / kTaps;  // (n * ho + yo) * wo + xo
  const int xo = (int)(p % wo);
  const long long q = p / wo;
  const int yo = (int)(q % ho);
  const long long n = q / ho;
  const float* o = om + p * kOffsets;
  const float dy = __ldg(o + 2 * k), dx = __ldg(o + 2 * k + 1), z = __ldg(o + 18 + k);
  const float m = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
  const int i = k / 3, j = k - 3 * (k / 3);
  const float py = __fadd_rn((float)(yo * stride - 1 + i), dy);
  const float px = __fadd_rn((float)(xo * stride - 1 + j), dx);
  float r[kVec];
  if (py > -1.0f && px > -1.0f && py < (float)h && px < (float)w) {
    const float fy = floorf(py), fx = floorf(px);
    const int y0 = (int)fy, x0 = (int)fx;
    const float ly = __fsub_rn(py, fy), lx = __fsub_rn(px, fx);
    const float hy = __fsub_rn(1.0f, ly), hx = __fsub_rn(1.0f, lx);
    const float w1 = __fmul_rn(hy, hx), w2 = __fmul_rn(hy, lx);
    const float w3 = __fmul_rn(ly, hx), w4 = __fmul_rn(ly, lx);
    const bool top = y0 >= 0, bottom = y0 + 1 <= h - 1, left = x0 >= 0, right = x0 + 1 <= w - 1;
    const __nv_bfloat16* img = x + (size_t)n * h * w * c + (size_t)v * kVec;
    const size_t row0 = (size_t)y0 * w, row1 = (size_t)(y0 + 1) * w;
    float v1[kVec], v2[kVec], v3[kVec], v4[kVec];
    corner(img + (row0 + x0) * c, top && left, v1);
    corner(img + (row0 + x0 + 1) * c, top && right, v2);
    corner(img + (row1 + x0) * c, bottom && left, v3);
    corner(img + (row1 + x0 + 1) * c, bottom && right, v4);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float a = __fadd_rn(__fmul_rn(w1, v1[e]), __fmul_rn(w2, v2[e]));
      const float b = __fadd_rn(__fadd_rn(a, __fmul_rn(w3, v3[e])), __fmul_rn(w4, v4[e]));
      r[e] = __fmul_rn(b, m);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) r[e] = 0.0f;
  }
  __stcs(reinterpret_cast<uint4*>(col + (size_t)pk * c + (size_t)v * kVec), pack(r));
}

}  // namespace

extern "C" {

// x: (n, c, h, w) bf16 in channels_last memory (NHWC), c a multiple of 8,
// 16-byte aligned; om: (n, ho, wo, 27) float32 contiguous; col: (n * ho *
// wo, 9 * c) bf16 out. Launches on `stream` (nothing when col is empty)
// and returns cudaGetLastError(). The wrapper checks the shapes and keeps
// the column buffer's vectors and n * h * w * c below 2**62.
int ctpn_deform_conv(const void* x, const void* om, void* col, int n, int c, int h, int w,
                     int ho, int wo, int stride, void* stream) {
  const long long total = (long long)n * ho * wo * kTaps * (c / kVec);
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  deform_sample_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)om, (__nv_bfloat16*)col, total, c, h, w, ho, wo,
      stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
