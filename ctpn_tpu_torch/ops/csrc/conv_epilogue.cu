// The epilogue of a VGG conv in one pass (sm_90a): bias, ReLU and, where a
// pool follows, the 2x2/2 max-pool, on the conv's bf16 output.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses the trunk's bias, ReLU
// and pool into the convolution (ctpn_tpu/models/vgg.py). On the card,
// PyTorch runs a cuDNN conv without its bias and then three passes over the
// activations: the broadcast `add_` of the bias, the ReLU (`clamp_min`)
// into a new tensor, and the max-pool that reads that tensor again. This
// kernel does the same arithmetic in one pass: it reads each conv output
// once and writes the activated tensor, or only its pooled quarter.
//
// Same bits as the three passes, operation for operation: for each input
// element, the bias added in float and rounded to bf16 (`cvt.rn`, as
// c10::BFloat16 converts on sm_80+), then clamp_min's ReLU (a NaN passes
// unchanged, else fmaxf(v, 0)); then the pool's own scan over the window
// (rows, then columns; a value replaces the running max when it is larger
// or NaN). Taking the max first and activating once would give the same
// values, but not always the same signed zero: so every element is
// activated. The arithmetic is a few instructions per byte.
//
// What bounds it on the H100: bytes. About 0.3 operations per byte, against
// the 295 at which the tensor cores would be the limit. Design for that:
//   * a thread owns 8 channels (16 bytes) of one output pixel; neighbouring
//     threads take neighbouring channel groups, then neighbouring pixels,
//     so each warp's loads and stores are contiguous runs of 16-byte
//     vectors (channels_last: NHWC in memory). A pooling thread reads the
//     four vectors of its window and writes one;
//   * loads bypass L1 and are marked evict-first in L2: nothing is read
//     twice, and a batch's activations (up to 3.4 GB) dwarf the 50 MB L2;
//   * a grid-stride loop with as many blocks as fit on the SMs at once.
//     The stride is a whole number of pixels, so a thread keeps its channel
//     group, and loads its 8 biases once;
//   * indices are 32-bit per pixel and 64-bit per byte offset.
// With no bias (a null pointer) the kernel adds -0.0, the identity of
// float addition, so every value passes through the rounding unchanged.
//
// The second kernel, residual_epilogue_kernel, ends a ResNet bottleneck
// (DBNet's trunk, models/resnet.py) in the same way: PyTorch adds conv3's
// bias to its output, the projection's bias to the identity (the first
// block of a stage), sums the two and applies the ReLU, four passes over
// the block's widest map. The kernel reads conv3's bias-less output and the
// identity once and writes the activated sum: relu(bf16(bf16(y + bias) +
// bf16(identity + identity_bias))), each add in float and rounded to bf16
// as PyTorch's add is, the ReLU as clamp_min. Same design as above: a
// thread per 8 channels of a pixel, streaming loads of both inputs, a
// grid-stride loop over whole pixels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 channels per 16-byte vector
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint4 load_stream(const __nv_bfloat16* p, uint64_t policy) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// bias, round to bf16, ReLU as clamp_min: the result as a float (exact)
__device__ __forceinline__ float activate(__nv_bfloat16 y, float bias) {
  const float v = __bfloat162float(__float2bfloat16(__bfloat162float(y) + bias));
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// a float rounded to bf16 and widened again (exact)
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// both biases, the sum, each rounded to bf16, then ReLU as clamp_min
__device__ __forceinline__ float residual(__nv_bfloat16 y, float bias, __nv_bfloat16 identity,
                                          float identity_bias) {
  const float v = round_bf16(round_bf16(__bfloat162float(y) + bias) +
                             round_bf16(__bfloat162float(identity) + identity_bias));
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

__device__ __forceinline__ void unpack(uint4 v, __nv_bfloat16 (&out)[kVec]) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = __ushort_as_bfloat16(static_cast<unsigned short>(words[k] & 0xffffu));
    out[2 * k + 1] = __ushort_as_bfloat16(static_cast<unsigned short>(words[k] >> 16));
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[kVec]) {
  uint32_t words[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // exact: each value is a bf16 value widened
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16(v[2 * k]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16(v[2 * k + 1]));
    words[k] = lo | (hi << 16);
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// y: (n, h, w, c) bf16, NHWC; out: (n, ho, wo, c), ho = h / 2 and wo = w / 2
// when kPool (floor), else h and w. `stride` is the grid's whole number of
// pixels times `groups` (= c / 8): items i, i + stride, ... share a group.
template <bool kPool>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(const __nv_bfloat16* __restrict__ y,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int pixels, int groups, int h,
                     int w, int ho, int wo, long long stride) {
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= stride) return;
  const int g = static_cast<int>(i % groups);
  const int c = groups * kVec;
  float b[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    b[k] = bias != nullptr ? __bfloat162float(bias[g * kVec + k]) : -0.0f;
  }
  const uint64_t policy = evict_first_policy();
  const int step = static_cast<int>(stride / groups);  // pixels per stride
  for (int p = static_cast<int>(i / groups); p < pixels; p += step) {
    float r[kVec];
    if (kPool) {
      const int ow = p % wo;
      const int t = p / wo;
      const int oh = t % ho;
      const int n = t / ho;
      const long long row = static_cast<long long>(w) * c;
      const __nv_bfloat16* src =
          y + ((static_cast<long long>(n) * h + 2 * oh) * w + 2 * ow) * c + g * kVec;
      const uint4 v00 = load_stream(src, policy);
      const uint4 v01 = load_stream(src + c, policy);
      const uint4 v10 = load_stream(src + row, policy);
      const uint4 v11 = load_stream(src + row + c, policy);
      __nv_bfloat16 e00[kVec], e01[kVec], e10[kVec], e11[kVec];
      unpack(v00, e00);
      unpack(v01, e01);
      unpack(v10, e10);
      unpack(v11, e11);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        // the pool's scan: the first element, then each larger or NaN one
        float m = activate(e00[k], b[k]);
        const float a01 = activate(e01[k], b[k]);
        if (a01 > m || isnan(a01)) m = a01;
        const float a10 = activate(e10[k], b[k]);
        if (a10 > m || isnan(a10)) m = a10;
        const float a11 = activate(e11[k], b[k]);
        if (a11 > m || isnan(a11)) m = a11;
        r[k] = m;
      }
    } else {
      const uint4 v = load_stream(y + static_cast<long long>(p) * c + g * kVec, policy);
      __nv_bfloat16 e[kVec];
      unpack(v, e);
#pragma unroll
      for (int k = 0; k < kVec; ++k) r[k] = activate(e[k], b[k]);
    }
    *reinterpret_cast<uint4*>(out + static_cast<long long>(p) * c + g * kVec) = pack(r);
  }
}

// y, identity, out: (n, h, w, c) bf16, NHWC; `stride` as above
__global__ void __launch_bounds__(kThreads)
residual_epilogue_kernel(const __nv_bfloat16* __restrict__ y,
                         const __nv_bfloat16* __restrict__ bias,
                         const __nv_bfloat16* __restrict__ identity,
                         const __nv_bfloat16* __restrict__ identity_bias,
                         __nv_bfloat16* __restrict__ out, int pixels, int groups,
                         long long stride) {
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= stride) return;
  const int g = static_cast<int>(i % groups);
  const int c = groups * kVec;
  float b[kVec], bi[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    b[k] = bias != nullptr ? __bfloat162float(bias[g * kVec + k]) : -0.0f;
    bi[k] = identity_bias != nullptr ? __bfloat162float(identity_bias[g * kVec + k]) : -0.0f;
  }
  const uint64_t policy = evict_first_policy();
  const int step = static_cast<int>(stride / groups);  // pixels per stride
  for (int p = static_cast<int>(i / groups); p < pixels; p += step) {
    const long long at = static_cast<long long>(p) * c + g * kVec;
    const uint4 vy = load_stream(y + at, policy);
    const uint4 vi = load_stream(identity + at, policy);
    __nv_bfloat16 ey[kVec], ei[kVec];
    unpack(vy, ey);
    unpack(vi, ei);
    float r[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) r[k] = residual(ey[k], b[k], ei[k], bi[k]);
    *reinterpret_cast<uint4*>(out + at) = pack(r);
  }
}

// resident blocks per SM of each kernel on each device, 0 until first asked
// (conv_epilogue_kernel<false>, <true>, residual_epilogue_kernel)
int g_blocks_per_sm[kMaxDevices][3];
int g_sms[kMaxDevices];

// The grid-stride loop's `stride` (items, a whole number of pixels) and
// grid for `pixels` pixels of `groups` vectors: as many threads as fit on
// the SMs at once, at most one per item and at least one per group. Zero
// items give stride 0 (no launch).
template <typename Kernel>
cudaError_t grid_stride(Kernel kernel, int variant, int pixels, int groups,
                        long long* stride, int* grid) {
  *stride = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& per_sm = g_blocks_per_sm[dev][variant];
  if (per_sm == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    per_sm = blocks > 0 ? blocks : 1;
  }
  if (pixels == 0 || groups == 0) return cudaSuccess;
  const long long items = static_cast<long long>(pixels) * groups;
  long long threads = static_cast<long long>(per_sm) * g_sms[dev] * kThreads;
  if (threads > items) threads = items;
  if (threads < groups) threads = groups;
  *stride = threads / groups * groups;
  *grid = static_cast<int>((*stride + kThreads - 1) / kThreads);
  return cudaSuccess;
}

template <bool kPool>
cudaError_t launch(const void* y, const void* bias, void* out, int n, int c, int h, int w,
                   cudaStream_t stream) {
  const int ho = kPool ? h / 2 : h;
  const int wo = kPool ? w / 2 : w;
  const int groups = c / kVec;
  long long stride = 0;
  int grid = 0;
  const cudaError_t err =
      grid_stride(conv_epilogue_kernel<kPool>, kPool ? 1 : 0, n * ho * wo, groups, &stride,
                  &grid);
  if (err != cudaSuccess || stride == 0) return err;
  conv_epilogue_kernel<kPool><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), n * ho * wo, groups, h, w, ho, wo, stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y: (n, c, h, w) bf16 in channels_last memory (NHWC), c a multiple of 8,
// 16-byte aligned; bias: c bf16, or null for none; out: (n, c, h, w), or
// (n, c, h / 2, w / 2) when `pool`, channels_last. Launches on `stream`
// (nothing when the output is empty) and returns cudaGetLastError() so that
// the caller sees a refused launch. The wrapper checks the shapes and keeps
// n * ho * wo below 2**31.
int ctpn_conv_epilogue(const void* y, const void* bias, void* out, int n, int c, int h,
                       int w, int pool, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = pool ? launch<true>(y, bias, out, n, c, h, w, s)
                               : launch<false>(y, bias, out, n, c, h, w, s);
  return static_cast<int>(err);
}

// y, identity: (n, c, h, w) bf16 in channels_last memory (NHWC), c a
// multiple of 8, 16-byte aligned; bias, identity_bias: c bf16 each, or null
// for none; out: (n, c, h, w), channels_last. Launches on `stream` (nothing
// when the output is empty) and returns cudaGetLastError(). The wrapper
// checks the shapes and keeps n * h * w below 2**31.
int ctpn_residual_epilogue(const void* y, const void* bias, const void* identity,
                           const void* identity_bias, void* out, int n, int c, int h, int w,
                           void* stream) {
  const int groups = c / kVec;
  long long stride = 0;
  int grid = 0;
  cudaError_t err =
      grid_stride(residual_epilogue_kernel, 2, n * h * w, groups, &stride, &grid);
  if (err != cudaSuccess || stride == 0) return static_cast<int>(err);
  residual_epilogue_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(identity),
      static_cast<const __nv_bfloat16*>(identity_bias), static_cast<__nv_bfloat16*>(out),
      n * h * w, groups, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
