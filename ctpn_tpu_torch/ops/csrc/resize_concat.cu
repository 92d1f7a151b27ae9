// A U-shaped decoder's skip input in one pass (sm_90a): the running map
// resized bilinearly to the skip's size and concatenated with the skip
// along the channels, written straight into the concatenated buffer.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses the resize into the
// concatenation. On the card, PyTorch runs `F.interpolate(h, size,
// mode="bilinear", align_corners=False)` (ATen's
// upsample_bilinear2d_nhwc_out_frame), which writes the resized map, and
// then `torch.cat([resized, skip], 1)`, which reads it and the skip back
// and writes both again. This kernel reads the low-resolution map and the
// skip once and writes the concatenated buffer once.
//
// Same bits as those two passes. For a channel of the first slice:
//   src = max(scale * (dst + 0.5) - 0.5, 0), scale = in / out in float
//   (ATen's area_pixel_compute_source_index and compute_scales_value);
//   i1 = int(src), i1p = i1 < in - 1, l1 = src - i1, l0 = 1 - l1, per axis;
//   v = h0l * (w0l * x00 + w1l * x01) + h1l * (w0l * x10 + w1l * x11)
// in float, rounded to bf16 once (`cvt.rn`, as c10::BFloat16 converts on
// sm_80+). PyTorch's build contracts those sums into fused multiply-adds;
// this file is built with -fmad=false and writes each contraction out
// (__fmaf_rn), so that the order is fixed here and not by the compiler.
// No weight is special-cased: a zero weight times an inf or NaN gives a
// NaN, as it does in ATen. The second slice, and the first when the map
// already has the skip's size (no resize: `torch.cat` alone), are copies
// of the 16-byte vectors, bit for bit.
//
// What bounds it on the H100: bytes (a few float ops per byte). Design:
//   * a thread owns 8 channels (16 bytes) of one output pixel at a time;
//     a block takes whole output rows in a grid-stride loop over them, as
//     many blocks as fit on the SMs at once, and works out the row's
//     vertical taps once;
//   * a row's items are its vectors of the resized slice, pixel by pixel,
//     then those of the skip's: neighbouring threads take neighbouring
//     items, so each warp's stores, and its loads of the skip, are
//     contiguous runs of 16-byte vectors, and all but one warp of a row
//     take one branch. (A thread that kept one channel group, and so its
//     slice, for its whole loop ran at about half the byte bound where a
//     pixel's 24 or 48 vectors split warps between the two branches.)
//   * the skip is read once: loads bypass L1 and are marked evict-first in
//     L2. The low-resolution map is read by about four output pixels each
//     (at 2x), so its loads go through the caches. The output is written
//     with streaming stores (st.global.cs): the next conv reads it once,
//     long after.
//   * indices are 32-bit per row and item, 64-bit per byte offset.

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

__device__ __forceinline__ void unpack(uint4 v, float (&out)[kVec]) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = __uint_as_float(words[k] << 16);  // exact: bf16 is float's top half
    out[2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[kVec]) {
  uint32_t words[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16(v[2 * k]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16(v[2 * k + 1]));
    words[k] = lo | (hi << 16);
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// ATen's source index and lambdas along one axis: the first source row (or
// column), the step to the second (0 at the edge), and the two weights
struct Taps {
  int i1;
  int i1p;
  float l0;
  float l1;
};

__device__ __forceinline__ Taps source(float scale, int dst, int in) {
  float src = __fmaf_rn(scale, __fadd_rn(static_cast<float>(dst), 0.5f), -0.5f);
  src = src < 0.0f ? 0.0f : src;
  Taps t;
  t.i1 = static_cast<int>(src);
  t.i1p = t.i1 < in - 1 ? 1 : 0;
  t.l1 = __fsub_rn(src, static_cast<float>(t.i1));
  t.l0 = __fsub_rn(1.0f, t.l1);
  return t;
}

// h: (n, hi, wi, c1) bf16 NHWC; skip: (n, ho, wo, c2); out: (n, ho, wo,
// c1 + c2); g1 = c1 / 8, g2 = c2 / 8. A block takes whole output rows
// (`rows` = n * ho), in a grid-stride loop over them. A row's items are its
// vectors of the first slice, pixel by pixel, then those of the second:
// a warp's threads take neighbouring items, so all but one warp of a row
// run one branch, and a row's taps are worked out once. kResize false: hi
// == ho and wi == wo, and the first slice is a copy too.
template <bool kResize>
__global__ void __launch_bounds__(kThreads)
resize_concat_kernel(const __nv_bfloat16* __restrict__ h,
                     const __nv_bfloat16* __restrict__ skip,
                     __nv_bfloat16* __restrict__ out, int rows, int g1, int g2, int hi,
                     int wi, int ho, int wo, float rh, float rw) {
  const int c1 = g1 * kVec;
  const int c = c1 + g2 * kVec;
  const int first = wo * g1;  // items of the first slice in a row
  const int items = first + wo * g2;
  const uint64_t policy = evict_first_policy();
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int n = row / ho;
    const int y = row - n * ho;
    __nv_bfloat16* out_row = out + static_cast<long long>(row) * wo * c;
    const __nv_bfloat16* skip_row = skip + static_cast<long long>(row) * wo * (c - c1);
    const Taps ty = kResize ? source(rh, y, hi) : Taps{y, 0, 1.0f, 0.0f};
    const __nv_bfloat16* h0 = h + (static_cast<long long>(n) * hi + ty.i1) * wi * c1;
    const __nv_bfloat16* h1 = h0 + static_cast<long long>(ty.i1p) * wi * c1;
#pragma unroll 2  // two items' loads in flight: about 4 % faster
    for (int i = threadIdx.x; i < items; i += kThreads) {
      uint4 v;
      __nv_bfloat16* dst;
      if (i < first) {
        const int x = i / g1;
        const int g = i - x * g1;
        dst = out_row + static_cast<long long>(x) * c + g * kVec;
        if (kResize) {
          const Taps tx = source(rw, x, wi);
          const __nv_bfloat16* p0 = h0 + static_cast<long long>(tx.i1) * c1 + g * kVec;
          const __nv_bfloat16* p1 = h1 + static_cast<long long>(tx.i1) * c1 + g * kVec;
          const int dx = tx.i1p * c1;
          float x00[kVec], x01[kVec], x10[kVec], x11[kVec], r[kVec];
          unpack(__ldg(reinterpret_cast<const uint4*>(p0)), x00);
          unpack(__ldg(reinterpret_cast<const uint4*>(p0 + dx)), x01);
          unpack(__ldg(reinterpret_cast<const uint4*>(p1)), x10);
          unpack(__ldg(reinterpret_cast<const uint4*>(p1 + dx)), x11);
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            const float top = __fmaf_rn(tx.l0, x00[k], __fmul_rn(tx.l1, x01[k]));
            const float bottom = __fmaf_rn(tx.l0, x10[k], __fmul_rn(tx.l1, x11[k]));
            r[k] = __fmaf_rn(ty.l0, top, __fmul_rn(ty.l1, bottom));
          }
          v = pack(r);
        } else {
          v = load_stream(h0 + static_cast<long long>(i) * kVec, policy);
        }
      } else {
        const int j = i - first;
        const int x = j / g2;
        dst = out_row + static_cast<long long>(x) * c + c1 + (j - x * g2) * kVec;
        v = load_stream(skip_row + static_cast<long long>(j) * kVec, policy);
      }
      __stcs(reinterpret_cast<uint4*>(dst), v);
    }
  }
}

// resident blocks per SM of each variant on each device, 0 until first asked
int g_blocks_per_sm[kMaxDevices][2];
int g_sms[kMaxDevices];

template <bool kResize>
cudaError_t launch(const void* h, const void* skip, void* out, int n, int c1, int c2, int hi,
                   int wi, int ho, int wo, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& per_sm = g_blocks_per_sm[dev][kResize ? 1 : 0];
  if (per_sm == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, resize_concat_kernel<kResize>, kThreads, 0);
    if (err != cudaSuccess) return err;
    per_sm = blocks > 0 ? blocks : 1;
  }
  const int rows = n * ho;
  if (rows == 0 || wo == 0) return cudaSuccess;
  const int grid = rows < per_sm * g_sms[dev] ? rows : per_sm * g_sms[dev];
  // ATen's scale: the sizes as floats, divided in float
  const float rh = static_cast<float>(hi) / static_cast<float>(ho);
  const float rw = static_cast<float>(wi) / static_cast<float>(wo);
  resize_concat_kernel<kResize><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(skip),
      static_cast<__nv_bfloat16*>(out), rows, c1 / kVec, c2 / kVec, hi, wi, ho, wo, rh, rw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h: (n, c1, hi, wi) and skip: (n, c2, ho, wo), bf16 in channels_last
// memory (NHWC), c1 and c2 multiples of 8, 16-byte aligned; out: (n, c1 +
// c2, ho, wo) channels_last. Launches on `stream` (nothing when the output
// is empty) and returns cudaGetLastError() so that the caller sees a
// refused launch. The wrapper checks the shapes and keeps n * ho, n * hi
// and a row's vectors, wo * (c1 + c2) / 8, below 2**31.
int ctpn_resize_concat(const void* h, const void* skip, void* out, int n, int c1, int c2,
                       int hi, int wi, int ho, int wo, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool resize = hi != ho || wi != wo;
  const cudaError_t err =
      resize ? launch<true>(h, skip, out, n, c1, c2, hi, wi, ho, wo, s)
             : launch<false>(h, skip, out, n, c1, c2, hi, wi, ho, wo, s);
  return static_cast<int>(err);
}

}  // extern "C"
