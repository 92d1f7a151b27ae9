// VGG block 1 fused: conv1_1 + ReLU + conv1_2 + ReLU + 2x2/2 max-pool
// (sm_90a; needs wgmma, so the `a` in the target matters).
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
// in, 142 MB out) take 0.05 ms. conv1_1 has to stay on the SIMT cores in a
// fixed order of summation (below), where its 1.5e10 FLOP are 0.23 ms of
// the card's f32 rate by themselves, so the design runs the two convs at
// the same time on different warps instead of one after the other:
//
//   * One persistent CTA per SM walks 16 x 24 output tiles of all images.
//     w2 (72 KB, packed once by the wrapper in the swizzled layout wgmma
//     reads) arrives in shared memory once per CTA by one bulk copy that
//     completes on an mbarrier.
//   * Eight producer warps compute conv1_1 for tile t+1 into one of two
//     conv1 buffers while two consumer warpgroups run conv1_2 for tile t
//     from the other; a full and an empty mbarrier per buffer hand them
//     over. A producer lane owns two output channels (its 54 weights live
//     in registers) and a 2 x 2 block of pixels per step: 16 broadcast
//     16-byte loads of the f32 input halo feed 216 FMAs in 8 independent
//     sums. The 27 products of a sum (exact in f32) are added to zero in
//     (ky, kx, ci) order, then the bias, as the plain version does: conv1
//     agrees bit for bit, so a bf16 rounding flip of a large conv1 value
//     cannot reach conv1_2. The next tile's input halo is prefetched into
//     registers during the FMAs and lands in the other of two halo buffers.
//   * conv1_2 is an implicit GEMM on wgmma m64n64k16 (bf16, f32
//     accumulators), A and B both read from shared memory through
//     descriptors. A conv1 pixel is one 128-byte row (64 channels) of a
//     128-byte-swizzled tile with a pitch of 26 pixels. The M = 64 rows of
//     one wgmma are an 8 x 8 pixel patch: the eight rows of a descriptor's
//     row group are eight neighbouring pixels of an image row, and the
//     group stride (SBO) is the tile's pitch, so the next group is the next
//     image row. A tap (ky, kx) is a shift of the start address by
//     ky * 26 + kx rows. The swizzle is a function of the absolute
//     shared-memory address (bits 7-9 XORed into bits 4-6), and the
//     producers store with that function, so a start address that is not
//     1024-byte aligned still reads what was written.
//   * In the accumulator layout a thread then holds pixels (2w, x) and
//     (2w + 1, x) of the patch (w the warp, x = lane / 4): the vertical
//     half of the pool is a register max, the horizontal half one shuffle
//     with lane ^ 4. Bias + ReLU + one bf16 rounding follow the max (all
//     three are monotonic, so this equals round-then-max), and a 576-byte
//     per-warp staging tile turns the fragments into 16-byte stores of 512
//     contiguous bytes per warp. A tile's patches alternate between the
//     two warpgroups, so one's epilogue runs under the other's wgmmas (one
//     warpgroup with two accumulator sets does not: ptxas serializes
//     wgmmas once other instructions read accumulators inside a stage).
// H and W are multiples of 8, so a patch is inside the image or outside
// it: edge tiles skip whole patches and need no masks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 64;             // channels of conv1_1 and conv1_2
constexpr int kCin = 3;             // input channels (BGR)
constexpr int kTaps1 = 9 * kCin;    // conv1_1 weights per output channel
constexpr int kTileH = 16;          // conv1_2 outputs per tile: 16 x 24
constexpr int kTileW = 24;
constexpr int kPatch = 8;           // one wgmma's M = 64 rows: 8 x 8 pixels
constexpr int kPatchesX = kTileW / kPatch;
constexpr int kPatchesY = kTileH / kPatch;
constexpr int kMidH = kTileH + 2;   // conv1 tile with its ring: 18 x 26
constexpr int kMidW = kTileW + 2;
constexpr int kInH = kTileH + 4;    // input halo: 20 x 28
constexpr int kInW = kTileW + 4;
constexpr int kConsumerGroups = 2;     // warpgroups on conv1_2
constexpr int kConsumerThreads = kConsumerGroups * 128;
constexpr int kProducerWarps = 8;
constexpr int kProducerThreads = kProducerWarps * 32;
constexpr int kThreads = kConsumerThreads + kProducerThreads;
constexpr int kQuadsX = kMidW / 2;  // a producer step: 2 x 2 conv1 pixels
constexpr int kQuads = (kMidH / 2) * kQuadsX;
static_assert(kMidW % 2 == 0 && kMidH % 2 == 0, "conv1 tile in 2 x 2 steps");
constexpr int kInElems = kInH * kInW * kCin;
constexpr int kPrefetch = (kInElems + kProducerThreads - 1) / kProducerThreads;

constexpr int kRowBytes = kCh * 2;                     // one pixel: 128 B
constexpr int kTapBytes = kCh * kRowBytes;             // w2 of one tap: 8 KB
constexpr int kW2Bytes = 9 * kTapBytes;                // 73,728
constexpr int kMidBytes = 59 * 1024;                   // >= 18 * 26 * 128
constexpr int kInBytes = kInH * kInW * 16;             // f32 x 4 per pixel
constexpr int kStagePx = kRowBytes + 16;               // padded pooled pixel
constexpr int kStageBytes = kConsumerGroups * 4 * 4 * kStagePx;  // per warp: 4 pixels
constexpr int kOffMid = kW2Bytes;
constexpr int kOffIn = kOffMid + 2 * kMidBytes;
constexpr int kOffStage = kOffIn + 2 * kInBytes;
constexpr int kOffBar = kOffStage + kStageBytes;
constexpr int kSmem = kOffBar + 64 + 1024;  // barriers; slack to align to 1024
static_assert(kMidBytes >= kMidH * kMidW * kRowBytes, "conv1 tile too small");
static_assert(kMidBytes % 1024 == 0 && kW2Bytes % 1024 == 0,
              "swizzled regions start on the 1024-byte pattern");
static_assert(kOffIn % 16 == 0 && kOffBar % 8 == 0, "layout");
static_assert(kSmem <= 232448, "over the 227 KB a block may use");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase differs from `parity`. The loop lives
// inside the asm so that the compiler sees straight-line, uniform code.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kProducerThreads) : "memory");
}

// wgmma shared-memory descriptor, K-major, 128-byte swizzle: start address
// and group stride in 16-byte units, LBO unused (1), layout type 1.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmmas that own the registers.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 f32) = or += A (64 x 16 bf16) * B (16 x 64 bf16), both from
// shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

struct Tile {
  int img, y0, x0;
};

__device__ __forceinline__ Tile decode_tile(int t, int tiles_y, int tiles_x) {
  Tile tile;
  tile.img = t / (tiles_y * tiles_x);
  const int rem = t - tile.img * tiles_y * tiles_x;
  const int ty = rem / tiles_x;
  tile.y0 = ty * kTileH;
  tile.x0 = (rem - ty * tiles_x) * kTileW;
  return tile;
}

// conv1_2 of one 8 x 8 patch: 9 taps x 4 k-steps of wgmma into `acc`,
// committed as one group. `a_patch` is the shared address of the patch's
// first conv1 row (tap (0, 0)), `b_w2` that of the packed w2.
__device__ __forceinline__ void mma_patch(float (&acc)[32], uint32_t a_patch,
                                            uint32_t b_w2) {
  const uint64_t desc_a = wgmma_desc(a_patch, kMidW * kRowBytes);
  const uint64_t desc_b = wgmma_desc(b_w2, 8 * kRowBytes);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int shift = ((tap / 3) * kMidW + tap % 3) * kRowBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64k16(acc, desc_a + ((shift + kk * 32) >> 4),
                      desc_b + ((tap * kTapBytes + kk * 32) >> 4),
                      (tap | kk) != 0);
    }
  }
  wgmma_commit();
}

// Bias + ReLU + 2x2 max-pool + bf16 of one patch's accumulators: warp `cw`
// of the warpgroup holds patch rows 2cw and 2cw + 1 and writes pooled row
// cw, four pooled pixels of 64 channels, to out + `o` (bf16 elements).
__device__ __forceinline__ void pool_patch(float (&acc)[32], const float (&bias_lo)[4],
                                           const float (&bias_hi)[4],
                                           unsigned char* stage, int lane,
                                           __nv_bfloat16* out, size_t o) {
  fence_acc(acc);
  float v[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // rows 2cw and 2cw + 1 of column lane / 4
    v[2 * j] = fmaxf(acc[4 * j], acc[4 * j + 2]);
    v[2 * j + 1] = fmaxf(acc[4 * j + 1], acc[4 * j + 3]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {  // columns x and x ^ 1
    v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], 4));
  }
  // both lanes of a column pair hold the max: the even column stores
  // channel chunks 0-3, the odd one chunks 4-7
  const int half = (lane >> 2) & 1;
  unsigned char* st = stage + (lane >> 3) * kStagePx + half * 64 + (lane & 3) * 4;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const float lo = half ? v[2 * (jj + 4)] : v[2 * jj];
    const float hi = half ? v[2 * (jj + 4) + 1] : v[2 * jj + 1];
    *reinterpret_cast<__nv_bfloat162*>(st + jj * 16) = __floats2bfloat162_rn(
        fmaxf(__fadd_rn(lo, bias_lo[jj]), 0.f), fmaxf(__fadd_rn(hi, bias_hi[jj]), 0.f));
  }
  __syncwarp();
  const uint4 val = *reinterpret_cast<const uint4*>(
      stage + (lane >> 3) * kStagePx + (lane & 7) * 16);
  *reinterpret_cast<uint4*>(out + o + (lane >> 3) * kCh + (lane & 7) * 8) = val;
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, 1)
stem_fused_kernel(const __nv_bfloat16* __restrict__ x,   // (N, H, W, 3)
                  const float* __restrict__ w1,          // (27, 64)
                  const float* __restrict__ b1,          // (64)
                  const unsigned char* __restrict__ w2,  // packed, kW2Bytes
                  const float* __restrict__ b2,          // (64)
                  __nv_bfloat16* __restrict__ out,       // (N, H/2, W/2, 64)
                  int h, int w, int tiles_y, int tiles_x, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* mid = smem + kOffMid;
  float4* xin = reinterpret_cast<float4*>(smem + kOffIn);
  const uint32_t bars = smem_u32(smem + kOffBar);
  const uint32_t bar_w2 = bars;
  const uint32_t bar_full = bars + 8;    // two: + 8 * buffer
  const uint32_t bar_empty = bars + 24;  // two

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    mbar_init(bar_w2, 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(bar_full + 8 * b, kProducerThreads);
      mbar_init(bar_empty + 8 * b, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the role comes from a shuffle so that the compiler knows it is uniform
  // across the warp: wgmma in a branch it takes for divergent is serialized
  const int group = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (group >= kConsumerGroups) {
    // ---------------- producers: conv1_1 on the SIMT cores ----------------
    const int ptid = tid - kConsumerThreads;
    const int pw = ptid >> 5;
    float wa[kTaps1], wb[kTaps1];  // channels 2 * lane and 2 * lane + 1
#pragma unroll
    for (int k = 0; k < kTaps1; ++k) {
      const float2 v = *reinterpret_cast<const float2*>(w1 + k * kCh + 2 * lane);
      wa[k] = v.x;
      wb[k] = v.y;
    }
    const float bias_a = b1[2 * lane];
    const float bias_b = b1[2 * lane + 1];
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);

    // the input halo of a tile, image rows y0-2 .. y0+17 and columns
    // x0-2 .. x0+25, as raw bf16 in registers; zero outside the image
    // (conv1_1's SAME padding)
    unsigned short pre[kPrefetch];
    auto fetch = [&](int t) {
      const Tile tile = decode_tile(t, tiles_y, tiles_x);
#pragma unroll
      for (int i = 0; i < kPrefetch; ++i) {
        const int e = ptid + i * kProducerThreads;
        const int p = e / kCin;
        const int iy = p / kInW;
        const int gy = tile.y0 - 2 + iy;
        const int gx = tile.x0 - 2 + p - iy * kInW;
        unsigned short v = 0;
        if (e < kInElems && gy >= 0 && gy < h && gx >= 0 && gx < w) {
          v = xs[((static_cast<size_t>(tile.img) * h + gy) * w + gx) * kCin +
                 (e - p * kCin)];
        }
        pre[i] = v;
      }
    };

    int t = blockIdx.x;
    fetch(t);
    for (int it = 0; t < n_tiles; t += gridDim.x, ++it) {
      const Tile tile = decode_tile(t, tiles_y, tiles_x);
      const int buf = it & 1;
      // the halo is double-buffered too: a warp still reading tile it - 1's
      // halo reads the other one, and none reads this one before the barrier
      float4* halo = xin + buf * (kInH * kInW);
#pragma unroll
      for (int i = 0; i < kPrefetch; ++i) {
        const int e = ptid + i * kProducerThreads;
        if (e < kInElems) {
          reinterpret_cast<float*>(halo)[(e / kCin) * 4 + e % kCin] =
              __uint_as_float(static_cast<uint32_t>(pre[i]) << 16);
        }
      }
      producers_sync();
      if (t + gridDim.x < n_tiles) fetch(t + gridDim.x);  // lands under the FMAs
      mbar_wait(bar_empty + 8 * buf, ((it >> 1) & 1) ^ 1);

      // conv1 tile (r, c) is image (y0-1+r, x0-1+c) and reads halo rows
      // r .. r+2, columns c .. c+2
      unsigned char* dst = mid + buf * kMidBytes;
      for (int item = pw; item < kQuads; item += kProducerWarps) {
        const int qr = item / kQuadsX;
        const int r = qr * 2;
        const int c = (item - qr * kQuadsX) * 2;
        const int gy = tile.y0 - 1 + r;
        const int gx = tile.x0 - 1 + c;
        const bool row_in[2] = {gy >= 0 && gy < h, gy + 1 >= 0 && gy + 1 < h};
        const bool col_in[2] = {gx >= 0 && gx < w, gx + 1 >= 0 && gx + 1 < w};
        float sa[2][2] = {}, sb[2][2] = {};  // [dy][dx]; channels 2l and 2l + 1
        if ((row_in[0] || row_in[1]) && (col_in[0] || col_in[1])) {
          // halo row r + iy is tap row ky = iy - dy of output row dy: every
          // sum still takes its taps in (ky, kx, ci) order
#pragma unroll
          for (int iy = 0; iy < 4; ++iy) {
            const float4* row = halo + (r + iy) * kInW + c;
            const float4 p[4] = {row[0], row[1], row[2], row[3]};
#pragma unroll
            for (int dy = 0; dy < 2; ++dy) {
              const int ky = iy - dy;
              if (ky < 0 || ky > 2) continue;
#pragma unroll
              for (int kx = 0; kx < 3; ++kx) {
                const int k = (ky * 3 + kx) * kCin;
#pragma unroll
                for (int dx = 0; dx < 2; ++dx) {
                  sa[dy][dx] = __fmaf_rn(p[kx + dx].x, wa[k], sa[dy][dx]);
                  sb[dy][dx] = __fmaf_rn(p[kx + dx].x, wb[k], sb[dy][dx]);
                }
#pragma unroll
                for (int dx = 0; dx < 2; ++dx) {
                  sa[dy][dx] = __fmaf_rn(p[kx + dx].y, wa[k + 1], sa[dy][dx]);
                  sb[dy][dx] = __fmaf_rn(p[kx + dx].y, wb[k + 1], sb[dy][dx]);
                }
#pragma unroll
                for (int dx = 0; dx < 2; ++dx) {
                  sa[dy][dx] = __fmaf_rn(p[kx + dx].z, wa[k + 2], sa[dy][dx]);
                  sb[dy][dx] = __fmaf_rn(p[kx + dx].z, wb[k + 2], sb[dy][dx]);
                }
              }
            }
          }
        }
        // pixel p is row p of the swizzled tile: 16-byte chunk q of the row
        // sits at chunk q ^ (p & 7)
        const int q = lane >> 2;
        const int sub = (lane & 3) * 4;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            // centred outside the image: conv1_2's zero padding
            const bool in = row_in[dy] && col_in[dx];
            const float va = in ? fmaxf(__fadd_rn(sa[dy][dx], bias_a), 0.f) : 0.f;
            const float vb = in ? fmaxf(__fadd_rn(sb[dy][dx], bias_b), 0.f) : 0.f;
            const int px = (r + dy) * kMidW + c + dx;
            *reinterpret_cast<__nv_bfloat162*>(
                dst + px * kRowBytes + ((q ^ (px & 7)) << 4) + sub) =
                __floats2bfloat162_rn(va, vb);
          }
        }
      }
      // generic-proxy stores must be visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(bar_full + 8 * buf);
    }
  } else {
    // ---------------- consumers: conv1_2 on wgmma, pool, store ----------------
    const int cw = (tid >> 5) & 3;  // warp of the warpgroup
    if (tid == 0) {
      mbar_arrive_expect_tx(bar_w2, kW2Bytes);
      bulk_copy_g2s(smem_u32(smem), w2, kW2Bytes, bar_w2);
    }
    // this lane's output channels in the epilogue: chunks 4 * half .. + 3,
    // channels 8 * chunk + 2 * (lane & 3) and the next one
    const int half = (lane >> 2) & 1;
    float bias_lo[4], bias_hi[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int ch = 8 * (jj + 4 * half) + 2 * (lane & 3);
      bias_lo[jj] = b2[ch];
      bias_hi[jj] = b2[ch + 1];
    }
    unsigned char* stage = smem + kOffStage + (tid >> 5) * 4 * kStagePx;
    const uint32_t b_w2 = smem_u32(smem);
    const int ho = h / 2;
    const int wo = w / 2;
    mbar_wait(bar_w2, 0);

    // the tile's patches alternate between the two warpgroups: one's
    // epilogue runs under the other's wgmmas
    float acc[32];
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
      const Tile tile = decode_tile(t, tiles_y, tiles_x);
      const int buf = it & 1;
      // patches inside the image: a prefix in y and in x
      const int nx = min(kPatchesX, (w - tile.x0) / kPatch);
      const int nv = min(kPatchesY, (h - tile.y0) / kPatch) * nx;
      const uint32_t a_tile = smem_u32(mid + buf * kMidBytes);
      mbar_wait(bar_full + 8 * buf, (it >> 1) & 1);
      if (group >= nv) mbar_arrive(bar_empty + 8 * buf);  // nothing to read
      for (int q = group; q < nv; q += kConsumerGroups) {
        const int py = q / nx;
        const int px = q - py * nx;
        mma_patch(acc, a_tile + (py * kPatch * kMidW + px * kPatch) * kRowBytes,
                    b_w2);
        wgmma_wait<0>();
        if (q + kConsumerGroups >= nv) {
          mbar_arrive(bar_empty + 8 * buf);  // this group's last read of the tile
        }
        // pooled row of this warp, first pooled pixel of the patch
        const int oy = (tile.y0 + py * kPatch) / 2 + cw;
        const int ox = (tile.x0 + px * kPatch) / 2;
        pool_patch(acc, bias_lo, bias_hi, stage, lane, out,
                   ((static_cast<size_t>(tile.img) * ho + oy) * wo + ox) * kCh);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`. x: (n, h, w, 3) bf16; w1: (27, 64) f32 holding
// bf16 values, rows in (ky, kx, ci) order; b1, b2: (64) f32; w2: 73,728
// bytes of bf16, [tap][co][ci] with the 16-byte chunks of each 128-byte
// (tap, co) row XOR-swizzled by co & 7 (the wrapper's pack_stem_weights);
// out: (n, h/2, w/2, 64) bf16. h and w must be multiples of 8 and n > 0
// (checked by the caller). Returns cudaGetLastError() so that the caller
// sees a refused launch.
int ctpn_stem_fused(const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, int n, int h,
                    int w, void* stream) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        stem_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_y = (h + kTileH - 1) / kTileH;
  const int n_tiles = n * tiles_y * tiles_x;
  const int grid = n_tiles < sms ? n_tiles : sms;  // one persistent CTA per SM
  stem_fused_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const unsigned char*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), h, w,
      tiles_y, tiles_x, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
