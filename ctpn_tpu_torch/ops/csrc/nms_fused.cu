// Greedy-NMS keep mask over score-sorted boxes, one CTA per image (sm_90a).
//
// Replaces the TPU kernel ctpn_tpu/ops/nms_fused.py::_fused_kernel (reached
// through nms_keep_sorted_fused, pl.pallas_call at nms_fused.py:212). Same
// function: boxes (B, K, 4) f32 and valid (B, K) bool, sorted by score
// descending, give keep (B, K) bool; a box is kept iff it is valid and no
// earlier kept box overlaps it with IoU >= t, tested divide-free as
// inter >= t * union with +1-pixel areas and union clamped at 1e-10. Once
// `cap` boxes are kept the kernel stops; later flags stay 0. The first `cap`
// survivors are bit-identical to the sequential greedy oracle.
//
// What bounds it on the H100: neither bytes nor FLOPs. The input is small
// (12000 boxes = 192 KB of boxes plus 12 KB of flags, all L2-resident), and
// the IoU pair tests of the blocks it visits are a few hundred million
// float ops at most, about a microsecond of the card's f32 rate. The greedy
// recurrence is sequential: box j's fate depends on every earlier kept box.
// The TPU walked 512-box blocks in grid order with an SMEM counter; Hopper
// runs CTAs in no order, so here the sequential walk is a loop inside one
// CTA per image:
//   1. the block's 512 boxes go to shared memory, one thread per box;
//   2. each thread tests its box against the compact list of boxes kept in
//      earlier blocks (shared memory, or global scratch when the cap is
//      large), in parallel over the block's rows;
//   3. each thread builds the 512-bit mask of earlier in-block candidates
//      that suppress its box, in parallel;
//   4. warp 0 resolves the block exactly in row order: lane w holds word w
//      of the kept-bit vector, and one ballot per row decides it;
//   5. kept boxes append to the list; the loop ends once `cap` are kept.
// Step 4 is the serial part (512 rows per block, a few cycles each). With
// one CTA per image a batch of 8 uses 8 of the 132 SMs: throughput is left
// on the table on purpose, correctness first.
//
// Bit-identity: the IoU arithmetic must round exactly as the plain PyTorch
// version and as numpy/XLA do. Every add, subtract and multiply below uses
// the _rn intrinsics, which nvcc never contracts into FMAs; the library is
// also built with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 512;            // boxes per block = threads per CTA
constexpr int kWords = kBlock / 32;    // 32-bit words of a block bit vector
// dynamic shared memory before the kept list: rows, masks, candidate flags
constexpr int kFixedSmem =
    kBlock * sizeof(float4) + kBlock * kWords * sizeof(uint32_t) + kBlock;

__device__ __forceinline__ float side(float lo, float hi) {
  return __fadd_rn(__fsub_rn(hi, lo), 1.0f);
}

// True iff `a` and `b` overlap with IoU >= t (divide-free, +1 areas).
__device__ __forceinline__ bool suppresses(float4 a, float4 b, float t) {
  float iw = __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f);
  float ih = __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f);
  float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  float area_a = __fmul_rn(side(a.x, a.z), side(a.y, a.w));
  float area_b = __fmul_rn(side(b.x, b.z), side(b.y, b.w));
  float uni = fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-10f);
  return inter >= __fmul_rn(t, uni);
}

__global__ void __launch_bounds__(kBlock)
nms_fused_kernel(const float* __restrict__ boxes,
                 const uint8_t* __restrict__ valid,
                 uint8_t* __restrict__ keep,
                 float4* __restrict__ kept_global,
                 int k, int cap, float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* rows = reinterpret_cast<float4*>(smem);
  uint32_t* supp_by = reinterpret_cast<uint32_t*>(rows + kBlock);
  uint8_t* cand = reinterpret_cast<uint8_t*>(supp_by + kBlock * kWords);
  float4* kept = kept_global != nullptr
                     ? kept_global + static_cast<size_t>(blockIdx.x) * cap
                     : reinterpret_cast<float4*>(smem + kFixedSmem);
  __shared__ uint32_t kept_bits[kWords];
  __shared__ int count_s;

  const int tid = threadIdx.x;
  const size_t img = blockIdx.x;
  boxes += img * k * 4;
  valid += img * k;
  keep += img * k;
  if (tid == 0) count_s = 0;
  __syncthreads();

  for (int lo = 0; lo < k; lo += kBlock) {
    const int count = count_s;
    if (count >= cap) break;  // uniform: every thread read the same count
    const int r = lo + tid;
    const int nrow = min(kBlock, k - lo);

    // 1-2. load this thread's box; test it against earlier kept boxes
    bool alive = false;
    float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < k) {
      box = make_float4(boxes[4 * r], boxes[4 * r + 1], boxes[4 * r + 2],
                        boxes[4 * r + 3]);
      alive = valid[r] != 0;
    }
    for (int c = 0; alive && c < count; ++c) {
      if (suppresses(kept[c], box, thresh)) alive = false;
    }
    rows[tid] = box;
    cand[tid] = alive;
    __syncthreads();

    // 3. mask of earlier in-block candidates that would suppress this box
    uint32_t* mine = supp_by + tid * kWords;
    for (int w = 0; w < kWords; ++w) {
      uint32_t bits = 0u;
      const int base = w * 32;
      if (alive && base < tid) {
        const int end = min(32, tid - base);
        for (int l = 0; l < end; ++l) {
          const int i = base + l;
          if (cand[i] && suppresses(rows[i], box, thresh)) bits |= 1u << l;
        }
      }
      mine[w] = bits;
    }
    __syncthreads();

    // 4-5. exact greedy over the block's rows, in score order
    if (tid < 32) {
      uint32_t word = 0u;  // lane w < kWords holds kept bits of word w
      int cnt = count;
      for (int j = 0; j < nrow && cnt < cap; ++j) {
        if (!cand[j]) continue;  // uniform across the warp
        uint32_t hit = tid < kWords ? (supp_by[j * kWords + tid] & word) : 0u;
        if (__any_sync(0xffffffffu, hit != 0u)) continue;
        if (tid == (j >> 5)) word |= 1u << (j & 31);
        if (tid == 0) kept[cnt] = rows[j];
        ++cnt;
      }
      if (tid < kWords) kept_bits[tid] = word;
      if (tid == 0) count_s = cnt;
    }
    __syncthreads();
    if (r < k) keep[r] = (kept_bits[tid >> 5] >> (tid & 31)) & 1u;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; `keep` must be zeroed by the caller. The kept list
// lives in shared memory, or in `kept_scratch` (batch * cap float4) when the
// caller passes one for a cap too large for shared memory. Returns
// cudaGetLastError() so that the caller sees a refused launch.
int ctpn_nms_fused(const void* boxes, const void* valid, void* keep,
                   void* kept_scratch, int batch, int k, int cap,
                   float thresh, void* stream) {
  const int smem = kept_scratch != nullptr
                       ? kFixedSmem
                       : kFixedSmem + cap * static_cast<int>(sizeof(float4));
  cudaError_t err = cudaFuncSetAttribute(
      nms_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_fused_kernel<<<batch, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), static_cast<float4*>(kept_scratch), k, cap,
      thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
