// Greedy-NMS keep mask over score-sorted boxes, one thread-block cluster of
// eight CTAs per image (sm_90a).
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
// The TPU walked 512-box blocks in grid order with an SMEM counter. Here
// the walk is a loop inside a cluster of eight CTAs (the portable cluster
// size: a batch of 8 fills 64 SMs), which spreads the parallel part of a
// block over 2048 threads and keeps the serial part short:
//   1. every CTA loads the block's 512 boxes into its shared memory;
//   2. CTA c tests candidates 64c .. 64c + 63 against the boxes kept in
//      earlier blocks, four threads per candidate over interleaved quarters
//      of the kept list (each CTA holds its own copy of the list, in shared
//      memory, or in global scratch when the cap is large), and sends its
//      two words of candidate bits to the leader CTA through distributed
//      shared memory;
//   3. the in-block suppression matrix (row i, column word w: which later
//      boxes of word w box i suppresses) is cut into 32 x 32 tiles; the 136
//      tiles on or above the diagonal are dealt round-robin to the
//      cluster's 64 warps, a lane per row, and land in the leader's shared
//      memory (row stride 17 words: no bank conflict by row or by word);
//   4. after a cluster barrier, warp 0 of the leader resolves the block
//      exactly, 32 boxes at a time: a word whose candidates do not touch
//      each other is kept as it is (one warp-wide OR decides that);
//      otherwise every lane runs the 32-step greedy chain on registers, the
//      rows' masks fetched by shuffles that do not depend on the chain. The
//      kept boxes' rows are then OR-reduced into the later words'
//      candidates. No step loads anything to skip a dead box;
//   5. after a second cluster barrier every CTA reads the kept bits and the
//      count from the leader, appends the kept boxes to its list, and
//      writes its stripe of the keep flags. The loop ends once `cap` boxes
//      are kept, exactly at the cap: a word that would pass it loses its
//      last boxes.
// Blocks are not pipelined: while the leader resolves, the other CTAs wait.
//
// Bit-identity: the IoU arithmetic must round exactly as the plain PyTorch
// version and as numpy/XLA do. Every add, subtract and multiply below uses
// the _rn intrinsics, which nvcc never contracts into FMAs; the library is
// also built with -fmad=false.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 512;            // boxes per block of the walk
constexpr int kWords = kBlock / 32;    // 32-bit words of a block bit vector
constexpr int kCluster = 8;            // CTAs per image
constexpr int kThreads = 256;          // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kStripe = kBlock / kCluster;  // candidates a CTA tests: 64
constexpr int kParts = kThreads / kStripe;  // threads per candidate: 4
constexpr int kMaskLd = kWords + 1;    // padded row stride of the matrix
constexpr int kTiles = kWords * (kWords + 1) / 2;  // on or above the diagonal
static_assert(kStripe == 64 && kParts == 4, "two candidate words per CTA");

// dynamic shared memory of every CTA (the leader's matrix, candidate words
// and result are the ones in use); the kept list follows
struct Shared {
  float4 rows[kBlock];
  uint32_t mask[kBlock * kMaskLd];
  uint32_t cand[kWords];
  uint32_t result[kWords + 1];  // kept bits, then the count
  uint32_t mine[kWords + 1];    // this CTA's copy of the leader's result
  uint8_t alive[kStripe];
};
constexpr int kFixedSmem = (sizeof(Shared) + 15) / 16 * 16;

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

// Exact greedy over one block in score order, by one warp. `cand` holds the
// candidates that survived the earlier blocks' kept boxes, `mask` the
// in-block matrix. Writes the kept bits and the new count to `result`.
__device__ __forceinline__ void resolve_block(const uint32_t* cand,
                                              const uint32_t* mask,
                                              uint32_t* result, int lane,
                                              int count, int cap) {
  uint32_t avail = lane < kWords ? cand[lane] : 0u;  // lane w: word w
  uint32_t kept_word = 0u;
#pragma unroll 1
  for (int wi = 0; wi < kWords && count < cap; ++wi) {
    uint32_t a = __shfl_sync(0xffffffffu, avail, wi);
    if (a == 0u) continue;  // uniform across the warp
    const uint32_t* row = mask + (wi * 32 + lane) * kMaskLd;
    const uint32_t own = row[wi];  // later boxes of this word that mine suppresses
    const uint32_t touched =
        __reduce_or_sync(0xffffffffu, ((a >> lane) & 1u) ? own : 0u) & a;
    if (touched != 0u) {
      // box i is kept iff still set when its turn comes; a row has bits
      // above its own index only, so bits at or below i are final
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const uint32_t m = __shfl_sync(0xffffffffu, own, i);
        if ((a >> i) & 1u) a &= ~m;
      }
    }
    while (__popc(a) > cap - count) a &= ~(0x80000000u >> __clz(a));
    count += __popc(a);
    if (lane == wi) kept_word = a;
    const bool kept = (a >> lane) & 1u;
    for (int w = wi + 1; w < kWords; ++w) {
      const uint32_t gone = __reduce_or_sync(0xffffffffu, kept ? row[w] : 0u);
      if (lane == w) avail &= ~gone;
    }
  }
  if (lane < kWords) result[lane] = kept_word;
  if (lane == kWords) result[kWords] = static_cast<uint32_t>(count);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
nms_fused_kernel(const float* __restrict__ boxes,
                 const uint8_t* __restrict__ valid,
                 uint8_t* __restrict__ keep,
                 float4* __restrict__ kept_global,
                 int k, int cap, float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t img = blockIdx.x / kCluster;
  Shared& leader = *cluster.map_shared_rank(&s, 0);
  // each CTA appends the same boxes to its own copy of the kept list
  float4* kept = kept_global != nullptr
                     ? kept_global + (img * kCluster + rank) * cap
                     : reinterpret_cast<float4*>(smem + kFixedSmem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  boxes += img * k * 4;
  valid += img * k;
  keep += img * k;

  int count = 0;  // the same in every thread of the cluster
  for (int lo = 0; lo < k && count < cap; lo += kBlock) {
    // 1. the block's boxes; rows past the end are zero boxes, never alive
    for (int i = tid; i < kBlock; i += kThreads) {
      const int r = lo + i;
      s.rows[i] = r < k ? make_float4(boxes[4 * r], boxes[4 * r + 1],
                                      boxes[4 * r + 2], boxes[4 * r + 3])
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    // 2. this CTA's candidates against the boxes kept in earlier blocks
    {
      const int ci = tid / kParts;
      const int j = rank * kStripe + ci;
      const float4 box = s.rows[j];
      bool alive = lo + j < k && valid[lo + j] != 0;
      for (int c = tid % kParts; alive && c < count; c += kParts) {
        if (suppresses(kept[c], box, thresh)) alive = false;
      }
      unsigned dead = !alive;  // the four quarters of the list must all pass
      dead |= __shfl_xor_sync(0xffffffffu, dead, 1);
      dead |= __shfl_xor_sync(0xffffffffu, dead, 2);
      if (tid % kParts == 0) s.alive[ci] = !dead;
    }
    __syncthreads();
    if (tid < kStripe) {  // warps 0 and 1: one candidate word each
      const uint32_t word = __ballot_sync(0xffffffffu, s.alive[tid] != 0);
      if (lane == 0) leader.cand[rank * (kStripe / 32) + warp] = word;
    }

    // 3. in-block matrix: tile (rw, cw), cw >= rw, a lane per row
    for (int t = rank * kWarps + warp; t < kTiles; t += kCluster * kWarps) {
      int rw = 0;
      int cw = t;
      while (cw >= kWords - rw) {
        cw -= kWords - rw;
        ++rw;
      }
      cw += rw;
      const int r = rw * 32 + lane;
      const float4 box = s.rows[r];
      uint32_t bits = 0u;
      for (int c = 0; c < 32; ++c) {
        const int col = cw * 32 + c;
        if (col > r && suppresses(box, s.rows[col], thresh)) bits |= 1u << c;
      }
      leader.mask[r * kMaskLd + cw] = bits;
    }
    cluster.sync();

    // 4. the leader's warp 0 resolves the block
    if (rank == 0 && warp == 0) {
      resolve_block(s.cand, s.mask, s.result, lane, count, cap);
    }
    cluster.sync();

    // 5. every CTA appends the kept boxes; CTA c writes its stripe's flags
    if (tid <= kWords) s.mine[tid] = leader.result[tid];
    __syncthreads();
    for (int i = tid; i < kBlock; i += kThreads) {
      const int w = i >> 5;
      const uint32_t word = s.mine[w];
      if ((word >> (i & 31)) & 1u) {
        int pos = count + __popc(word & ((1u << (i & 31)) - 1u));
        for (int u = 0; u < w; ++u) pos += __popc(s.mine[u]);
        kept[pos] = s.rows[i];
      }
    }
    if (tid < kStripe) {
      const int i = rank * kStripe + tid;
      if (lo + i < k) keep[lo + i] = (s.mine[i >> 5] >> (i & 31)) & 1u;
    }
    count = static_cast<int>(s.mine[kWords]);
    __syncthreads();  // rows and mine are rewritten by the next block
  }
  cluster.sync();  // no CTA leaves while another may still read its memory
}

}  // namespace

extern "C" {

// Launches on `stream`; `keep` must be zeroed by the caller. Every CTA of
// an image's cluster keeps its own copy of the kept list: in shared memory,
// or in `kept_scratch` (batch * 8 * cap float4) when the caller passes one
// for a cap too large for shared memory. Returns cudaGetLastError() so that
// the caller sees a refused launch.
int ctpn_nms_fused(const void* boxes, const void* valid, void* keep,
                   void* kept_scratch, int batch, int k, int cap,
                   float thresh, void* stream) {
  const int smem = kept_scratch != nullptr
                       ? kFixedSmem
                       : kFixedSmem + cap * static_cast<int>(sizeof(float4));
  cudaError_t err = cudaFuncSetAttribute(
      nms_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_fused_kernel<<<batch * kCluster, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), static_cast<float4*>(kept_scratch), k, cap,
      thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
