// Greedy-NMS keep flags from a suppression bitmask, one CTA per image
// (sm_90a).
//
// Replaces no Pallas kernel: its counterpart in the JAX package is the jnp
// program ctpn_tpu/ops/nms.py::nms_fixed_point_blocked (lines 136-196, a
// lax.scan over blocks with a lax.while_loop inside, one device program).
// Same function: mask (B, N, W) 32-bit words, W = ceil(N / 32), row i's bits
// = the later boxes that box i suppresses (bit j % 32 of word j / 32), and
// valid (B, N) bool give keep (B, N) bool, the unique solution of
//   keep[i] = valid[i] and not any(keep[j] and bit(j, i) for j < i).
// Every box is resolved; there is no cap.
//
// What bounds it on the H100: a dependency chain, and one SM's load rate.
// The words right of the diagonal are 9 MB per image at N = 12000 (72 MB at
// batch 8: 0.022 ms at the card's 3.35 TB/s) and the work on them is one OR
// each, but box i's fate needs every kept earlier row, and a single CTA
// per image waits for its loads longer than it resolves: one SM draws a
// small share of the card's memory rate. So the fixed-point sweeps of the
// jnp program (and of the plain version here) are replaced by the exact
// serial chain, kept short, and the loads are spread over a thread-block
// cluster of up to eight CTAs per image:
//   1. the rows are walked 32 at a time (group g = rows 32g .. 32g + 31,
//      whose diagonal word is word g). CTA c owns a slice of the W word
//      columns, [c * slice, (c + 1) * slice): it keeps `supp`, the boxes
//      of its columns that the rows kept so far suppress, in shared memory,
//      and it resolves the groups whose diagonal word lies in its slice;
//   2. resolving is warp 0's work, a row per lane: alive = valid &
//      ~supp[g]; if no alive row's diagonal word touches an alive box (one
//      warp-wide OR) the word is final, else a 32-step chain clears the
//      boxes of each row that is still alive at its turn, the diagonal
//      words coming to the lanes by shuffles that do not depend on the
//      chain. It writes the 32 keep flags and sends the keep word to every
//      later CTA of the cluster through distributed shared memory, as one
//      64-bit store of (g + 1, word), so that tag and word arrive together;
//   3. a CTA whose slice lies right of group g waits for that word (warp 0
//      polls its own shared memory) and folds: thread f ORs the kept rows'
//      word of its column, already in registers, into supp. Columns at or
//      left of the diagonal are never read, which halves the bytes, and a
//      CTA is done once the walk has passed its slice. So the chain runs
//      through the cluster once, from CTA 0 to the last, and the later
//      CTAs fold behind it;
//   4. the 32 words a thread folds were loaded kDepth - 1 groups earlier
//      into a rotating set of register buffers, so no load sits on the
//      chain. Loads are 4 bytes wide, coalesced along the row: a row's
//      stride (W words) is in general no multiple of 16 bytes.
// Two __syncthreads per group inside a CTA (three warps): supp[g] complete
// before the resolve, the keep word there before the fold. The launcher
// takes the smallest cluster of 1, 2, 4 or 8 CTAs whose slices fit the
// kFold fold threads; beyond that (N > 16384) a thread also folds the
// columns kFold further on, from direct loads of the kept rows. A wait
// that outlasts any schedule traps instead of hanging the card. keep is
// written as bools. The kernel touches no float.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kFold = 64;             // threads that fold, a column each
constexpr int kThreads = kFold + 32;  // and warp 0, which resolves
constexpr int kDepth = 4;             // register buffers: groups in flight + 1
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr long long kSpinMax = 1ll << 26;  // polls before a wait gives up
constexpr uint32_t kFull = 0xffffffffu;

// A fold thread's words of group g: b[k] = word w of row 32g + k, for the
// groups left of its column.
__device__ __forceinline__ void load_fold(const uint32_t* __restrict__ mask,
                                          int n, int words, int g, int w,
                                          bool owns, uint32_t (&b)[32]) {
  // rows of the group that exist, if this thread loads at all
  const int rows = owns && g < w ? min(32, n - g * 32) : 0;
  const uint32_t* p = mask + static_cast<size_t>(g) * 32 * words + w;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    b[k] = k < rows ? __ldcs(p) : 0u;
    p += words;  // one add per load: no 64-bit multiply
  }
}

// A resolver lane's row 32g + lane: its diagonal word and its valid flag,
// for the groups of the CTA's own slice [w_lo, w_hi).
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ mask,
                                         const uint8_t* __restrict__ valid,
                                         int n, int words, int g, int lane,
                                         int w_lo, int w_hi, uint32_t& diag,
                                         bool& ok) {
  const int i = g * 32 + lane;
  const bool mine = g >= w_lo && g < w_hi && i < n;
  diag = mine ? __ldcs(mask + static_cast<size_t>(i) * words + g) : 0u;
  ok = mine && valid[i] != 0;
}

__global__ void __launch_bounds__(kThreads)
nms_resolve_kernel(const uint32_t* __restrict__ mask,
                   const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ keep, int n, int words, int slice,
                   int ranks) {
  // keep words by group, each tagged with its group + 1; then supp
  extern __shared__ __align__(8) unsigned char smem[];
  unsigned long long* slot = reinterpret_cast<unsigned long long*>(smem);
  uint32_t* supp = reinterpret_cast<uint32_t*>(slot + words);
  __shared__ uint32_t kept_word;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool resolver = tid < 32;
  const size_t img = blockIdx.x / ranks;
  mask += img * n * static_cast<size_t>(words);
  valid += img * n;
  keep += img * n;

  const int w_lo = min(words, rank * slice);  // this CTA's columns
  const int w_hi = min(words, w_lo + slice);
  const int w = w_lo + tid - 32;              // a fold thread's column
  const bool owns = !resolver && w < w_hi;

  for (int g = tid; g < words; g += kThreads) slot[g] = 0ull;
  for (int c = tid; c < slice; c += kThreads) supp[c] = 0u;
  cluster.sync();  // no keep word arrives before the slots are cleared

  // index g % kDepth holds group g's: a fold thread's words, a resolver lane's row
  uint32_t buf[kDepth][32];
  uint32_t diag[kDepth];
  bool ok[kDepth];
#pragma unroll
  for (int s = 0; s < kDepth - 1; ++s) {
    if (resolver) {
      load_row(mask, valid, n, words, s, lane, w_lo, w_hi, diag[s], ok[s]);
    } else {
      load_fold(mask, n, words, s, w, owns, buf[s]);
    }
  }

  // the walk ends for this CTA with the last group of its slice
  for (int g0 = 0; g0 < w_hi; g0 += kDepth) {
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      const int g = g0 + s;
      if (g >= w_hi) break;  // uniform over the CTA
      // the buffer of group g - 1, folded already, takes group g + kDepth - 1:
      // issued between the barriers, off the chain from one keep word
      // through the fold to the next resolve
      constexpr int kLast = kDepth - 1;

      __syncthreads();  // every fold into supp[g] is done
      if (resolver) {
        uint32_t a;
        if (g >= w_lo) {
          a = __ballot_sync(kFull, ok[s]) & ~supp[g - w_lo];
          // row 32g + lane may only suppress later boxes of its own word
          const uint32_t own = lane == 31 ? 0u : diag[s] & (kFull << (lane + 1));
          const uint32_t touched =
              __reduce_or_sync(kFull, ((a >> lane) & 1u) ? own : 0u) & a;
          if (touched != 0u) {
            // box k is kept iff its bit is still set when its turn comes;
            // bits at or below k are final by then
#pragma unroll
            for (int k = 0; k < 32; ++k) {
              const uint32_t m = __shfl_sync(kFull, own, k);
              if ((a >> k) & 1u) a &= ~m;
            }
          }
          // lane r tells CTA rank + r
          if (lane > 0 && rank + lane < ranks) {
            unsigned long long* theirs = cluster.map_shared_rank(slot, rank + lane);
            *reinterpret_cast<volatile unsigned long long*>(theirs + g) =
                (static_cast<unsigned long long>(g + 1) << 32) | a;
          }
          const int i = g * 32 + lane;
          if (i < n) keep[i] = (a >> lane) & 1u;
        } else {
          unsigned long long v = 0ull;
          if (lane == 0) {
            const volatile unsigned long long* mine = slot + g;
            long long spins = 0;
            while (static_cast<int>((v = *mine) >> 32) != g + 1) {
              if (++spins > kSpinMax) __trap();
            }
          }
          a = static_cast<uint32_t>(__shfl_sync(kFull, v, 0));
        }
        if (lane == 0) kept_word = a;
        load_row(mask, valid, n, words, g + kLast, lane, w_lo, w_hi,
                 diag[(s + kLast) % kDepth], ok[(s + kLast) % kDepth]);
      } else {
        load_fold(mask, n, words, g + kLast, w, owns, buf[(s + kLast) % kDepth]);
      }
      __syncthreads();  // the keep word is there

      const uint32_t a = kept_word;
      if (a == 0u) continue;  // uniform: nothing kept, nothing to fold
      if (owns && g < w) {
        uint32_t acc = 0u;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          if ((a >> k) & 1u) acc |= buf[s][k];
        }
        supp[w - w_lo] |= acc;
      }
      // columns beyond the prefetched ones: the kept rows only (a kept row
      // lies below n)
      if (!resolver) {
        for (int far = w + kFold; far < w_hi; far += kFold) {
          if (g >= far) continue;
          const uint32_t* p = mask + static_cast<size_t>(g) * 32 * words + far;
          uint32_t acc = 0u;
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            if ((a >> k) & 1u) acc |= __ldcs(p);
            p += words;
          }
          supp[far - w_lo] |= acc;
        }
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may still write to it
}

}  // namespace

extern "C" {

// Launches on `stream` and writes every flag of `keep` (batch * n bytes,
// 0 or 1). `mask` holds batch * n * ceil(n / 32) words, `valid` batch * n
// bytes. Returns the launch's error code so that the caller sees a refused
// launch.
int ctpn_nms_resolve(const void* mask, const void* valid, void* keep,
                     int batch, int n, void* stream) {
  const int words = (n + 31) / 32;
  int ranks = 1;
  while (ranks < kMaxCluster && (words + ranks - 1) / ranks > kFold) ranks *= 2;
  const int slice = (words + ranks - 1) / ranks;
  const size_t smem = words * sizeof(unsigned long long) + slice * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * ranks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &config, nms_resolve_kernel, static_cast<const uint32_t*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), n, words,
      slice, ranks);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
