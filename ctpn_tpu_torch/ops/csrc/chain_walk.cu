// The text-line connector's two kernels (sm_90a): the successor graph, and
// the walk of every chain in it.
//
// successors_kernel: each proposal's kept successor or -1, by the rules of
// `build_successors` (ctpn_tpu/postprocess/connector.py:71 on the TPU):
// j is a candidate successor of i if both are valid, 0 < col_j - col_i <=
// max_gap, and their vertical overlap and size similarity are at least
// their thresholds; i keeps, among its candidates in the nearest such
// column, the best score (ties to the lowest index, as torch.argmax), and
// the edge stands if score_i is at least the best precursor score of that
// successor (the mirror rule, over the nearest column to its left).
//
// Replaces the port's dense form, about thirty passes over (N, P, P)
// tensors, 48 M elements each at the program's (48, 1000): 7.3 GB per
// batch through memory for 48 M pair tests. Few of the pairs matter: a
// candidate lies within max_gap columns, about three 16-px columns of the
// image's 57. What bounds it on the H100 is the branch and latency of the
// tests, not bytes (the inputs are 17 bytes a proposal) nor operations.
// Design for that:
//   * one CTA per image sorts the image's valid proposals by (column,
//     index) with a bitonic sort of 64-bit keys in shared memory, so a
//     node's candidates are its neighbours in that order, and a warp (32
//     consecutive positions) holds nodes of one or two columns that take
//     the same branches;
//   * a thread per position scans right to the nearest column that holds
//     a candidate successor and left to the nearest that holds a candidate
//     precursor, and stops there or past max_gap: tens of pair tests a
//     node, not P;
//   * the float tests are PyTorch's operations, rounded alike: h = (y2 -
//     y1) + 1, the overlap (min(y2) - max(y1)) + 1 clamped at 0, NaN
//     propagated by min and max, correctly rounded divides (__fdiv_rn),
//     -fmad=false; the successors are integers and equal the dense form's
//     bit for bit;
//   * each node's best precursor score goes to shared memory and its best
//     successor to the output; after a barrier, every edge is decided.
// Where an image's keys do not fit a block's shared memory (P > 16384),
// the wrapper hands global scratch for the keys and the precursor scores;
// where its sorted inputs do not fit beside them, they are read from
// global memory.
//
// chain_walk_kernel: from every proposal, its successor path, with the
// features summed in path order, the nodes counted, the least x1 and
// largest x2 taken, and whether it starts a chain.
//
// Replaces the port's dense form of `chain_reachability` and `_fit`
// (ctpn_tpu/postprocess/connector.py:105-134 on the TPU): there the members
// of every chain are the rows of a (P, P) reachability matrix R, found by
// ceil(log2(P)) squarings of (I + S) on the matrix unit, and each per-chain
// sum is a row of R @ F. On the card that is six float32 products of
// (1000, 1000) matrices per image, 12 GFLOP, and a dozen passes over R.
// The graph is a forest of paths (one successor per node, every edge a
// column to the right), so a row of R is one path, at most 57 nodes long
// at the program's largest bucket: it is walked instead.
//
// What bounds it on the H100: neither bytes nor operations. An image's
// graph and features are 41 KB (P = 1000, K = 7), read once; its sums are
// at most 57 adds per feature and node. The walk is a chain of dependent
// loads: the next node is known only when the current one's successor has
// been read. Design for that latency:
//   * one CTA per image stages the image's successors, x1, x2 and features
//     in shared memory (coalesced loads), so each dependent step is a
//     shared-memory load, not a global one;
//   * a thread per node walks its own path; 1024 threads keep 32 warps of
//     independent walks in flight on the SM to hide each step's latency;
//   * the in-edge flags are set in shared memory from the staged
//     successors after a barrier: a flag is only ever written 1, so writers
//     of the same flag need no atomic;
//   * each sum is a running float64 add in path order, rounded to float32
//     once at the end: the plain version's order and rounding (no atomics,
//     -fmad=false), so the bits repeat and equal it. Float32 running sums
//     would lose about a digit to the chain fits' covariance form, which
//     cancels the leading digits of sums of squares; float64 adds cost
//     nothing beside the walk's load latency.
// Where an image's features do not fit the block's shared memory, only its
// successors and flags are staged, and the features are read from global
// memory through the same pointers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxK = 8;  // the wrapper's MAX_K
constexpr int kMaxDevices = 64;
constexpr int kSharedNodes = 16384;  // the wrapper's SHARED_NODES
constexpr unsigned long long kNoNode = ~0ull;  // the key of an invalid node: sorted last

// a valid node's sort key: its column (order kept by flipping the sign
// bit), then its index
__device__ __forceinline__ unsigned long long node_key(int col, int i) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(col) ^ 0x80000000u) << 32) |
         static_cast<unsigned>(i);
}

__device__ __forceinline__ long long key_col(unsigned long long key) {
  return static_cast<int>(static_cast<unsigned>(key >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int key_node(unsigned long long key) {
  return static_cast<int>(static_cast<unsigned>(key));
}

// torch.minimum and torch.maximum: NaN if either is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// the dense form's pair test, symmetric in its two proposals (a has height
// ha): vertical overlap and size similarity both at least their thresholds
__device__ __forceinline__ bool meets(float y1a, float y2a, float ha, float y1b, float y2b,
                                      float min_ov, float min_sim) {
  const float hb = __fadd_rn(__fsub_rn(y2b, y1b), 1.0f);
  const float inter = __fadd_rn(__fsub_rn(min_nan(y2a, y2b), max_nan(y1a, y1b)), 1.0f);
  const float lo = min_nan(ha, hb);
  const float hi = max_nan(ha, hb);
  const float over = inter != inter ? inter : fmaxf(inter, 0.0f);  // torch.clamp(min=0)
  return __fdiv_rn(over, lo) >= min_ov && __fdiv_rn(lo, hi) >= min_sim;
}

// shared memory: the sort keys (p2 of 8 bytes) and the best precursor
// scores (p floats), then, when `staged`, y1, y2 and the score of each
// sorted position (3 p floats); with `keys_g` (never staged) the keys and
// the precursor scores are in global memory
__global__ void __launch_bounds__(kThreads)
successors_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                  const bool* __restrict__ valid, int* succ, unsigned long long* keys_g,
                  float* prec_g, int p, int p2, int max_gap, float min_ov, float min_sim,
                  bool staged) {
  extern __shared__ int4 smem_raw[];
  const long long base = static_cast<long long>(blockIdx.x) * p;
  const float* B = boxes + base * 4;
  const float* S = scores + base;
  const bool* V = valid + base;
  int* out = succ + base;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem_raw);
  float* prec = reinterpret_cast<float*>(keys + p2);
  if (keys_g != nullptr) {
    keys = keys_g + static_cast<long long>(blockIdx.x) * p2;
    prec = prec_g + base;
  }
  float* sy1 = prec + p;
  float* sy2 = sy1 + p;
  float* ssc = sy2 + p;

  for (int i = threadIdx.x; i < p2; i += kThreads) {
    unsigned long long key = kNoNode;
    if (i < p) {
      if (V[i]) key = node_key(static_cast<int>(floorf(B[4 * i])), i);
      prec[i] = -INFINITY;
      out[i] = -1;
    }
    keys[i] = key;
  }
  __syncthreads();

  // bitonic sort, ascending: each thread compares and swaps pairs (lo, lo + j)
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int m = threadIdx.x; m < p2 / 2; m += kThreads) {
        const int lo = 2 * m - (m & (j - 1));
        const unsigned long long a = keys[lo];
        const unsigned long long b = keys[lo + j];
        if ((a > b) == ((lo & k) == 0)) {
          keys[lo] = b;
          keys[lo + j] = a;
        }
      }
      __syncthreads();
    }
  }

  if (staged) {
    for (int r = threadIdx.x; r < p; r += kThreads) {
      const unsigned long long key = keys[r];
      if (key == kNoNode) break;
      const int i = key_node(key);
      sy1[r] = B[4 * i + 1];
      sy2[r] = B[4 * i + 3];
      ssc[r] = S[i];
    }
    __syncthreads();
  }

  // the valid nodes hold positions [0, valid count), the invalid keys the rest
  for (int r = threadIdx.x; r < p; r += kThreads) {
    const unsigned long long key = keys[r];
    if (key == kNoNode) break;
    const int t = key_node(key);
    const long long ct = key_col(key);
    const float y1t = staged ? sy1[r] : B[4 * t + 1];
    const float y2t = staged ? sy2[r] : B[4 * t + 3];
    const float ht = __fadd_rn(__fsub_rn(y2t, y1t), 1.0f);

    // successor: the nearest column to the right with a candidate; there the
    // best score, ties to the lowest index, from index 0 and -inf as
    // torch.argmax over a row of -inf and the column's scores
    int best = -1;
    float best_s = -INFINITY;
    long long near = 0;
    for (int q = r + 1; q < p; ++q) {
      const unsigned long long kq = keys[q];
      if (kq == kNoNode) break;
      const long long c = key_col(kq);
      if (c == ct) continue;
      if (c - ct > max_gap || (best >= 0 && c != near)) break;
      const int k = key_node(kq);
      if (!meets(y1t, y2t, ht, staged ? sy1[q] : B[4 * k + 1], staged ? sy2[q] : B[4 * k + 3],
                 min_ov, min_sim)) {
        continue;
      }
      if (best < 0) {
        best = 0;
        near = c;
      }
      const float s = staged ? ssc[q] : S[k];
      if (s > best_s || (s != s && best_s == best_s)) {  // a NaN wins, the first one
        best_s = s;
        best = k;
      }
    }

    // precursor: the nearest column to the left with a candidate; there the
    // largest score (NaN if any is NaN, as torch.max)
    float prec_s = -INFINITY;
    bool found = false;
    for (int q = r - 1; q >= 0; --q) {
      const unsigned long long kq = keys[q];
      const long long c = key_col(kq);
      if (c == ct) continue;
      if (ct - c > max_gap || (found && c != near)) break;
      const int k = key_node(kq);
      if (!meets(y1t, y2t, ht, staged ? sy1[q] : B[4 * k + 1], staged ? sy2[q] : B[4 * k + 3],
                 min_ov, min_sim)) {
        continue;
      }
      found = true;
      near = c;
      const float s = staged ? ssc[q] : S[k];
      if (s > prec_s || s != s) prec_s = s;
    }
    prec[t] = prec_s;
    out[t] = best;
  }
  __syncthreads();

  // the edge i -> j stands if score_i >= the best precursor score of j
  for (int i = threadIdx.x; i < p; i += kThreads) {
    const int j = out[i];
    if (j >= 0 && !(S[i] >= prec[j])) out[i] = -1;
  }
}

// shared memory: successors (p ints), then x1, x2 and the features (p,
// p and p * k floats) when `staged`, then the in-edge flags (p bytes)
__global__ void __launch_bounds__(kThreads)
chain_walk_kernel(const int* __restrict__ succ, const float* __restrict__ feats,
                  const float* __restrict__ x1, const float* __restrict__ x2,
                  float* __restrict__ sums, float* __restrict__ cnt,
                  float* __restrict__ min_x1, float* __restrict__ max_x2,
                  bool* __restrict__ is_start, int p, int k, int steps, bool staged) {
  extern __shared__ int4 smem_raw[];
  const long long base = static_cast<long long>(blockIdx.x) * p;
  int* s_succ = reinterpret_cast<int*>(smem_raw);
  float* s_floats = reinterpret_cast<float*>(s_succ + p);
  const float* X1 = x1 + base;
  const float* X2 = x2 + base;
  const float* F = feats + base * k;
  unsigned char* s_in = reinterpret_cast<unsigned char*>(s_floats);
  if (staged) {
    float* sx1 = s_floats;
    float* sx2 = sx1 + p;
    float* sf = sx2 + p;
    for (int i = threadIdx.x; i < p; i += kThreads) {
      sx1[i] = X1[i];
      sx2[i] = X2[i];
    }
    for (int i = threadIdx.x; i < p * k; i += kThreads) sf[i] = F[i];
    X1 = sx1;
    X2 = sx2;
    F = sf;
    s_in = reinterpret_cast<unsigned char*>(sf + p * k);
  }
  for (int i = threadIdx.x; i < p; i += kThreads) {
    s_succ[i] = succ[base + i];
    s_in[i] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p; i += kThreads) {
    const int j = s_succ[i];
    if (j >= 0 && j < p) s_in[j] = 1;
  }
  __syncthreads();

  for (int s = threadIdx.x; s < p; s += kThreads) {
    double acc[kMaxK];
#pragma unroll
    for (int c = 0; c < kMaxK; ++c) acc[c] = c < k ? F[s * k + c] : 0.0;
    float lo = X1[s];
    float hi = X2[s];
    int n = 1;
    int cur = s;
    for (int t = 0; t < steps; ++t) {
      const int nxt = s_succ[cur];
      if (nxt < 0 || nxt >= p) break;
      cur = nxt;
#pragma unroll
      for (int c = 0; c < kMaxK; ++c) {
        if (c < k) acc[c] = __dadd_rn(acc[c], F[cur * k + c]);
      }
      ++n;
      const float a = X1[cur];
      if (a < lo) lo = a;
      const float b = X2[cur];
      if (b > hi) hi = b;
    }
    float* out = sums + (base + s) * k;
#pragma unroll
    for (int c = 0; c < kMaxK; ++c) {
      if (c < k) out[c] = __double2float_rn(acc[c]);
    }
    cnt[base + s] = static_cast<float>(n);
    min_x1[base + s] = lo;
    max_x2[base + s] = hi;
    const int j = s_succ[s];
    is_start[base + s] = j >= 0 && j < p && !s_in[s];
  }
}

// the block's opt-in shared-memory limit on each device, per kernel; 0
// until first asked
int g_successors_optin[kMaxDevices];
int g_walk_optin[kMaxDevices];

// `optin` = the block's opt-in shared-memory limit on the current device,
// and `kernel` allowed all of it: asked and set once per device, in the
// first (eager) call
cudaError_t smem_optin(const void* kernel, int* cache, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int limit = 0;
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return err;
    cache[dev] = limit;
  }
  *optin = cache[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// boxes: (n, p, 4) float32 [x1, y1, x2, y2]; scores: (n, p) float32; valid:
// (n, p) bool; output succ (n, p) int32; keys, prec: null, or global
// scratch of n * p2 int64 and n * p float32 (p2 the power of two >= p),
// which an image of more than 16384 nodes needs; all contiguous on the
// current device. Launches one CTA per image on `stream` and returns
// cudaGetLastError(); cudaErrorInvalidValue when the scratch is missing
// where needed, or p exceeds 2^30.
int ctpn_successors(const void* boxes, const void* scores, const void* valid, void* succ,
                    void* keys, void* prec, int n, int p, int max_gap, float min_v_overlaps,
                    float min_size_sim, void* stream) {
  if (n < 0 || p < 0 || p > (1 << 30) || (keys == nullptr) != (prec == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0 || p == 0) return cudaSuccess;
  if (keys == nullptr && p > kSharedNodes) return cudaErrorInvalidValue;
  int p2 = 1;
  while (p2 < p) p2 <<= 1;
  int optin = 0;
  cudaError_t err =
      smem_optin(reinterpret_cast<const void*>(successors_kernel), g_successors_optin, &optin);
  if (err != cudaSuccess) return err;
  long long bytes = 0;
  bool staged = false;
  if (keys == nullptr) {
    const long long lean = 8LL * p2 + 4LL * p;
    const long long full = lean + 12LL * p;
    staged = full <= optin;
    bytes = staged ? full : lean;
    if (bytes > optin) return cudaErrorInvalidValue;
  }
  successors_kernel<<<n, kThreads, static_cast<size_t>(bytes),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const bool*>(valid), static_cast<int*>(succ),
      static_cast<unsigned long long*>(keys), static_cast<float*>(prec), p, p2, max_gap,
      min_v_overlaps, min_size_sim, staged);
  return static_cast<int>(cudaGetLastError());
}

// succ: (n, p) int32; feats: (n, p, k) float32, 1 <= k <= 8; x1, x2:
// (n, p) float32; outputs sums (n, p, k), cnt, min_x1, max_x2 (n, p)
// float32 and is_start (n, p) bool; all contiguous on the current device.
// Launches one CTA per image on `stream` and returns cudaGetLastError();
// cudaErrorInvalidValue when k is out of range or an image's successors
// and flags alone exceed a block's shared memory.
int ctpn_chain_walk(const void* succ, const void* feats, const void* x1, const void* x2,
                    void* sums, void* cnt, void* min_x1, void* max_x2, void* is_start,
                    int n, int p, int k, int steps, void* stream) {
  if (k < 1 || k > kMaxK || n < 0 || p < 0 || steps < 0) return cudaErrorInvalidValue;
  if (n == 0 || p == 0) return cudaSuccess;
  int optin = 0;
  cudaError_t err =
      smem_optin(reinterpret_cast<const void*>(chain_walk_kernel), g_walk_optin, &optin);
  if (err != cudaSuccess) return err;
  const long long full = static_cast<long long>(p) * (4 * (3 + k) + 1);
  const long long lean = static_cast<long long>(p) * 5;
  const bool staged = full <= optin;
  const long long bytes = staged ? full : lean;
  if (bytes > optin) return cudaErrorInvalidValue;
  chain_walk_kernel<<<n, kThreads, static_cast<size_t>(bytes),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(succ), static_cast<const float*>(feats),
      static_cast<const float*>(x1), static_cast<const float*>(x2),
      static_cast<float*>(sums), static_cast<float*>(cnt), static_cast<float*>(min_x1),
      static_cast<float*>(max_x2), static_cast<bool*>(is_start), p, k, steps, staged);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
