// The text-line connector's chain walk (sm_90a): from every proposal, its
// successor path, with the features summed in path order, the nodes
// counted, the least x1 and largest x2 taken, and whether it starts a chain.
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
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxK = 8;  // the wrapper's MAX_K
constexpr int kMaxDevices = 64;

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

// the block's shared-memory limit on each device, 0 until first asked
int g_smem_optin[kMaxDevices];

}  // namespace

extern "C" {

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
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int optin = g_smem_optin[dev];
  if (optin == 0) {  // once per device, in the first (eager) call
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(chain_walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    g_smem_optin[dev] = optin;
  }
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
