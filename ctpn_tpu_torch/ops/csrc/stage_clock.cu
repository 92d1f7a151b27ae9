// The stage clock's stamp: the card's %globaltimer (ns) into a ring of rows,
// one row per run of a program (utils/timer.py::StageClock).
//
// The ring is `rows * slots` int64 stamps followed by the row counter, the
// number of runs stamped in full. A stamp writes slot `slot` of row
// `counter % rows`; the last slot then advances the counter. One thread does
// it all: the stamp orders after the work queued before it on the stream and
// before the work queued after it, in an eager run as in a captured graph's
// replay, so the stamps of one row bound the program's stages on the card.
// Successive stamps of a run are separate launches on one stream, so each
// reads the counter the one before it wrote.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stage_stamp_kernel(long long* ring, int rows, int slots, int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long* counter = ring + static_cast<long long>(rows) * slots;
  const long long done = *counter;
  const long long row = done % rows;
  ring[row * slots + slot] = static_cast<long long>(now);
  if (slot == slots - 1) *counter = done + 1;
}

}  // namespace

extern "C" {

// Launches one thread on `stream`. Returns cudaGetLastError() so that the
// caller sees a refused launch.
int ctpn_stage_stamp(void* ring, int rows, int slots, int slot, void* stream) {
  stage_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), rows, slots, slot);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
