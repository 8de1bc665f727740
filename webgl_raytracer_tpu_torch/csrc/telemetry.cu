// The recorder's device clock (utils/telemetry.py): one thread writes the
// GPU's global nanosecond timer into out[0].
//
// The recorder launches it at each boundary of a frame's device spans, on
// the frame's stream, so a captured frame replays it as a kernel node: it
// runs when the work before it on the stream has finished, and the work
// after it starts once it has. A stamp costs about a small kernel's slot
// in the graph; a timing event's record node measured about three times
// that, and reading an event pair costs the host a call each.
#include <cuda_runtime.h>

namespace {

__global__ void clock_mark(unsigned long long* out) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  out[0] = t;
}

}  // namespace

extern "C" int wrt_clock_mark(unsigned long long* out, void* stream) {
  clock_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}
