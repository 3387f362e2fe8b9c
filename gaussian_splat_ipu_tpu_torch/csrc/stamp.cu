// Span stamp: one thread appends (tag, %globaltimer) to a device-resident
// log.
//
// Replaces no TPU kernel: the JAX package names its ranges with
// jax.named_scope, which XLA's profiler reads. A CUDA graph replays kernel
// nodes and nothing else, so a range that must be timed on every replay of
// a captured frame or step is a kernel node: this one, launched by
// utils/profiling.py at a span's entry and exit. (A CUDA event captured in
// a graph is re-recorded by every replay, so with two replays in flight
// the next one overwrites it before it can be read.) Plain version:
// gaussian_splat_ipu_tpu_torch/utils/profiling.py::stamp_torch.
//
// Each stamp takes its slot with atomicAdd on the log's cursor (state[0]),
// so stamps from any stream land in the order they ran. The log has a
// fixed capacity: a stamp past it only counts itself in state[1] and never
// wraps over an entry not yet read. Bound on the H100: launch latency (a
// few microseconds a launch, about one inside a graph); one 16-byte store.
// anchor_kernel reads the same clock for utils/profiling.py's anchors.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* __restrict__ log,
                             unsigned long long* __restrict__ state,
                             long long capacity, long long tag) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long slot = atomicAdd(state, 1ULL);
  if (slot < (unsigned long long)capacity) {
    log[2 * slot] = tag;
    log[2 * slot + 1] = (long long)now;
  } else {
    atomicAdd(state + 1, 1ULL);
  }
}

// The anchor's handshake: the kernel raises words[1] when it runs, spins
// until the host raises words[0], then writes its clock to words[2]. The
// host reads its own clock just before it raises words[0] and just after
// it sees words[2]: a bracket of two trips over PCIe, about 2 us, instead
// of a launch and a synchronisation. words lie in page-locked host memory,
// which a kernel reads and writes directly (unified addressing). A host
// that does not answer within timeout_ns leaves words[3] = 1.
__global__ void anchor_kernel(volatile long long* words,
                              long long timeout_ns) {
  unsigned long long t0, now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  words[1] = 1;
  __threadfence_system();
  now = t0;
  while (words[0] == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (now - t0 > (unsigned long long)timeout_ns) {
      words[3] = 1;
      break;
    }
  }
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  words[2] = (long long)now;
  __threadfence_system();
}

}  // namespace

extern "C" int gsplat_anchor(long long* words, long long timeout_ns,
                             void* stream) {
  anchor_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(words, timeout_ns);
  return (int)cudaGetLastError();
}

extern "C" int gsplat_stamp(long long* log, unsigned long long* state,
                            long long capacity, long long tag,
                            void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(log, state, capacity, tag);
  return (int)cudaGetLastError();
}
