// The timing gate of the multi-card all-reduce probe: one thread per card
// that holds the card's stream until the host has queued every timed call.
//
// Replaces no TPU kernel: the JAX package times its psum as one compiled
// program and needs no gate. Here each timed call is a launch per card,
// and an event pair around one of them would also time the host queueing
// the other cards' launches. So ops/device_timing.py:gated_windows queues,
// on every card's current stream, this kernel, then the timed calls with
// their events, and opens the gate from the host once the last of them is
// queued.
//
// What bounds it: nothing of the card. Its whole time is the wait for the
// host, which is the point; what it must not do is wait longer. A spin of
// fixed length (torch.cuda._sleep, before) had to outlast the slowest
// queueing it expected; this gate returns as soon as the host has opened
// it.
//
// Design:
//   * One thread, <<<1, 1>>>: it takes one SM slot while it waits, and
//     nothing else is on the card's stream behind it until it returns.
//   * The host word is a 32-bit epoch in pinned host memory, allocated
//     portable and mapped (timing_gate_alloc), so every card reads the same
//     word over PCIe. The thread polls it with a system-scope acquire load
//     and sleeps kPollNs between polls (__nanosleep), so the reads stay a
//     few hundred a millisecond. It returns once the word has reached this
//     gate's epoch: (int)(word - epoch) >= 0, which holds across the
//     counter's wrap as long as word and epoch are within 2^31 of each
//     other (the host's epochs go up by one a gate).
//   * A watchdog on %globaltimer, as hbm_stream_sum.cu's stall trap has:
//     past timeout_ns of its own time the thread returns anyway, so a host
//     that never opens the gate (a raised call, a lost process) costs each
//     card at most that long. The caller passes 1 ms, the length of the
//     capped spin it replaces.
//   * Before it returns, the thread writes kReleased or kTimedOut to its
//     card's outcome word, also in the pinned host block; the host reads it
//     after the event recorded behind the gate has completed.
//   * The kernel is named spin_kernel, in this port's namespace: a device
//     trace files the gate's card time under that name (the benchmark's
//     gate_spin_ms reads every spin_kernel).

#include <cuda_runtime.h>

#include <cstdint>

namespace tfd_torch {

constexpr unsigned int kReleased = 1;
constexpr unsigned int kTimedOut = 2;
constexpr unsigned int kPollNs = 500;

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned int load_acquire_sys(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.sys.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed_sys(unsigned int* p, unsigned int v) {
  asm volatile("st.relaxed.sys.u32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

__global__ void spin_kernel(const unsigned int* word, unsigned int epoch,
                            unsigned int* outcome,
                            unsigned long long timeout_ns) {
  const uint64_t t0 = global_ns();
  unsigned int state = kTimedOut;
  for (;;) {
    if (static_cast<int>(load_acquire_sys(word) - epoch) >= 0) {
      state = kReleased;
      break;
    }
    if (global_ns() - t0 >= timeout_ns) break;
    __nanosleep(kPollNs);
  }
  store_relaxed_sys(outcome, state);
}

}  // namespace tfd_torch

// The outcome codes; the wrapper checks them against its own.
extern "C" int timing_gate_released() { return tfd_torch::kReleased; }
extern "C" int timing_gate_timed_out() { return tfd_torch::kTimedOut; }

// `words` zeroed 32-bit words of pinned host memory, portable (every
// card's context) and mapped (every card reads it at the same address,
// under unified addressing). Returns nullptr where cudaHostAlloc fails.
extern "C" void* timing_gate_alloc(int words) {
  void* p = nullptr;
  const size_t bytes = static_cast<size_t>(words) * sizeof(unsigned int);
  if (cudaHostAlloc(&p, bytes, cudaHostAllocPortable | cudaHostAllocMapped) !=
      cudaSuccess) {
    return nullptr;
  }
  for (size_t i = 0; i < static_cast<size_t>(words); ++i) {
    static_cast<unsigned int*>(p)[i] = 0;
  }
  return p;
}

// Open every gate of `epoch` and before: a release store of the host word,
// so whatever the host wrote before it is seen by a card that sees it.
extern "C" void timing_gate_open(void* word, unsigned int epoch) {
  __atomic_store_n(static_cast<unsigned int*>(word), epoch, __ATOMIC_RELEASE);
}

// One gate on `stream` of the current device: waits until `word` reaches
// `epoch`, or timeout_ns of its own time, and writes the outcome to
// `outcome`. Returns the launch's cudaError_t (0 = ok).
extern "C" int timing_gate_launch(const void* word, unsigned int epoch,
                                  void* outcome, unsigned long long timeout_ns,
                                  void* stream) {
  tfd_torch::spin_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned int*>(word), epoch,
      static_cast<unsigned int*>(outcome), timeout_ns);
  return static_cast<int>(cudaGetLastError());
}
