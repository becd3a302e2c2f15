// HBM read-bandwidth probe: the sum of a (rows, 128) f32 buffer.
//
// Replaces the TPU kernel gpu_feature_discovery_tpu/ops/hbm.py:_bandwidth_kernel
// (a Pallas kernel streaming 512-row chunks HBM->VMEM through a 4-slot
// async-copy ring, 3 copies in flight, into one SMEM scalar). The reduction
// consumes every byte of the buffer, so no load can be elided, and the
// result is a checksum the caller compares with the exact expected sum.
//
// What bounds it on an H100 SXM: bytes. Every byte is read once and the
// arithmetic is one add per float, so the floor is the buffer over the HBM
// rate: 268,435,456 B / 3.35 TB/s = about 80 us at the probe's 256 MiB.
// Reaching it takes enough bytes in flight on every SM, all the time, and
// no pause of the stream anywhere.
//
// Design: the counterpart of the Pallas DMA ring, one launch.
//   * Persistent grid: one block per SM (the wrapper, ops/hbm.py, sizes the
//     grid from the SM count). The buffer is cut into 32 KiB tiles of 64
//     rows, eight to a 512-row chunk; block b owns the contiguous range of
//     tiles [b * base + min(b, extra), + base + (b < extra)), so the blocks'
//     loads differ by at most one tile. ops/hbm.py:tile_ranges computes the
//     same partition, which the CPU tests hold.
//   * Copies: one producer thread issues 1-D TMA bulk copies
//     (cp.async.bulk ... mbarrier::complete_tx::bytes) of one tile each into
//     a kStages-deep ring of shared memory (dynamic, 128 KiB). Each stage
//     has a "full" mbarrier (the copy's bytes arrived) and an "empty" one
//     (every consumer thread has read it). No register holds a byte in
//     flight and no thread computes an address but the producer.
//   * Consumers: 8 warps wait for a stage to fill, add their 8 float4 of
//     the tile in fp32 per thread, promote that tile sum to fp64, and
//     release the stage. There is no block-wide barrier in the stream: a
//     stage is refilled as soon as its last reader arrived.
//   * One launch: each block writes one fp64 partial, fences, and takes a
//     ticket on a counter. The block that draws the last ticket adds all
//     the partials in index order through a fixed tree, writes the (1, 1)
//     f32 result and sets the counter back to 0 for the next launch on the
//     same stream (the wrapper keeps one counter per device and stream, so
//     two launches that share a counter are ordered by their stream). No
//     memset launch, no second kernel.
//   * A stalled ring (a wrong phase parity would wait forever) traps after
//     kStallNs, 30 s on %globaltimer, instead of hanging the card; the
//     launch then fails. The timer runs on while the context is off the
//     card (time-slicing, compute preemption), so the limit sits far above
//     any time slice: a healthy ring finishes its tiles in well under a
//     millisecond of its own time, and a slice is milliseconds long.
//
// Why the checksum is exact (the argument of ops/hbm.py's pattern, carried
// to this reduction order): stream_pattern fills chunk c with 1 + c % 7,
// and a tile lies inside one chunk. A thread's fp32 tile sum is at most
// 8 * 4 * 7 = 224, a small integer, so it is exact; every fp64 sum after it
// (per thread, per warp, per block, across blocks) adds integers far below
// 2^53, and the total m * 2^16 with m <= 7 * num_chunks is exact in the
// final f32 too. So the result equals expected_stream_sum(rows) whatever
// the order. On any other buffer the order is still fixed: each thread
// reads the same elements in the same order, every tree is fixed and the
// partition depends only on the grid, so two launches on one device give
// the same bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kStageRows = 64;
constexpr int kStageBytes = kStageRows * kLanes * 4;  // 32 KiB
constexpr int kStageVec4 = kStageBytes / 16;          // 2,048 float4
constexpr int kStages = 4;
constexpr int kRingBytes = kStages * kStageBytes;     // 128 KiB
constexpr int kConsumerWarps = 8;
constexpr int kConsumerThreads = kConsumerWarps * 32;
constexpr int kThreads = kConsumerThreads + 32;       // + the producer warp
constexpr int kVec4PerThread = kStageVec4 / kConsumerThreads;  // 8
constexpr uint64_t kStallNs = 30000000000ull;  // 30 s
constexpr int kMaxDevices = 64;

static_assert(kStageVec4 % kConsumerThreads == 0, "a tile splits evenly");
static_assert(kStageBytes % 16 == 0, "bulk copies move multiples of 16 B");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  for (uint32_t tries = 1;; ++tries) {
    if (mbar_try_wait(bar, parity)) return;
    if ((tries & 1023u) == 0 && global_ns() - t0 > kStallNs) __trap();
  }
}

// One TMA bulk copy global -> shared; its bytes complete on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Barrier over the consumer warps only (the producer warp may have left).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// fp64 sum over the consumer threads in a fixed tree; valid in thread 0.
__device__ double consumer_sum(double v, double* warp_sums) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  consumer_sync();
  double total = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kConsumerWarps; ++w) total += warp_sums[w];
  }
  consumer_sync();  // warp_sums may be written again after this
  return total;
}

__global__ void __launch_bounds__(kThreads, 1)
stream_sum(const uint8_t* __restrict__ buf, long long tiles_base,
           int tiles_extra, double* __restrict__ partials,
           unsigned int* __restrict__ counter, float* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ double warp_sums[kConsumerWarps];
  __shared__ bool is_last;

  const int b = blockIdx.x;
  const long long first =
      b * tiles_base + (b < tiles_extra ? b : tiles_extra);
  const long long count = tiles_base + (b < tiles_extra ? 1 : 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                  // the producer's expect_tx
      mbar_init(&empty[s], kConsumerThreads);  // every reader
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  if (warp == kConsumerWarps) {
    // Producer: one thread keeps the ring full.
    if ((threadIdx.x & 31) == 0) {
      for (long long i = 0; i < count; ++i) {
        const int stage = static_cast<int>(i % kStages);
        const uint32_t parity = static_cast<uint32_t>((i / kStages) & 1) ^ 1u;
        mbar_wait(&empty[stage], parity);
        mbar_arrive_expect_tx(&full[stage], kStageBytes);
        bulk_copy_g2s(ring + stage * kStageBytes,
                      buf + (first + i) * kStageBytes,
                      kStageBytes, &full[stage]);
      }
    }
    return;
  }

  // Consumers: fp32 per thread within a tile, fp64 across tiles.
  const float4* tiles = reinterpret_cast<const float4*>(ring);
  double total = 0.0;
  for (long long i = 0; i < count; ++i) {
    const int stage = static_cast<int>(i % kStages);
    const uint32_t parity = static_cast<uint32_t>((i / kStages) & 1);
    mbar_wait(&full[stage], parity);
    const float4* tile = tiles + stage * kStageVec4;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kVec4PerThread; ++j) {
      const float4 v = tile[j * kConsumerThreads + threadIdx.x];
      acc += (v.x + v.y) + (v.z + v.w);
    }
    total += static_cast<double>(acc);
    mbar_arrive(&empty[stage]);
  }

  const double block_total = consumer_sum(total, warp_sums);
  if (threadIdx.x == 0) {
    partials[b] = block_total;
    __threadfence();  // the partial is visible before the ticket is
    is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  consumer_sync();
  if (!is_last) return;

  // The last block: every partial is written; add them in index order.
  __threadfence();
  double v = 0.0;
  for (int k = threadIdx.x; k < static_cast<int>(gridDim.x);
       k += kConsumerThreads) {
    v += __ldcg(partials + k);
  }
  const double sum = consumer_sum(v, warp_sums);
  if (threadIdx.x == 0) {
    out[0] = static_cast<float>(sum);
    *counter = 0u;  // ready for the next launch on this stream
  }
}

bool g_configured[kMaxDevices];

}  // namespace

// Tile size in bytes; the wrapper checks it against its own partition.
extern "C" int hbm_stream_sum_stage_bytes() { return kStageBytes; }

// buf: (rows, 128) f32, 16-byte aligned, contiguous, rows a multiple of 64.
// Block b of num_blocks sums tiles [b * tiles_base + min(b, tiles_extra),
// + tiles_base + (b < tiles_extra)). partials: num_blocks doubles of
// scratch. counter: one unsigned int, 0 before the launch and 0 after it.
// out: one float. Launches on `stream`; returns the launch's cudaError_t
// (0 = ok).
extern "C" int hbm_stream_sum_launch(const void* buf, long long tiles_base,
                                     int tiles_extra, int num_blocks,
                                     void* partials, void* counter, void* out,
                                     void* stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!g_configured[device]) {
    // Above 48 KB a block's shared memory must be asked for, per device.
    err = cudaFuncSetAttribute(stream_sum,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRingBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_configured[device] = true;
  }
  stream_sum<<<num_blocks, kThreads, kRingBytes,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), tiles_base, tiles_extra,
      static_cast<double*>(partials), static_cast<unsigned int*>(counter),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
