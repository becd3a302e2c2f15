// The HBM stream sum's first, two-launch design, kept as the baseline
// that tools/hbm_stream_baseline.py times beside the kernel the probe
// runs (gpu_feature_discovery_tpu_torch/ops/csrc/hbm_stream_sum.cu).
//
// Two launches: pass 1 (stream_sum_partials) has min(num_chunks, 4 x SMs)
// blocks of 256 threads take whole 512-row chunks in a grid-stride loop,
// each thread summing its 64 float4 of a chunk in f32 (__ldg, unroll 16),
// each chunk ending in a block-wide fp64 reduction with two
// __syncthreads; each block writes one fp64 partial. Pass 2
// (stream_sum_final) is one thread adding the partials in index order.
// two_pass_launch runs both, or pass 1 alone when given no output, so the
// tool can split the two.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kChunkRows = 512;
constexpr int kChunkVec4 = kLanes * kChunkRows / 4;  // 16,384 float4
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec4PerThread = kChunkVec4 / kThreads;  // 64

// fp64 sum of one value per thread; the total is valid in thread 0.
__device__ double block_sum(double v, double* warp_sums) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  }
  __syncthreads();  // warp_sums is reused by the next chunk
  return total;
}

__global__ void __launch_bounds__(kThreads)
stream_sum_partials(const float4* __restrict__ buf, long long num_chunks,
                    double* __restrict__ partials) {
  __shared__ double warp_sums[kWarps];
  double block_total = 0.0;  // meaningful in thread 0 only
  for (long long c = blockIdx.x; c < num_chunks; c += gridDim.x) {
    const float4* chunk = buf + c * kChunkVec4;
    float acc = 0.0f;
#pragma unroll 16
    for (int i = 0; i < kVec4PerThread; ++i) {
      const float4 v = __ldg(chunk + i * kThreads + threadIdx.x);
      acc += (v.x + v.y) + (v.z + v.w);
    }
    const double chunk_sum = block_sum(static_cast<double>(acc), warp_sums);
    if (threadIdx.x == 0) block_total += chunk_sum;
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = block_total;
}

__global__ void stream_sum_final(const double* __restrict__ partials,
                                 int num_partials, float* __restrict__ out) {
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int i = 0; i < num_partials; ++i) total += partials[i];
    out[0] = static_cast<float>(total);
  }
}

}  // namespace

// buf: (num_chunks * 512, 128) f32, 16-byte aligned, contiguous.
// partials: num_blocks doubles of scratch. out: one float, or null to run
// pass 1 alone (for timing the split). Launches on `stream`; returns
// cudaGetLastError() (0 = ok).
extern "C" int two_pass_launch(const void* buf, long long num_chunks,
                               void* partials, int num_blocks, void* out,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stream_sum_partials<<<num_blocks, kThreads, 0, s>>>(
      static_cast<const float4*>(buf), num_chunks,
      static_cast<double*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return static_cast<int>(err);
  stream_sum_final<<<1, 32, 0, s>>>(static_cast<const double*>(partials),
                                    num_blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
