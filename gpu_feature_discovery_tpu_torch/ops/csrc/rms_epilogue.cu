// The burn-in pass's RMS epilogue: after each product y = carry @ w (f32),
// rms = sqrt(mean(y^2) + 1e-6) and carry = bf16(y / rms); after the last
// layer also the checksum, the f32 sum of that carry.
//
// Replaces no TPU kernel: the JAX package writes this epilogue as plain
// jnp (gpu_feature_discovery_tpu/ops/healthcheck.py burnin_step) and leaves
// it to XLA's fusion. Plain PyTorch runs it as six passes over device
// memory per layer (square, mean, add, sqrt, divide, cast) and two more
// for the checksum (widen, sum): about 510 MB a pass at the probe's
// 2048 x 2048 geometry, which took 1.6 times the products' time.
//
// What bounds it on an H100 SXM: bytes. Per layer the work needs one read
// of y (16.8 MB f32) for the sum of squares, a second read of y for the
// scale, and one bf16 write of the carry (8.4 MB): at most 42 MB, or
// 12.5 us at 3.35 TB/s, and less where the second read hits the 50 MB L2,
// which still holds the y the product just wrote.
//
// Design: two launches per layer, nothing else.
//   * rms_sumsq: a persistent grid (the wrapper, ops/rms_epilogue.py, sizes
//     it from the SM count and the element count). Every thread walks its
//     vectors of 8 floats (two 16-byte loads) in a grid-stride loop,
//     kUnroll vectors in flight at once, squares and adds each vector in
//     f32 and carries the sum in f64. Each block writes one f64 partial and
//     takes a ticket on a counter; the block that draws the last ticket
//     adds the partials in block order through a fixed tree, writes
//     rms = sqrtf(sum / n + 1e-6f) to a 0-d f32 and sets the counter back
//     to 0 for the next launch on the same stream (the wrapper keeps one
//     counter per device and stream). No float atomics: the result is the
//     same to the bit in every launch on one grid.
//   * rms_scale_cast: the same grid reads y again (mostly from L2) and the
//     device rms, and writes carry = __float2bfloat16_rn(y / rms), one
//     16-byte store per vector. The division is IEEE (__fdiv_rn; never a
//     reciprocal multiply, never fast math), so each element is computed
//     as PyTorch computes it; only the order of the sum of squares
//     differs. On the last layer the same kernel also sums the bf16 values
//     widened to f32, with the same last-block scheme, and writes the
//     checksum: the widen-and-sum passes go away.
//   * n % 8 trailing elements are taken one per thread by block 0.
//   * A NaN or Inf anywhere in y reaches rms (plain adds, no fmaxf) and so
//     every carry element and the checksum: the probe's verdict is "all
//     outputs finite".

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;
constexpr int kWarps = kThreads / 32;
constexpr int kVector = 8;  // floats per vector: 32 B of y in, 16 B of carry out
constexpr int kUnroll = 4;  // vectors a thread has in flight
constexpr float kEps = 1e-6f;

struct Vec8 {
  float4 lo, hi;
};

__device__ __forceinline__ Vec8 load_vector(const float* __restrict__ y,
                                            long long v) {
  const float4* p = reinterpret_cast<const float4*>(y) + 2 * v;
  return {p[0], p[1]};
}

// The last read of y: evict first, so the carry stays in L2 for the next
// product.
__device__ __forceinline__ Vec8 load_vector_last(const float* __restrict__ y,
                                                 long long v) {
  const float4* p = reinterpret_cast<const float4*>(y) + 2 * v;
  return {__ldcs(p), __ldcs(p + 1)};
}

__device__ __forceinline__ float sum_of_squares(const Vec8& v) {
  const float a = __fmul_rn(v.lo.x, v.lo.x) + __fmul_rn(v.lo.y, v.lo.y);
  const float b = __fmul_rn(v.lo.z, v.lo.z) + __fmul_rn(v.lo.w, v.lo.w);
  const float c = __fmul_rn(v.hi.x, v.hi.x) + __fmul_rn(v.hi.y, v.hi.y);
  const float d = __fmul_rn(v.hi.z, v.hi.z) + __fmul_rn(v.hi.w, v.hi.w);
  return (a + b) + (c + d);
}

__device__ __forceinline__ __nv_bfloat162 scale_pair(float a, float b,
                                                     float rms) {
  return __floats2bfloat162_rn(__fdiv_rn(a, rms), __fdiv_rn(b, rms));
}

__device__ __forceinline__ float widened_sum(__nv_bfloat162 p) {
  return __low2float(p) + __high2float(p);
}

// f64 sum over the block in a fixed tree; valid in thread 0.
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
  __syncthreads();  // warp_sums may be written again after this
  return total;
}

// Every block's sum of `v` into one total, in the block that draws the
// last ticket: returns true there, with the total in thread 0's `*total`,
// and sets the counter back to 0. Every other block returns false.
__device__ bool grid_sum(double v, double* __restrict__ partials,
                         unsigned int* __restrict__ counter, double* total) {
  __shared__ double warp_sums[kWarps];
  __shared__ bool is_last;
  const double block_total = block_sum(v, warp_sums);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = block_total;
    __threadfence();  // the partial is visible before the ticket is
    is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  double p = 0.0;
  for (int k = threadIdx.x; k < static_cast<int>(gridDim.x); k += kThreads) {
    p += __ldcg(partials + k);
  }
  *total = block_sum(p, warp_sums);
  if (threadIdx.x == 0) *counter = 0u;  // ready for the next launch
  return true;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
rms_sumsq(const float* __restrict__ y, long long n,
          double* __restrict__ partials, unsigned int* __restrict__ counter,
          float* __restrict__ rms) {
  const long long vectors = n / kVector;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  double acc = 0.0;
  for (long long first = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
       first < vectors; first += stride * kUnroll) {
    Vec8 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (first + u * stride < vectors) v[u] = load_vector(y, first + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (first + u * stride < vectors) acc += sum_of_squares(v[u]);
    }
  }
  const long long tail = vectors * kVector;
  if (blockIdx.x == 0 && threadIdx.x < n - tail) {
    const float t = y[tail + threadIdx.x];
    acc += __fmul_rn(t, t);
  }
  double total = 0.0;
  if (grid_sum(acc, partials, counter, &total) && threadIdx.x == 0) {
    const float mean = static_cast<float>(total / static_cast<double>(n));
    rms[0] = sqrtf(mean + kEps);
  }
}

template <bool kChecksum>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
rms_scale_cast(const float* __restrict__ y, long long n,
               const float* __restrict__ rms, __nv_bfloat16* __restrict__ carry,
               double* __restrict__ partials,
               unsigned int* __restrict__ counter,
               float* __restrict__ checksum) {
  const float r = __ldg(rms);
  const long long vectors = n / kVector;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  uint4* out = reinterpret_cast<uint4*>(carry);
  double acc = 0.0;
  for (long long first = static_cast<long long>(blockIdx.x) * kThreads +
                         threadIdx.x;
       first < vectors; first += stride * kUnroll) {
    Vec8 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (first + u * stride < vectors) {
        v[u] = load_vector_last(y, first + u * stride);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (first + u * stride < vectors) {
        const __nv_bfloat162 p0 = scale_pair(v[u].lo.x, v[u].lo.y, r);
        const __nv_bfloat162 p1 = scale_pair(v[u].lo.z, v[u].lo.w, r);
        const __nv_bfloat162 p2 = scale_pair(v[u].hi.x, v[u].hi.y, r);
        const __nv_bfloat162 p3 = scale_pair(v[u].hi.z, v[u].hi.w, r);
        uint4 packed;
        packed.x = *reinterpret_cast<const uint32_t*>(&p0);
        packed.y = *reinterpret_cast<const uint32_t*>(&p1);
        packed.z = *reinterpret_cast<const uint32_t*>(&p2);
        packed.w = *reinterpret_cast<const uint32_t*>(&p3);
        out[first + u * stride] = packed;
        if (kChecksum) {
          acc += (widened_sum(p0) + widened_sum(p1)) +
                 (widened_sum(p2) + widened_sum(p3));
        }
      }
    }
  }
  const long long tail = vectors * kVector;
  if (blockIdx.x == 0 && threadIdx.x < n - tail) {
    const __nv_bfloat16 c = __float2bfloat16_rn(__fdiv_rn(y[tail + threadIdx.x], r));
    carry[tail + threadIdx.x] = c;
    if (kChecksum) acc += __bfloat162float(c);
  }
  if (!kChecksum) return;
  double total = 0.0;
  if (grid_sum(acc, partials, counter, &total) && threadIdx.x == 0) {
    checksum[0] = static_cast<float>(total);
  }
}

}  // namespace

// The wrapper's grid arithmetic must agree with these.
extern "C" int rms_epilogue_block_threads() { return kThreads; }
extern "C" int rms_epilogue_vector_floats() { return kVector; }
extern "C" int rms_epilogue_blocks_per_sm() { return kBlocksPerSm; }

// y: n f32, contiguous, 16-byte aligned. num_blocks: the grid of both
// kernels. partials: num_blocks doubles of scratch. counter: one unsigned
// int, 0 before the launch and 0 after it. rms: one float (written).
// carry: n bf16, 16-byte aligned (written). checksum: one float, or null
// when this layer is not the last. Launches both kernels on `stream`, in
// order; returns the first launch error as a cudaError_t (0 = ok).
extern "C" int rms_epilogue_launch(const void* y, long long n, int num_blocks,
                                   void* partials, void* counter, void* rms,
                                   void* carry, void* checksum, void* stream) {
  if (n <= 0 || num_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  double* part = static_cast<double*>(partials);
  unsigned int* ticket = static_cast<unsigned int*>(counter);
  float* r = static_cast<float*>(rms);
  __nv_bfloat16* c = static_cast<__nv_bfloat16*>(carry);
  rms_sumsq<<<num_blocks, kThreads, 0, s>>>(yf, n, part, ticket, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (checksum != nullptr) {
    rms_scale_cast<true><<<num_blocks, kThreads, 0, s>>>(
        yf, n, r, c, part, ticket, static_cast<float*>(checksum));
  } else {
    rms_scale_cast<false><<<num_blocks, kThreads, 0, s>>>(
        yf, n, r, c, part, ticket, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
