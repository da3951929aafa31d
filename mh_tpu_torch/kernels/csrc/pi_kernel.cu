// Monte-Carlo pi hit count for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pi_kernel` (mh_tpu/kernels/pi_kernel.py:28):
// draw `total` points (x, y) of 23-bit uniforms in [0, 1) and count those with
// x^2 + y^2 <= 1 (f32, no contracted multiply-add: built with --fmad=false).
// The TPU kernel draws from the TPU's hardware generator; this one keys every
// coordinate by (seed, sample index, coordinate) through the counter hash of
// counter_rng.cuh -- sample s uses draw counter s >> 31 and flat indices 2s
// (x) and 2s + 1 (y), modulo 2^32 -- so `pi_hits_reference` in
// ../pi_kernel.py counts exactly the same hits.
//
// What bounds it: integer throughput. Each sample is four rounds of the
// 32-bit mix (~40 integer operations) and reads no memory. The design keeps
// every SM busy with a grid-stride loop over all samples, counts per thread
// in 64-bit integers (a count never passes through floating point, unlike
// the TPU kernel's f32 block counts), folds a block with warp shuffles and
// one shared-memory pass, and writes one int64 partial per block.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    pi_hits_kernel(unsigned long long* partial, uint32_t seed, unsigned long long total) {
  unsigned long long hits = 0;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * THREADS;
  for (unsigned long long s = static_cast<unsigned long long>(blockIdx.x) * THREADS + threadIdx.x;
       s < total; s += stride) {
    const uint32_t counter = static_cast<uint32_t>(s >> 31);
    const uint32_t flat = static_cast<uint32_t>(s << 1);
    const float x = static_cast<float>(counter_bits(seed, counter, flat)) * 1.1920928955078125e-07f;
    const float y =
        static_cast<float>(counter_bits(seed, counter, flat | 1u)) * 1.1920928955078125e-07f;
    hits += (x * x + y * y <= 1.f) ? 1ull : 0ull;
  }
  for (int o = 16; o > 0; o >>= 1) hits += __shfl_down_sync(0xffffffffu, hits, o);
  __shared__ unsigned long long warp_hits[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_hits[threadIdx.x >> 5] = hits;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long block = 0;
    for (int w = 0; w < THREADS / 32; ++w) block += warp_hits[w];
    partial[blockIdx.x] = block;
  }
}

}  // namespace

extern "C" {

// Counts the hits of samples [0, total) into partial[0 .. n_blocks) (one
// per block; their sum is the count) on `stream`. Returns the cudaError_t
// of the launch (0 on success); the kernel runs asynchronously.
int mh_pi_hits(long long* partial, int n_blocks, uint32_t seed, long long total, void* stream) {
  if (n_blocks < 1 || total < 0) return static_cast<int>(cudaErrorInvalidValue);
  pi_hits_kernel<<<n_blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<unsigned long long*>(partial), seed,
      static_cast<unsigned long long>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
