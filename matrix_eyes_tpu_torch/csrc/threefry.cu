// Stereogram noise for Hopper (sm_90a): jax.random.randint(key, shape, 0,
// 256, uint8) bit for bit, as JAX's partitionable threefry computes it.
//
// Replaces the noise that XLA draws inside the JAX package's stereogram
// programs (matrix_eyes_tpu/ops/stereogram.py: _synthesize, and the
// stereogram_noise program that draws the noise ahead of the render); not a
// TPU kernel.
// For the flat row-major index i of the output:
//
//   (s0, s1) = threefry2x32(key, (0, 1))              // word pair 1 of split(key)
//   (b1, b2) = threefry2x32((s0, s1), (i >> 32, i & 0xffffffff))
//   out[i]   = (b1 ^ b2) & 0xff
//
// threefry2x32 is Threefry-2x32 with 20 rounds (rotations 13, 15, 26, 6 and
// 17, 29, 16, 24, a key injection after every four), each rotation one
// __funnelshift_l.
//
// What bounds it on this card: integer operations. An element is one
// 20-round hash, ~73 32-bit operations for one byte written (chip_smoke.py
// phase 2 counts the SASS nvcc makes of it), so the integer pipes take an
// order of magnitude longer than the bytes. Nothing is shared between
// elements: a thread hashes PER_THREAD consecutive counters and
// writes them as one 16-byte store (the output is 16-byte aligned, so every
// full thread's store is), the last thread byte by byte up to the end. The
// key is read from device memory, never passed by value, so that a CUDA
// graph that captured the launch draws the noise of whatever key its input
// holds at replay; each thread splits it itself (one hash more per 16).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int PER_THREAD = 16;  // bytes a thread writes: one uint4

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, R0); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R1); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R2); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R3); x1 ^= x0;
}

// (x0, x1) <- threefry2x32((k0, k1), (x0, x1))
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
}

__global__ void __launch_bounds__(BLOCK)
randint_u8_kernel(const int64_t* __restrict__ key, uint8_t* __restrict__ out, long long n) {
  const long long i0 = ((long long)blockIdx.x * BLOCK + threadIdx.x) * PER_THREAD;
  if (i0 >= n) return;
  uint32_t s0 = 0u, s1 = 1u;
  threefry2x32((uint32_t)__ldg(key), (uint32_t)__ldg(key + 1), s0, s1);
  uint32_t w[PER_THREAD / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const unsigned long long i = (unsigned long long)(i0 + j);
    uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
    threefry2x32(s0, s1, x0, x1);
    w[j >> 2] |= ((x0 ^ x1) & 0xffu) << (8 * (j & 3));
  }
  if (i0 + PER_THREAD <= n) {
    *reinterpret_cast<uint4*>(out + i0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    // unrolled, so that w stays in registers (a loop to n - i0 indexes it
    // at run time and puts it on the stack)
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (j < n - i0) out[i0 + j] = (uint8_t)(w[j >> 2] >> (8 * (j & 3)));
  }
}

}  // namespace

// key: (2,) int64 on the device, the words of jax.random.PRNGKey(seed);
// out: n bytes, 16-byte aligned. Returns cudaGetLastError() after the
// launch, or a negative code for arguments the kernel does not take.
extern "C" int me_threefry_randint_u8(const void* key, void* out, long long n, void* stream) {
  if (n < 1) return -2;
  if ((reinterpret_cast<uintptr_t>(out) & 15) != 0) return -3;
  const long long threads = (n + PER_THREAD - 1) / PER_THREAD;
  const long long blocks = (threads + BLOCK - 1) / BLOCK;
  if (blocks > 0x7fffffffLL) return -4;
  randint_u8_kernel<<<(unsigned)blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(key), static_cast<uint8_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
