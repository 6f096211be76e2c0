// Stereogram pixel-linking scan for Hopper (sm_90a).
//
// Replaces the TPU kernel matrix_eyes_tpu/ops/stereogram_kernel.py:
// linker_scan_tpu (_linker_kernel). Per row, for 0 <= shift < win <= pw:
//
//   out[x] = noise[x]                   for x < pw
//   out[x] = out[x - pw + shift[x]]     for x >= pw
//
// RGB u8 out, bit-exact: every pixel is a copy of a seed pixel.
//
// What bounds it on this card: device-memory bytes are small (4 B of shift
// read and 3 B of pixels written per pixel, 84 MB at 3024 x 4032), so the
// bound is the loop-carried dependency along x. The TPU kernel hid it by
// putting 128 rows on the vector lanes and resolving each parent with a
// mask-and-sum over the (win, 128) window, because gathers were slow there.
// Neither trick is needed here: a thread reads its parent directly.
//
// Design: one block per row. Column x reads a parent in
// [x - pw, x - pw + win - 1] = [x - pw, x - L] with L = pw - win + 1, so
// columns fewer than L apart are independent: a block resolves
// step = min(L, BLOCK) columns at once, one per thread, with one barrier per
// step (14 steps at 4032 columns and amplitude 1/16). Every step works in
// shared memory, so no device-memory latency sits on the loop-carried path:
// the row is staged a chunk of up to CHUNK columns at a time, its shifts
// copied in by 16-byte cp.async (all in flight at once, while the noise
// pixels are read) before the walk and its RGB bytes written
// out with 16-byte stores after it (both sides of each copy on the same
// 16-byte phase, the ragged ends by the word or byte). The row's state is a
// ring of R packed pixels (r | g << 8 | b << 16, as the TPU kernel packs
// them), R the power of two at or above pw + BLOCK, column c in slot
// c & (R - 1): a step reads columns [x0 - pw, x0 - 1] and writes
// [x0, x0 + step), which never share a slot because R >= pw + step. The
// ring lives in shared memory beside the staging buffers whenever it fits
// (pw up to ~32K: 4 KB at the defaults, 128 KB at the 30000-column,
// amplitude 0.45 shape); past that it lives in a global scratch buffer, one
// per row, that the wrapper allocates (me_linker_scan_scratch_words), so
// any width runs. A shift outside [0, win) gives a black pixel, as the TPU
// kernel's empty window match does.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int CHUNK = 4096;          // columns staged in shared memory at a time
constexpr int MAX_SMEM = 232448;     // 227 KB per block

int ring_words(int pw) {
  int r = 1;
  while (r < pw + BLOCK) r <<= 1;
  return r;
}

int chunk_cols(int W) { return W < CHUNK ? W : CHUNK; }

// Staging of one chunk: its shifts (a word of lead for the 16-byte phase
// of each copy, up to 3) and its RGB bytes (up to 15 bytes of lead).
__host__ __device__ int shift_words(int chunk) { return (chunk + 3 + 3) & ~3; }
__host__ __device__ int out_bytes(int chunk) { return (3 * chunk + 15 + 15) & ~15; }
int staging_bytes(int W) { return 4 * shift_words(chunk_cols(W)) + out_bytes(chunk_cols(W)); }

bool ring_in_smem(int W, int pw) {
  return (long long)staging_bytes(W) + 4LL * ring_words(pw) <= MAX_SMEM;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts copying n words from src (4-byte aligned) to shared dst + lead,
// lead = the word phase of src inside 16 bytes, so that the middle goes by
// 16-byte copies on both sides; dst is 16-byte aligned. The copies run
// asynchronously (every one in flight at once) until cp_async_wait_all.
// Returns lead.
__device__ __forceinline__ int start_load_words(uint32_t* dst, const int32_t* src, int n) {
  const int lead = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min(n, (4 - lead) & 3);
  const int nv = (n - head) >> 2;
  for (int i = threadIdx.x; i < nv; i += BLOCK)
    cp_async16(dst + lead + head + 4 * i, src + head + 4 * i);
  for (int i = threadIdx.x; i < head; i += BLOCK) cp_async4(dst + lead + i, src + i);
  for (int i = head + 4 * nv + threadIdx.x; i < n; i += BLOCK) cp_async4(dst + lead + i, src + i);
  return lead;
}

// Copies n bytes from shared src to global dst, both on the same 16-byte
// phase: bytes up to dst's first 16-byte boundary, 16-byte vectors, bytes.
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint8_t* src, int n) {
  const int head = min(n, (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15));
  const int nv = (n - head) >> 4;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  for (int i = threadIdx.x; i < nv; i += BLOCK) d4[i] = s4[i];
  for (int i = threadIdx.x; i < head; i += BLOCK) dst[i] = src[i];
  for (int i = head + 16 * nv + threadIdx.x; i < n; i += BLOCK) dst[i] = src[i];
}

__device__ __forceinline__ void put_rgb(uint8_t* p, uint32_t v) {
  p[0] = v & 0xffu;
  p[1] = (v >> 8) & 0xffu;
  p[2] = (v >> 16) & 0xffu;
}

// ring_global: the rings in device memory (one of R words per row), or null
// when the ring is in shared memory (or there is nothing to scan).
__global__ void __launch_bounds__(BLOCK)
linker_scan_kernel(const int32_t* __restrict__ shift, const uint8_t* __restrict__ noise,
                   uint8_t* __restrict__ out, uint32_t* __restrict__ ring_global, int W,
                   int noise_w, int pw, int win, int R, int chunk) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int y = blockIdx.x;
  const bool scan = pw < W;  // otherwise every column is a noise pixel
  uint32_t* sh = reinterpret_cast<uint32_t*>(smem);
  uint8_t* ob = smem + 4 * shift_words(chunk);
  uint32_t* ring = ring_global != nullptr
                       ? ring_global + (size_t)y * R
                       : reinterpret_cast<uint32_t*>(ob + out_bytes(chunk));
  const uint32_t mask = R - 1;
  const int32_t* srow = shift + (size_t)y * W;
  const uint8_t* nrow = noise + (size_t)y * noise_w * 3;
  uint8_t* orow = out + (size_t)y * W * 3;
  const int step = min(pw - win + 1, BLOCK);

  for (int c0 = 0; c0 < W; c0 += chunk) {
    const int c1 = min(W, c0 + chunk);
    const int s0 = max(c0, pw);  // first scanned column of the chunk
    const int slead = s0 < c1 ? start_load_words(sh, srow + s0, c1 - s0) : 0;
    uint8_t* oc = ob + (int)(reinterpret_cast<uintptr_t>(orow + 3 * c0) & 15);
    // the noise pixels, while the shifts land
#pragma unroll 4
    for (int x = c0 + threadIdx.x; x < min(c1, pw); x += BLOCK) {
      const uint32_t v =
          __ldg(nrow + 3 * x) | (__ldg(nrow + 3 * x + 1) << 8) | (__ldg(nrow + 3 * x + 2) << 16);
      if (scan) ring[x] = v;  // x < pw < R: slot x
      put_rgb(oc + 3 * (x - c0), v);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int x0 = s0; x0 < c1; x0 += step) {
      const int x = x0 + threadIdx.x;
      if (threadIdx.x < step && x < c1) {
        const int s = (int)sh[slead + x - s0];
        const uint32_t v = (s >= 0 && s < win) ? ring[(uint32_t)(x - pw + s) & mask] : 0u;
        ring[(uint32_t)x & mask] = v;
        put_rgb(oc + 3 * (x - c0), v);
      }
      __syncthreads();  // the next step reads what this one wrote
    }
    store_bytes(orow + 3 * c0, oc, 3 * (c1 - c0));
    __syncthreads();  // the next chunk reuses the staging buffers
  }
}

}  // namespace

// Words of global scratch the scan needs: one ring per row where the ring
// does not fit in shared memory beside the staging buffers, else 0 (also
// when every column is a noise pixel, pw >= W, and there is nothing to scan).
extern "C" long long me_linker_scan_scratch_words(int H, int W, int pw) {
  if (pw >= W || ring_in_smem(W, pw)) return 0;
  return (long long)H * ring_words(pw);
}

// shift: (H, W) int32; noise: (H, noise_w, 3) u8 with noise_w >= pw; out:
// (H, W, 3) u8; scratch: me_linker_scan_scratch_words(H, W, pw) words or
// null when that is 0. Returns cudaGetLastError() after the launch, or a
// negative code for arguments the kernel does not take.
extern "C" int me_linker_scan(const void* shift, const void* noise, void* out, void* scratch,
                              int H, int W, int noise_w, int pw, int win, void* stream) {
  if (H < 1 || W < 1 || win < 1 || win > pw || noise_w < pw) return -2;
  const bool global_ring = me_linker_scan_scratch_words(H, W, pw) > 0;
  if (global_ring && scratch == nullptr) return -4;
  const bool smem_ring = pw < W && !global_ring;
  const int R = ring_words(pw);
  const int smem = staging_bytes(W) + (smem_ring ? 4 * R : 0);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        linker_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  linker_scan_kernel<<<H, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(shift), static_cast<const uint8_t*>(noise),
      static_cast<uint8_t*>(out), global_ring ? static_cast<uint32_t*>(scratch) : nullptr, W,
      noise_w, pw, win, R, chunk_cols(W));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one launch (for reports).
extern "C" int me_linker_scan_smem_bytes(int W, int pw) {
  const bool smem_ring = pw < W && ring_in_smem(W, pw);
  return staging_bytes(W) + (smem_ring ? 4 * ring_words(pw) : 0);
}
