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
// step (14 steps at 4032 columns and amplitude 1/16). The row's state is a
// ring of R = pw + BLOCK packed pixels (r | g << 8 | b << 16, as the TPU
// kernel packs them), column c in slot c % R: a step reads columns
// [x0 - pw, x0 - 1] and writes [x0, x0 + step), which never share a slot
// because R >= pw + step. The rings lie in a global scratch buffer, one per
// row, that the wrapper allocates (me_linker_scan_scratch_words): about
// 3 KB a row at the defaults, small enough for L2. A ring in shared memory
// (possible up to pw = 12032) timed 6-10 % faster on an H100, 3-10 us a
// call at 12 and 27 MP, which no end-to-end time can show, so there is one
// place for every width. A shift outside [0, win) gives a black pixel, as
// the TPU kernel's empty window match does.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

__device__ __forceinline__ void store_rgb(uint8_t* p, uint32_t v) {
  p[0] = v & 0xffu;
  p[1] = (v >> 8) & 0xffu;
  p[2] = (v >> 16) & 0xffu;
}

__global__ void __launch_bounds__(BLOCK)
linker_scan_kernel(const int32_t* __restrict__ shift, const uint8_t* __restrict__ noise,
                   uint8_t* __restrict__ out, uint32_t* __restrict__ scratch, int W,
                   int noise_w, int pw, int win) {
  const int R = pw + BLOCK;
  const int y = blockIdx.x;
  const bool scan = pw < W;  // otherwise every column is a noise pixel
  uint32_t* ring = scratch + (size_t)y * R;  // unused (and null) when !scan
  const int32_t* srow = shift + (size_t)y * W;
  const uint8_t* nrow = noise + (size_t)y * noise_w * 3;
  uint8_t* orow = out + (size_t)y * W * 3;

  const int head = min(pw, W);
  for (int x = threadIdx.x; x < head; x += BLOCK) {
    const uint32_t v = nrow[3 * x] | (nrow[3 * x + 1] << 8) | (nrow[3 * x + 2] << 16);
    if (scan) ring[x] = v;  // x < pw < R: slot x
    store_rgb(orow + 3 * x, v);
  }
  if (!scan) return;
  __syncthreads();

  const int step = min(pw - win + 1, BLOCK);
  for (int x0 = head; x0 < W; x0 += step) {
    const int x = x0 + threadIdx.x;
    if (threadIdx.x < step && x < W) {
      const int s = srow[x];
      const uint32_t v = (s >= 0 && s < win) ? ring[(x - pw + s) % R] : 0u;
      ring[x % R] = v;
      store_rgb(orow + 3 * x, v);
    }
    __syncthreads();  // the next step reads what this one wrote
  }
}

}  // namespace

// Words of global scratch the scan needs: one ring per row, or 0 when every
// column is a noise pixel (pw >= W) and there is nothing to scan.
extern "C" long long me_linker_scan_scratch_words(int H, int W, int pw) {
  if (pw >= W) return 0;
  return (long long)H * (pw + BLOCK);
}

// shift: (H, W) int32; noise: (H, noise_w, 3) u8 with noise_w >= pw; out:
// (H, W, 3) u8; scratch: me_linker_scan_scratch_words(H, W, pw) words or
// null when that is 0. Returns cudaGetLastError() after the launch, or a
// negative code for arguments the kernel does not take.
extern "C" int me_linker_scan(const void* shift, const void* noise, void* out, void* scratch,
                              int H, int W, int noise_w, int pw, int win, void* stream) {
  if (H < 1 || W < 1 || win < 1 || win > pw || noise_w < pw) return -2;
  if (me_linker_scan_scratch_words(H, W, pw) > 0 && scratch == nullptr) return -4;
  linker_scan_kernel<<<H, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(shift), static_cast<const uint8_t*>(noise),
      static_cast<uint8_t*>(out), static_cast<uint32_t*>(scratch), W, noise_w, pw, win);
  return static_cast<int>(cudaGetLastError());
}
