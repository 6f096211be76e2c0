// Bilinear resampling of NHWC tensors with align_corners=True for Hopper
// (sm_90a): Depth Anything V2's DPT head, four fusion blocks and the head's
// upsampling to the input's size (ops/nn.py::resize_bilinear).
//
// Replaces no TPU kernel: the JAX package has no Depth Anything V2, and its
// resamplings (Depth Pro's) are XLA's. It was added because PyTorch's
// channels-last kernel (upsample_bilinear2d_nhwc_out_frame) runs one thread
// an output element, with 2-byte loads and stores and the source indices and
// weights computed again for every channel: at the head's 8 x 296 x 528 x
// 128 -> 518 x 924 it reached ~9% of its byte bound.
//
//   resample_bilinear_kernel: out[n, y, x, c] = the bilinear sample of
//   x[n, :, :, c] at (y * (in_h - 1) / (out_h - 1), x * (in_w - 1) / (out_w - 1))
//
// It is PyTorch's result bit for bit, in the tensor's dtype. The arithmetic
// is PyTorch's (aten/src/ATen/native/cuda/UpSampleBilinear2d.cu): the scale
// (in - 1) / (out - 1) in f32 (0 where out is 1), the source coordinate
// scale * dst rounded to f32, its integer part h1 (the +1 neighbour clamped at
// the last row or column), lambda = coordinate - h1, 1 - lambda, then
//   h0l * (w0l * x00 + w1l * x01) + h1l * (w0l * x10 + w1l * x11)
// in f32, rounded once to the dtype. nvcc contracts that expression into
// FMAs, and not alike in PyTorch's kernels (found on an H100 by holding
// candidate roundings against their results, and read in the SASS of the
// same source): every kernel adds the rows as fma(h0l, upper, h1l * lower)
// and sums the lower row as fma(w0l, x10, w1l * x11); the upper row is
// summed the same way, fma(w0l, x00, w1l * x01), except by the f32 build of
// the channels-last kernel (which PyTorch runs from 16 channels, its NCHW
// kernel below), which sums it as fma(w1l, x01, w0l * x00). Every rounding
// is written out below (__fmul_rn, __fmaf_rn, __fsub_rn), so nvcc's
// contraction cannot change it.
//
// What bounds it on this card: bytes. An output element costs ~6 f32
// operations against ~2.5 bytes moved at bf16 (2 written, ~0.5 read at 2x),
// so only the issue rate can keep a kernel from its byte bound: PyTorch's
// spends its instructions on an element's indices and weights and moves 2
// bytes a load. So a lane moves 16 bytes a load and a store (8 bf16 or f16
// values, 4 f32), neighbouring lanes on neighbouring channels and columns;
// the column's source and weights are computed once a lane, the row's once
// a row; and a lane walks down `rows` output rows of one column, so an input
// row is loaded and summed across (its two neighbouring columns) once where
// it serves several output rows: at 2x, ~0.5 row loads and horizontal sums
// an output row. The output, 77% of the bytes at 2x, is written with
// streaming stores. A block takes BLOCK vectors of `rows` output rows of one
// image; the host sizes `rows` so the grid fills the SMs at the smallest
// shape too. A row of a channel count whose bytes are not a multiple of 16
// (or a pointer not 16-byte aligned) takes the same walk one element a lane.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_ROWS = 16;   // output rows a lane walks down
constexpr int BLOCKS_PER_SM = 16;  // the grid the host aims for: two waves of 8 blocks

template <typename T>
struct Tag {
  using type = T;
};

// one element to and from f32
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void from_f32(float f, float& v) { v = f; }
__device__ __forceinline__ void from_f32(float f, __nv_bfloat16& v) { v = __float2bfloat16_rn(f); }
__device__ __forceinline__ void from_f32(float f, __half& v) { v = __float2half_rn(f); }

// two 2-byte floats in one 32-bit word
__device__ __forceinline__ float2 unpack(uint32_t u, Tag<__nv_bfloat16>) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ float2 unpack(uint32_t u, Tag<__half>) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}
__device__ __forceinline__ uint32_t pack(float a, float b, Tag<__nv_bfloat16>) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack(float a, float b, Tag<__half>) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The unit a lane loads and stores: 16 bytes (Wide) or one element
template <typename T, bool Wide>
struct Vec;

template <typename T>
struct Vec<T, false> {
  static constexpr int N = 1;
  T v;
  __device__ __forceinline__ void load(const T* p) { v = *p; }
  __device__ __forceinline__ void store(T* p) const { *p = v; }
  __device__ __forceinline__ void get(float (&f)[N]) const { f[0] = to_f32(v); }
  __device__ __forceinline__ void set(const float (&f)[N]) { from_f32(f[0], v); }
};

template <>
struct Vec<float, true> {
  static constexpr int N = 4;
  uint4 w;
  __device__ __forceinline__ void load(const float* p) { w = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void store(float* p) const { __stcs(reinterpret_cast<uint4*>(p), w); }
  __device__ __forceinline__ void get(float (&f)[N]) const {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
  __device__ __forceinline__ void set(const float (&f)[N]) {
    w = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                   __float_as_uint(f[3]));
  }
};

template <typename T>
struct Vec<T, true> {  // __nv_bfloat16 or __half
  static constexpr int N = 8;
  uint4 w;
  __device__ __forceinline__ void load(const T* p) { w = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void store(T* p) const { __stcs(reinterpret_cast<uint4*>(p), w); }
  __device__ __forceinline__ void get(float (&f)[N]) const {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = unpack(u[k], Tag<T>{});
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
  __device__ __forceinline__ void set(const float (&f)[N]) {
    w = make_uint4(pack(f[0], f[1], Tag<T>{}), pack(f[2], f[3], Tag<T>{}),
                   pack(f[4], f[5], Tag<T>{}), pack(f[6], f[7], Tag<T>{}));
  }
};

// An output row's (column's) source and weights, as PyTorch computes them
// (area_pixel_compute_source_index with align_corners): the coordinate
// rounded to f32, its integer part, the clamped step to the next, and the
// two weights
struct Source {
  int i, step;
  float l0, l1;
};

__device__ __forceinline__ Source source(float scale, int dst, int in) {
  const float r = __fmul_rn(scale, (float)dst);
  Source s;
  s.i = (int)r;
  s.step = s.i < in - 1 ? 1 : 0;
  s.l1 = __fsub_rn(r, (float)s.i);
  s.l0 = __fsub_rn(1.0f, s.l1);
  return s;
}

// The horizontal sums of one input row at a column: w0l * a + w1l * b in
// one FMA, as every kernel sums the lower row, and w1l * b + w0l * a, as
// the f32 channels-last kernel sums the upper one
__device__ __forceinline__ float lower(const Source& w, float a, float b) {
  return __fmaf_rn(w.l0, a, __fmul_rn(w.l1, b));
}
__device__ __forceinline__ float upper_swapped(const Source& w, float a, float b) {
  return __fmaf_rn(w.l1, b, __fmul_rn(w.l0, a));
}
// the two rows' sums added: h0l * upper + h1l * lower in one FMA
__device__ __forceinline__ float vertical(const Source& h, float up, float dn) {
  return __fmaf_rn(h.l0, up, __fmul_rn(h.l1, dn));
}

// x (batch, in_h, in_w, vecs * N) to out (batch, out_h, out_w, vecs * N) in T;
// N elements a lane (Vec<T, Wide>::N). Block b takes vectors [c * BLOCK,
// (c + 1) * BLOCK) of output rows [g * rows, (g + 1) * rows) of image n,
// where b = (n * groups + g) * chunks + c. Swapped: the upper row summed as
// the f32 channels-last kernel sums it (module note)
template <typename T, bool Wide, bool Swapped>
__global__ void __launch_bounds__(BLOCK)
resample_bilinear_kernel(const T* __restrict__ x, T* __restrict__ out, int in_h, int in_w,
                         int out_h, int out_w, int vecs, float scale_h, float scale_w, int rows,
                         int groups, int chunks) {
  using V = Vec<T, Wide>;
  constexpr int N = V::N;
  const int chunk = blockIdx.x % chunks;
  const int g = (blockIdx.x / chunks) % groups;
  const int n = blockIdx.x / chunks / groups;
  const int row_vecs = out_w * vecs;
  const int v = chunk * BLOCK + threadIdx.x;
  if (v >= row_vecs) return;
  const int col = v / vecs;
  const int cv = v - col * vecs;
  const Source w = source(scale_w, col, in_w);
  const long long in_row = (long long)in_w * vecs * N;
  const T* p0 = x + (long long)n * in_h * in_row + ((long long)w.i * vecs + cv) * N;
  const T* p1 = p0 + (long long)w.step * vecs * N;
  const int r0 = g * rows;
  const int r1 = min(r0 + rows, out_h);
  T* o = out + (((long long)n * out_h + r0) * row_vecs + v) * N;

  // up: the upper row's sums; dn: the lower row's; nxt: the sums of row
  // `lo`, the lower row last loaded, as an upper row
  float up[N], dn[N], nxt[N];
  int have = -1, lo = -1;
  for (int r = r0; r < r1; ++r, o += (long long)row_vecs * N) {
    const Source h = source(scale_h, r, in_h);
    if (h.i != have) {
      if (h.i == lo) {
#pragma unroll
        for (int k = 0; k < N; ++k) up[k] = nxt[k];
      } else {
        V a, b;
        a.load(p0 + h.i * in_row);
        b.load(p1 + h.i * in_row);
        float fa[N], fb[N];
        a.get(fa);
        b.get(fb);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          up[k] = Swapped ? upper_swapped(w, fa[k], fb[k]) : lower(w, fa[k], fb[k]);
          if (!h.step) {
            dn[k] = lower(w, fa[k], fb[k]);
            nxt[k] = up[k];
          }
        }
        if (!h.step) lo = h.i;
      }
      if (h.step && h.i + 1 != lo) {
        V a, b;
        a.load(p0 + (h.i + 1) * in_row);
        b.load(p1 + (h.i + 1) * in_row);
        float fa[N], fb[N];
        a.get(fa);
        b.get(fb);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          dn[k] = lower(w, fa[k], fb[k]);
          nxt[k] = Swapped ? upper_swapped(w, fa[k], fb[k]) : dn[k];
        }
        lo = h.i + 1;
      }
      have = h.i;
    }
    float f[N];
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = vertical(h, up[k], dn[k]);
    V y;
    y.set(f);
    y.store(o);
  }
}

// the dtype codes of ops/_build.py::dtype_code
template <typename F>
int with_type(int code, F&& f) {
  switch (code) {
    case 0: return f(Tag<float>{});
    case 1: return f(Tag<__nv_bfloat16>{});
    case 2: return f(Tag<__half>{});
  }
  return -5;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// PyTorch's scale with align_corners (area_pixel_compute_scale)
float scale_of(int in, int out) { return out > 1 ? (float)(in - 1) / (out - 1) : 0.0f; }

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

template <typename T, bool Wide, bool Swapped>
int launch(const void* x, void* out, int batch, int in_h, int in_w, int out_h, int out_w,
           int channels, cudaStream_t stream) {
  constexpr int N = Vec<T, Wide>::N;
  const int vecs = channels / N;
  const long long row_vecs = (long long)out_w * vecs;
  const long long chunks = (row_vecs + BLOCK - 1) / BLOCK;
  // rows a lane walks: as many as leave BLOCKS_PER_SM blocks an SM, 1 to MAX_ROWS
  long long rows = (long long)batch * out_h * chunks / ((long long)sm_count() * BLOCKS_PER_SM);
  rows = rows < 1 ? 1 : rows > MAX_ROWS ? MAX_ROWS : rows;
  const long long groups = (out_h + rows - 1) / rows;
  const long long blocks = (long long)batch * groups * chunks;
  if (row_vecs > 0x7fffffffLL || blocks > 0x7fffffffLL) return -2;
  resample_bilinear_kernel<T, Wide, Swapped><<<(unsigned)blocks, BLOCK, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), in_h, in_w, out_h, out_w, vecs,
      scale_of(in_h, out_h), scale_of(in_w, out_w), (int)rows, (int)groups, (int)chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (batch, out_h, out_w, channels) <- x (batch, in_h, in_w, channels)
// resampled bilinearly with align_corners=True, both contiguous in `dtype`
// (0 f32, 1 bf16, 2 f16). Launched on `stream`; a resampling to the same
// size is PyTorch's copy. Returns cudaGetLastError() after the launch, or a
// negative code for arguments the kernel does not take.
extern "C" int me_resample_bilinear(const void* x, void* out, int batch, int in_h, int in_w,
                                    int out_h, int out_w, int channels, int dtype,
                                    void* stream) {
  if (batch < 1 || in_h < 1 || in_w < 1 || out_h < 1 || out_w < 1 || channels < 1) return -2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_type(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    if (in_h == out_h && in_w == out_w)
      return static_cast<int>(cudaMemcpyAsync(
          out, x, (size_t)batch * in_h * in_w * channels * sizeof(T), cudaMemcpyDeviceToDevice, s));
    constexpr int N = Vec<T, true>::N;
    const bool wide = channels % N == 0 && aligned16(x) && aligned16(out);
    // PyTorch runs its channels-last kernel from 16 channels, its NCHW kernel below
    const bool swapped = sizeof(T) == 4 && channels >= 16;
    if (wide)
      return swapped ? launch<T, true, true>(x, out, batch, in_h, in_w, out_h, out_w, channels, s)
                     : launch<T, true, false>(x, out, batch, in_h, in_w, out_h, out_w, channels, s);
    return swapped ? launch<T, false, true>(x, out, batch, in_h, in_w, out_h, out_w, channels, s)
                   : launch<T, false, false>(x, out, batch, in_h, in_w, out_h, out_w, channels, s);
  });
}
