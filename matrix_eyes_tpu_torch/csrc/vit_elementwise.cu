// The ViT block's two elementwise chains for Hopper (sm_90a), one pass each.
//
// Replaces no TPU kernel: XLA fused these chains into the neighbouring
// programs on the TPU (matrix_eyes_tpu/models/vit.py::block_forward), while
// PyTorch runs each as three passes that write their f32 intermediates to
// device memory (an up-cast copy, the f32 operation, a cast or an add).
//
//   vit_gelu_kernel:              x <- x * 0.5 * (1 + erf(x / sqrt(2)))   (in place)
//   vit_scaled_residual_kernel:   out = x + o * ls   (ls broadcast over rows)
//
// Each is bit for bit the PyTorch chain it replaces (ops/nn.py's plain
// versions). GELU is written as PyTorch's GeluCUDAKernelImpl writes it,
// (x * 0.5f) * (1.0f + erff(x * M_SQRT1_2)), in f32 on a value read at its
// stored dtype and rounded once to that dtype. The residual rounds as
// `x + o.to(x.dtype) * ls.to(x.dtype)` does: o and ls to x's dtype, their
// product rounded to it (__fmul_rn), then the sum (__fadd_rn); the explicit
// roundings keep nvcc's default -fmad=true from contracting the two into one
// FMA, which would differ wherever the product is inexact (an f32 ls).
//
// What bounds them on this card: bytes. GELU does ~20 f32 operations an
// element against 4 bytes moved at bf16 (read and write), the residual 2
// against 10 (f32 x and out, bf16 o); at 3.35 TB/s the bytes take ~10x the
// CUDA cores' time. So each pass reads every input once at its stored dtype
// and writes its output once, and keeps the f32 values in registers; GELU
// writes over its input, which the ViT block does not read again, so the
// caching allocator holds no second (tokens, 4096) buffer. A lane
// moves a chunk of 8 elements in 16-byte vector loads and stores (two for
// f32) and loads all of its UNROLL chunks before it computes; a block takes
// one tile of UNROLL rows of BLOCK chunks, and the grid covers the tensor in
// tiles (the patch ViT's GELU is ~40,000 blocks, many waves over the 132
// SMs). The tile sizes were chosen on the card against a grid of resident
// blocks striding over the tensor, which left ~20% of the bandwidth unused.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int VEC = 8;     // elements a chunk: 16 bytes of bf16 or f16, 32 of f32
constexpr int UNROLL = 2;  // chunks a lane loads before it computes
constexpr float kSqrtHalf = 0.70710678118654752440f;  // M_SQRT1_2, PyTorch's kAlpha

template <typename T>
struct Tag {
  using type = T;
};

// 8 elements of T as raw 16-byte words, to and from f32
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  uint4 w[2];
  __device__ __forceinline__ void load(const float* p) {
    w[0] = reinterpret_cast<const uint4*>(p)[0];
    w[1] = reinterpret_cast<const uint4*>(p)[1];
  }
  __device__ __forceinline__ void store(float* p) const {
    reinterpret_cast<uint4*>(p)[0] = w[0];
    reinterpret_cast<uint4*>(p)[1] = w[1];
  }
  __device__ __forceinline__ void get(float (&f)[VEC]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      f[4 * h + 0] = __uint_as_float(w[h].x);
      f[4 * h + 1] = __uint_as_float(w[h].y);
      f[4 * h + 2] = __uint_as_float(w[h].z);
      f[4 * h + 3] = __uint_as_float(w[h].w);
    }
  }
  __device__ __forceinline__ void set(const float (&f)[VEC]) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      w[h] = make_uint4(__float_as_uint(f[4 * h + 0]), __float_as_uint(f[4 * h + 1]),
                        __float_as_uint(f[4 * h + 2]), __float_as_uint(f[4 * h + 3]));
  }
};

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

template <typename T>
struct Chunk {  // __nv_bfloat16 or __half
  uint4 w;
  __device__ __forceinline__ void load(const T* p) { w = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void store(T* p) const { *reinterpret_cast<uint4*>(p) = w; }
  __device__ __forceinline__ void get(float (&f)[VEC]) const {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = unpack(u[k], Tag<T>{});
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
  __device__ __forceinline__ void set(const float (&f)[VEC]) {
    w = make_uint4(pack(f[0], f[1], Tag<T>{}), pack(f[2], f[3], Tag<T>{}),
                   pack(f[4], f[5], Tag<T>{}), pack(f[6], f[7], Tag<T>{}));
  }
};

// one element, for the tail past the last whole chunk
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void from_f32(float f, float& v) { v = f; }
__device__ __forceinline__ void from_f32(float f, __nv_bfloat16& v) { v = __float2bfloat16_rn(f); }
__device__ __forceinline__ void from_f32(float f, __half& v) { v = __float2half_rn(f); }

// f rounded to T's precision, as an f32
template <typename T>
__device__ __forceinline__ float round_to(float f) {
  T v;
  from_f32(f, v);
  return to_f32(v);
}

__device__ __forceinline__ float gelu_erf(float x) {
  return (x * 0.5f) * (1.0f + erff(x * kSqrtHalf));
}

// out = x + o * ls with PyTorch's roundings in x's dtype X (module note)
template <typename X>
__device__ __forceinline__ float scaled_residual(float x, float o, float ls) {
  const float p = round_to<X>(__fmul_rn(round_to<X>(o), round_to<X>(ls)));
  return __fadd_rn(x, p);
}

// GELU at f32 (the FOV ViT's): one 32-byte chunk a lane, as fast as
// PyTorch's own f32 pass at the FOV's shapes, where two lost ~15%
template <typename T>
constexpr int kGeluUnroll = sizeof(T) == 4 ? 1 : UNROLL;

// x <- gelu(x) over n elements of T, in place: each element is read, then
// written, by one thread. A block's tile is U rows of BLOCK chunks, thread
// t taking chunk t of each row
template <typename T>
__global__ void __launch_bounds__(BLOCK)
vit_gelu_kernel(T* x, long long n) {
  constexpr int U = kGeluUnroll<T>;
  const long long chunks = n / VEC;
  const long long first = (long long)blockIdx.x * BLOCK * U + threadIdx.x;
  Chunk<T> v[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (first + u * BLOCK < chunks) v[u].load(x + (first + u * BLOCK) * VEC);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (first + u * BLOCK < chunks) {
      float f[VEC];
      v[u].get(f);
#pragma unroll
      for (int k = 0; k < VEC; ++k) f[k] = gelu_erf(f[k]);
      v[u].set(f);
      v[u].store(x + (first + u * BLOCK) * VEC);
    }
  }
  const long long i = chunks * VEC + first;  // the < 8 elements past the last chunk
  if (i < n) from_f32(gelu_erf(to_f32(x[i])), x[i]);
}

// out = x + o * ls: x, out (rows, d) in X; o (rows, d) in O; ls (d,) in L.
// d is a multiple of VEC, so a chunk lies within one row and reads ls[j, j + 8);
// a block's tile as vit_gelu_kernel's
template <typename X, typename O, typename L>
__global__ void __launch_bounds__(BLOCK)
vit_scaled_residual_kernel(const X* __restrict__ x, const O* __restrict__ o,
                           const L* __restrict__ ls, X* __restrict__ out, long long chunks,
                           long long row_chunks) {
  const long long first = (long long)blockIdx.x * BLOCK * UNROLL + threadIdx.x;
  Chunk<X> xv[UNROLL];
  Chunk<O> ov[UNROLL];
  Chunk<L> lv[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long c = first + u * BLOCK;
    if (c < chunks) {
      xv[u].load(x + c * VEC);
      ov[u].load(o + c * VEC);
      lv[u].load(ls + (c % row_chunks) * VEC);
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long c = first + u * BLOCK;
    if (c < chunks) {
      float xf[VEC], of[VEC], lf[VEC];
      xv[u].get(xf);
      ov[u].get(of);
      lv[u].get(lf);
#pragma unroll
      for (int k = 0; k < VEC; ++k) xf[k] = scaled_residual<X>(xf[k], of[k], lf[k]);
      xv[u].set(xf);
      xv[u].store(out + c * VEC);
    }
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

// blocks to cover `chunks` in tiles of BLOCK * unroll
unsigned grid_for(long long chunks, int unroll) {
  const long long tile = (long long)BLOCK * unroll;
  return (unsigned)(chunks < 1 ? 1 : (chunks + tile - 1) / tile);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x <- gelu(x) in place, n elements of `dtype` (0 f32, 1 bf16, 2 f16),
// 16-byte aligned. Launched on `stream`; returns cudaGetLastError() after
// the launch, or a negative code for arguments the kernel does not take.
extern "C" int me_vit_gelu(void* x, long long n, int dtype, void* stream) {
  if (n < 1) return -2;
  if (!aligned16(x)) return -3;
  return with_type(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    vit_gelu_kernel<T><<<grid_for(n / VEC, kGeluUnroll<T>), BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(static_cast<T*>(x), n);
    return static_cast<int>(cudaGetLastError());
  });
}

// out = x + o * ls over n elements in rows of d (a multiple of 8): x and
// out in x_dtype, o in o_dtype, ls (d,) in ls_dtype; every pointer 16-byte
// aligned. Returns as me_vit_gelu does.
extern "C" int me_vit_scaled_residual(const void* x, const void* o, const void* ls, void* out,
                                      long long n, long long d, int x_dtype, int o_dtype,
                                      int ls_dtype, void* stream) {
  if (n < 1 || d < VEC || d % VEC != 0 || n % d != 0) return -2;
  if (!aligned16(x) || !aligned16(o) || !aligned16(ls) || !aligned16(out)) return -3;
  return with_type(x_dtype, [&](auto tx) {
    return with_type(o_dtype, [&](auto to) {
      return with_type(ls_dtype, [&](auto tl) {
        using X = typename decltype(tx)::type;
        using O = typename decltype(to)::type;
        using L = typename decltype(tl)::type;
        vit_scaled_residual_kernel<X, O, L><<<grid_for(n / VEC, UNROLL), BLOCK, 0,
                                              static_cast<cudaStream_t>(stream)>>>(
            static_cast<const X*>(x), static_cast<const O*>(o), static_cast<const L*>(ls),
            static_cast<X*>(out), n / VEC, d / VEC);
        return static_cast<int>(cudaGetLastError());
      });
    });
  });
}
