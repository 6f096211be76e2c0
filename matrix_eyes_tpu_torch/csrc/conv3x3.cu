// 3x3 convolution, stride 1, padding 1, NHWC x HWIO, for Hopper (sm_90a).
//
// Replaces the TPU kernel matrix_eyes_tpu/ops/conv3x3.py: conv3x3_pallas
// (_conv3x3_kernel): out = conv3x3(relu_in ? relu(x) : x, w) + bias
// (+ skip) (+ skip2), accumulated in f32, stored in the input dtype. It
// carries the decoder's residual units and projections and the head's two
// 3x3 convs.
//
// What bounds it on this card: the hot shape (768^2 x 256 -> 256) is
// 0.7 TFLOP against ~0.6 GB of bf16 traffic (~1100 FLOP/byte), so it is
// compute bound; the decoder and head together are 4.8 TFLOP per image.
// With the math on tensor cores, what remains is gathering the operands
// into shared memory and feeding the fragments from it.
//
// Design: the conv is read as an implicit GEMM with M = B*H*W output
// pixels, N = Cout and K = 9*Cin ordered (tap, input channel), exactly the
// row order of the HWIO weight, so the weight is the (K, N) matrix as it
// lies in memory. The A tile is gathered straight from x: zero padding
// comes from bounds checks (no padded copy), and relu_in is applied on
// load. The next K step's global loads are issued into registers before
// the current step's math, so their latency hides behind it. The epilogue
// adds the bias and up to two residuals in f32 and casts once to the
// output dtype: the TPU kernel's fused RCU, with no extra pass over device
// memory. Two paths:
//
// * bf16: tensor cores through mma.sync m16n8k16 (bf16 in, f32
//   accumulate). A 256-thread block computes a 128 x 64 output tile as
//   eight 32 x 32 warp tiles, stepping K by 32. With Cin and Cout multiples
//   of 8 (every Depth Pro conv but the head's 129-channel composed conv)
//   operands move as 16-byte vectors; otherwise element by element.
// * f32 (--dtype f32): FP32 CUDA cores, a 64 x 64 tile of 4 x 4 register
//   tiles stepping K by 16; TF32 would not keep f32 accuracy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// CUDA-core path (f32).

constexpr int BM = 64;                // output pixels per block
constexpr int BN = 64;                // output channels per block
constexpr int BK = 16;                // reduction step (tap x input channel)
constexpr int NT = 256;               // threads: a 16 x 16 grid of 4 x 4 tiles
constexpr int A_PER = BM * BK / NT;   // A elements each thread loads per step
constexpr int B_PER = BK * BN / NT;   // B elements each thread loads per step
constexpr int A_ROWS = NT / BK;       // pixel stride between a thread's A elements

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Gather this thread's share of the A (pixels x K) and B (K x Cout) tiles
// of reduction step k0 into registers.
template <typename T>
__device__ __forceinline__ void load_step(const T* __restrict__ x, const T* __restrict__ w,
                                          int k0, int tid, int H, int W, int Cin, int Cout,
                                          int n0, bool relu_in, const int (&py)[A_PER],
                                          const int (&px)[A_PER],
                                          const long long (&pimg)[A_PER],
                                          float (&a)[A_PER], float (&bv)[B_PER]) {
  const int K = 9 * Cin;
  const int k = k0 + tid % BK;
  if (k < K) {
    const int tap = k / Cin;
    const int ci = k - tap * Cin;
    const int du = tap / 3 - 1;
    const int dv = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      float val = 0.f;
      const int iy = py[i] + du;
      const int ix = px[i] + dv;
      if (pimg[i] >= 0 && iy >= 0 && iy < H && ix >= 0 && ix < W) {
        val = to_f32(x[(pimg[i] + (long long)iy * W + ix) * Cin + ci]);
        if (relu_in) val = fmaxf(val, 0.f);
      }
      a[i] = val;
    }
  } else {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) a[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < B_PER; ++i) {
    const int e = tid + i * NT;
    const int kb = k0 + e / BN;
    const int n = n0 + e % BN;
    bv[i] = (kb < K && n < Cout) ? to_f32(w[(long long)kb * Cout + n]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
               const T* __restrict__ skip, const T* __restrict__ skip2, T* __restrict__ out,
               int B, int H, int W, int Cin, int Cout, int relu_in) {
  __shared__ __align__(16) float As[BK][BM + 4];  // +4 keeps float4 rows, spreads banks
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const long long HW = (long long)H * W;
  const long long M = (long long)B * HW;
  const int K = 9 * Cin;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  int py[A_PER], px[A_PER];
  long long pimg[A_PER];  // pixel index of (b, 0, 0) for this pixel, -1 past M
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const long long m = m0 + tid / BK + i * A_ROWS;
    if (m < M) {
      const long long bb = m / HW;
      const int rem = (int)(m - bb * HW);
      py[i] = rem / W;
      px[i] = rem - py[i] * W;
      pimg[i] = bb * HW;
    } else {
      py[i] = 0;
      px[i] = 0;
      pimg[i] = -1;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int ty = tid / 16;
  const int tx = tid % 16;
  float a_reg[A_PER], b_reg[B_PER];
  load_step<T>(x, w, 0, tid, H, W, Cin, Cout, n0, relu_in != 0, py, px, pimg, a_reg, b_reg);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) As[tid % BK][tid / BK + i * A_ROWS] = a_reg[i];
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * NT;
      Bs[e / BN][e % BN] = b_reg[i];
    }
    __syncthreads();
    if (k0 + BK < K)
      load_step<T>(x, w, k0 + BK, tid, H, W, Cin, Cout, n0, relu_in != 0, py, px, pimg,
                   a_reg, b_reg);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bw[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();  // the next step overwrites As/Bs
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= Cout) continue;
      const size_t o = (size_t)m * Cout + n;
      float v = acc[i][j];
      if (bias) v += to_f32(bias[n]);
      if (skip) v += to_f32(skip[o]);
      if (skip2) v += to_f32(skip2[o]);
      out[o] = from_f32<T>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16).
//
// mma.sync m16n8k16 fragment layout, lane = 4 * g + t:
//   A (16 x 16, row major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same
//     cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, column major): b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8,
//     2t+9, col g);
//   C (16 x 8, f32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// Each 32-bit register holds two bf16, the lower column in the low half.

using bf16 = __nv_bfloat16;

constexpr int TC_BM = 128;           // output pixels per block
constexpr int TC_BN = 64;            // output channels per block
constexpr int TC_BK = 32;            // reduction step
constexpr int TC_NT = 256;           // 8 warps: 4 along M x 2 along N, 32 x 32 each
constexpr int TC_LD = TC_BK + 8;     // smem row pitch (bf16): conflict-free fragment loads

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// VEC: Cin and Cout are multiples of 8, so every 8-element run of A (one
// tap, 8 input channels) and of B (8 output channels) is one 16-byte load
// (the wrapper checks that the operands are 16-byte aligned).
template <bool VEC>
__global__ void __launch_bounds__(TC_NT)
conv3x3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const bf16* __restrict__ bias, const bf16* __restrict__ skip,
                   const bf16* __restrict__ skip2, bf16* __restrict__ out, int B, int H, int W,
                   int Cin, int Cout, int relu_in) {
  __shared__ __align__(16) bf16 As[TC_BM * TC_LD];  // [pixel][k]
  __shared__ __align__(16) bf16 Bs[TC_BN * TC_LD];  // [cout][k]: B transposed

  constexpr int AR = VEC ? TC_BM * TC_BK / 8 / TC_NT : TC_BM * TC_BK / TC_NT;  // A runs/thread
  constexpr int BR = VEC ? 1 : TC_BK * TC_BN / TC_NT;                          // B runs/thread
  const int tid = threadIdx.x;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = (tid / 32) % 4, wn = (tid / 32) / 4;
  const long long HW = (long long)H * W;
  const long long M = (long long)B * HW;
  const int K = 9 * Cin;
  const long long m0 = (long long)blockIdx.x * TC_BM;
  const int n0 = blockIdx.y * TC_BN;
  const bf16 zero = __float2bfloat16(0.f);

  // this thread's A rows (pixels) and its k offset within a step
  const int a_k = VEC ? (tid % 4) * 8 : tid % 32;
  int a_row[AR], py[AR], px[AR];
  long long pimg[AR];  // pixel index of (b, 0, 0), -1 past M
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    a_row[i] = VEC ? tid / 4 + 64 * i : tid / 32 + 8 * i;
    const long long m = m0 + a_row[i];
    if (m < M) {
      const long long bb = m / HW;
      const int rem = (int)(m - bb * HW);
      py[i] = rem / W;
      px[i] = rem - py[i] * W;
      pimg[i] = bb * HW;
    } else {
      py[i] = 0;
      px[i] = 0;
      pimg[i] = -1;
    }
  }

  uint4 a_vec[VEC ? AR : 1];
  bf16 a_val[VEC ? 1 : AR];
  uint4 b_vec;
  bf16 b_val[VEC ? 1 : BR];

  auto gather_step = [&](int k0) {
    const int k = k0 + a_k;
    int ci = 0, du = 0, dv = 0;
    const bool k_ok = k < K;
    if (k_ok) {
      const int tap = k / Cin;
      ci = k - tap * Cin;
      du = tap / 3 - 1;
      dv = tap % 3 - 1;
    }
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const int iy = py[i] + du;
      const int ix = px[i] + dv;
      const bool ok = k_ok && pimg[i] >= 0 && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const size_t off = ok ? (size_t)((pimg[i] + (long long)iy * W + ix) * Cin + ci) : 0;
      if constexpr (VEC) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (ok) {
          v = *reinterpret_cast<const uint4*>(x + off);
          if (relu_in) {
            __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
            for (int j = 0; j < 4; ++j) h2[j] = __hmax2(h2[j], __bfloat162bfloat162(zero));
          }
        }
        a_vec[i] = v;
      } else {
        bf16 v = zero;
        if (ok) {
          v = x[off];
          if (relu_in) v = __hmax(v, zero);
        }
        a_val[i] = v;
      }
    }
    if constexpr (VEC) {
      const int kb = k0 + tid / 8;
      const int n = n0 + (tid % 8) * 8;
      b_vec = (kb < K && n < Cout)
                  ? *reinterpret_cast<const uint4*>(w + (size_t)kb * Cout + n)
                  : make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int i = 0; i < BR; ++i) {
        const int e = tid + i * TC_NT;
        const int kb = k0 + e / TC_BN;
        const int n = n0 + e % TC_BN;
        b_val[i] = (kb < K && n < Cout) ? w[(size_t)kb * Cout + n] : zero;
      }
    }
  };

  auto stash_step = [&]() {
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      if constexpr (VEC) *reinterpret_cast<uint4*>(&As[a_row[i] * TC_LD + a_k]) = a_vec[i];
      else As[a_row[i] * TC_LD + a_k] = a_val[i];
    }
    if constexpr (VEC) {
      const bf16* v = reinterpret_cast<const bf16*>(&b_vec);
      const int kb = tid / 8, nb = (tid % 8) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) Bs[(nb + j) * TC_LD + kb] = v[j];
    } else {
#pragma unroll
      for (int i = 0; i < BR; ++i) {
        const int e = tid + i * TC_NT;
        Bs[(e % TC_BN) * TC_LD + e / TC_BN] = b_val[i];
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mf][nf][i] = 0.f;

  gather_step(0);
  for (int k0 = 0; k0 < K; k0 += TC_BK) {
    stash_step();
    __syncthreads();
    if (k0 + TC_BK < K) gather_step(k0 + TC_BK);
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        const bf16* ap = &As[(wm * 32 + mf * 16 + g) * TC_LD + kk * 16 + 2 * t];
        af[mf][0] = lds32(ap);
        af[mf][1] = lds32(ap + 8 * TC_LD);
        af[mf][2] = lds32(ap + 8);
        af[mf][3] = lds32(ap + 8 * TC_LD + 8);
      }
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const bf16* bp = &Bs[(wn * 32 + nf * 8 + g) * TC_LD + kk * 16 + 2 * t];
        const uint32_t b0 = lds32(bp), b1 = lds32(bp + 8);
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) mma_16816(acc[mf][nf], af[mf], b0, b1);
      }
    }
    __syncthreads();  // the next step overwrites As/Bs
  }

#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + wm * 32 + mf * 16 + g + 8 * (i >> 1);
      if (m >= M) continue;
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const int n = n0 + wn * 32 + nf * 8 + 2 * t + (i & 1);
        if (n >= Cout) continue;
        const size_t o = (size_t)m * Cout + n;
        float v = acc[mf][nf][i];
        if (bias) v += __bfloat162float(bias[n]);
        if (skip) v += __bfloat162float(skip[o]);
        if (skip2) v += __bfloat162float(skip2[o]);
        out[o] = __float2bfloat16(v);
      }
    }
}

// ---------------------------------------------------------------------------

int launch_f32(const void* x, const void* w, const void* bias, const void* skip,
               const void* skip2, void* out, int B, int H, int W, int Cin, int Cout,
               int relu_in, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  conv3x3_kernel<float><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(skip),
      static_cast<const float*>(skip2), static_cast<float*>(out), B, H, W, Cin, Cout,
      relu_in);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* x, const void* w, const void* bias, const void* skip,
                const void* skip2, void* out, int B, int H, int W, int Cin, int Cout,
                int relu_in, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + TC_BM - 1) / TC_BM), (unsigned)((Cout + TC_BN - 1) / TC_BN));
  const bool vec = Cin % 8 == 0 && Cout % 8 == 0;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const bf16* bb = static_cast<const bf16*>(bias);
  const bf16* s1 = static_cast<const bf16*>(skip);
  const bf16* s2 = static_cast<const bf16*>(skip2);
  bf16* ob = static_cast<bf16*>(out);
  if (vec)
    conv3x3_mma_kernel<true><<<grid, TC_NT, 0, stream>>>(xb, wb, bb, s1, s2, ob, B, H, W, Cin,
                                                         Cout, relu_in);
  else
    conv3x3_mma_kernel<false><<<grid, TC_NT, 0, stream>>>(xb, wb, bb, s1, s2, ob, B, H, W,
                                                          Cin, Cout, relu_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias, skip and skip2 may be null.
// Returns cudaGetLastError() after the launch, or a negative code for
// arguments the kernel does not take.
extern "C" int me_conv3x3(const void* x, const void* w, const void* bias, const void* skip,
                          const void* skip2, void* out, int B, int H, int W, int Cin, int Cout,
                          int relu_in, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(x, w, bias, skip, skip2, out, B, H, W, Cin, Cout, relu_in, st);
  if (dtype == 1)
    return launch_bf16(x, w, bias, skip, skip2, out, B, H, W, Cin, Cout, relu_in, st);
  return -3;
}
