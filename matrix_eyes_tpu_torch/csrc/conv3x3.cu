// 3x3 convolution, stride 1, padding 1, NHWC x HWIO, for Hopper (sm_90a).
//
// Replaces the TPU kernel matrix_eyes_tpu/ops/conv3x3.py: conv3x3_pallas
// (_conv3x3_kernel): out = conv3x3(relu_in ? relu(x) : x, w) + bias
// (+ skip) (+ skip2), accumulated in f32, stored in the input dtype. It
// carries the decoder's residual units and projections and the head's two
// 3x3 convs.
//
// What bounds it on this card: the hot shape (768^2 x 256 -> 256, relu_in,
// two residuals) is 0.70 TFLOP against 1.21 GB of bf16 traffic, so it is
// compute bound (0.70 ms at 989 TFLOP/s); the decoder and head together are
// 4.5 TFLOP per image. What the design has to do is keep the tensor cores
// fed: operands arrive by TMA, never through registers, and a ring of
// stages keeps the next loads in flight behind the math.
//
// The conv is an implicit GEMM: M = output pixels, N = Cout, K = 9 taps x
// Cin, as the TPU kernel's row band does with 9 shifted matmuls. Two paths:
//
// * bf16 (Cin and Cout multiples of 8, so every TMA stride is a multiple of
//   16 bytes; the wrapper pads other counts): a block computes a band of
//   128 output pixels (R rows x Wt columns of one image) by BN = 128 or 256
//   output channels. One producer warp issues, per K step (one tap, 64 input
//   channels), one TMA box (64 ch, Wt, R, 1) of x at (c0, x0 + dv - 1,
//   y0 + du - 1, b) and BN / 64 boxes of the HWIO weight viewed as
//   (Cout, Cin, 9). TMA fills coordinates outside the image with zeros,
//   which is the conv's padding: no bounds checks. Both land with a 128-byte
//   swizzle in a ring of stages guarded by mbarriers. The weight tile is used
//   as it lies (N contiguous): an MN-major B operand, read through wgmma's
//   transpose bit, so nothing is transposed in shared memory. Two consumer
//   warpgroups each own 64 of the pixels and issue wgmma m64nBNk16 with A
//   from registers: ldmatrix from the swizzled stage, then relu_in as one
//   __hmax2 per register. The register form was chosen over an in-place
//   ReLU pass over the stage because it reads the tile once, writes nothing
//   back and needs no extra barrier; both ReLU settings take it, so there is
//   one code path. The epilogue stages the f32 tile in shared memory and
//   walks it with 16-byte vectors: bias, skip and skip2 added in f32, one
//   bf16 rounding, coalesced residual reads and output writes, each
//   thread's loads issued four vectors at a time so their latencies
//   overlap (the residuals are 2 x 302 MB of the hot shape's 1.21 GB, and
//   one block per SM leaves nothing else to hide them behind). Grids that
//   cannot fill the card (the 48^2 and 96^2 projections, K = 9216) split K
//   across blocks, each writing an f32 partial that a second pass sums with
//   the bias and residuals (the wrapper plans the split).
// * f32 (--dtype f32): FP32 CUDA cores, a 64 x 64 tile of 4 x 4 register
//   tiles stepping K by 16; TF32 would not keep f32 accuracy.

#include "hopper.cuh"

#include <stddef.h>

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

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

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
// Tensor-core path (bf16): TMA + mbarrier ring + wgmma.

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int TC_BM = 128;       // output pixels per block: two warpgroups x 64
constexpr int TC_BK = 64;        // input channels per K step: one 128-byte swizzle row
constexpr int TC_THREADS = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2

template <int TN>
struct TcCfg {
  static constexpr int STAGES = TN == 256 ? 4 : 6;
  static constexpr int A_BYTES = TC_BM * TC_BK * 2;  // 16 KB
  static constexpr int B_BYTES = TC_BK * TN * 2;     // TN / 64 boxes of 8 KB
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int EPI_LD = TN + 8;  // f32 staging pitch: conflict-free float2 stores
  static constexpr int SMEM = 1024 + RING_BYTES + 2 * STAGES * 8;
  static_assert(TC_BM * EPI_LD * 4 <= RING_BYTES, "epilogue staging reuses the ring");
};

struct TcArgs {
  const bf16* bias;   // (Cout,) or null
  const bf16* skip;   // (B, H, W, Cout) or null
  const bf16* skip2;  // (B, H, W, Cout) or null
  bf16* out;          // (B, H, W, Cout); unused when partial is set
  float* partial;     // split K: (splits, B, H, W, Cout) f32, else null
  int H, W, Cout;
  int Wt, R;                  // the pixel band: R rows x Wt columns, R * Wt = TC_BM
  int tiles_x, tiles_y;       // bands per row of bands, rows of bands per image
  int cchunks;                // ceil(Cin / 64)
  int steps_per_split;        // K steps per blockIdx.z
  long long split_stride;     // elements between two splits' partials
};

template <int TN, bool RELU>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const TcArgs p) {
  using C = TcCfg<TN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::RING_BYTES);
  uint64_t* empty = full + C::STAGES;

  int mt = blockIdx.x;
  const int x0 = (mt % p.tiles_x) * p.Wt;
  mt /= p.tiles_x;
  const int y0 = (mt % p.tiles_y) * p.R;
  const int b = mt / p.tiles_y;
  const int n0 = blockIdx.y * TN;
  const int k_begin = blockIdx.z * p.steps_per_split;
  const int k_end = min(9 * p.cchunks, k_begin + p.steps_per_split);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      for (int k = k_begin, i = 0; k < k_end; ++k, ++i) {
        const int s = i % C::STAGES;
        mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
        uint8_t* a = smem + s * C::STAGE_BYTES;
        const int tap = k / p.cchunks;
        const int c0 = (k - tap * p.cchunks) * TC_BK;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_4d(a, &xmap, &full[s], c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, b);
#pragma unroll
        for (int j = 0; j < TN / 64; ++j)
          tma_load_3d(a + C::A_BYTES + j * 8192, &wmap, &full[s], n0 + 64 * j, c0, tap);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;

    float acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;

    // ldmatrix: lane l addresses pixel row (l % 16) of this warp's 16 and
    // the 16-byte chunk (2 kk + l / 16) of the 128-byte row, swizzled
    const uint32_t row_off = (uint32_t)(wg * 64 + warp * 16 + lane % 16) * 128;
    const uint32_t ring = smem_u32(smem);

    for (int k = k_begin, i = 0; k < k_end; ++k, ++i) {
      const int s = i % C::STAGES;
      mbar_wait(&full[s], (i / C::STAGES) & 1);
      const uint32_t a_tile = ring + s * C::STAGE_BYTES;
      uint32_t af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(af[kk], a_tile + swizzle<128>(row_off + (2 * kk + lane / 16) * 16));
      if (RELU) {
        const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&af[kk][r]);
            v = __hmax2(v, zero);
            af[kk][r] = *reinterpret_cast<uint32_t*>(&v);
          }
      }
      // B: TN / 64 boxes of 64 (k) x 64 (n), LBO = box stride, SBO = 8 k rows
      const uint64_t desc = make_desc<128>(smem + s * C::STAGE_BYTES + C::A_BYTES, 8192, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t d = desc + (uint64_t)((kk * 16 * 128) >> 4);
        if constexpr (TN == 256)
          wgmma_m64n256k16_rs(acc, af[kk], d, 1);
        else
          wgmma_m64n128k16_rs(acc, af[kk], d, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(af[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // Epilogue. Both warpgroups are past the ring before it is reused.
    named_barrier(1, 256);
    float* stage = reinterpret_cast<float*>(smem);
    {
      const int g = lane / 4, t = lane % 4;
      const int r0 = wg * 64 + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int c = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(&stage[r0 * C::EPI_LD + c]) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(&stage[(r0 + 8) * C::EPI_LD + c]) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    named_barrier(1, 256);
    // 256 threads walk the tile in 16-byte vectors of 8 channels, a group
    // of GROUP vectors at a time: every residual and bias load of a group
    // is in flight before the first is used
    constexpr int VPR = TN / 8;  // 8-channel vectors per pixel
    constexpr int ITERS = TC_BM * VPR / 256;
    constexpr int GROUP = 4;
    const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
    for (int it0 = 0; it0 < ITERS; it0 += GROUP) {
      int r[GROUP], c[GROUP];
      bool ok[GROUP];
      size_t o[GROUP];
      uint4 add[GROUP][3];  // bias, skip, skip2
#pragma unroll
      for (int q = 0; q < GROUP; ++q) {
        const int e = threadIdx.x + (it0 + q) * 256;
        r[q] = e / VPR;
        c[q] = (e % VPR) * 8;
        const int yy = y0 + r[q] / p.Wt;
        const int xx = x0 + r[q] % p.Wt;
        const int n = n0 + c[q];
        ok[q] = yy < p.H && xx < p.W && n < p.Cout;
        o[q] = ok[q] ? (((size_t)b * p.H + yy) * p.W + xx) * p.Cout + n : 0;
        const bool out_pass = ok[q] && !p.partial;
        add[q][0] = out_pass && p.bias ? __ldg(reinterpret_cast<const uint4*>(p.bias + n)) : zero4;
        add[q][1] = out_pass && p.skip ? __ldg(reinterpret_cast<const uint4*>(p.skip + o[q]))
                                       : zero4;
        add[q][2] = out_pass && p.skip2 ? __ldg(reinterpret_cast<const uint4*>(p.skip2 + o[q]))
                                        : zero4;
      }
#pragma unroll
      for (int q = 0; q < GROUP; ++q) {
        if (!ok[q]) continue;
        const float4 lo = *reinterpret_cast<const float4*>(&stage[r[q] * C::EPI_LD + c[q]]);
        const float4 hi = *reinterpret_cast<const float4*>(&stage[r[q] * C::EPI_LD + c[q] + 4]);
        if (p.partial) {
          float4* dst = reinterpret_cast<float4*>(p.partial + blockIdx.z * p.split_stride + o[q]);
          dst[0] = lo;
          dst[1] = hi;
          continue;
        }
        float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const bool present[3] = {p.bias != nullptr, p.skip != nullptr, p.skip2 != nullptr};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          if (!present[a]) continue;
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&add[q][a]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(h[k]);
            v[2 * k] += f.x;
            v[2 * k + 1] += f.y;
          }
        }
        uint4 u;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        *reinterpret_cast<uint4*>(p.out + o[q]) = u;
      }
    }
  }
}

// Split K: out = sum of the splits' f32 partials + bias + skip + skip2, one
// rounding. Each thread takes 8 channels of one pixel (Cout % 8 == 0).
__global__ void __launch_bounds__(256)
conv3x3_splitk_reduce(const float* __restrict__ partial, int splits, long long split_stride,
                      const bf16* __restrict__ bias, const bf16* __restrict__ skip,
                      const bf16* __restrict__ skip2, bf16* __restrict__ out, int Cout) {
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (e >= split_stride) return;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    const float4* src = reinterpret_cast<const float4*>(partial + s * split_stride + e);
    const float4 lo = src[0], hi = src[1];
    v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
    v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
  }
  const bf16* adds[3] = {bias ? bias + e % Cout : nullptr, skip ? skip + e : nullptr,
                         skip2 ? skip2 + e : nullptr};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (!adds[a]) continue;
    const uint4 u = *reinterpret_cast<const uint4*>(adds[a]);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      v[2 * q] += f.x;
      v[2 * q + 1] += f.y;
    }
  }
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  *reinterpret_cast<uint4*>(out + e) = u;
}

template <int TN, bool RELU>
int launch_tc(const CUtensorMap& xmap, const CUtensorMap& wmap, const TcArgs& a, dim3 grid,
              cudaStream_t stream) {
  // set on every launch: the attribute belongs to the current device
  const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<TN, RELU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TcCfg<TN>::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  conv3x3_wgmma_kernel<TN, RELU><<<grid, TC_THREADS, TcCfg<TN>::SMEM, stream>>>(xmap, wmap, a);
  return static_cast<int>(cudaGetLastError());
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


// bf16 on tensor cores. The band (Wt x R), the N tile (bn) and the K split
// come from the wrapper's plan (ops/conv3x3.py: plan), which this only
// checks; workspace holds splits x B*H*W*Cout floats when splits > 1.
int launch_bf16(const void* x, const void* w, const void* bias, const void* skip,
                const void* skip2, void* out, float* workspace, int B, int H, int W, int Cin,
                int Cout, int relu_in, int Wt, int R, int bn, int splits, cudaStream_t stream) {
  if (Cin % 8 || Cout % 8 || Wt * R != TC_BM || Wt > 256 || R > 256 || (bn != 128 && bn != 256) ||
      splits < 1 || (splits > 1 && workspace == nullptr))
    return -4;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[4] = {(uint64_t)Cin, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t xstr[3] = {(uint64_t)Cin * 2, (uint64_t)W * Cin * 2, (uint64_t)H * W * Cin * 2};
  const uint32_t xbox[4] = {TC_BK, (uint32_t)Wt, (uint32_t)R, 1};
  int rc = make_map(&xmap, x, 4, xdims, xstr, xbox, 128);
  if (rc) return rc;
  const uint64_t wdims[3] = {(uint64_t)Cout, (uint64_t)Cin, 9};
  const uint64_t wstr[2] = {(uint64_t)Cout * 2, (uint64_t)Cin * Cout * 2};
  const uint32_t wbox[3] = {64, TC_BK, 1};
  rc = make_map(&wmap, w, 3, wdims, wstr, wbox, 128);
  if (rc) return rc;

  TcArgs a;
  a.bias = static_cast<const bf16*>(bias);
  a.skip = static_cast<const bf16*>(skip);
  a.skip2 = static_cast<const bf16*>(skip2);
  a.out = static_cast<bf16*>(out);
  a.partial = splits > 1 ? workspace : nullptr;
  a.H = H;
  a.W = W;
  a.Cout = Cout;
  a.Wt = Wt;
  a.R = R;
  a.tiles_x = (W + Wt - 1) / Wt;
  a.tiles_y = (H + R - 1) / R;
  a.cchunks = (Cin + TC_BK - 1) / TC_BK;
  const int steps = 9 * a.cchunks;
  a.steps_per_split = (steps + splits - 1) / splits;
  if ((steps + a.steps_per_split - 1) / a.steps_per_split != splits) return -4;  // an empty split
  a.split_stride = (long long)B * H * W * Cout;
  const dim3 grid((unsigned)(B * a.tiles_y * a.tiles_x), (unsigned)((Cout + bn - 1) / bn),
                  (unsigned)splits);
  if (bn == 256)
    rc = relu_in ? launch_tc<256, true>(xmap, wmap, a, grid, stream)
                 : launch_tc<256, false>(xmap, wmap, a, grid, stream);
  else
    rc = relu_in ? launch_tc<128, true>(xmap, wmap, a, grid, stream)
                 : launch_tc<128, false>(xmap, wmap, a, grid, stream);
  if (rc || splits == 1) return rc;
  const long long vecs = a.split_stride / 8;
  conv3x3_splitk_reduce<<<(unsigned)((vecs + 255) / 256), 256, 0, stream>>>(
      workspace, splits, a.split_stride, a.bias, a.skip, a.skip2, a.out, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias, skip and skip2 may be null. The
// bf16 path takes its band (Wt x R pixels, Wt * R = 128), N tile (128 or
// 256) and K split from the caller, and a workspace of splits * B*H*W*Cout
// floats when splits > 1; the f32 path ignores them. Returns
// cudaGetLastError() after the launch, or a negative code for arguments the
// kernel does not take.
extern "C" int me_conv3x3(const void* x, const void* w, const void* bias, const void* skip,
                          const void* skip2, void* out, void* workspace, int B, int H, int W,
                          int Cin, int Cout, int relu_in, int dtype, int Wt, int R, int bn,
                          int splits, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(x, w, bias, skip, skip2, out, B, H, W, Cin, Cout, relu_in, st);
  if (dtype == 1)
    return launch_bf16(x, w, bias, skip, skip2, out, static_cast<float*>(workspace), B, H, W,
                       Cin, Cout, relu_in, Wt, R, bn, splits, st);
  return -3;
}

// Dynamic shared memory of one bf16 launch with N tile bn (for reports).
extern "C" int me_conv3x3_smem_bytes(int bn) {
  return bn == 256 ? TcCfg<256>::SMEM : TcCfg<128>::SMEM;
}
