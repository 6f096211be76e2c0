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
// Cin, as the TPU kernel's row band does with 9 shifted matmuls. Cin and
// Cout are multiples of 8, so every TMA stride is a multiple of 16 bytes
// (the wrapper pads other counts). Every dtype shares the band, the ring,
// the epilogue and the K split:
//
// * bf16 and f16 (one template: the two types share the m64nNk16 wgmma
//   shapes and fragment layouts, hopper.cuh Half16): a block computes a band of 128 output pixels (R rows x Wt
//   columns of one image) by BN = 128 or 256 output channels. One producer
//   warp issues, per K step (one tap, 64 input channels), one TMA box (64
//   ch, Wt, R, 1) of x at (c0, x0 + dv - 1, y0 + du - 1, b) and BN / 64
//   boxes of the HWIO weight viewed as (Cout, Cin, 9). TMA fills
//   coordinates outside the image with zeros, which is the conv's padding:
//   no bounds checks. Both land with a 128-byte swizzle in a ring of stages
//   guarded by mbarriers. The weight tile is used as it lies (N
//   contiguous): an MN-major B operand, read through wgmma's transpose bit,
//   so nothing is transposed in shared memory. Two consumer warpgroups each
//   own 64 of the pixels and issue wgmma m64nBNk16 with A from registers:
//   ldmatrix from the swizzled stage, then relu_in as one __hmax2 per
//   register (a pair of bf16 or f16). The register form was chosen over an
//   in-place ReLU pass over the stage because it reads the tile once,
//   writes nothing back and needs no extra barrier; both ReLU settings take
//   it, so there is one code path.
// * f32 (--dtype f32): tensor cores at f32 accuracy, 3xTF32. Every operand
//   is split as v = big + small, big = tf32(v), small = tf32(v - big), and
//   every product is small*big + big*small + big*big, three wgmma
//   m64n128k8.tf32: about 21 mantissa bits a product where one TF32 product
//   keeps 11 (tests/test_torch_tf32.py emulates it up to K = 9216). A K
//   step is one tap x 32 input channels, a 128-byte swizzle row of f32 as
//   64 channels are of a 16-bit type: a stage is 16 KB of x and 2 x 128 x 128 bytes
//   of weight, four stages (16-channel steps in eight 24 KB stages were
//   slower at every f32 shape of the forward). x arrives raw by TMA and is
//   split in registers after ldmatrix, relu_in first: a pre-pass over x
//   would move more bytes than the whole conv. wgmma takes .tf32 operands
//   K-major only, and the HWIO weight has Cout contiguous, so a pre-pass
//   (conv3x3_split_weights) writes the weight once per call as
//   [big | small] x (9, Cout, Cin) into the caller's workspace, and one
//   4-D TMA box brings both halves of a stage. The tensor cores round each wgmma's sum toward zero; over a
//   whole K that bias passed atol 1e-5 at 768^2 x 256 -> 256, so each K
//   step sums into a fresh accumulator that is added to the running one in
//   registers, rounded to nearest. Both accumulators fit at 128 output
//   channels, not at 256: BN is 128, and a band's two N tiles of Cout = 256
//   are neighbours in the grid, so the second read of x comes from L2. What
//   bounds it: three TF32 products at 495 TFLOP/s, 4.2 ms at the hot shape
//   against 0.72 ms of f32 traffic.
//
// The epilogue stages the f32 tile in shared memory and walks it with
// 16-byte vectors: bias, skip and skip2 added in f32, one rounding to the
// output type, coalesced residual reads and output writes, each thread's
// loads issued four vectors at a time so their latencies overlap (the
// residuals are 2 x 302 MB of the bf16 hot shape's 1.21 GB, and one block
// per SM leaves nothing else to hide them behind). Grids that cannot fill
// the card (the 48^2 and 96^2 projections, K = 9216) split K across blocks,
// each writing an f32 partial that a second pass sums with the bias and
// residuals (the wrapper plans the split).

#include "hopper.cuh"

#include <stddef.h>

#include <type_traits>

namespace {

using namespace hopper;

constexpr int TC_BM = 128;       // output pixels per block: two warpgroups x 64
constexpr int TC_BK = 64;        // bf16/f16 input channels per K step: one 128-byte swizzle row
constexpr int TF_BK = 32;        // f32 input channels per K step: one 128-byte swizzle row
constexpr int TF_BN = 128;       // f32 output channels per block
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

struct Tf32Cfg {
  static constexpr int ROW = TF_BK * 4;        // bytes of one pixel's or channel's K step
  static constexpr int A_BYTES = TC_BM * ROW;  // 16 KB
  static constexpr int B_HALF = TF_BN * ROW;   // one TF32 half of the weight tile, 16 KB
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_HALF;
  static constexpr int STAGES = 4;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int EPI_LD = TF_BN + 8;
  static constexpr int SMEM = 1024 + RING_BYTES + 2 * STAGES * 8;
  static_assert(TC_BM * EPI_LD * 4 <= RING_BYTES, "epilogue staging reuses the ring");
  static_assert(SMEM <= 232448, "the ring fits one block per SM");
};

// 16 bytes of the output type, read into and written from f32: eight bf16
// or f16 values, or four f32.
template <typename T>
struct Vec {
  using H = Half16<T>;
  static constexpr int N = 8;
  static __device__ __forceinline__ void add(float (&v)[8], const uint4& u) {
    const typename H::T2* h = reinterpret_cast<const typename H::T2*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = H::unpack(h[k]);
      v[2 * k] += f.x;
      v[2 * k + 1] += f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[8]) {
    uint4 u;
    typename H::T2* h = reinterpret_cast<typename H::T2*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = H::pack(v[2 * k], v[2 * k + 1]);
    return u;
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void add(float (&v)[4], const uint4& u) {
    v[0] += __uint_as_float(u.x);
    v[1] += __uint_as_float(u.y);
    v[2] += __uint_as_float(u.z);
    v[3] += __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <typename T>
struct TcArgs {
  const T* bias;   // (Cout,) or null
  const T* skip;   // (B, H, W, Cout) or null
  const T* skip2;  // (B, H, W, Cout) or null
  T* out;          // (B, H, W, Cout); unused when partial is set
  float* partial;  // split K: (splits, B, H, W, Cout) f32, else null
  int H, W, Cout;
  int Wt, R;                  // the pixel band: R rows x Wt columns, R * Wt = TC_BM
  int tiles_x, tiles_y;       // bands per row of bands, rows of bands per image
  int cchunks;                // K steps per tap: ceil(Cin / channels per step)
  int steps_per_split;        // K steps per blockIdx.z
  long long split_stride;     // elements between two splits' partials
};

// The block's place: (b, y0, x0) of its band, n0 of its N tile and its K
// steps. The N tiles of one band are neighbours in blockIdx.x, so the
// second read of the band's x comes from L2.
struct Tile {
  int b, y0, x0, n0, k_begin, k_end;
};

template <typename T>
__device__ __forceinline__ Tile block_tile(const TcArgs<T>& p, int tn) {
  Tile t;
  const int n_tiles = (p.Cout + tn - 1) / tn;
  t.n0 = (blockIdx.x % n_tiles) * tn;
  int mt = blockIdx.x / n_tiles;
  t.x0 = (mt % p.tiles_x) * p.Wt;
  mt /= p.tiles_x;
  t.y0 = (mt % p.tiles_y) * p.R;
  t.b = mt / p.tiles_y;
  t.k_begin = blockIdx.z * p.steps_per_split;
  t.k_end = min(9 * p.cchunks, t.k_begin + p.steps_per_split);
  return t;
}

// The consumers' epilogue (both warpgroups, after their last K step): the
// accumulators staged in shared memory over the drained ring, then 256
// threads walk the tile in 16-byte vectors of T, a group of GROUP vectors
// at a time, so that every residual and bias load of a group is in flight
// before the first is used. Split K writes the f32 sums instead.
template <typename T, int TN, int EPI_LD>
__device__ __forceinline__ void epilogue(uint8_t* smem, const float (&acc)[TN / 2],
                                         const TcArgs<T>& p, const Tile& tile) {
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  named_barrier(1, 256);  // both warpgroups are past the ring before it is reused
  float* stage = reinterpret_cast<float*>(smem);
  {
    const int g = lane / 4, t = lane % 4;
    const int r0 = wg * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int c = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(&stage[r0 * EPI_LD + c]) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(&stage[(r0 + 8) * EPI_LD + c]) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  named_barrier(1, 256);
  constexpr int V = Vec<T>::N;  // channels per 16-byte vector
  constexpr int VPR = TN / V;   // vectors per pixel
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
      c[q] = (e % VPR) * V;
      const int yy = tile.y0 + r[q] / p.Wt;
      const int xx = tile.x0 + r[q] % p.Wt;
      const int n = tile.n0 + c[q];
      ok[q] = yy < p.H && xx < p.W && n < p.Cout;
      o[q] = ok[q] ? (((size_t)tile.b * p.H + yy) * p.W + xx) * p.Cout + n : 0;
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
      float v[V];
#pragma unroll
      for (int j = 0; j < V / 4; ++j) {
        const float4 f = *reinterpret_cast<const float4*>(&stage[r[q] * EPI_LD + c[q] + 4 * j]);
        v[4 * j] = f.x;
        v[4 * j + 1] = f.y;
        v[4 * j + 2] = f.z;
        v[4 * j + 3] = f.w;
      }
      if (p.partial) {
        float4* dst = reinterpret_cast<float4*>(p.partial + blockIdx.z * p.split_stride + o[q]);
#pragma unroll
        for (int j = 0; j < V / 4; ++j)
          dst[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
        continue;
      }
      if (p.bias) Vec<T>::add(v, add[q][0]);
      if (p.skip) Vec<T>::add(v, add[q][1]);
      if (p.skip2) Vec<T>::add(v, add[q][2]);
      *reinterpret_cast<uint4*>(p.out + o[q]) = Vec<T>::pack(v);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16 (T): TMA + mbarrier ring + wgmma.

template <typename T, int TN, bool RELU>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const TcArgs<T> p) {
  using C = TcCfg<TN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::RING_BYTES);
  uint64_t* empty = full + C::STAGES;
  const Tile tile = block_tile(p, TN);

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
      for (int k = tile.k_begin, i = 0; k < tile.k_end; ++k, ++i) {
        const int s = i % C::STAGES;
        mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
        uint8_t* a = smem + s * C::STAGE_BYTES;
        const int tap = k / p.cchunks;
        const int c0 = (k - tap * p.cchunks) * TC_BK;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_4d(a, &xmap, &full[s], c0, tile.x0 + tap % 3 - 1, tile.y0 + tap / 3 - 1,
                    tile.b);
#pragma unroll
        for (int j = 0; j < TN / 64; ++j)
          tma_load_3d(a + C::A_BYTES + j * 8192, &wmap, &full[s], tile.n0 + 64 * j, c0, tap);
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

    for (int k = tile.k_begin, i = 0; k < tile.k_end; ++k, ++i) {
      const int s = i % C::STAGES;
      mbar_wait(&full[s], (i / C::STAGES) & 1);
      const uint32_t a_tile = ring + s * C::STAGE_BYTES;
      uint32_t af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(af[kk], a_tile + swizzle<128>(row_off + (2 * kk + lane / 16) * 16));
      if (RELU) {
        using T2 = typename Half16<T>::T2;
        const T2 zero = Half16<T>::pack(0.f, 0.f);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            T2 v = *reinterpret_cast<T2*>(&af[kk][r]);
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
          wgmma_m64n256k16_rs<T>(acc, af[kk], d, 1);
        else
          wgmma_m64n128k16_rs<T>(acc, af[kk], d, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(af[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    epilogue<T, TN, C::EPI_LD>(smem, acc, p, tile);
  }
}

// ---------------------------------------------------------------------------
// f32: the weight pre-pass, then TMA + mbarrier ring + 3xTF32 wgmma.

// The HWIO weight (9, Cin, Cout) to its TF32 halves, K-major:
// out = [big | small] x (9, Cout, Cin), through a 32 x 32 tile in shared
// memory (coalesced reads along Cout, writes along Cin). Grid
// (ceil(Cout / 32), ceil(Cin / 32), 9), 256 threads.
__global__ void __launch_bounds__(256)
conv3x3_split_weights(const float* __restrict__ w, float* __restrict__ out, int Cin, int Cout) {
  __shared__ float t[32][33];
  const int tap = blockIdx.z;
  const int ci0 = blockIdx.y * 32, co0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float* src = w + (size_t)tap * Cin * Cout;
  for (int i = ty; i < 32; i += 8) {
    const int ci = ci0 + i, co = co0 + tx;
    t[i][tx] = ci < Cin && co < Cout ? src[(size_t)ci * Cout + co] : 0.f;
  }
  __syncthreads();
  const size_t half = (size_t)9 * Cout * Cin;
  for (int i = ty; i < 32; i += 8) {
    const int co = co0 + i, ci = ci0 + tx;
    if (co < Cout && ci < Cin) {
      const float v = t[tx][i];
      const float big = __uint_as_float(tf32_rna(v));
      const size_t o = ((size_t)tap * Cout + co) * Cin + ci;
      out[o] = big;
      out[half + o] = __uint_as_float(tf32_rna(v - big));
    }
  }
}

template <bool RELU>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv3x3_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const TcArgs<float> p) {
  using C = Tf32Cfg;
  constexpr int KK = TF_BK / 8;  // k8 steps per K step
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::RING_BYTES);
  uint64_t* empty = full + C::STAGES;
  const Tile tile = block_tile(p, TF_BN);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread keeps the ring full; a stage is one box
    // of raw x and one box of both weight halves (Cin, Cout, tap, half)
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      for (int k = tile.k_begin, i = 0; k < tile.k_end; ++k, ++i) {
        const int s = i % C::STAGES;
        mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
        uint8_t* a = smem + s * C::STAGE_BYTES;
        const int tap = k / p.cchunks;
        const int c0 = (k - tap * p.cchunks) * TF_BK;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_4d(a, &xmap, &full[s], c0, tile.x0 + tap % 3 - 1, tile.y0 + tap / 3 - 1,
                    tile.b);
        tma_load_4d(a + C::A_BYTES, &wmap, &full[s], c0, tile.n0, tap, 0);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;

    // The tensor cores round each wgmma's sum toward zero, a bias that
    // grows with the number of accumulations (past the f32 tolerance after
    // the 9 x 256 / 8 x 3 of K = 2304). So each K step sums into `part`,
    // which starts at zero, and is added to `acc` in f32 registers, rounded
    // to nearest.
    float acc[TF_BN / 2], part[TF_BN / 2];
#pragma unroll
    for (int i = 0; i < TF_BN / 2; ++i) acc[i] = 0.f;

    // ldmatrix over f32: lane l addresses pixel row (l % 16) of this warp's
    // 16 and the 16-byte chunk (2 kk + l / 16) of the 128-byte row, which
    // gives the TF32 A fragment of k8 step kk (hopper.cuh)
    const uint32_t row_off = (uint32_t)(wg * 64 + warp * 16 + lane % 16) * C::ROW;
    const uint32_t ring = smem_u32(smem);

    for (int k = tile.k_begin, i = 0; k < tile.k_end; ++k, ++i) {
      const int s = i % C::STAGES;
      mbar_wait(&full[s], (i / C::STAGES) & 1);
      const uint32_t a_tile = ring + s * C::STAGE_BYTES;
      uint32_t big[KK][4], small[KK][4];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
        ldmatrix_x4(big[kk], a_tile + swizzle<C::ROW>(row_off + (2 * kk + lane / 16) * 16));
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v = __uint_as_float(big[kk][r]);
          if (RELU) v = fmaxf(v, 0.f);
          big[kk][r] = tf32_rna(v);
          small[kk][r] = tf32_rna(v - __uint_as_float(big[kk][r]));
        }
      // B: TF_BN rows (output channels) of 128 bytes, K-major, 8-row
      // groups 1024 bytes apart; the small half follows the big one
      const uint8_t* b_tile = smem + s * C::STAGE_BYTES + C::A_BYTES;
      const uint64_t wb = make_desc<C::ROW>(b_tile, 16, 8 * C::ROW);
      const uint64_t ws = make_desc<C::ROW>(b_tile + C::B_HALF, 16, 8 * C::ROW);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const uint64_t off = (uint64_t)((kk * 32) >> 4);
        wgmma_m64n128k8_rs(part, small[kk], wb + off, kk > 0);
        wgmma_m64n128k8_rs(part, big[kk], ws + off, 1);
        wgmma_m64n128k8_rs(part, big[kk], wb + off, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        fence_regs(big[kk]);
        fence_regs(small[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < TF_BN / 2; ++j) acc[j] += part[j];
    }
    epilogue<float, TF_BN, C::EPI_LD>(smem, acc, p, tile);
  }
}

// ---------------------------------------------------------------------------

// Split K: out = sum of the splits' f32 partials + bias + skip + skip2, one
// rounding. Each thread takes one 16-byte vector of T (Cout % 8 == 0).
template <typename T>
__global__ void __launch_bounds__(256)
conv3x3_splitk_reduce(const float* __restrict__ partial, int splits, long long split_stride,
                      const T* __restrict__ bias, const T* __restrict__ skip,
                      const T* __restrict__ skip2, T* __restrict__ out, int Cout) {
  constexpr int V = Vec<T>::N;
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (e >= split_stride) return;
  float v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float4* src = reinterpret_cast<const float4*>(partial + s * split_stride + e);
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const float4 f = src[j];
      v[4 * j] += f.x;
      v[4 * j + 1] += f.y;
      v[4 * j + 2] += f.z;
      v[4 * j + 3] += f.w;
    }
  }
  const T* adds[3] = {bias ? bias + e % Cout : nullptr, skip ? skip + e : nullptr,
                      skip2 ? skip2 + e : nullptr};
#pragma unroll
  for (int a = 0; a < 3; ++a)
    if (adds[a]) Vec<T>::add(v, *reinterpret_cast<const uint4*>(adds[a]));
  *reinterpret_cast<uint4*>(out + e) = Vec<T>::pack(v);
}

template <typename Kernel, typename T>
int launch_ring(Kernel kernel, int smem, const CUtensorMap& xmap, const CUtensorMap& wmap,
                const TcArgs<T>& a, dim3 grid, cudaStream_t stream) {
  // set on every launch: the attribute belongs to the current device
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, TC_THREADS, smem, stream>>>(xmap, wmap, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TN>
int launch_16(const CUtensorMap& xmap, const CUtensorMap& wmap, const TcArgs<T>& a,
              dim3 grid, bool relu_in, cudaStream_t stream) {
  return relu_in ? launch_ring(conv3x3_wgmma_kernel<T, TN, true>, TcCfg<TN>::SMEM, xmap, wmap,
                               a, grid, stream)
                 : launch_ring(conv3x3_wgmma_kernel<T, TN, false>, TcCfg<TN>::SMEM, xmap, wmap,
                               a, grid, stream);
}

// Floats of workspace one call needs: the split weights (f32) first, then
// the split K's partials (splits > 1).
long long workspace_floats(int B, int H, int W, int Cin, int Cout, bool f32, int splits) {
  return (f32 ? 18LL * Cin * Cout : 0) + (splits > 1 ? (long long)splits * B * H * W * Cout : 0);
}

// The band (Wt x R), the N tile (bn: 128 or 256 for bf16 and f16, TF_BN for f32)
// and the K split come from the wrapper's plan (ops/conv3x3.py: plan),
// which this only checks.
template <typename T>
int launch(const void* x, const void* w, const void* bias, const void* skip, const void* skip2,
           void* out, float* workspace, int B, int H, int W, int Cin, int Cout, int relu_in,
           int Wt, int R, int bn, int splits, cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int KC = F32 ? TF_BK : TC_BK;  // input channels per K step
  constexpr int E = sizeof(T);
  if (Cin % 8 || Cout % 8 || Wt * R != TC_BM || Wt > 256 || R > 256 ||
      (F32 ? bn != TF_BN : bn != 128 && bn != 256) || splits < 1 ||
      (workspace == nullptr && workspace_floats(B, H, W, Cin, Cout, F32, splits) > 0))
    return -4;
  CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if constexpr (!F32) type = Half16<T>::kMapType;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[4] = {(uint64_t)Cin, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t xstr[3] = {(uint64_t)Cin * E, (uint64_t)W * Cin * E, (uint64_t)H * W * Cin * E};
  const uint32_t xbox[4] = {KC, (uint32_t)Wt, (uint32_t)R, 1};
  int rc = make_map(&xmap, x, 4, xdims, xstr, xbox, KC * E, type);
  if (rc) return rc;
  float* partial = workspace;
  if constexpr (F32) {
    float* wsplit = workspace;
    partial = workspace + 18LL * Cin * Cout;
    conv3x3_split_weights<<<dim3((Cout + 31) / 32, (Cin + 31) / 32, 9), 256, 0, stream>>>(
        static_cast<const float*>(w), wsplit, Cin, Cout);
    rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    const uint64_t wdims[4] = {(uint64_t)Cin, (uint64_t)Cout, 9, 2};
    const uint64_t wstr[3] = {(uint64_t)Cin * 4, (uint64_t)Cout * Cin * 4,
                              9ULL * Cout * Cin * 4};
    const uint32_t wbox[4] = {TF_BK, (uint32_t)bn, 1, 2};
    rc = make_map(&wmap, wsplit, 4, wdims, wstr, wbox, TF_BK * 4, type);
  } else {
    const uint64_t wdims[3] = {(uint64_t)Cout, (uint64_t)Cin, 9};
    const uint64_t wstr[2] = {(uint64_t)Cout * 2, (uint64_t)Cin * Cout * 2};
    const uint32_t wbox[3] = {64, TC_BK, 1};
    rc = make_map(&wmap, w, 3, wdims, wstr, wbox, 128, type);
  }
  if (rc) return rc;

  TcArgs<T> a;
  a.bias = static_cast<const T*>(bias);
  a.skip = static_cast<const T*>(skip);
  a.skip2 = static_cast<const T*>(skip2);
  a.out = static_cast<T*>(out);
  a.partial = splits > 1 ? partial : nullptr;
  a.H = H;
  a.W = W;
  a.Cout = Cout;
  a.Wt = Wt;
  a.R = R;
  a.tiles_x = (W + Wt - 1) / Wt;
  a.tiles_y = (H + R - 1) / R;
  a.cchunks = (Cin + KC - 1) / KC;
  const int steps = 9 * a.cchunks;
  a.steps_per_split = (steps + splits - 1) / splits;
  if ((steps + a.steps_per_split - 1) / a.steps_per_split != splits) return -4;  // an empty split
  a.split_stride = (long long)B * H * W * Cout;
  const dim3 grid((unsigned)(B * a.tiles_y * a.tiles_x * ((Cout + bn - 1) / bn)), 1,
                  (unsigned)splits);
  if constexpr (F32)
    rc = relu_in ? launch_ring(conv3x3_tf32_kernel<true>, Tf32Cfg::SMEM, xmap, wmap, a, grid,
                               stream)
                 : launch_ring(conv3x3_tf32_kernel<false>, Tf32Cfg::SMEM, xmap, wmap, a, grid,
                               stream);
  else
    rc = bn == 256 ? launch_16<T, 256>(xmap, wmap, a, grid, relu_in != 0, stream)
                   : launch_16<T, 128>(xmap, wmap, a, grid, relu_in != 0, stream);
  if (rc || splits == 1) return rc;
  const long long vecs = a.split_stride / Vec<T>::N;
  conv3x3_splitk_reduce<T><<<(unsigned)((vecs + 255) / 256), 256, 0, stream>>>(
      partial, splits, a.split_stride, a.bias, a.skip, a.skip2, a.out, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. bias, skip and skip2 may be null. The
// band (Wt x R pixels, Wt * R = 128), the N tile (128 or 256) and the K
// split come from the caller, with a workspace of
// me_conv3x3_workspace_floats floats (null when that is 0). Returns
// cudaGetLastError() after the launches, or a negative code for arguments
// the kernels do not take.
extern "C" int me_conv3x3(const void* x, const void* w, const void* bias, const void* skip,
                          const void* skip2, void* out, void* workspace, int B, int H, int W,
                          int Cin, int Cout, int relu_in, int dtype, int Wt, int R, int bn,
                          int splits, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0)
    return launch<float>(x, w, bias, skip, skip2, out, ws, B, H, W, Cin, Cout, relu_in, Wt, R, bn,
                         splits, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, bias, skip, skip2, out, ws, B, H, W, Cin, Cout, relu_in,
                                 Wt, R, bn, splits, st);
  if (dtype == 2)
    return launch<__half>(x, w, bias, skip, skip2, out, ws, B, H, W, Cin, Cout, relu_in, Wt, R,
                          bn, splits, st);
  return -3;
}

// Floats of device workspace one call needs: f32's split weights
// (2 x 9 x Cin x Cout) and, for splits > 1, the partial sums.
extern "C" long long me_conv3x3_workspace_floats(int B, int H, int W, int Cin, int Cout,
                                                 int dtype, int splits) {
  return workspace_floats(B, H, W, Cin, Cout, dtype == 0, splits);
}

// Dynamic shared memory of one launch with N tile bn (for reports); bf16 and
// f16 (dtype 1, 2) share their rings.
extern "C" int me_conv3x3_smem_bytes(int bn, int dtype) {
  if (dtype == 0) return Tf32Cfg::SMEM;
  return bn == 256 ? TcCfg<256>::SMEM : TcCfg<128>::SMEM;
}
