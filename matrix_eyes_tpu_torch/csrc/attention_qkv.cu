// Multi-head attention for Hopper (sm_90a), FlashAttention style.
//
// Replaces two TPU kernels of matrix_eyes_tpu/ops/flash_attention.py with
// one device code and two entries:
//
// * me_attention_qkv: attention_flash_qkv (_attention_qkv_kernel, helpers
//   _qk_log2 and _softmax_pv). q, k and v are strided column ranges of the
//   (B, N, 3C) qkv projection ([q|k|v] x head x dim) and the output is
//   (B, N, C) token-major: no transposes around the kernel.
// * me_attention_bhnd: attention_flash (_attention_kernel), separate
//   (B, H, N, D) q, k, v and o, each with its own batch, head and token
//   strides (the head dim has unit stride).
//
// For every (batch, head) both compute softmax(q k^T * scale) v; the
// kernels address q, k, v and o only through the strides of Attn.
//
// What bounds it on this card: at the Depth Pro shapes (B = 35, N = 577,
// H = 16, D = 64) the plain version writes and re-reads the (B, H, N, N)
// f32 score tensor, 745 MB per layer, so it is bound by device memory
// bytes. This kernel keeps scores on chip: its device-memory traffic is one
// read of q, k, v and one write of o (165 MB), and the matrix math (4 N^2 D
// FLOPs per head, 47.7 GFLOP) takes as long at the bf16 peak; the softmax's
// exp2 on the SFU (N^2 per head) comes close.
//
// Every path runs an online softmax in the log2 domain (scores scaled by
// scale*log2(e) in f32, exp2, as _qk_log2 does) with f32 running max and
// sum per query row. Keys >= n_valid score -1e30 (not -inf), so ragged
// rows never poison valid ones; rows >= N are never read. Three paths:
//
// * bf16 and f16 with D in {32, 64}: TMA + mbarriers + wgmma (one template;
//   the two types share the m64nNk16 shapes and fragment layouts, hopper.cuh
//   Half16). A block serves one
//   (batch, head) and a run of its 64-row query tiles, with four consumer
//   warpgroups (three when K and V stream) taking tiles in turn, a round
//   of tiles at a time. Where the head's K and V fit in shared
//   memory beside the q tiles (n_valid rows, rounded up to 64: up to 640
//   keys at D = 64, 1536 at D = 32), they are loaded once per block by TMA,
//   one mbarrier per 64-key tile so the math starts on the first tile while
//   the rest land, and stay for all of the block's query tiles (2 x 80 KB at
//   N = 577, D = 64). Longer heads stream K and V through a ring of
//   KV_STAGES tiles that a producer warp refills once per round of query
//   tiles (the warpgroups' full/empty mbarriers pace it), so any N runs.
//   The tensor maps view q, k, v and o as (D, N, H, B)
//   through their strides, so rows >= N read as zeros and a box never
//   crosses into the next batch. Each warpgroup double-buffers its q tiles
//   (the next tile's load overlaps this one's math). S = q k^T is a wgmma
//   with both operands K-major in shared memory; P stays in registers (the
//   S accumulator's layout is the A-fragment layout), is rounded to the
//   input type (bf16 or f16),
//   and O += P V is a wgmma with A from registers and V as it lies, an
//   MN-major B operand read through the transpose bit. S of key tile j + 1
//   and P V of tile j are in flight together, and tile j + 1's softmax
//   (ex2.approx, the scale folded into one FFMA) runs while P V finishes.
//   The output tile is written over the q tile it came from and stored by
//   TMA, which clips rows >= N. Small grids (the B = 1 image ViT: 16 heads) give each block
//   fewer query tiles so the card fills; the 577th row costs one tile of
//   one warpgroup, not a block.
// * f32 with D in {32, 64} (the FOV ViT under every dtype, everything
//   under --dtype f32): tensor cores at f32 accuracy, 3xTF32. Every operand
//   is split as x = big + small, big = tf32(x), small = tf32(x - big), and
//   every product is small*big + big*small + big*big, three wgmma
//   m64nNk8.tf32 into one f32 accumulator: about 21 mantissa bits a
//   product, where one TF32 product keeps 11. A pre-pass
//   (split_tf32_kernel) reads q, k and v once through the entry's strides
//   and writes the split operands into a scratch buffer the wrapper
//   allocates (me_attention_scratch_floats): q and k as 32-column panels
//   (a 256-byte f32 row at D = 64 is past the 128-byte swizzle span), and
//   V transposed, (D, keys), because wgmma takes .tf32 operands K-major
//   only. P goes in from registers; the accumulator holds keys 2t, 2t + 1
//   of each 8-key group where the TF32 A fragment wants t, t + 4, so the
//   pre-pass stores each 8-key group of V^T as keys 0 2 4 6 1 3 5 7 and P
//   needs no shuffle. A block holds two consumer warpgroups, one 64-row
//   query tile each, and a producer warp that streams 64-key K and V tiles
//   (big and small, 32 KB each at D = 64) through two-slot rings of their
//   own: K's slot frees when S is done, V's when P V is done, so each load
//   has a whole key tile's math to land. S of tile j + 1 and P V of tile j
//   are in flight together, as on the bf16 path. 192 KB of shared memory:
//   one block per SM, the two query tiles sharing each K/V tile. What
//   bounds it: 3 x 4 N^2 D FLOPs per head at 495 TFLOP/s (TF32 dense),
//   0.0083 ms at the FOV shape, against 0.0204 ms for one f32 product on
//   CUDA cores; the pre-pass moves 3 x the input's bytes (read once, two
//   halves written).
// * D = 8 (TINY), every dtype: FP32 CUDA cores, one thread per query row
//   holding its q row and output accumulator; 8 is narrower than one
//   16-bit wgmma k-step and a 32-column panel.

#include <math.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half(v); }

// Pointers and element strides of one call. Row n of head h of batch b of
// q starts at q + b * q_b + h * q_h + n * q_n; likewise k, v and o.
template <typename T>
struct Attn {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  long long q_b, q_h, q_n, k_b, k_h, k_n, v_b, v_h, v_n, o_b, o_h, o_n;
  int N, n_valid;
  float scale_log2;
};

// ---------------------------------------------------------------------------
// CUDA-core path: D = 8, f32, bf16 and f16.

constexpr int BM = 64;  // query rows per block, one thread each
constexpr int BN = 32;  // keys per shared-memory tile

template <typename T, int D>
__global__ void __launch_bounds__(BM)
attention_kernel(const Attn<T> a) {
  __shared__ __align__(16) float ks[BN][D];
  __shared__ __align__(16) float vs[BN][D];
  __shared__ float qo[BM][D + 1];  // +1: thread r reads row r without bank conflicts

  const int N = a.N, n_valid = a.n_valid;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const T* __restrict__ qbase = a.q + b * a.q_b + h * a.q_h;
  const T* __restrict__ kbase = a.k + b * a.k_b + h * a.k_h;
  const T* __restrict__ vbase = a.v + b * a.v_b + h * a.v_h;

  for (int e = tid; e < BM * D; e += BM) {
    const int r = e / D, d = e % D;
    const int m = m0 + r;
    qo[r][d] = m < N ? to_f32(qbase[m * a.q_n + d]) * a.scale_log2 : 0.f;
  }
  __syncthreads();

  float q[D], o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = qo[tid][d];
    o[d] = 0.f;
  }
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int j0 = 0; j0 < n_valid; j0 += BN) {
    for (int e = tid; e < BN * D; e += BM) {
      const int r = e / D, d = e % D;
      const int j = j0 + r;
      const bool ok = j < n_valid;
      ks[r][d] = ok ? to_f32(kbase[j * a.k_n + d]) : 0.f;
      vs[r][d] = ok ? to_f32(vbase[j * a.v_n + d]) : 0.f;
    }
    __syncthreads();

    float s[BN];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(q[d], ks[j][d], acc);
      s[j] = (j0 + j < n_valid) ? acc : -1e30f;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m_run, m_tile);
    const float alpha = exp2f(m_run - m_new);  // 0 on the first tile
    l_run *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float p = exp2f(s[j] - m_new);
      l_run += p;
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = fmaf(p, vs[j][d], o[d]);
    }
    m_run = m_new;
    __syncthreads();  // the next tile overwrites ks/vs
  }

  const float inv_l = 1.f / l_run;
#pragma unroll
  for (int d = 0; d < D; ++d) qo[tid][d] = o[d] * inv_l;
  __syncthreads();

  T* __restrict__ obase = a.o + b * a.o_b + h * a.o_h;
  for (int e = tid; e < BM * D; e += BM) {
    const int r = e / D, d = e % D;
    const int m = m0 + r;
    if (m < N) obase[m * a.o_n + d] = from_f32<T>(qo[r][d]);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16 and f16 (T), D in {32, 64}.

using namespace hopper;

constexpr int TC_ROWS = 64;  // query rows per tile, keys per K/V tile

constexpr int KV_STAGES = 8;  // the K/V ring of a head too long to keep whole

// RESIDENT: the head's K and V stay whole in shared memory, loaded once by
// thread 0, and four consumer warpgroups share them; else they stream
// through KV_STAGES slots, filled by a producer warp beside three consumer
// warpgroups (ptxas gives 4 x 128 + 32 threads only 96 registers, and the
// consumers need ~110).
template <int D, bool RESIDENT>
struct TcCfg {
  static constexpr int WGS = RESIDENT ? 4 : 3;  // consumer warpgroups per block
  static constexpr int THREADS = 128 * WGS + (RESIDENT ? 0 : 32);
  static constexpr int ROW_BYTES = 2 * D;                 // 128 or 64: the swizzle width
  static constexpr int TILE_BYTES = TC_ROWS * ROW_BYTES;  // one 64-row tile
  static constexpr int Q_BUFS = 2 * WGS;                  // two q tiles per warpgroup
  __host__ __device__ static constexpr int kv_slots(int key_tiles) {
    return RESIDENT ? key_tiles : KV_STAGES;
  }
  static constexpr int smem_bytes(int key_tiles) {
    const int kv = kv_slots(key_tiles);
    return 1024 + (2 * kv + Q_BUFS) * TILE_BYTES + ((RESIDENT ? 1 : 2) * kv + Q_BUFS) * 8;
  }
  static constexpr int MAX_SMEM = 232448;  // 227 KB per block
};
static_assert(TcCfg<64, false>::smem_bytes(0) <= TcCfg<64, false>::MAX_SMEM, "the ring fits");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online-softmax step for one 64-key tile held in s (raw q k^T, rows g and
// g + 8 of this warp's 16): masks keys >= n_valid at -1e30 in the scaled
// domain, updates the running max and sum, leaves p = 2^(s * scale - m) in
// s and the factor that rescales the earlier output in alpha.
__device__ __forceinline__ void softmax_tile(float (&s)[32], int key0, int n_valid, int t,
                                             float scale_log2, float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2]) {
  if (key0 + TC_ROWS > n_valid) {
    const float masked = -1e30f / scale_log2;  // -1e30 once scaled
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + 8 * n + 2 * t + (e & 1) >= n_valid) s[4 * n + e] = masked;
  }
  float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) m_tile[e >> 1] = fmaxf(m_tile[e >> 1], s[4 * n + e]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
    m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
    const float m_new = fmaxf(m_run[r], m_tile[r] * scale_log2);  // scale > 0
    alpha[r] = ex2(m_run[r] - m_new);  // 0 on the first tile
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * n + e], scale_log2, neg_m[e >> 1]));
      s[4 * n + e] = p;
      l_run[e >> 1] += p;
    }
}

template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&s)[32], const uint8_t* qb, const uint8_t* kt) {
  constexpr int RB = 2 * D;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss<T>(s, make_desc<RB>(qb + kk * 32, 16, 8 * RB),
                       make_desc<RB>(kt + kk * 32, 16, 8 * RB), kk > 0);
  wgmma_commit();
}

template <typename T, int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[4][4],
                                         const uint8_t* vt) {
  constexpr int RB = 2 * D;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv = make_desc<RB>(vt + kk * 16 * RB, 16, 8 * RB);
    if constexpr (D == 64)
      wgmma_m64n64k16_rs<T>(o, pa[kk], dv, 1);
    else
      wgmma_m64n32k16_rs<T>(o, pa[kk], dv, 1);
  }
  wgmma_commit();
}

// P (f32, accumulator layout) to T A fragments: k16 step kk covers keys
// 16kk..16kk+15, i.e. accumulator blocks 2kk and 2kk + 1.
template <typename T>
__device__ __forceinline__ void pack_p(const float (&s)[32], uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 2 * kk + half;
      pa[kk][2 * half] = pack2<T>(s[4 * n], s[4 * n + 1]);
      pa[kk][2 * half + 1] = pack2<T>(s[4 * n + 2], s[4 * n + 3]);
    }
}

template <typename T, int D, bool RESIDENT>
__global__ void __launch_bounds__(TcCfg<D, RESIDENT>::THREADS, 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap, int N, int n_valid,
                       float scale_log2, int tiles_per_block) {
  using C = TcCfg<D, RESIDENT>;
  constexpr int WGS = C::WGS;
  constexpr int RB = C::ROW_BYTES;
  constexpr int TILE = C::TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int key_tiles = (n_valid + TC_ROWS - 1) / TC_ROWS;
  const int kv = C::kv_slots(key_tiles);
  uint8_t* ks = smem;
  uint8_t* vs = ks + kv * TILE;
  uint8_t* qs = vs + kv * TILE;  // [warpgroup][buffer] q tiles, reused for o
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(qs + C::Q_BUFS * TILE);
  uint64_t* kvempty = kvfull + kv;                  // streaming only
  uint64_t* qbar = kvempty + (RESIDENT ? 0 : kv);  // [warpgroup][buffer]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_tiles = (N + TC_ROWS - 1) / TC_ROWS;
  const int first = blockIdx.x * tiles_per_block;
  const int last = min(q_tiles, first + tiles_per_block);
  const int rounds = (last - first + WGS - 1) / WGS;  // WGS query tiles per round
  const int wg = threadIdx.x / 128;
  const int wtid = threadIdx.x % 128;
  const int warp = wtid / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  if (threadIdx.x == 0) {
    for (int j = 0; j < kv; ++j) {
      mbar_init(&kvfull[j], 1);
      if (!RESIDENT) mbar_init(&kvempty[j], 4 * WGS);  // one arrival per consumer warp
    }
    for (int j = 0; j < C::Q_BUFS; ++j) mbar_init(&qbar[j], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if constexpr (RESIDENT) {
    if (threadIdx.x == 0) {
      for (int j = 0; j < key_tiles; ++j) {
        mbar_expect_tx(&kvfull[j], 2 * TILE);
        tma_load_4d(ks + j * TILE, &kmap, &kvfull[j], 0, j * TC_ROWS, h, b);
        tma_load_4d(vs + j * TILE, &vmap, &kvfull[j], 0, j * TC_ROWS, h, b);
      }
    }
  } else if (wg == WGS) {
    // producer warp: each round of query tiles reads every key tile, in
    // order, through the ring
    if (lane == 0) {
      for (int u = 0; u < rounds * key_tiles; ++u) {
        const int s = u % KV_STAGES, j = u % key_tiles;
        if (u >= KV_STAGES) mbar_wait(&kvempty[s], ((u / KV_STAGES) - 1) & 1);
        mbar_expect_tx(&kvfull[s], 2 * TILE);
        tma_load_4d(ks + s * TILE, &kmap, &kvfull[s], 0, j * TC_ROWS, h, b);
        tma_load_4d(vs + s * TILE, &vmap, &kvfull[s], 0, j * TC_ROWS, h, b);
      }
    }
    return;
  }
  // K/V tile u of the block's stream (u = round * key_tiles + key tile when
  // streaming): its slot and the parity of its fill. A streamed slot goes
  // back to the producer once this warp's wgmmas on it are done.
  auto slot = [&](int u) { return RESIDENT ? u : u % KV_STAGES; };
  auto parity = [&](int u) { return RESIDENT ? 0u : (uint32_t)((u / KV_STAGES) & 1); };
  auto release = [&](int u) {
    if constexpr (!RESIDENT) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&kvempty[u % KV_STAGES]);
    }
  };

  if (wtid == 0 && first + wg < last) {
    mbar_expect_tx(&qbar[wg * 2], TILE);
    tma_load_4d(qs + wg * 2 * TILE, &qmap, &qbar[wg * 2], 0, (first + wg) * TC_ROWS, h, b);
  }

  for (int i = 0; i < rounds; ++i) {
    const int tile = first + i * WGS + wg;
    const int u0 = RESIDENT ? 0 : i * key_tiles;
    if (tile >= last) {
      // no query tile for this warpgroup in the last round: hand the
      // round's streamed slots straight back
      if constexpr (!RESIDENT) {
        for (int j = 0; j < key_tiles; ++j) {
          mbar_wait(&kvfull[slot(u0 + j)], parity(u0 + j));
          release(u0 + j);
        }
      }
      break;
    }
    const int buf = i & 1;
    uint8_t* qb = qs + (wg * 2 + buf) * TILE;
    if (wtid == 0 && tile + WGS < last) {
      // the other buffer held the previous tile's q, then its o: wait until
      // that store has read it, then fetch the next q into it
      bulk_wait_read();
      mbar_expect_tx(&qbar[wg * 2 + (buf ^ 1)], TILE);
      tma_load_4d(qs + (wg * 2 + (buf ^ 1)) * TILE, &qmap, &qbar[wg * 2 + (buf ^ 1)], 0,
                  (tile + WGS) * TC_ROWS, h, b);
    }
    mbar_wait(&qbar[wg * 2 + buf], (i >> 1) & 1);

    float o[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) o[r] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of this warp's 16
    float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums
    float s[32], alpha[2];
    uint32_t pa[4][4];

    mbar_wait(&kvfull[slot(u0)], parity(u0));
    issue_qk<T, D>(s, qb, ks + slot(u0) * TILE);
    wgmma_wait_all();
    fence_regs(s);
    softmax_tile(s, 0, n_valid, t, scale_log2, m_run, l_run, alpha);
    pack_p<T>(s, pa);
    for (int j = 0; j + 1 < key_tiles; ++j) {
      // S of the next tile and P V of this one in flight together; the next
      // tile's softmax runs while P V finishes
      const int u = u0 + j;
      mbar_wait(&kvfull[slot(u + 1)], parity(u + 1));
      issue_qk<T, D>(s, qb, ks + slot(u + 1) * TILE);
      issue_pv<T, D>(o, pa, vs + slot(u) * TILE);
      wgmma_wait_1();
      fence_regs(s);
      softmax_tile(s, (j + 1) * TC_ROWS, n_valid, t, scale_log2, m_run, l_run, alpha);
      wgmma_wait_all();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      release(u);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
      pack_p<T>(s, pa);
    }
    issue_pv<T, D>(o, pa, vs + slot(u0 + key_tiles - 1) * TILE);
    wgmma_wait_all();
    fence_regs(o);
    release(u0 + key_tiles - 1);

    float inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      inv_l[r] = 1.f / l_run[r];
    }
    // o over its q tile (every read of q is done), swizzled as the o map expects
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t row = warp * 16 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(qb + swizzle<RB>(row * RB + n * 16 + 4 * t)) =
            pack2<T>(o[4 * n + 2 * r] * inv_l[r], o[4 * n + 2 * r + 1] * inv_l[r]);
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wtid == 0) {
      tma_store_4d(&omap, qb, 0, tile * TC_ROWS, h, b);
      bulk_commit();
    }
  }
  if (wtid == 0) bulk_wait();
}

// ---------------------------------------------------------------------------
// Tensor-core path at f32 accuracy: f32, D in {32, 64}, 3xTF32.

constexpr int SPLIT_ROWS = 32;     // tokens per pre-pass block, one V^T panel of keys
constexpr int SPLIT_THREADS = 256;

// V^T slot of key k inside its 8-key group: even keys take slots 0-3, odd
// keys 4-7, matching the TF32 A fragment (columns t, t + 4) to the f32
// accumulator's (2t, 2t + 1).
__host__ __device__ constexpr int vt_key_of_slot(int slot) {
  return slot < 4 ? 2 * slot : 2 * (slot - 4) + 1;
}

// Scratch of one call, in floats, by (b * H + h) head and part (0 = big,
// 1 = small): q as [head][part][D / 32][N][32], k as
// [head][part][D / 32][n_valid][32], V^T as [head][part][kp][D][32] with kp =
// ceil(n_valid / 32) panels of 32 keys (keys >= n_valid zero). Every region
// starts on a 128-byte boundary.
struct Tf32Scratch {
  float* q;
  float* k;
  float* vt;
  int kp;
  static long long floats(int B, int N, int H, int D, int n_valid) {
    const long long kp = (n_valid + SPLIT_ROWS - 1) / SPLIT_ROWS;
    return (long long)B * H * 2 * D * (N + n_valid + kp * SPLIT_ROWS);
  }
  Tf32Scratch(float* base, int B, int N, int H, int D, int n_valid)
      : q(base),
        k(base + (size_t)B * H * 2 * D * N),
        vt(k + (size_t)B * H * 2 * D * n_valid),
        kp((n_valid + SPLIT_ROWS - 1) / SPLIT_ROWS) {}
};

__device__ __forceinline__ void split4(const float4 x, float4& big, float4& small) {
  const float in[4] = {x.x, x.y, x.z, x.w};
  float b[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b[i] = __uint_as_float(tf32_rna(in[i]));
    l[i] = __uint_as_float(tf32_rna(in[i] - b[i]));
  }
  big = make_float4(b[0], b[1], b[2], b[3]);
  small = make_float4(l[0], l[1], l[2], l[3]);
}

// The pre-pass: tokens [32 x, 32 x + 32) of head (blockIdx.y, blockIdx.z).
// q rows < N and k rows < n_valid are split in place of their panels; the
// block's 32 keys of V become V^T panel x (when x < kp), keys >= n_valid
// written as zeros so that P = 0 never meets a stale value.
template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS)
split_tf32_kernel(const Attn<float> a, const Tf32Scratch sc, int H) {
  constexpr int P = D / 32;
  constexpr int V4 = D / 4;  // float4s per row
  __shared__ float vtile[SPLIT_ROWS][D + 1];
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const int N = a.N, nv = a.n_valid;
  const int r0 = blockIdx.x * SPLIT_ROWS;
  const float* q = a.q + b * a.q_b + h * a.q_h;
  const float* k = a.k + b * a.k_b + h * a.k_h;
  const float* v = a.v + b * a.v_b + h * a.v_h;
  for (int e = threadIdx.x; e < SPLIT_ROWS * V4; e += SPLIT_THREADS) {
    const int r = e / V4, d = (e % V4) * 4;
    const int n = r0 + r;
    const int panel = d / 32, c = d % 32;
    float4 big, small;
    if (n < N) {
      split4(*reinterpret_cast<const float4*>(q + n * a.q_n + d), big, small);
      float* dst = sc.q + ((bh * 2) * P + panel) * (long long)N * 32 + n * 32 + c;
      *reinterpret_cast<float4*>(dst) = big;
      *reinterpret_cast<float4*>(dst + (long long)P * N * 32) = small;
    }
    if (n < nv) {
      split4(*reinterpret_cast<const float4*>(k + n * a.k_n + d), big, small);
      float* dst = sc.k + ((bh * 2) * P + panel) * (long long)nv * 32 + n * 32 + c;
      *reinterpret_cast<float4*>(dst) = big;
      *reinterpret_cast<float4*>(dst + (long long)P * nv * 32) = small;
    }
    const float4 x = n < nv ? *reinterpret_cast<const float4*>(v + n * a.v_n + d)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    vtile[r][d] = x.x;
    vtile[r][d + 1] = x.y;
    vtile[r][d + 2] = x.z;
    vtile[r][d + 3] = x.w;
  }
  if ((int)blockIdx.x >= sc.kp) return;  // no V^T panel here (uniform over the block)
  __syncthreads();
  for (int e = threadIdx.x; e < D * 8; e += SPLIT_THREADS) {
    const int d = e / 8, s4 = (e % 8) * 4;
    float xs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int slot = s4 + i;
      xs[i] = vtile[(slot & ~7) + vt_key_of_slot(slot & 7)][d];
    }
    float4 big, small;
    split4(make_float4(xs[0], xs[1], xs[2], xs[3]), big, small);
    float* dst = sc.vt + ((bh * 2) * sc.kp + blockIdx.x) * (long long)D * 32 + d * 32 + s4;
    *reinterpret_cast<float4*>(dst) = big;
    *reinterpret_cast<float4*>(dst + (long long)sc.kp * D * 32) = small;
  }
}

template <int D>
struct Tf32Cfg {
  static constexpr int WGS = 2;  // consumer warpgroups, one query tile each
  static constexpr int THREADS = 128 * WGS + 32;
  static constexpr int P = D / 32;                          // 128-byte panels per row
  static constexpr int PANEL = TC_ROWS * 128;               // 64 rows of one q or k panel
  static constexpr int Q_BYTES = 2 * P * PANEL;             // a 64-row tile, big + small
  static constexpr int KV_BYTES = 2 * TC_ROWS * D * 4;      // a 64-key K or V^T tile, big + small
  static constexpr int VT_PANEL = D * 128;                  // 32 keys of V^T
  static constexpr int STAGES = 2;
  static constexpr int SMEM = 1024 + WGS * Q_BYTES + 2 * STAGES * KV_BYTES + (WGS + 4 * STAGES) * 8;
};
static_assert(Tf32Cfg<64>::SMEM <= 232448, "two query tiles and both rings fit");

// S = q k^T for one 64-key tile: k8 step kk reads panel kk / 4 of q and k at
// byte kk % 4 * 32; three TF32 products per step, the small ones first.
template <int D>
__device__ __forceinline__ void issue_qk_tf32(float (&s)[32], const uint8_t* qt,
                                              const uint8_t* kt) {
  using C = Tf32Cfg<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int off = (kk / 4) * C::PANEL + (kk % 4) * 32;
    const uint64_t qb = make_desc<128>(qt + off, 16, 1024);
    const uint64_t qs = make_desc<128>(qt + C::P * C::PANEL + off, 16, 1024);
    const uint64_t kb = make_desc<128>(kt + off, 16, 1024);
    const uint64_t ks = make_desc<128>(kt + C::P * C::PANEL + off, 16, 1024);
    wgmma_m64n64k8_ss(s, qs, kb, kk > 0);
    wgmma_m64n64k8_ss(s, qb, ks, 1);
    wgmma_m64n64k8_ss(s, qb, kb, 1);
  }
  wgmma_commit();
}

// O += P V for one 64-key tile: k8 step kk is accumulator block kk of P and
// 8 keys of V^T panel kk / 4 at byte kk % 4 * 32.
template <int D>
__device__ __forceinline__ void issue_pv_tf32(float (&o)[D / 2], const uint32_t (&pb)[8][4],
                                              const uint32_t (&ps)[8][4], const uint8_t* vt) {
  using C = Tf32Cfg<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int off = (kk / 4) * C::VT_PANEL + (kk % 4) * 32;
    const uint64_t vb = make_desc<128>(vt + off, 16, 1024);
    const uint64_t vs = make_desc<128>(vt + 2 * C::VT_PANEL + off, 16, 1024);
    if constexpr (D == 64) {
      wgmma_m64n64k8_rs(o, ps[kk], vb);
      wgmma_m64n64k8_rs(o, pb[kk], vs);
      wgmma_m64n64k8_rs(o, pb[kk], vb);
    } else {
      wgmma_m64n32k8_rs(o, ps[kk], vb);
      wgmma_m64n32k8_rs(o, pb[kk], vs);
      wgmma_m64n32k8_rs(o, pb[kk], vb);
    }
  }
  wgmma_commit();
}

// P (f32, accumulator layout) to big and small TF32 A fragments: block kk
// holds keys 8kk + 2t, 8kk + 2t + 1 of rows g, g + 8, which go to slots t
// and t + 4 (V^T's key order).
__device__ __forceinline__ void split_p(const float (&s)[32], uint32_t (&pb)[8][4],
                                        uint32_t (&ps)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int idx[4] = {4 * kk, 4 * kk + 2, 4 * kk + 1, 4 * kk + 3};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = s[idx[i]];
      pb[kk][i] = tf32_rna(p);
      ps[kk][i] = tf32_rna(p - __uint_as_float(pb[kk][i]));
    }
  }
}

// Grid (ceil(q_tiles / 2), H, B): consumer warpgroup w takes query tile
// 2 blockIdx.x + w; the producer warp streams the head's key tiles once.
template <int D>
__global__ void __launch_bounds__(Tf32Cfg<D>::THREADS, 1)
attention_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, float* __restrict__ out,
                      long long o_b, long long o_h, long long o_n, int N, int n_valid, int H,
                      float scale_log2) {
  using C = Tf32Cfg<D>;
  constexpr int WGS = C::WGS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;                        // [warpgroup] q tiles
  uint8_t* ks = qs + WGS * C::Q_BYTES;       // [slot] K tiles
  uint8_t* vs = ks + C::STAGES * C::KV_BYTES;  // [slot] V^T tiles
  uint64_t* kfull = reinterpret_cast<uint64_t*>(vs + C::STAGES * C::KV_BYTES);
  uint64_t* kempty = kfull + C::STAGES;
  uint64_t* vfull = kempty + C::STAGES;
  uint64_t* vempty = vfull + C::STAGES;
  uint64_t* qbar = vempty + C::STAGES;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int q_tiles = (N + TC_ROWS - 1) / TC_ROWS;
  const int key_tiles = (n_valid + TC_ROWS - 1) / TC_ROWS;
  const int active = min(WGS, q_tiles - (int)blockIdx.x * WGS);  // warpgroups with a tile
  const int wg = threadIdx.x / 128;
  const int wtid = threadIdx.x % 128;
  const int warp = wtid / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  if (threadIdx.x == 0) {
    for (int j = 0; j < C::STAGES; ++j) {
      mbar_init(&kfull[j], 1);
      mbar_init(&vfull[j], 1);
      mbar_init(&kempty[j], 4 * active);  // one arrival per consumer warp
      mbar_init(&vempty[j], 4 * active);
    }
    for (int j = 0; j < WGS; ++j) mbar_init(&qbar[j], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (wg == WGS) {
    // producer warp: K tile j into slot j % 2 once S of tile j - 2 is done,
    // V^T tile j once P V of tile j - 2 is done
    if (lane == 0) {
      for (int j = 0; j < key_tiles; ++j) {
        const int s = j % C::STAGES;
        const uint32_t par = ((j / C::STAGES) - 1) & 1;
        if (j >= C::STAGES) mbar_wait(&kempty[s], par);
        mbar_expect_tx(&kfull[s], C::KV_BYTES);
        tma_load_5d(ks + s * C::KV_BYTES, &kmap, &kfull[s], 0, j * TC_ROWS, 0, 0, bh);
        if (j >= C::STAGES) mbar_wait(&vempty[s], par);
        mbar_expect_tx(&vfull[s], C::KV_BYTES);
        tma_load_5d(vs + s * C::KV_BYTES, &vmap, &vfull[s], 0, 0, 2 * j, 0, bh);
      }
    }
    return;
  }
  if (wg >= active) return;  // the odd last query tile of a head
  const int tile = blockIdx.x * WGS + wg;
  uint8_t* qt = qs + wg * C::Q_BYTES;
  if (wtid == 0) {
    mbar_expect_tx(&qbar[wg], C::Q_BYTES);
    tma_load_5d(qt, &qmap, &qbar[wg], 0, tile * TC_ROWS, 0, 0, bh);
  }
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto par = [](int j) { return (uint32_t)((j / C::STAGES) & 1); };

  float o[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) o[r] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of this warp's 16
  float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums
  float s[32], alpha[2];
  uint32_t pb[8][4], ps[8][4];

  mbar_wait(&qbar[wg], 0);
  mbar_wait(&kfull[0], 0);
  issue_qk_tf32<D>(s, qt, ks);
  wgmma_wait_all();
  fence_regs(s);
  release(&kempty[0]);
  softmax_tile(s, 0, n_valid, t, scale_log2, m_run, l_run, alpha);
  split_p(s, pb, ps);
  for (int j = 0; j + 1 < key_tiles; ++j) {
    // S of the next tile and P V of this one in flight together; the next
    // tile's softmax runs while P V finishes
    const int sn = (j + 1) % C::STAGES, sc = j % C::STAGES;
    mbar_wait(&kfull[sn], par(j + 1));
    issue_qk_tf32<D>(s, qt, ks + sn * C::KV_BYTES);
    mbar_wait(&vfull[sc], par(j));
    issue_pv_tf32<D>(o, pb, ps, vs + sc * C::KV_BYTES);
    wgmma_wait_1();
    fence_regs(s);
    release(&kempty[sn]);
    softmax_tile(s, (j + 1) * TC_ROWS, n_valid, t, scale_log2, m_run, l_run, alpha);
    wgmma_wait_all();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      fence_regs(pb[kk]);
      fence_regs(ps[kk]);
    }
    release(&vempty[sc]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
    split_p(s, pb, ps);
  }
  const int last = key_tiles - 1;
  mbar_wait(&vfull[last % C::STAGES], par(last));
  issue_pv_tf32<D>(o, pb, ps, vs + (last % C::STAGES) * C::KV_BYTES);
  wgmma_wait_all();
  fence_regs(o);

  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv_l[r] = 1.f / l_run[r];
  }
  float* obase = out + b * o_b + h * o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = tile * TC_ROWS + warp * 16 + g + 8 * r;
    if (row < N) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(obase + row * o_n + 8 * n + 2 * t) =
            make_float2(o[4 * n + 2 * r] * inv_l[r], o[4 * n + 2 * r + 1] * inv_l[r]);
    }
  }
}

// f32, D in {32, 64}: the pre-pass into `scratch`, then the 3xTF32 kernel
// over 5-D tensor maps of the split operands (32-float panel rows, rows,
// panels, big/small, heads), boxes of one 64-row tile.
template <int D>
int launch_tf32(const Attn<float>& a, int B, int H, float* scratch, cudaStream_t stream) {
  using C = Tf32Cfg<D>;
  if (scratch == nullptr) return -4;
  const int N = a.N, nv = a.n_valid;
  const Tf32Scratch sc(scratch, B, N, H, D, nv);
  split_tf32_kernel<D><<<dim3((N + SPLIT_ROWS - 1) / SPLIT_ROWS, H, B), SPLIT_THREADS, 0,
                         stream>>>(a, sc, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t heads = (uint64_t)B * H;
  CUtensorMap qmap, kmap, vmap;
  const struct {
    CUtensorMap* map;
    const float* base;
    uint64_t rows, panels;
    uint32_t box_rows, box_panels;
  } specs[3] = {{&qmap, sc.q, (uint64_t)N, C::P, TC_ROWS, C::P},
                {&kmap, sc.k, (uint64_t)nv, C::P, TC_ROWS, C::P},
                {&vmap, sc.vt, (uint64_t)D, (uint64_t)sc.kp, D, 2}};
  for (const auto& m : specs) {
    const uint64_t dims[5] = {32, m.rows, m.panels, 2, heads};
    const uint64_t strides[4] = {128, m.rows * 128, m.panels * m.rows * 128,
                                 2 * m.panels * m.rows * 128};
    const uint32_t box[5] = {32, m.box_rows, m.box_panels, 2, 1};
    const int rc = make_map(m.map, m.base, 5, dims, strides, box, 128,
                            CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (rc) return rc;
  }
  err = cudaFuncSetAttribute(attention_tf32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (N + TC_ROWS - 1) / TC_ROWS;
  const dim3 grid((unsigned)((q_tiles + C::WGS - 1) / C::WGS), (unsigned)H, (unsigned)B);
  attention_tf32_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      qmap, kmap, vmap, a.o, a.o_b, a.o_h, a.o_n, N, nv, H, a.scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
void launch(const Attn<T>& a, int B, int H, cudaStream_t stream) {
  const dim3 grid((a.N + BM - 1) / BM, H, B);
  attention_kernel<T, D><<<grid, BM, 0, stream>>>(a);
}

template <int D>
bool kv_resident(int n_valid) {
  using C = TcCfg<D, true>;
  return C::smem_bytes((n_valid + TC_ROWS - 1) / TC_ROWS) <= C::MAX_SMEM;
}

// bf16 and f16, D in {32, 64}: tensor maps over the (D, N, H, B) views of
// q, k, v and o, and a grid of (query-tile runs, heads, batch).
template <typename T, int D, bool RESIDENT>
int launch_tc_cfg(const CUtensorMap (&maps)[4], const Attn<T>& a, int B, int H,
                  cudaStream_t stream) {
  using C = TcCfg<D, RESIDENT>;
  // set on every launch: the attribute belongs to the current device
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_wgmma_kernel<T, D, RESIDENT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // enough blocks to fill the card: with few heads, fewer query tiles per block
  const int q_tiles = (a.N + TC_ROWS - 1) / TC_ROWS;
  const int heads = B * H;
  const int sms = sm_count();
  int per_block = q_tiles;
  if (heads < 2 * sms) per_block = max(2, (q_tiles * heads + sms - 1) / sms);
  per_block = min(per_block, q_tiles);
  const dim3 grid((unsigned)((q_tiles + per_block - 1) / per_block), (unsigned)H, (unsigned)B);
  const int smem = C::smem_bytes((a.n_valid + TC_ROWS - 1) / TC_ROWS);
  attention_wgmma_kernel<T, D, RESIDENT><<<grid, C::THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.N, a.n_valid, a.scale_log2, per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_tc(const Attn<T>& a, int B, int H, cudaStream_t stream) {
  CUtensorMap maps[4];
  const void* ptrs[4] = {a.q, a.k, a.v, a.o};
  const long long str[4][3] = {{a.q_n, a.q_h, a.q_b},
                               {a.k_n, a.k_h, a.k_b},
                               {a.v_n, a.v_h, a.v_b},
                               {a.o_n, a.o_h, a.o_b}};
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)a.N, (uint64_t)H, (uint64_t)B};
  const uint32_t box[4] = {(uint32_t)D, TC_ROWS, 1, 1};
  for (int i = 0; i < 4; ++i) {
    const uint64_t strides[3] = {(uint64_t)str[i][0] * 2, (uint64_t)str[i][1] * 2,
                                 (uint64_t)str[i][2] * 2};
    const int rc = make_map(&maps[i], ptrs[i], 4, dims, strides, box, 2 * D,
                            Half16<T>::kMapType);
    if (rc) return rc;
  }
  if (kv_resident<D>(a.n_valid)) return launch_tc_cfg<T, D, true>(maps, a, B, H, stream);
  return launch_tc_cfg<T, D, false>(maps, a, B, H, stream);
}

int dispatch(const Attn<float>& a, int B, int H, int D, void* scratch, cudaStream_t stream) {
  float* sc = static_cast<float*>(scratch);
  switch (D) {
    case 8: launch<float, 8>(a, B, H, stream); break;
    case 32: return launch_tf32<32>(a, B, H, sc, stream);
    case 64: return launch_tf32<64>(a, B, H, sc, stream);
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16 and f16
template <typename T>
int dispatch(const Attn<T>& a, int B, int H, int D, void*, cudaStream_t stream) {
  switch (D) {
    case 8: launch<T, 8>(a, B, H, stream); break;
    case 32: return launch_tc<T, 32>(a, B, H, stream);
    case 64: return launch_tc<T, 64>(a, B, H, stream);
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// q/k/v as column ranges of the (B, N, 3C) qkv buffer, o as (B, N, C)
template <typename T>
int run_qkv(const void* qkv, void* out, void* scratch, int B, int N, int H, int D, int n_valid,
            float scale_log2, cudaStream_t stream) {
  const long long C = (long long)H * D;
  const T* base = static_cast<const T*>(qkv);
  const Attn<T> a{base, base + C, base + 2 * C, static_cast<T*>(out),
                  N * 3 * C, D, 3 * C, N * 3 * C, D, 3 * C, N * 3 * C, D, 3 * C,
                  N * C, D, C, N, n_valid, scale_log2};
  return dispatch(a, B, H, D, scratch, stream);
}

// strides: q, k, v, o, each (batch, head, token), in elements
template <typename T>
int run_bhnd(const void* q, const void* k, const void* v, void* o, void* scratch, int B, int H,
             int N, int D, int n_valid, float scale_log2, const long long* st,
             cudaStream_t stream) {
  const Attn<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(o), st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                  st[8], st[9], st[10], st[11], N, n_valid, scale_log2};
  return dispatch(a, B, H, D, scratch, stream);
}

}  // namespace

// Floats of device scratch one call needs: the f32 tensor-core path's split
// operands (3xTF32), 0 for every other path. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16.
extern "C" long long me_attention_scratch_floats(int B, int N, int H, int D, int n_valid,
                                                 int dtype) {
  if (dtype != 0 || (D != 32 && D != 64)) return 0;
  return Tf32Scratch::floats(B, N, H, D, n_valid);
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; scratch: me_attention_scratch_floats
// floats, or null when that is 0. Both entries return cudaGetLastError()
// after the launches, or a negative code for arguments the kernels do not
// take.
extern "C" int me_attention_qkv(const void* qkv, void* out, void* scratch, int B, int N, int H,
                                int D, int n_valid, float scale_log2, int dtype, void* stream) {
  if (B < 1 || N < 1 || H < 1 || n_valid < 1 || n_valid > N) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_qkv<float>(qkv, out, scratch, B, N, H, D, n_valid, scale_log2, st);
  if (dtype == 1)
    return run_qkv<__nv_bfloat16>(qkv, out, scratch, B, N, H, D, n_valid, scale_log2, st);
  if (dtype == 2)
    return run_qkv<__half>(qkv, out, scratch, B, N, H, D, n_valid, scale_log2, st);
  return -3;
}

// q, k, v, o: (B, H, N, D) with unit stride on D; strides[12] holds the
// (batch, head, token) element strides of q, k, v and o in that order.
extern "C" int me_attention_bhnd(const void* q, const void* k, const void* v, void* o,
                                 void* scratch, int B, int H, int N, int D, int n_valid,
                                 float scale_log2, int dtype, const long long* strides,
                                 void* stream) {
  if (B < 1 || N < 1 || H < 1 || n_valid < 1 || n_valid > N) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_bhnd<float>(q, k, v, o, scratch, B, H, N, D, n_valid, scale_log2, strides, st);
  if (dtype == 1)
    return run_bhnd<__nv_bfloat16>(q, k, v, o, scratch, B, H, N, D, n_valid, scale_log2,
                                   strides, st);
  if (dtype == 2)
    return run_bhnd<__half>(q, k, v, o, scratch, B, H, N, D, n_valid, scale_log2, strides, st);
  return -3;
}

// How a launch at head dim D over n_valid keys reads a head's K and V: 0 on
// the CUDA cores (D = 8), 1 whole in shared memory (bf16 and f16 where they
// fit: kv_resident), 2 through the ring (bf16 and f16 beyond that, and the
// f32 3xTF32 kernel at every length). -1 for a D no kernel takes.
extern "C" int me_attention_kv_path(int D, int n_valid, int dtype) {
  if (D == 8) return 0;
  if (D != 32 && D != 64) return -1;
  if (dtype == 0) return 2;
  return (D == 64 ? kv_resident<64>(n_valid) : kv_resident<32>(n_valid)) ? 1 : 2;
}

// Dynamic shared memory of one tensor-core launch at head dim D over
// n_valid keys (for reports): bf16 and f16 (dtype 1, 2) K and V whole where they fit,
// else the ring; f32 (dtype 0) the 3xTF32 kernel's two query tiles and
// rings. -1 for a D the tensor-core paths do not take.
extern "C" int me_attention_smem_bytes(int D, int n_valid, int dtype) {
  const int key_tiles = (n_valid + TC_ROWS - 1) / TC_ROWS;
  if (dtype == 0) {
    if (D == 64) return Tf32Cfg<64>::SMEM;
    if (D == 32) return Tf32Cfg<32>::SMEM;
    return -1;
  }
  if (D == 64)
    return kv_resident<64>(n_valid) ? TcCfg<64, true>::smem_bytes(key_tiles)
                                    : TcCfg<64, false>::smem_bytes(key_tiles);
  if (D == 32)
    return kv_resident<32>(n_valid) ? TcCfg<32, true>::smem_bytes(key_tiles)
                                    : TcCfg<32, false>::smem_bytes(key_tiles);
  return -1;
}
