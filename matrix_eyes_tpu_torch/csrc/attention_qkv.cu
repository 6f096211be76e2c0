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
// rows never poison valid ones; rows >= N are never read. Two paths:
//
// * bf16 with D in {32, 64}: TMA + mbarriers + wgmma. A block serves one
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
//   S accumulator's layout is the A-fragment layout), is rounded to bf16,
//   and O += P V is a wgmma with A from registers and V as it lies, an
//   MN-major B operand read through the transpose bit. S of key tile j + 1
//   and P V of tile j are in flight together, and tile j + 1's softmax
//   (ex2.approx, the scale folded into one FFMA) runs while P V finishes.
//   The output tile is written over the q tile it came from and stored by
//   TMA, which clips rows >= N. Small grids (the B = 1 image ViT: 16 heads) give each block
//   fewer query tiles so the card fills; the 577th row costs one tile of
//   one warpgroup, not a block.
// * f32 (the FOV ViT, and --dtype f32) and D = 8: FP32 CUDA cores, one
//   thread per query row holding its q row and output accumulator;
//   TF32 would not keep f32 accuracy. D = 8 is too narrow for the
//   16-deep mma step.

#include <math.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
// CUDA-core path: f32, and bf16 at D = 8.

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
// Tensor-core path: bf16, D in {32, 64}.

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

template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[32], const uint8_t* qb, const uint8_t* kt) {
  constexpr int RB = 2 * D;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss(s, make_desc<RB>(qb + kk * 32, 16, 8 * RB),
                       make_desc<RB>(kt + kk * 32, 16, 8 * RB), kk > 0);
  wgmma_commit();
}

template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[4][4],
                                         const uint8_t* vt) {
  constexpr int RB = 2 * D;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv = make_desc<RB>(vt + kk * 16 * RB, 16, 8 * RB);
    if constexpr (D == 64)
      wgmma_m64n64k16_rs(o, pa[kk], dv, 1);
    else
      wgmma_m64n32k16_rs(o, pa[kk], dv, 1);
  }
  wgmma_commit();
}

// P (f32, accumulator layout) to bf16 A fragments: k16 step kk covers keys
// 16kk..16kk+15, i.e. accumulator blocks 2kk and 2kk + 1.
__device__ __forceinline__ void pack_p(const float (&s)[32], uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 2 * kk + half;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(s[4 * n], s[4 * n + 1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(s[4 * n + 2], s[4 * n + 3]);
      pa[kk][2 * half] = *reinterpret_cast<const uint32_t*>(&lo);
      pa[kk][2 * half + 1] = *reinterpret_cast<const uint32_t*>(&hi);
    }
}

template <int D, bool RESIDENT>
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
    issue_qk<D>(s, qb, ks + slot(u0) * TILE);
    wgmma_wait_all();
    fence_regs(s);
    softmax_tile(s, 0, n_valid, t, scale_log2, m_run, l_run, alpha);
    pack_p(s, pa);
    for (int j = 0; j + 1 < key_tiles; ++j) {
      // S of the next tile and P V of this one in flight together; the next
      // tile's softmax runs while P V finishes
      const int u = u0 + j;
      mbar_wait(&kvfull[slot(u + 1)], parity(u + 1));
      issue_qk<D>(s, qb, ks + slot(u + 1) * TILE);
      issue_pv<D>(o, pa, vs + slot(u) * TILE);
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
      pack_p(s, pa);
    }
    issue_pv<D>(o, pa, vs + slot(u0 + key_tiles - 1) * TILE);
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
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(o[4 * n + 2 * r] * inv_l[r], o[4 * n + 2 * r + 1] * inv_l[r]);
        *reinterpret_cast<__nv_bfloat162*>(qb + swizzle<RB>(row * RB + n * 16 + 4 * t)) = v;
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

// bf16, D in {32, 64}: tensor maps over the (D, N, H, B) views of q, k, v
// and o, and a grid of (query-tile runs, heads, batch).
template <int D, bool RESIDENT>
int launch_tc_cfg(const CUtensorMap (&maps)[4], const Attn<__nv_bfloat16>& a, int B, int H,
                  cudaStream_t stream) {
  using C = TcCfg<D, RESIDENT>;
  // set on every launch: the attribute belongs to the current device
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_wgmma_kernel<D, RESIDENT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  attention_wgmma_kernel<D, RESIDENT><<<grid, C::THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.N, a.n_valid, a.scale_log2, per_block);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc(const Attn<__nv_bfloat16>& a, int B, int H, cudaStream_t stream) {
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
    const int rc = make_map(&maps[i], ptrs[i], 4, dims, strides, box, 2 * D);
    if (rc) return rc;
  }
  if (kv_resident<D>(a.n_valid)) return launch_tc_cfg<D, true>(maps, a, B, H, stream);
  return launch_tc_cfg<D, false>(maps, a, B, H, stream);
}

int dispatch(const Attn<float>& a, int B, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 8: launch<float, 8>(a, B, H, stream); break;
    case 32: launch<float, 32>(a, B, H, stream); break;
    case 64: launch<float, 64>(a, B, H, stream); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Attn<__nv_bfloat16>& a, int B, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 8: launch<__nv_bfloat16, 8>(a, B, H, stream); break;
    case 32: return launch_tc<32>(a, B, H, stream);
    case 64: return launch_tc<64>(a, B, H, stream);
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// q/k/v as column ranges of the (B, N, 3C) qkv buffer, o as (B, N, C)
template <typename T>
int run_qkv(const void* qkv, void* out, int B, int N, int H, int D, int n_valid,
            float scale_log2, cudaStream_t stream) {
  const long long C = (long long)H * D;
  const T* base = static_cast<const T*>(qkv);
  const Attn<T> a{base, base + C, base + 2 * C, static_cast<T*>(out),
                  N * 3 * C, D, 3 * C, N * 3 * C, D, 3 * C, N * 3 * C, D, 3 * C,
                  N * C, D, C, N, n_valid, scale_log2};
  return dispatch(a, B, H, D, stream);
}

// strides: q, k, v, o, each (batch, head, token), in elements
template <typename T>
int run_bhnd(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
             int n_valid, float scale_log2, const long long* st, cudaStream_t stream) {
  const Attn<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(o), st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                  st[8], st[9], st[10], st[11], N, n_valid, scale_log2};
  return dispatch(a, B, H, D, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Both entries return cudaGetLastError()
// after the launch, or a negative code for arguments the kernel does not
// take.
extern "C" int me_attention_qkv(const void* qkv, void* out, int B, int N, int H, int D,
                                int n_valid, float scale_log2, int dtype, void* stream) {
  if (B < 1 || N < 1 || H < 1 || n_valid < 1 || n_valid > N) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_qkv<float>(qkv, out, B, N, H, D, n_valid, scale_log2, st);
  if (dtype == 1) return run_qkv<__nv_bfloat16>(qkv, out, B, N, H, D, n_valid, scale_log2, st);
  return -3;
}

// q, k, v, o: (B, H, N, D) with unit stride on D; strides[12] holds the
// (batch, head, token) element strides of q, k, v and o in that order.
extern "C" int me_attention_bhnd(const void* q, const void* k, const void* v, void* o, int B,
                                 int H, int N, int D, int n_valid, float scale_log2, int dtype,
                                 const long long* strides, void* stream) {
  if (B < 1 || N < 1 || H < 1 || n_valid < 1 || n_valid > N) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_bhnd<float>(q, k, v, o, B, H, N, D, n_valid, scale_log2, strides, st);
  if (dtype == 1)
    return run_bhnd<__nv_bfloat16>(q, k, v, o, B, H, N, D, n_valid, scale_log2, strides, st);
  return -3;
}

// Dynamic shared memory of one bf16 launch at head dim D over n_valid keys
// (for reports: K and V whole where they fit, else the ring); -1 for a D
// the tensor-core path does not take.
extern "C" int me_attention_smem_bytes(int D, int n_valid) {
  const int key_tiles = (n_valid + TC_ROWS - 1) / TC_ROWS;
  if (D == 64)
    return kv_resident<64>(n_valid) ? TcCfg<64, true>::smem_bytes(key_tiles)
                                    : TcCfg<64, false>::smem_bytes(key_tiles);
  if (D == 32)
    return kv_resident<32>(n_valid) ? TcCfg<32, true>::smem_bytes(key_tiles)
                                    : TcCfg<32, false>::smem_bytes(key_tiles);
  return -1;
}
