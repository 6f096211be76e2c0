// Multi-head attention for Hopper (sm_90a), FlashAttention-2 style.
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
// read of q, k, v and one write of o, and it is bound by the matrix math
// (4 N^2 D FLOPs per head) and the shared-memory operand traffic feeding it.
//
// Design: one thread block per (query tile, head, batch), an online
// softmax in the log2 domain (scores scaled by scale*log2(e) in f32, exp2,
// as _qk_log2 does) with f32 running max and sum per query row, and k/v
// tiles staged in shared memory. Keys >= n_valid score -1e30 (not -inf) and
// their shared-memory rows are zero, so ragged rows never poison valid
// ones; rows >= N are never read. Two paths:
//
// * bf16 with D in {32, 64}: tensor cores through mma.sync m16n8k16
//   (bf16 in, f32 accumulate). Four warps own 16 query rows each; q stays
//   in registers as A fragments, S = q k^T lands in accumulator registers
//   whose layout is the A-fragment layout of P, so P never leaves
//   registers (rounded to bf16 for the P V product, as the TPU kernel
//   does). V is staged transposed so its B fragments are 32-bit loads.
// * f32 (the FOV ViT, and --dtype f32) and D = 8: FP32 CUDA cores, one
//   thread per query row holding its q row and output accumulator;
//   TF32 would not keep f32 accuracy. D = 8 is too narrow for the
//   16-deep mma step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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
// Tensor-core path: bf16, D in {32, 64}. k/v rows move as 16-byte vectors
// (the wrappers check the alignment of every row).
//
// mma.sync m16n8k16 fragment layout, lane = 4 * g + t:
//   A (16 x 16, row major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same
//     cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, column major): b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8,
//     2t+9, col g);
//   C (16 x 8, f32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// Each 32-bit register holds two bf16, the lower column in the low half.

constexpr int MMA_WARPS = 4;
constexpr int MMA_BM = 16 * MMA_WARPS;  // query rows per block
constexpr int MMA_BN = 64;              // keys per shared-memory tile

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(MMA_WARPS * 32)
attention_mma_kernel(const Attn<__nv_bfloat16> a) {
  constexpr int KS = D / 16;          // k-steps of q k^T over the head dim
  constexpr int NS = MMA_BN / 8;      // n-tiles of S over the keys
  constexpr int NO = D / 8;           // n-tiles of O over the head dim
  constexpr int LDK = D + 8;          // row pitches (bf16): the +8 keeps the
  constexpr int LDV = MMA_BN + 8;     // 32-bit fragment loads conflict-free
  constexpr int VEC = 8;              // bf16 per 16-byte global load
  __shared__ __align__(16) __nv_bfloat16 ks[MMA_BN * LDK];  // k tile, [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt[D * LDV];       // v tile transposed, [d][key]

  const int N = a.N, n_valid = a.n_valid;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * MMA_BM + (threadIdx.x / 32) * 16;
  const __nv_bfloat16* __restrict__ qbase = a.q + b * a.q_b + h * a.q_h;
  const __nv_bfloat16* __restrict__ kbase = a.k + b * a.k_b + h * a.k_h;
  const __nv_bfloat16* __restrict__ vbase = a.v + b * a.v_b + h * a.v_h;

  // q rows m0+g and m0+g+8 as A fragments, one per 16-wide k-step
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + g + 8 * (i & 1);
      const int d = kk * 16 + 8 * (i >> 1) + 2 * t;
      qf[kk][i] = m < N ? *reinterpret_cast<const uint32_t*>(qbase + m * a.q_n + d) : 0u;
    }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g+8
  float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums

  for (int j0 = 0; j0 < n_valid; j0 += MMA_BN) {
    __syncthreads();  // the previous tile's fragment reads are done
    for (int e = threadIdx.x; e < MMA_BN * D / VEC; e += MMA_WARPS * 32) {
      const int r = e / (D / VEC);
      const int c = (e % (D / VEC)) * VEC;
      const int j = j0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (j < n_valid) {
        kv = *reinterpret_cast<const uint4*>(kbase + j * a.k_n + c);
        vv = *reinterpret_cast<const uint4*>(vbase + j * a.v_n + c);
      }
      *reinterpret_cast<uint4*>(&ks[r * LDK + c]) = kv;
      const __nv_bfloat16* vp = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) vt[(c + i) * LDV + r] = vp[i];
    }
    __syncthreads();

    // S = q k^T for this warp's 16 rows x MMA_BN keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* kp = &ks[(n * 8 + g) * LDK + kk * 16 + 2 * t];
        mma_16816(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                  *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // log2-domain scores, masked keys at -1e30, row maxima over the quad
    float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = j0 + n * 8 + 2 * t + (i & 1);
        const float v = key < n_valid ? s[n][i] * a.scale_log2 : -1e30f;
        s[n][i] = v;
        m_tile[i >> 1] = fmaxf(m_tile[i >> 1], v);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
      const float m_new = fmaxf(m_run[r], m_tile[r]);
      alpha[r] = exp2f(m_run[r] - m_new);  // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[n][i] - m_run[i >> 1]);
        s[n][i] = p;
        l_run[i >> 1] += p;
      }

    // O += P V: S's accumulator layout is P's A-fragment layout
#pragma unroll
    for (int kk = 0; kk < MMA_BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vp = &vt[(n * 8 + g) * LDV + kk * 16 + 2 * t];
        mma_16816(o[n], pa, *reinterpret_cast<const uint32_t*>(vp),
                  *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
  }

  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv_l[r] = 1.f / l_run[r];
  }
  __nv_bfloat16* __restrict__ obase = a.o + b * a.o_b + h * a.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + g + 8 * r;
    if (m >= N) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(obase + m * a.o_n + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * r] * inv_l[r], o[n][2 * r + 1] * inv_l[r]);
  }
}

// ---------------------------------------------------------------------------

template <typename T, int D>
void launch(const Attn<T>& a, int B, int H, cudaStream_t stream) {
  const dim3 grid((a.N + BM - 1) / BM, H, B);
  attention_kernel<T, D><<<grid, BM, 0, stream>>>(a);
}

template <int D>
void launch_mma(const Attn<__nv_bfloat16>& a, int B, int H, cudaStream_t stream) {
  const dim3 grid((a.N + MMA_BM - 1) / MMA_BM, H, B);
  attention_mma_kernel<D><<<grid, MMA_WARPS * 32, 0, stream>>>(a);
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
    case 32: launch_mma<32>(a, B, H, stream); break;
    case 64: launch_mma<64>(a, B, H, stream); break;
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
