// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// mbarriers, TMA loads and stores through tensor maps, wgmma descriptors and
// instructions, and the host-side tensor-map encoder.
//
// Shared-memory tiles are written by TMA with a 128-byte or 64-byte swizzle
// (a row of 128 or 64 bytes; 16-byte chunk c of the row at byte offset o
// lands at chunk c ^ ((o >> 7) & 7) or c ^ ((o >> 7) & 3)), and every tile
// starts on a 1024-byte boundary, so wgmma descriptors see the canonical
// swizzled layouts:
//   K-major (the reduction dimension contiguous): rows of the swizzle
//     width, 8-row groups SBO bytes apart; a k16 step inside a row advances
//     the start address by 32 bytes.
//   MN-major (the output dimension contiguous, "transposed" B): rows are
//     k, 8-row groups SBO bytes apart, blocks of the swizzle width along N
//     LBO bytes apart; a k16 step advances the start by 16 rows.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing links against libcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

// ---------------------------------------------------------------------------
// Device side.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// Shared -> global; the box's parts outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The issuing thread's bulk stores have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory become visible to TMA and wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Byte offset inside a 1024-byte-aligned swizzled tile whose rows are
// ROW_BYTES (128 or 64) long.
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64, "128- or 64-byte swizzle");
  return off ^ ((off >> 3) & (ROW_BYTES == 128 ? 0x70u : 0x30u));
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, and the swizzle of the tile (ROW_BYTES 128 or 64).
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t layout = ROW_BYTES == 128 ? 1 : 2;
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// All but the most recently committed wgmma group are complete.
__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Registers that an in-flight wgmma reads or writes: after wgmma_wait_all,
// this keeps the compiler from touching them before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_ACC8(d, i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_ACC16(d) WG_ACC8(d, 0), WG_ACC8(d, 8)
#define WG_ACC32(d) WG_ACC16(d), WG_ACC8(d, 16), WG_ACC8(d, 24)
#define WG_ACC64(d) \
  WG_ACC32(d), WG_ACC8(d, 32), WG_ACC8(d, 40), WG_ACC8(d, 48), WG_ACC8(d, 56)
#define WG_ACC128(d)                                                                        \
  WG_ACC64(d), WG_ACC8(d, 64), WG_ACC8(d, 72), WG_ACC8(d, 80), WG_ACC8(d, 88), WG_ACC8(d, 96), \
      WG_ACC8(d, 104), WG_ACC8(d, 112), WG_ACC8(d, 120)

// Accumulator layout of m64nNk16 (f32), lane = 4 * g + t of warp w of the
// warpgroup: d[4j + 0, 1] = row 16w + g, columns 8j + 2t, 8j + 2t + 1;
// d[4j + 2, 3] = row 16w + g + 8, same columns. The register A operand of
// one k16 step has the same layout per 16 x 16 block as mma.sync's.

// The 16-bit element types of the tensor-core paths. bf16 and f16 share the
// wgmma shapes (m64nNk16), descriptors and fragment layouts; only the type
// named in the instruction, the rounding of a float pair and the tensor-map
// type differ.
template <typename T>
struct Half16;

template <>
struct Half16<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ T2 pack(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 unpack(T2 v) { return __bfloat1622float2(v); }
};

template <>
struct Half16<__half> {
  using T2 = __half2;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ T2 pack(float lo, float hi) { return __floats2half2_rn(lo, hi); }
  static __device__ __forceinline__ float2 unpack(T2 v) { return __half22float2(v); }
};

// Two floats rounded to nearest into one 32-bit register of T pairs (lo in
// the low half), the layout of a wgmma A fragment.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const typename Half16<T>::T2 v = Half16<T>::pack(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The instruction's A and B type for T: "bf16" or "f16", pasted into the
// asm text below as a literal.
#define WG_TYPED(T, BODY)                       \
  if constexpr (std::is_same<T, __half>::value) { \
    BODY("f16");                                \
  } else {                                      \
    static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 or f16"); \
    BODY("bf16");                               \
  }

// D(64 x 256, f32) (+)= A(64 x 16, registers) * B(16 x 256, MN-major in shared memory)
template <typename T>
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
#define WG_BODY(TY)                                                                           \
  asm volatile(                                                                               \
      "{\n.reg .pred p;\n"                                                                    \
      "setp.ne.b32 p, %133, 0;\n"                                                             \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "                            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "      \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "      \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "      \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "      \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, " \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                                      \
      : WG_ACC128(d)                                                                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate))
  WG_TYPED(T, WG_BODY)
#undef WG_BODY
}

// D(64 x 128, f32) (+)= A(64 x 16, registers) * B(16 x 128, MN-major in shared memory)
template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
#define WG_BODY(TY)                                                                      \
  asm volatile(                                                                          \
      "{\n.reg .pred p;\n"                                                               \
      "setp.ne.b32 p, %69, 0;\n"                                                         \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                       \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                      \
      : WG_ACC64(d)                                                                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate))
  WG_TYPED(T, WG_BODY)
#undef WG_BODY
}

// D(64 x 64, f32) (+)= A(64 x 16, registers) * B(16 x 64, MN-major in shared memory)
template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
#define WG_BODY(TY)                                                                      \
  asm volatile(                                                                          \
      "{\n.reg .pred p;\n"                                                               \
      "setp.ne.b32 p, %37, 0;\n"                                                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                        \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                      \
      : WG_ACC32(d)                                                                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate))
  WG_TYPED(T, WG_BODY)
#undef WG_BODY
}

// D(64 x 32, f32) (+)= A(64 x 16, registers) * B(16 x 32, MN-major in shared memory)
template <typename T>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
#define WG_BODY(TY)                                                                \
  asm volatile(                                                                    \
      "{\n.reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %21, 0;\n"                                                   \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "   \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                                \
      : WG_ACC16(d)                                                                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate))
  WG_TYPED(T, WG_BODY)
#undef WG_BODY
}

// D(64 x 64, f32) (+)= A(64 x 16) * B(16 x 64), both K-major in shared memory;
// accumulate = 0 overwrites D.
template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
#define WG_BODY(TY)                                                                      \
  asm volatile(                                                                          \
      "{\n.reg .pred p;\n"                                                               \
      "setp.ne.b32 p, %34, 0;\n"                                                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                        \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                    \
      : WG_ACC32(d)                                                                      \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))
  WG_TYPED(T, WG_BODY)
#undef WG_BODY
}

#undef WG_TYPED

// TF32 (f32 with a 10-bit mantissa, as cvt.rna.tf32.f32 rounds: to nearest,
// ties away from zero). wgmma reads .tf32 operands K-major only (no
// transpose bit); the register A operand of one k8 step of warp w holds
// a[0] = (row 16w + g, k t), a[1] = (16w + g + 8, t), a[2] = (16w + g, t + 4),
// a[3] = (16w + g + 8, t + 4), lane = 4g + t: what ldmatrix_x4 returns for
// f32 rows when lane l addresses row l % 16 at 16-byte chunk 2 kk + l / 16
// (each b16 pair is one f32). In a 128- or 64-byte swizzled K-major tile a
// k8 step advances the start address by 32 bytes, as a bf16 k16 does.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// D(64 x 64, f32) (+)= A(64 x 8) * B(8 x 64), tf32, both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k8_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : WG_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D(64 x 128, f32) (+)= A(64 x 8, tf32 registers) * B(8 x 128, tf32, K-major in shared memory);
// accumulate = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n128k8_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D(64 x 64, f32) += A(64 x 8, tf32 registers) * B(8 x 64, tf32, K-major in shared memory)
__device__ __forceinline__ void wgmma_m64n64k8_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

// D(64 x 32, f32) += A(64 x 8, tf32 registers) * B(8 x 32, tf32, K-major in shared memory)
__device__ __forceinline__ void wgmma_m64n32k8_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : WG_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

#undef WG_ACC8
#undef WG_ACC16
#undef WG_ACC32
#undef WG_ACC64
#undef WG_ACC128

// ---------------------------------------------------------------------------
// Host side.

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tensor map of `rank` dimensions (innermost first) with byte strides of
// dimensions 1.. and a box of `box` elements of `type` (bf16, f16 or f32:
// Half16<T>::kMapType for the 16-bit ones); coordinates outside the tensor
// read as zeros. Returns 0, or a negative code.
inline int make_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                    const uint64_t* strides, const uint32_t* box, int row_bytes,
                    CUtensorMapDataType type) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -10;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, (cuuint32_t)rank,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -100 - (int)r;
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return n;
}

}  // namespace hopper
