// Hopper (sm_90a) building blocks for the tensor-core kernels, as inline
// PTX: mbarriers, TMA tile loads, wgmma shared-memory descriptors and the
// warpgroup matrix multiplies the flash-attention kernel issues.
//
// Shared-memory tiles are 64 rows x 128 bytes (64 bf16), written by TMA
// with the 128-byte swizzle and 1024-byte aligned: the canonical layout
// wgmma reads with the same swizzle. A wider matrix is a row of such
// panels, one after another.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA: the box at coordinates (c0, c1, c2) of a 3-D tensor map into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at `p`: `lbo` and `sbo`
// in bytes (K-major: sbo = 1024 between 8-row groups, lbo unused;
// MN-major: lbo = the stride between 64-element panels, sbo = 1024
// between 8-row groups along K).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
}

// 2^x on the special-function unit (subnormal results flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// The wgmma wrappers' operand lists, spelled once by the preprocessor:
// RT_D<n> is the constraint list "+f"(d[0]), ..., "+f"(d[n - 1]) of an
// n-register accumulator, RT_PH<n> the placeholders "%0, ..., %<n - 1>"
// that name it in the instruction (RT_PH10(t) is "%t0, ..., %t9, ").
#define RT_D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define RT_D32_AT(i) RT_D8(i), RT_D8(i + 8), RT_D8(i + 16), RT_D8(i + 24)
#define RT_D32 RT_D32_AT(0)
#define RT_D64 RT_D32_AT(0), RT_D32_AT(32)
#define RT_D128 RT_D64, RT_D32_AT(64), RT_D32_AT(96)
#define RT_PH10(t)                                                       \
  "%" #t "0, %" #t "1, %" #t "2, %" #t "3, %" #t "4, %" #t "5, %" #t "6, " \
  "%" #t "7, %" #t "8, %" #t "9, "
#define RT_PH30 RT_PH10() RT_PH10(1) RT_PH10(2)
#define RT_PH60 RT_PH30 RT_PH10(3) RT_PH10(4) RT_PH10(5)
#define RT_PH32 RT_PH30 "%30, %31"
#define RT_PH64 RT_PH60 "%60, %61, %62, %63"
#define RT_PH128                                                         \
  RT_PH60 RT_PH10(6) RT_PH10(7) RT_PH10(8) RT_PH10(9) RT_PH10(10)        \
  RT_PH10(11) "%120, %121, %122, %123, %124, %125, %126, %127"

// wgmma_m64n<N>k16_ss: D (64 x N) (+)= A (64 x 16, shared memory, K-major)
// * B (N x 16, shared memory, K-major)^T; bf16 inputs, f32 accumulators
// (NACC = N / 2 a thread); D is overwritten when scale_d is 0. OPERANDS
// and SCALE are the placeholders of the two descriptors and of scale_d.
#define RT_WGMMA_SS(N, NACC, OPERANDS, SCALE)                             \
  __device__ __forceinline__ void wgmma_m64n##N##k16_ss(                  \
      float (&d)[NACC], uint64_t desc_a, uint64_t desc_b, int scale_d) {  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"       \
                 "wgmma.mma_async.sync.aligned.m64n" #N                   \
                 "k16.f32.bf16.bf16 {" RT_PH##NACC " }, " OPERANDS        \
                 ", p, 1, 1, 0, 0;\n}\n"                                  \
                 : RT_D##NACC                                             \
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));               \
  }

// wgmma_m64n<N>k16_rs: D (64 x N) += A (64 x 16, registers) * B (16 x N,
// shared memory, MN-major); bf16 inputs, f32 accumulators. OPERANDS and
// SCALE are the placeholders of A's four registers and B's descriptor,
// and of the constant 1 that keeps D.
#define RT_WGMMA_RS(N, NACC, OPERANDS, SCALE)                             \
  __device__ __forceinline__ void wgmma_m64n##N##k16_rs(                  \
      float (&d)[NACC], const uint32_t (&a)[4], uint64_t desc_b) {        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"       \
                 "wgmma.mma_async.sync.aligned.m64n" #N                   \
                 "k16.f32.bf16.bf16 {" RT_PH##NACC " }, " OPERANDS        \
                 ", p, 1, 1, 1;\n}\n"                                     \
                 : RT_D##NACC                                             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),            \
                   "l"(desc_b), "r"(1));                                  \
  }

// Q K^T takes N = BK keys (TcCfg), P V takes N = head dim.
RT_WGMMA_SS(64, 32, "%32, %33", "%34")
RT_WGMMA_SS(128, 64, "%64, %65", "%66")
RT_WGMMA_RS(64, 32, "{%32, %33, %34, %35}, %36", "%37")
RT_WGMMA_RS(128, 64, "{%64, %65, %66, %67}, %68", "%69")
RT_WGMMA_RS(256, 128, "{%128, %129, %130, %131}, %132", "%133")

}  // namespace repro_torch
