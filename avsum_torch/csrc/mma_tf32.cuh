// Tensor-core helpers shared by the port's kernels: float32 products on
// Hopper's TF32 tensor cores at float32-level accuracy by wgmma (a
// warpgroup of four warps; K1, K2, B3, B4), the cp.async copies that feed
// K1, and the mbarriers and TMA loads that feed K2, B3 and B4
// (flash_tiles.cuh).
//
// 3xTF32. TF32 keeps 10 of float32's 23 mantissa bits, about three
// decimal digits. Each operand x is split as x = big + small, big =
// tf32(x) (round to nearest) and small = tf32(x - big); the product
// a * b is then summed as a_small * b_big + a_big * b_small + a_big * b_big
// (small terms first). Only small * small, ~2^-22 of |a b|, is dropped,
// and each short run of k-steps is summed from zero before it is added to
// the accumulator in float32 (see wgmma3), so a dot product keeps
// float32's accuracy. Three products each, at a third of the TF32 rate.
//
// The tensor cores read a .tf32 operand from the top 19 bits of its
// register and ignore the low 13, so a float32 with half a TF32 ulp
// (0x1000) added to its bits is read as the nearest TF32 value (ties away
// from zero, as cvt.rna): split() costs four integer and float
// instructions where two cvt.rna.tf32.f32, which also check for Inf and
// NaN, cost seven. The operands here are finite.
//
// A wgmma's A operand from registers is, in each warp, an m16n8k8 A
// fragment: with g = lane / 4 and t = lane % 4 it holds (row m, column k)
//   a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
// and its accumulator is N / 8 m16n8 C fragments, each
//   c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// The contraction index k may be permuted freely as long as A and B agree,
// which the kernels use to read two A values with one 8-byte load.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// x -> (big, small) as the MMA reads them: big = tf32(x) exactly (low
// bits cleared, since x - big needs its value), small = x - big with half
// a TF32 ulp added, which the MMA's truncation turns into tf32(x - big).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// x -> (big, small) in two instructions, for operands read once: big =
// x truncated to TF32, small = x - big exactly, which the MMA reads
// truncated too. Each part loses less than 2^-10 of itself, so a product
// keeps ~2^-20 of |a b| against split()'s ~2^-22; B3 and B4 take it for
// the A fragments they read from every streamed tile
// (tests/test_torch_flash_split.py holds it to their tolerance).
__device__ __forceinline__ void split_trunc(float x, uint32_t& big,
                                            uint32_t& small) {
  big = __float_as_uint(x) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared of the first src_bytes (0 to 16)
// bytes, zero-filling the rest (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wgmma: Hopper's warpgroup MMA, m64nNk8 .f32.tf32.tf32 with A from
// registers. The four warps of a warpgroup (warps 4i .. 4i + 3) multiply
// their 64 rows, warp w holding rows 16 (w % 4) .. + 15 as an m16n8k8 A
// fragment (above), by an 8 x N B operand that the hardware reads from
// shared memory once for all four warps (mma.sync would have every warp
// load its own copy). The accumulator is N / 8 m16n8 C fragments, d[4i .. 4i + 3]
// for columns 8i .. 8i + 7. The call is asynchronous: it is fenced,
// committed and waited for before d or a's registers are touched again
// (wgmma3 does all three).
//
// A B plane (8 x N floats) is K-major without swizzle: 8-row x 16-byte
// core matrices, element (n, k) at byte (n / 8) * 256 + (k / 4) * 128 +
// (n % 8) * 16 + (k % 4) * 4 (K1's wrapper lays its bases out so:
// avsum_torch/ops/melspec.py, _planes).
__device__ __forceinline__ uint64_t wgmma_desc_at(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF)  // start address
         | ((uint64_t)(128 >> 4) << 16)    // LBO: the next core matrix in K
         | ((uint64_t)(256 >> 4) << 32);   // SBO: the next 8 rows in N
}

// The same for a plane by pointer. Its k-steps of 8 x N floats follow each
// other every 32 N bytes, so k-step ks's descriptor is this plus 2 N ks
// (the start address counts 16 bytes).
__device__ __forceinline__ uint64_t wgmma_desc(const float* plane) {
  return wgmma_desc_at(smem_addr(plane));
}

// Shared-memory writes by this thread (st.shared, cp.async) made visible
// to the wgmma's reads (the async proxy); then a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of d across the wgmma
// fence, commit and wait around it.
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a * b, one k-step; N = 32, 64 or 128 by the size of d.
__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// Register writes by this thread ordered before the wgmmas that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += sum over k < K of a[k] * B[k] in 3xTF32, a = big + small split
// (the small terms of every k-step first). The tensor cores round their
// float32 sums toward zero, so an accumulator that takes product after
// product drifts by up to an ulp of its own size a step, all one way
// (~1e-5 after a few hundred): where that matters, d starts from zero for
// a short run of k-steps and is then added to the accumulator by one
// ordinary float32 add (round to nearest). B[k]'s big plane is at
// planes + 2k * PF floats, its small plane PF further.
template <int PF, int R, int K>
__device__ __forceinline__ void wgmma3(float (&d)[R],
                                       const uint32_t (&big)[K][4],
                                       const uint32_t (&small)[K][4],
                                       const float* planes) {
  fence_operand(d);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < K; ++k) wgmma(d, small[k], wgmma_desc(planes + 2 * k * PF));
#pragma unroll
  for (int k = 0; k < K; ++k)
    wgmma(d, big[k], wgmma_desc(planes + (2 * k + 1) * PF));
#pragma unroll
  for (int k = 0; k < K; ++k) wgmma(d, big[k], wgmma_desc(planes + 2 * k * PF));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(d);
}

// As fence_operand, for A fragments: keeps them alive until the wgmmas
// that read them were waited for.
template <int K>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// mbarriers (8 bytes of shared memory each, by shared address) and TMA
// loads. A TMA load copies a box of a tensor map into shared memory and
// counts its bytes against the mbarrier's expected transaction bytes; the
// barrier's phase completes when every expected arrival has arrived and
// every byte has landed.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Makes the initialized barriers visible to the async proxy (TMA); then a
// __syncthreads.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` more transaction bytes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A new barrier is
// in phase 0, so a wait for parity 1 returns at once.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: the box of the 4-D tensor map `map` (a __grid_constant__ kernel
// parameter) at coordinates (c0, c1, c2, c3), innermost first, into
// shared memory at dst, completing on bar. Elements outside the tensor
// land as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory loads and stores by shared address; volatile, so that they
// keep their place among the barrier waits and wgmmas around them.
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

}  // namespace tf32
