// Tensor-core helpers shared by the port's kernels: float32 products on
// Hopper's TF32 tensor cores at float32-level accuracy, by mma.sync (one
// warp) or wgmma (a warpgroup of four), and the cp.async copies that feed
// them.
//
// 3xTF32. TF32 keeps 10 of float32's 23 mantissa bits, about three
// decimal digits. Each operand x is split as x = big + small, big =
// tf32(x) (round to nearest) and small = tf32(x - big); the product
// a * b is then summed as a_small * b_big + a_big * b_small + a_big * b_big
// (small terms first). Only small * small, ~2^-22 of |a b|, is dropped,
// and each short run of k-steps is summed from zero before it is added to
// the accumulator in float32 (see mma3), so a dot product keeps float32's
// accuracy. Three MMAs per product, at a third of the TF32 rate.
//
// The MMA reads a .tf32 operand from the top 19 bits of its register and
// ignores the low 13, so a float32 with half a TF32 ulp (0x1000) added to
// its bits is read as the nearest TF32 value (ties away from zero, as
// cvt.rna): split() costs four integer and float instructions where two
// cvt.rna.tf32.f32, which also check for Inf and NaN, cost seven. The
// operands here are finite.
//
// The MMA is mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, one warp.
// With g = lane / 4 and t = lane % 4 its fragments hold:
//   A (16 x 8, row m, column k): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                                a3 (g + 8, t + 4)
//   B (8 x 8, row k, column n):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):                  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                                c3 (g + 8, 2t + 1)
// The contraction index k may be permuted freely as long as A and B agree,
// which the kernels use to load two or four fragment values with one
// vector load, or to take C fragments as A fragments without a shuffle.

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

// An A fragment (4 values) or a B fragment (2 values), split.
template <int N>
struct Frag {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(int i, float x) {
    split(x, big[i], small[i]);
  }
};
using FragA = Frag<4>;
using FragB = Frag<2>;

// Not volatile: it has no side effect, so the compiler may schedule it.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b, from a zero accumulator.
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// c[n] += sum over k < K of a[k] * b[k][n], for N tiles of one row of
// tiles, at float32-level accuracy (3xTF32). The tensor cores round their
// float32 sums toward zero, so an accumulator that takes MMA after MMA
// drifts by up to an ulp of its own size a step, all one way (~1e-5 after
// a few hundred). So the 3K products of a tile are summed from zero, at
// the size of a K-step partial sum, and that sum is added to c by one
// ordinary float32 add (round to nearest). Each pass runs over all N
// tiles before the next, so consecutive MMAs are independent.
template <int N, int K>
__device__ __forceinline__ void mma3(float (*c)[4], const FragA* a,
                                     const FragB (*b)[N]) {
  float d[N][4];
#pragma unroll
  for (int n = 0; n < N; ++n) mma0(d[n], a[0].small, b[0][n].big);
#pragma unroll
  for (int k = 1; k < K; ++k)
#pragma unroll
    for (int n = 0; n < N; ++n) mma(d[n], a[k].small, b[k][n].big);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int n = 0; n < N; ++n) mma(d[n], a[k].big, b[k][n].small);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int n = 0; n < N; ++n) mma(d[n], a[k].big, b[k][n].big);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += d[n][e];
}

// One k-step: c[n] += a * b[n].
template <int N>
__device__ __forceinline__ void mma3_row(float (*c)[4], const FragA& a,
                                         const FragB* b) {
  mma3<N, 1>(c, &a, reinterpret_cast<const FragB(*)[N]>(b));
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

// 4-byte async copy global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Swizzled [rows][D] float32 tiles, as the flash-attention kernels keep
// them in shared memory: each row's 16-byte chunks are XOR-permuted by a
// function of the row's low three bits, so that a warp's float4 loads of
// one column chunk from eight rows (the fragment loads over D, rows_dot),
// and its loads of one to four columns from each of the rows 2t or
// 2t + 1, t < 4, at eight columns or column chunks g (the fragment loads
// over the rows), hit 32 distinct banks. D >= 32.
__device__ __forceinline__ int swizzle(int r) { return (r & 6) ^ ((r & 1) << 2); }

// Offset of element (r, c) of a swizzled [rows][D] tile.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((((c >> 2) ^ swizzle(r)) << 2) | (c & 3));
}

// cp.async rows [s0, s0 + ROWS) of a strided [S, D] head slice (row
// stride in floats, a multiple of 4, and a 16-byte aligned base) into a
// swizzled tile, by all kThreads threads of the block; rows past S become
// zeros.
template <int D, int ROWS, int kThreads>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long row_stride, int s0, int S) {
  for (int i = threadIdx.x; i < ROWS * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4)), s = s0 + r;
    const bool in = s < S;
    cp_async16(dst + swz<D>(r, c), src + (in ? s * row_stride + c : 0),
               in ? 16 : 0);
  }
}

// acc[n] += A rows (r, r + 8) . B rows (n0 + 8n + g), n = 0, 1, over the
// SPAN columns from c0 (a multiple of 16) of two swizzled [rows][D]
// tiles: one m-tile x two n-tiles of A B^T, as m16n8 C fragments. Over
// each 16 columns d0 .. d0 + 15, lane (g, t) loads the float4 at d0 + 4t
// of its A and B rows: k-step 0 takes columns d0 + 4t (k = t) and
// d0 + 4t + 1 (k = t + 4), k-step 1 the other two; A and B agree, so the
// sum is over all 16, one mma3.
template <int D, int SPAN, int UNROLL>
__device__ __forceinline__ void rows_dot(float (&acc)[2][4], const float* a,
                                         int r, const float* b, int n0,
                                         int c0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll (UNROLL)
  for (int d0 = c0; d0 < c0 + SPAN; d0 += 16) {
    const int c = d0 + 4 * t;
    const float4 lo = *reinterpret_cast<const float4*>(a + swz<D>(r, c));
    const float4 hi = *reinterpret_cast<const float4*>(a + swz<D>(r + 8, c));
    FragA fa[2];
    fa[0].set(0, lo.x); fa[0].set(1, hi.x); fa[0].set(2, lo.y); fa[0].set(3, hi.y);
    fa[1].set(0, lo.z); fa[1].set(1, hi.z); fa[1].set(2, lo.w); fa[1].set(3, hi.w);
    FragB fb[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float4 x = *reinterpret_cast<const float4*>(b + swz<D>(n0 + 8 * n + g, c));
      fb[0][n].set(0, x.x); fb[0][n].set(1, x.y);
      fb[1][n].set(0, x.z); fb[1][n].set(1, x.w);
    }
    mma3<2, 2>(acc, fa, fb);
  }
}

// N (2 or 4) consecutive floats from shared memory, 8 or 16 bytes aligned.
template <int N>
__device__ __forceinline__ void load_vec(float (&out)[N], const float* p) {
  static_assert(N == 2 || N == 4, "load_vec takes 2 or 4 floats");
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  }
}

// N consecutive floats to device memory, 8 or 16 bytes aligned.
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[N]) {
  static_assert(N == 2 || N == 4, "store_vec takes 2 or 4 floats");
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// wgmma: Hopper's warpgroup MMA, m64nNk8 .f32.tf32.tf32 with A from
// registers. The four warps of a warpgroup (warps 4i .. 4i + 3) multiply
// their 64 rows, warp w holding rows 16 (w % 4) .. + 15 as an m16n8k8 A
// fragment (above), by an 8 x N B operand that the hardware reads from
// shared memory once for all four warps; mma.sync has every warp load its
// own copy. The accumulator is N / 8 m16n8 C fragments, d[4i .. 4i + 3]
// for columns 8i .. 8i + 7. The call is asynchronous: it is fenced,
// committed and waited for before d or a's registers are touched again
// (wgmma3 does all three).
//
// A B plane (8 x N floats) is K-major without swizzle: 8-row x 16-byte
// core matrices, element (n, k) at byte (n / 8) * 256 + (k / 4) * 128 +
// (n % 8) * 16 + (k % 4) * 4 (K1's wrapper lays its bases out so:
// avsum_torch/ops/melspec.py, _planes).
__device__ __forceinline__ uint64_t wgmma_desc(const float* plane) {
  const uint32_t a = smem_addr(plane);
  return (uint64_t)((a >> 4) & 0x3FFF)     // start address
         | ((uint64_t)(128 >> 4) << 16)    // LBO: the next core matrix in K
         | ((uint64_t)(256 >> 4) << 32);   // SBO: the next 8 rows in N
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

// d += a * b, one k-step; N = 64 or 128 by the size of d.
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

// d += sum over k < K of a[k] * B[k] in 3xTF32, a = big + small split
// (the small terms of every k-step first): the wgmmas chain in d, whose
// own sums round toward zero, so d should start from zero where that drift
// matters (see mma3). B[k]'s big plane is at planes + 2k * PF floats, its
// small plane PF further.
template <int PF, int R, int K>
__device__ __forceinline__ void wgmma3(float (&d)[R],
                                       const uint32_t (&big)[K][4],
                                       const uint32_t (&small)[K][4],
                                       const float* planes) {
  fence_operand(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < K; ++k) wgmma(d, small[k], wgmma_desc(planes + 2 * k * PF));
#pragma unroll
  for (int k = 0; k < K; ++k)
    wgmma(d, big[k], wgmma_desc(planes + (2 * k + 1) * PF));
#pragma unroll
  for (int k = 0; k < K; ++k) wgmma(d, big[k], wgmma_desc(planes + 2 * k * PF));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operand(d);
}

}  // namespace tf32
