// The streamed-tile machinery of the flash-attention kernels on wgmma and
// TMA, shared by the forward (K2, flash_fwd.cu) and the backward (B3 and
// B4, flash_bwd.cu): the tensor maps of [B, S, H, D] views, the gather of
// wgmma A fragments from a landed TMA chunk, the products in flight over
// a chunk, and the B planes a kernel writes itself (its resident rows, and
// P or dS each tile). N is the wgmma N of a product: the resident rows
// it multiplies, 32 (B3, B4; K2's smaller blocks) or 64 (K2).
//
// A streamed tile is kTile = 64 rows (wgmma's M) of K, V, Q or dO; it
// arrives in chunks of [64 rows x 64 columns of D] as two TMA boxes of
// [64 rows x 32 floats] with the 128-byte swizzle, 16 KB a chunk, into a
// ring of stages that each kernel lays out and tracks with mbarriers.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace flash {

constexpr int kTile = 64;      // streamed rows per tile: wgmma's M
constexpr int kChunk = 64;     // columns of D per streamed chunk
constexpr int kBox = 32;       // floats per TMA box row: 128 bytes
constexpr int kThreads = 256;  // two warpgroups
constexpr int kChunkBytes = 4 * kTile * kChunk;
constexpr int kBoxBytes = 4 * kTile * kBox;
constexpr float kMaskBias = -1e30f;

__device__ __forceinline__ float key_bias(const float* mask, int b, int S,
                                          int key) {
  return (mask == nullptr || mask[(long)b * S + key] > 0.f) ? 0.f : kMaskBias;
}

// Offset (floats) of element (n, k) of k-step ks of a B plane [ks][N n][8 k]
// (tf32::wgmma_desc's core-matrix order).
template <int N>
__device__ __forceinline__ int plane_at(int ks, int n, int k) {
  return ks * 8 * N + (n >> 3) * 64 + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
}

using AFrag = uint32_t[4][4];  // four k-steps of A fragments

// Where this thread reads its A fragments in a landed chunk: byte offsets
// within a TMA box (rows of 128 bytes whose 16-byte chunks are XOR-
// swizzled by the row's low three bits; the boxes are 1024-byte aligned).
struct Gather {
  // By row: tile row 16w + g, columns 2t and 2t + 1 of 16-byte chunk pair
  // (2j, 2j + 1) are 8 bytes at row ^ (2j << 4); row + 8 is 1024 bytes
  // further.
  uint32_t row;
  // By column: column 16 (w % 2) + g + 8e of tile row 2t + e' is at
  // col[2e + e'] in box w / 2; tile row 8kk + 2t + e' is 1024 kk further.
  uint32_t col[4];
  uint32_t col_box;  // w / 2 boxes in

  __device__ __forceinline__ Gather(int w, int g, int t) {
    row = (16 * w + g) * 128 + (((t >> 1) ^ g) << 4) + 8 * (t & 1);
    const int c4 = 4 * (w & 1) + (g >> 2);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2)
        col[2 * e + e2] = (2 * t + e2) * 128 +
                          (((c4 + 2 * e) ^ (2 * t + e2)) << 4) + 4 * (g & 3);
    col_box = (w >> 1) * kBoxBytes;
  }

  // A = the chunk's tile rows 16w + g (+ 8) x its columns 8kk + 2t (k = t)
  // and 8kk + 2t + 1 (k = t + 4), k-steps kk = 4H .. 4H + 3 (box H); the
  // resident planes hold D in the same order within each k-step.
  template <int H>
  __device__ __forceinline__ void rows(AFrag& big, AFrag& small,
                                       uint32_t chunk) const {
    const uint32_t a = chunk + H * kBoxBytes + row;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t at = a ^ ((2 * k) << 4);
      const float2 lo = tf32::lds2(at), hi = tf32::lds2(at + 1024);
      tf32::split_trunc(lo.x, big[k][0], small[k][0]);
      tf32::split_trunc(hi.x, big[k][1], small[k][1]);
      tf32::split_trunc(lo.y, big[k][2], small[k][2]);
      tf32::split_trunc(hi.y, big[k][3], small[k][3]);
    }
  }

  // A = the chunk transposed: its columns 16w + g (+ 8) x tile rows
  // 8kk + 2t (k = t) and 8kk + 2t + 1 (k = t + 4), kk = 4H .. 4H + 3.
  template <int H>
  __device__ __forceinline__ void cols(AFrag& big, AFrag& small,
                                       uint32_t chunk) const {
    const uint32_t box = chunk + col_box + 1024 * 4 * H;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t at = box + 1024 * k;
      tf32::split_trunc(tf32::lds(at + col[0]), big[k][0], small[k][0]);
      tf32::split_trunc(tf32::lds(at + col[2]), big[k][1], small[k][1]);
      tf32::split_trunc(tf32::lds(at + col[1]), big[k][2], small[k][2]);
      tf32::split_trunc(tf32::lds(at + col[3]), big[k][3], small[k][3]);
    }
  }
};

// Products in flight. A product is d = A B over the 8 k-steps of a chunk
// in 3xTF32: 24 wgmmas m64nNk8 in two commit groups (halves of 4
// k-steps), A gathered from the landed chunk into the half's register
// set, B from a big and a small plane (descriptors of the product's first
// k-step), summed from zero into partial d[P], P alternating within a
// phase. The next product's first half is gathered while this one's
// second half runs, so the tensor cores always have a group queued.
template <int N>
struct Pipe {
  AFrag big[2], small[2];
  float d[2][N / 2];
};

template <int H, int N>
__device__ __forceinline__ void issue_half(float (&d)[N / 2], const AFrag& big,
                                           const AFrag& small, uint64_t b_big,
                                           uint64_t b_small) {
  constexpr uint64_t kDescStep = 4 * 8 * N >> 4;  // a k-step of a plane
  tf32::wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k)
    tf32::wgmma(d, small[k], b_big + (4 * H + k) * kDescStep);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    tf32::wgmma(d, big[k], b_small + (4 * H + k) * kDescStep);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    tf32::wgmma(d, big[k], b_big + (4 * H + k) * kDescStep);
  tf32::wgmma_commit();
}

template <int R>
__device__ __forceinline__ void add(float (&acc)[R], const float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += d[i];
}

// A product of a phase, into partial P (its index in the phase mod 2),
// A read from `chunk` by row or column. Once its A fragments are read, the
// calling warp releases the chunk's stage (`release`); the previous
// product's partial sum, complete once this one's first half is queued,
// is added to `prev` unless this is the phase's first product.
template <int P, bool kByRow, int N, class Release>
__device__ __forceinline__ void issue(Pipe<N>& q, bool first, const Gather& ga,
                                      uint32_t chunk, uint64_t b_big,
                                      uint64_t b_small, Release release,
                                      float (&prev)[N / 2]) {
  float(&d)[N / 2] = q.d[P];
  float(&d_prev)[N / 2] = q.d[P ^ 1];
  tf32::wgmma_wait<1>();  // the previous product's first half: set 0 free
  tf32::fence_operand(q.big[0]);
  tf32::fence_operand(q.small[0]);
  if (kByRow) ga.rows<0>(q.big[0], q.small[0], chunk);
  else ga.cols<0>(q.big[0], q.small[0], chunk);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  tf32::fence_operand(d);
  issue_half<0, N>(d, q.big[0], q.small[0], b_big, b_small);
  tf32::wgmma_wait<1>();  // its second half: set 1 free, d_prev complete
  tf32::fence_operand(d_prev);
  tf32::fence_operand(q.big[1]);
  tf32::fence_operand(q.small[1]);
  if (!first) add(prev, d_prev);
  if (kByRow) ga.rows<1>(q.big[1], q.small[1], chunk);
  else ga.cols<1>(q.big[1], q.small[1], chunk);
  release();
  issue_half<1, N>(d, q.big[1], q.small[1], b_big, b_small);
}

// Wait for every product of the phase; the last one's sum (partial P) is
// added to `dest`.
template <int P, int N>
__device__ __forceinline__ void drain(Pipe<N>& q, float (&dest)[N / 2]) {
  tf32::wgmma_wait<0>();
  float(&d)[N / 2] = q.d[P];
  tf32::fence_operand(d);
  tf32::fence_operand(q.big[0]);
  tf32::fence_operand(q.small[0]);
  tf32::fence_operand(q.big[1]);
  tf32::fence_operand(q.small[1]);
  add(dest, d);
}

// Named barriers: all 128 threads of one group, or 128 that arrive and
// 128 that wait between the two groups.
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + grp) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// The planes' offset (floats) of this thread's accumulator element
// v[4i + e] (tile row 16w + g + 8 (e / 2), resident column 8i + 2t +
// e % 2) as a B operand of the products over the tile: k-step = row / 8,
// k = the row's place in Gather::cols' order.
template <int N>
__device__ __forceinline__ int pds_at(int i, int e, int w, int g, int t) {
  return plane_at<N>(2 * w + (e >> 1), 8 * i + 2 * t + (e & 1),
                     (g >> 1) | ((g & 1) << 2));
}

// v split into the B planes at shared addresses big, small.
template <int N>
__device__ __forceinline__ void store_planes(uint32_t big, uint32_t small,
                                             const float (&v)[N / 2], int w,
                                             int g, int t) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t at = 4 * pds_at<N>(i, e, w, g, t);
      uint32_t hi, lo;
      tf32::split(v[4 * i + e], hi, lo);
      tf32::sts(big + at, hi);
      tf32::sts(small + at, lo);
    }
  tf32::fence_proxy_async();
}

// Resident rows r0 .. r0 + N - 1 of a [S, D] head slice (row stride ss
// floats, 16-byte aligned rows) split into big and small B planes at
// shared addresses big, small, the products over D's k-steps (zeros past
// S), by kBy threads (i0: this thread's index among them).
template <int N, int D, int kBy = 128>
__device__ __forceinline__ void split_rows(uint32_t big, uint32_t small,
                                           const float* src, long ss, int r0,
                                           int S, int i0) {
  for (int i = i0; i < N * D / 4; i += kBy) {
    const int n = i / (D / 4), d = 4 * (i % (D / 4)), s = r0 + n;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) x = *reinterpret_cast<const float4*>(src + s * ss + d);
    // column d + j of D is k = (j >> 1) + 4 (j & 1) of k-step d / 8 when
    // d % 8 == 0 (Gather::rows' order), k = that + 2 when d % 8 == 4
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t hi, lo;
      tf32::split(v[j], hi, lo);
      const int k = ((d & 4) >> 1) + (j >> 1) + 4 * (j & 1);
      const uint32_t at = 4 * plane_at<N>(d >> 3, n, k);
      tf32::sts(big + at, hi);
      tf32::sts(small + at, lo);
    }
  }
}

// cuTensorMapEncodeTiled, a driver function, reached through the runtime
// so that the library need not link libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The tensor map of a [B, S, H, D] float32 view with element strides
// st = {b, s, h} and a unit stride on D: boxes of [kTile rows][kBox
// floats] at coordinates (d, h, s, b), 128-byte swizzle, zeros outside.
// The stride of an axis of extent 1 is never followed, so it is given the
// packed value. Returns 0 or a CUDA error code.
inline int make_map(CUtensorMap* map, const float* base, int B, int S, int H,
                    int D, const long* st) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const long sh = H > 1 ? st[2] : D;
  const long ss = S > 1 ? st[1] : (long)H * sh;
  const long sb = B > 1 ? st[0] : (long)S * ss;
  const cuuint64_t strides[3] = {(cuuint64_t)(4 * sh), (cuuint64_t)(4 * ss),
                                 (cuuint64_t)(4 * sb)};
  const cuuint32_t box[4] = {kBox, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace flash
