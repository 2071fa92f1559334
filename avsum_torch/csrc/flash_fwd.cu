// Flash-attention forward: O = softmax(Q K^T / sqrt(D) + key bias) V with
// an online softmax, float32 throughout; the [S, S] probabilities never
// reach device memory. Also writes LSE = m + log(l) per query row.
//
// Replaces the TPU kernel avsum_tpu/ops/attention.py::_flash_fwd_kernel
// (pallas_call in _flash_fwd; wrapper flash_attention). Python wrapper:
// avsum_torch/ops/attention.py.
//
// Layout: q, k, v are [B, S, H, D] views read through their (b, s, h)
// strides with a unit stride on D, so the scorer's fused qkv projection
// [B, S, 3, H, D] is read in place; they arrive by 16-byte cp.async, so
// those strides must be multiples of 4 floats and the base addresses
// 16-byte aligned (the wrapper copies a view that is not). Out is
// [B, S, H, D] contiguous, LSE [B, H, S]. Keys past S (the ragged last
// tile) are skipped, so S needs no padding; masked keys get a -1e30 bias,
// and a row whose keys are all masked averages V uniformly over the S
// keys (the materialized softmax's answer). The denominator is clamped at
// 1e-30 as in the TPU kernel.
//
// What bounds it on an H100: arithmetic. 4 * S^2 * D flops per head (two
// S x S x D products) against O(S * D) bytes: at [1, 544, 4, 256] 1.21
// GFLOP against 6.7 MB of q, k, v and out (2 us at 3.35 TB/s); in 3xTF32
// (three TF32 products each, for float32's accuracy) that is at least
// 7.3 us at the dense TF32 peak of 495 TFLOP/s. And at the scorer's
// shortest kernel sequences the grid is small: B * H * ceil(S / 32) = 68
// blocks of 32 queries at [1, 544, 4, D], for 132 SMs.
//
// Design: the TPU grid walked key blocks in order with VMEM scratch; here
// a block of 8 warps owns (b, h, kRows = 16 MT queries) and loops over
// tiles of kKeys = 4096 / D keys (16 at D = 256, 32 at D = 128), with
// both products on the tensor cores, mma.sync m16n8k8 TF32 in the 3xTF32
// split (mma_tf32.cuh). Per tile:
//   1. S = Q K^T [kRows x kKeys]: each warp takes one (m-tile, 16 keys)
//      pair and one of the D-parts that 8 warps leave per pair, and
//      computes its two 8-key n-tiles over that part with B3's fragment
//      loads (float4s of the swizzled rows); the partial sums go to shared
//      memory.
//   2. The online softmax: 256 / kRows threads per query row sum the
//      parts of its keys and reduce the row's max and sum by shuffles
//      within the row's lanes; they keep the row's running max and sum in
//      registers and write P and the rescale alpha = exp(m_old - m_new) to
//      shared memory.
//   3. O = alpha O + P V over the tile's keys: warp w owns columns
//      [w D / 8, (w + 1) D / 8) of O for all kRows rows, in registers (32 a
//      thread at D = 256, MT = 2). Within each group of NT = D / 64 n-tiles
//      a warp owns, n-tile i's column g is column NT g + i, so the B
//      fragments of all NT n-tiles at one key are NT consecutive floats of
//      a V row, one vector load. P's A fragments are float2 loads.
// Q stays resident; K and V tiles (and the tile's key mask) are
// double-buffered: the next tile's 16-byte cp.async copies are issued
// before this tile's products. Three barriers a tile, and the softmax
// between them, cost the same at any kKeys, so the tile is as long as
// two blocks per SM allow (95 and 111 KB of shared memory at D = 128 and
// 256 with 32-query blocks): on an H100, 32-key tiles at D = 128 took
// 3.08 ms at [1, 7168, 4, 128] against 3.83 with 16, and 32-key tiles at
// D = 256 (one block per SM) 6.46 ms against 6.11 at [1, 7168, 4, 256]
// (scripts/time_flash_torch.py).
// The launcher takes MT = 2 (32 queries a block), or MT = 1 where
// B * H * ceil(S / 32) is below the card's SM count: at [1, 544, 4, D]
// that makes 136 blocks of 16 queries, which two-per-SM residency holds
// in one wave, instead of 68 of 32 that leave half the SMs idle. At long
// S a 32-query block reads each K / V tile for twice the queries, halving
// the tiles' traffic from L2.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMaskBias = -1e30f;

template <int D, int MT>
struct FwdSmem {
  static constexpr int kRows = 16 * MT;         // queries per block
  static constexpr int kKeys = 4096 / D;        // keys per K / V tile
  static constexpr int kPitch = kKeys + 8;      // rows of the S parts and P
  static constexpr int kPairs = MT * kKeys / 16;  // (m-tile, 16 keys) pairs
  static constexpr int kParts = kWarps / kPairs;  // D-parts of the S product
  static constexpr size_t kFloats =
      (size_t)kRows * D                  // Q
      + 4 * (size_t)kKeys * D            // two stages of K and V
      + (size_t)kParts * kRows * kPitch  // S partial sums
      + (size_t)kRows * kPitch           // P
      + 2 * (size_t)kKeys                // two stages of the key mask
      + 2 * (size_t)kRows;               // alpha, the final row sums
  // blocks that share an SM's 228 KB (1 KB of it reserved for each)
  static constexpr int kBlocksPerSM =
      2 * (kFloats * sizeof(float) + 1024) <= 228 * 1024 ? 2 : 1;
};

template <int D, int MT>
__global__ void __launch_bounds__(kThreads, FwdSmem<D, MT>::kBlocksPerSM)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ mask,  // [B, S] or null
                 float* __restrict__ out, float* __restrict__ lse, int S,
                 int H, long qsb, long qss, long qsh, long ksb, long kss,
                 long ksh, long vsb, long vss, long vsh, float scale) {
  using Smem = FwdSmem<D, MT>;
  constexpr int kRows = Smem::kRows;
  constexpr int kKeys = Smem::kKeys;
  constexpr int kPitch = Smem::kPitch;
  constexpr int kPairs = Smem::kPairs;
  constexpr int kParts = Smem::kParts;
  constexpr int kSpan = D / kParts;              // D columns of an S part
  constexpr int NT = D / 64;                     // n-tiles of O per warp
  constexpr int kRowThreads = kThreads / kRows;  // softmax threads per row
  constexpr int kRowKeys = kKeys / kRowThreads;  // keys per softmax thread
  constexpr int kSteps = kKeys / 8;              // k-steps of P V per tile
  static_assert(kSpan % 16 == 0 && kRowKeys >= 1, "tiling");
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [kRows][D] swizzled
  float* sk = sq + kRows * D;                   // [2][kKeys][D] swizzled
  float* sv = sk + 2 * kKeys * D;               // [2][kKeys][D] swizzled
  float* ss = sv + 2 * kKeys * D;               // [kParts][kRows][kPitch]
  float* sp = ss + kParts * kRows * kPitch;     // [kRows][kPitch]  P
  float* smask = sp + kRows * kPitch;           // [2][kKeys]  key mask > 0
  float* salpha = smask + 2 * kKeys;            // [kRows]
  float* sl = salpha + kRows;                   // [kRows]

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;

  auto copy_tile = [&](int k0, int buf) {
    tf32::copy_rows<D, kKeys, kThreads>(sk + buf * kKeys * D, kb, kss, k0, S);
    tf32::copy_rows<D, kKeys, kThreads>(sv + buf * kKeys * D, vb, vss, k0, S);
    if (threadIdx.x < kKeys) {
      const int s = k0 + threadIdx.x;
      float* dst = smask + buf * kKeys + threadIdx.x;
      if (mask == nullptr) {
        *dst = 1.f;
      } else {
        tf32::cp_async4(dst, mask + (long)b * S + (s < S ? s : 0), s < S);
      }
    }
  };
  tf32::copy_rows<D, kRows, kThreads>(sq, q + b * qsb + h * qsh, qss, q0, S);
  copy_tile(0, 0);
  tf32::cp_async_commit();

  // 1: this warp's m-tile rows, 16 keys and D-part
  const int srow = 16 * (warp % kPairs % MT) + g;
  const int skey = 16 * (warp % kPairs / MT);
  const int part = warp / kPairs;
  float* s_part = ss + part * kRows * kPitch;
  // 2: this thread's query row and keys
  const int row = threadIdx.x / kRowThreads;
  const int key0 = (threadIdx.x % kRowThreads) * kRowKeys;
  float m_run = kMaskBias, l_run = 0.f;
  // 3: O columns [cb, cb + D / 8)
  const int cb = warp * (D / 8);
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  const int n_tiles = (S + kKeys - 1) / kKeys;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, k0 = it * kKeys;
    tf32::cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < n_tiles) copy_tile(k0 + kKeys, buf ^ 1);
    tf32::cp_async_commit();
    const float* tk = sk + buf * kKeys * D;
    const float* tv = sv + buf * kKeys * D;
    const float* tmask = smask + buf * kKeys;

    // 1. over this warp's part of D
    {
      float acc_s[2][4] = {};
      tf32::rows_dot<D, kSpan, kSpan / 16>(acc_s, sq, srow, tk, skey,
                                           part * kSpan);
      // c0..c3 of n-tile n: (row srow, key skey + 8n + 2t), (srow, + 1),
      // (srow + 8, ..)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int kj = skey + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(s_part + srow * kPitch + kj) =
            make_float2(acc_s[n][0], acc_s[n][1]);
        *reinterpret_cast<float2*>(s_part + (srow + 8) * kPitch + kj) =
            make_float2(acc_s[n][2], acc_s[n][3]);
      }
    }
    __syncthreads();  // the S parts are in shared memory

    // 2. Keys past S take no part; masked keys take part at -1e30.
    {
      float s[kRowKeys];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRowKeys; ++j) {
        const int key = key0 + j;
        float dot = 0.f;
#pragma unroll
        for (int p = 0; p < kParts; ++p) dot += ss[(p * kRows + row) * kPitch + key];
        const float bias = tmask[key] > 0.f ? 0.f : kMaskBias;
        s[j] = k0 + key < S ? dot * scale + bias : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
#pragma unroll
      for (int o = kRowThreads / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run, mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kRowKeys; ++j) {
        const float p = k0 + key0 + j < S ? expf(s[j] - m_new) : 0.f;
        sp[row * kPitch + key0 + j] = p;
        psum += p;
      }
#pragma unroll
      for (int o = kRowThreads / 2; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + psum;
      m_run = m_new;
      if (threadIdx.x % kRowThreads == 0) salpha[row] = alpha;
    }
    __syncthreads();  // P and alpha are in shared memory

    // 3. K-step j covers keys 8j .. 8j + 7: k = t is key 8j + 2t and
    // k = t + 4 is key 8j + 2t + 1, in A (a float2 of the P rows) and in B
    // (rows 8j + 2t, 8j + 2t + 1 of V) alike.
    {
      tf32::FragB fv[kSteps][NT];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int kj = 8 * j + 2 * t;
        float lo[NT], hi[NT];
        tf32::load_vec<NT>(lo, tv + tf32::swz<D>(kj, cb + NT * g));
        tf32::load_vec<NT>(hi, tv + tf32::swz<D>(kj + 1, cb + NT * g));
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          fv[j][n].set(0, lo[n]);
          fv[j][n].set(1, hi[n]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int r = 16 * m + g;
        const float a_lo = salpha[r], a_hi = salpha[r + 8];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[m][n][0] *= a_lo; acc[m][n][1] *= a_lo;
          acc[m][n][2] *= a_hi; acc[m][n][3] *= a_hi;
        }
        tf32::FragA fp[kSteps];
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const int kj = 8 * j + 2 * t;
          const float2 p_lo = *reinterpret_cast<const float2*>(sp + r * kPitch + kj);
          const float2 p_hi = *reinterpret_cast<const float2*>(sp + (r + 8) * kPitch + kj);
          fp[j].set(0, p_lo.x); fp[j].set(1, p_hi.x);
          fp[j].set(2, p_lo.y); fp[j].set(3, p_hi.y);
        }
        tf32::mma3<NT, kSteps>(acc[m], fp, fv);
      }
    }
  }

  if (threadIdx.x % kRowThreads == 0) {
    const float l = fmaxf(l_run, 1e-30f);
    sl[row] = l;
    if (q0 + row < S) lse[((long)b * H + h) * S + q0 + row] = m_run + logf(l);
  }
  __syncthreads();  // the row sums are in shared memory

  // c0..c3 of (m, n): (row 16m + g, column cb + NT (2t) + n), (.., cb +
  // NT (2t + 1) + n), (row 16m + g + 8, ..): NT consecutive columns each
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * m + g + 8 * i, s = q0 + r;
      if (s >= S) continue;
      const float inv = 1.f / sl[r];
      float* orow = out + (((long)b * S + s) * H + h) * D + cb + 2 * NT * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) x[n] = acc[m][n][2 * i + e] * inv;
        tf32::store_vec<NT>(orow + NT * e, x);
      }
    }
}

template <int D, int MT>
int launch(const float* q, const float* k, const float* v, const float* mask,
           float* out, float* lse, int B, int S, int H, const long* qs,
           const long* ks, const long* vs, cudaStream_t stream) {
  constexpr int kRows = FwdSmem<D, MT>::kRows;
  const size_t smem = FwdSmem<D, MT>::kFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<D, MT><<<grid, kThreads, smem, stream>>>(
      q, k, v, mask, out, lse, S, H, qs[0], qs[1], qs[2], ks[0], ks[1],
      ks[2], vs[0], vs[1], vs[2], 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// 16-query blocks where 32-query blocks would not cover the card's SMs.
template <int D>
int launch_d(const float* q, const float* k, const float* v,
             const float* mask, float* out, float* lse, int B, int S, int H,
             const long* qs, const long* ks, const long* vs,
             cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if ((long)B * H * ((S + 31) / 32) < sms)
    return launch<D, 1>(q, k, v, mask, out, lse, B, S, H, qs, ks, vs, stream);
  return launch<D, 2>(q, k, v, mask, out, lse, B, S, H, qs, ks, vs, stream);
}

}  // namespace

// q, k, v: float32 [B, S, H, D] with element strides {b, s, h} in
// q_strides / k_strides / v_strides (multiples of 4, 16-byte aligned
// bases) and unit stride on D; mask: float32 [B, S] contiguous (> 0 =
// valid key) or null; out: [B, S, H, D] contiguous; lse: [B, H, S]. D
// must be 128 or 256 (returns cudaErrorInvalidValue otherwise). Returns
// cudaGetLastError().
extern "C" int avsum_flash_fwd(const void* q, const void* k, const void* v,
                               const void* mask, void* out, void* lse, int B,
                               int S, int H, int D, const long* q_strides,
                               const long* k_strides, const long* v_strides,
                               void* stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* mf = (const float*)mask;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return launch_d<128>(qf, kf, vf, mf, (float*)out, (float*)lse, B, S, H,
                         q_strides, k_strides, v_strides, st);
  if (D == 256)
    return launch_d<256>(qf, kf, vf, mf, (float*)out, (float*)lse, B, S, H,
                         q_strides, k_strides, v_strides, st);
  return (int)cudaErrorInvalidValue;
}
