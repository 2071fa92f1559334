// Flash-attention backward, float32 throughout: the gradients of
// O = softmax(Q K^T / sqrt(D) + key bias) V, with the probabilities
// recomputed tile by tile as P = exp(S - LSE) from the forward's LSE, so
// the [S, S] matrices never reach device memory. Two kernels, as on the
// TPU, so no output is shared between blocks and no atomics are needed:
//
//   B3 flash_bwd_dkv_kernel: dV = P^T dO, dK = D^-1/2 dS^T Q
//   B4 flash_bwd_dq_kernel:  dQ = D^-1/2 dS K
//
// with dP = dO V^T and dS = P o (dP - delta), delta = rowsum(dO o O)
// computed by the caller. They replace the TPU kernels
// avsum_tpu/ops/attention.py::_flash_bwd_dkv_kernel and
// ::_flash_bwd_dq_kernel (pallas_calls in _flash_bwd). Python wrappers:
// avsum_torch/ops/attention.py (flash_bwd_dkv, flash_bwd_dq, and the
// autograd Function that runs flash_fwd.cu, then these two).
//
// Layout: q, k, v, dO are [B, S, H, D] views read through their (b, s, h)
// strides with a unit stride on D (q, k, v are slices of the scorer's
// fused qkv projection; dO is whatever autograd hands the Function).
// LSE and delta are [B, H, S]; dQ, dK, dV are [B, S, H, D] contiguous.
// Rows past S (the ragged last tile) are loaded as zeros, get P = 0 and
// are never written, so S needs no padding. Masked keys have bias -1e30,
// so P is exactly 0 there. A query row whose keys are all masked has
// LSE = -1e30 in float32, so its recomputed P is 1 rather than 1/S (the
// TPU kernel does the same); the scorer multiplies every attention
// output by the mask, so dO, and with it every gradient term from such a
// row, is 0.
//
// What bounds it on an H100: arithmetic. B3 does 8 * S^2 * D flops per
// head (four S x S x D products, counting the recomputed scores), B4
// 6 * S^2 * D (three), against O(S * D) bytes: at [1, 1024, 4, 256], 16.8
// MB of q, k, v, dO (5 us at 3.35 TB/s) against 8.6 and 6.4 GFLOP, which
// in 3xTF32 (three TF32 products each) take at least 52 and 39 us at the
// dense TF32 peak of 495 TFLOP/s. The TPU grid walked its inner blocks in
// order, carrying dK/dV (or dQ) in VMEM scratch; here one block owns
// (b, h, 32 rows) and loops over the 32-row tiles of the other side
// itself, with its accumulators in registers.
//
// Both run every product on the tensor cores, mma.sync m16n8k8 TF32 in
// the 3xTF32 split for float32-level accuracy (mma_tf32.cuh; see the
// notes above the kernels for their tilings). mma.sync rather than wgmma:
// a wgmma takes 64 rows, so 64-row blocks (64 blocks at [1, 1024, 4, D]
// on 132 SMs) or 64-row tiles, and its shared-memory B operands would
// need split (big, small) planes of every streamed tile, which at
// D = 256 do not fit beside the double buffers; mma.sync's fragments are
// split in registers as they are loaded, and P and dS go through shared
// memory in the layouts the last products take. The streamed and the
// resident tiles arrive by 16-byte cp.async into XOR-swizzled rows
// (mma_tf32.cuh), so the (b, s, h) strides of q, k, v and dout must be
// multiples of 4 floats and their base addresses 16-byte aligned (the
// wrapper copies a tensor that is not). Block shape: 32 rows, so
// [1, 1024, 4, D] is 128 blocks, one wave on 132 SMs (a 64-row block
// would leave half the SMs idle), and S = 7168 is 896. At D = 256 their
// tiles are ~203 KB of shared memory, one block per SM; at D = 128
// ~107 KB, two.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kBlock = 32;  // rows a block owns
constexpr int kTile = 32;   // rows of the other side per loop step
constexpr int kThreads = 256;
constexpr float kMaskBias = -1e30f;

__device__ __forceinline__ float key_bias(const float* mask, int b, int S,
                                          int key) {
  return (mask == nullptr || mask[(long)b * S + key] > 0.f) ? 0.f : kMaskBias;
}

// B3: one block owns (b, h, keys [k0, k0 + 32)) and loops over tiles of 32
// queries, on the tensor cores (3xTF32, mma_tf32.cuh). Per tile:
//   products 1 and 2, S^T = K Q^T and dP^T = V dO^T over D, [32 keys x 32
//   queries]: warps 0-3 compute S^T, warps 4-7 dP^T, each one 16-key
//   m-tile x two 8-query n-tiles. The S^T warps write P^T = exp(S^T *
//   scale + bias - LSE) to shared memory, the dP^T warps dP^T - delta;
//   products 3 and 4, dV += P^T dO and dK += dS^T Q over the tile's 32
//   queries, with dS^T = P^T o (dP^T - delta) formed as the A fragment is
//   loaded: warp w owns columns [w D / 8, (w + 1) D / 8) of dK and dV for
//   all 32 keys, in registers (64 a thread at D = 256).
// Q and dO tiles are double-buffered: the next tile's 16-byte cp.async
// copies (and its LSE and delta) are issued before this tile's products.
// The [rows][D] tiles are stored with their 16-byte chunks XOR-swizzled
// by the row (swizzle()), so that both the row-wise float4 fragment loads
// of products 1-2 and the column-wise loads of products 3-4 hit 32
// distinct banks; P^T and dP^T rows are padded to 40 floats for the same.
template <int D>
struct DkvSmem {
  static constexpr int kPitch = kTile + 8;  // P^T, dP^T rows
  static constexpr size_t kFloats =
      6 * (size_t)kBlock * D            // K, V, and two stages of Q, dO
      + 2 * (size_t)kBlock * kPitch     // P^T, dP^T - delta
      + 4 * (size_t)kTile;              // two stages of LSE, delta
};

// cp.async rows [s0, s0 + 32) of a strided [S, D] head slice into a
// swizzled tile (mma_tf32.cuh); rows past S become zeros.
template <int D>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long row_stride, int s0, int S) {
  tf32::copy_rows<D, kBlock, kThreads>(dst, src, row_stride, s0, S);
}

using tf32::swz;

template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 2 : 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ mask,  // [B, S] or null
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int S,
                     int H, long qsb, long qss, long qsh, long ksb, long kss,
                     long ksh, long vsb, long vss, long vsh, long dsb,
                     long dss, long dsh, float scale) {
  using Smem = DkvSmem<D>;
  constexpr int kPitch = Smem::kPitch;
  constexpr int NT = D / 64;  // 8-column tiles of dK / dV per warp
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);  // [kBlock][D] swizzled
  float* sv = sk + kBlock * D;                  // [kBlock][D]
  float* sq = sv + kBlock * D;                  // [2][kTile][D]
  float* sdo = sq + 2 * kTile * D;              // [2][kTile][D]
  float* sp = sdo + 2 * kTile * D;              // [kBlock][kPitch]  P^T
  float* sdp = sp + kBlock * kPitch;            // [kBlock][kPitch]  dP^T - delta
  float* slse = sdp + kBlock * kPitch;          // [2][kTile]
  float* sdelta = slse + 2 * kTile;             // [2][kTile]

  const int k0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* qb = q + b * qsb + h * qsh;
  const float* dob = dout + b * dsb + h * dsh;
  const float* lseb = lse + ((long)b * H + h) * S;
  const float* deltab = delta + ((long)b * H + h) * S;

  auto copy_tile = [&](int q0, int buf) {
    copy_rows<D>(sq + buf * kTile * D, qb, qss, q0, S);
    copy_rows<D>(sdo + buf * kTile * D, dob, dss, q0, S);
    if (threadIdx.x < 2 * kTile) {
      const int i = threadIdx.x % kTile, s = q0 + i;
      const float* src = threadIdx.x < kTile ? lseb : deltab;
      float* dst = (threadIdx.x < kTile ? slse : sdelta) + buf * kTile + i;
      tf32::cp_async4(dst, src + (s < S ? s : 0), s < S);
    }
  };
  copy_rows<D>(sk, k + b * ksb + h * ksh, kss, k0, S);
  copy_rows<D>(sv, v + b * vsb + h * vsh, vss, k0, S);
  copy_tile(0, 0);
  tf32::cp_async_commit();

  // products 1-2: this warp's product, key m-tile and query n-tiles
  const bool dp_warp = warp >= 4;
  const int mrow = 16 * ((warp >> 1) & 1) + g;  // key rows mrow, mrow + 8
  const int ncol = 16 * (warp & 1);             // queries ncol .. ncol + 15
  const float* a_tile = dp_warp ? sv : sk;
  float bias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + mrow + 8 * i;
    bias[i] = key < S ? key_bias(mask, b, S, key) : 0.f;
  }
  // products 3-4: dK, dV columns [cb, cb + D / 8)
  const int cb = warp * (D / 8);
  float acc_k[2][NT][4], acc_v[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[m][n][e] = acc_v[m][n][e] = 0.f;

  const int n_tiles = (S + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, q0 = it * kTile;
    tf32::cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < n_tiles) copy_tile(q0 + kTile, buf ^ 1);
    tf32::cp_async_commit();
    const float* tq = sq + buf * kTile * D;
    const float* tdo = sdo + buf * kTile * D;

    // products 1-2, over all of D
    {
      float acc[2][4] = {};
      tf32::rows_dot<D, D, 4>(acc, a_tile, mrow, dp_warp ? tdo : tq, ncol, 0);
      // c0..c3 of tile n: (key mrow, query 2t), (mrow, 2t + 1), (mrow + 8, ..)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int qi = ncol + 8 * n + 2 * t;
        float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = qi + (e & 1);
          if (dp_warp) {
            out[e] = acc[n][e] - sdelta[buf * kTile + qq];
          } else {
            out[e] = q0 + qq < S
                ? expf(acc[n][e] * scale + bias[e >> 1] - slse[buf * kTile + qq])
                : 0.f;
          }
        }
        float* dst = dp_warp ? sdp : sp;
        *reinterpret_cast<float2*>(dst + mrow * kPitch + qi) = make_float2(out[0], out[1]);
        *reinterpret_cast<float2*>(dst + (mrow + 8) * kPitch + qi) = make_float2(out[2], out[3]);
      }
    }
    __syncthreads();  // P^T and dP^T - delta are in shared memory

    // products 3-4. K-step j covers queries 8j .. 8j + 7: k = t is query
    // 8j + 2t and k = t + 4 is query 8j + 2t + 1, in A (a float2 of the
    // P^T row) and in B (rows 8j + 2t, 8j + 2t + 1 of dO and Q) alike.
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const int qi = 8 * j + 2 * t;
      tf32::FragA fp[2], fs[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = 16 * m + g;
        const float2 p_lo = *reinterpret_cast<const float2*>(sp + r * kPitch + qi);
        const float2 p_hi = *reinterpret_cast<const float2*>(sp + (r + 8) * kPitch + qi);
        const float2 d_lo = *reinterpret_cast<const float2*>(sdp + r * kPitch + qi);
        const float2 d_hi = *reinterpret_cast<const float2*>(sdp + (r + 8) * kPitch + qi);
        fp[m].set(0, p_lo.x); fp[m].set(1, p_hi.x);
        fp[m].set(2, p_lo.y); fp[m].set(3, p_hi.y);
        fs[m].set(0, p_lo.x * d_lo.x); fs[m].set(1, p_hi.x * d_hi.x);
        fs[m].set(2, p_lo.y * d_lo.y); fs[m].set(3, p_hi.y * d_hi.y);
      }
      tf32::FragB fo[NT], fq[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = cb + 8 * n + g;
        fo[n].set(0, tdo[swz<D>(qi, c)]);
        fo[n].set(1, tdo[swz<D>(qi + 1, c)]);
        fq[n].set(0, tq[swz<D>(qi, c)]);
        fq[n].set(1, tq[swz<D>(qi + 1, c)]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        tf32::mma3_row<NT>(acc_v[m], fp[m], fo);
        tf32::mma3_row<NT>(acc_k[m], fs[m], fq);
      }
    }
  }

  // c0..c3 of (m, n): (key 16m + g, column cb + 8n + 2t), (.., + 1),
  // (key 16m + g + 8, ..)
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = k0 + 16 * m + g + 8 * i;
      if (s >= S) continue;
      const long row = (((long)b * S + s) * H + h) * D + cb + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<float2*>(dk + row + 8 * n) =
            make_float2(acc_k[m][n][2 * i] * scale, acc_k[m][n][2 * i + 1] * scale);
        *reinterpret_cast<float2*>(dv + row + 8 * n) =
            make_float2(acc_v[m][n][2 * i], acc_v[m][n][2 * i + 1]);
      }
    }
}

// B4, the mirror of B3: one block owns (b, h, queries [q0, q0 + 32)) and
// loops over tiles of 32 keys, on the tensor cores (3xTF32). Per tile:
//   products 1 and 2, S = Q K^T and dP = dO V^T over D, [32 queries x 32
//   keys]: warps 0-3 compute S, warps 4-7 dP, each one 16-query m-tile x
//   two 8-key n-tiles, with the same fragment loads as B3's. The S warps
//   write P = exp(S * scale + bias - LSE) to shared memory (0 for keys
//   past S), the dP warps dP - delta;
//   product 3, dQ += dS K over the tile's 32 keys, with dS = P o (dP -
//   delta) formed as the A fragment is loaded: warp w owns columns
//   [w D / 8, (w + 1) D / 8) of dQ for all 32 queries, in registers (32 a
//   thread at D = 256). Within each group of NT = D / 64 n-tiles a warp
//   owns, n-tile i's column g is column NT g + i, so the B fragments of all
//   NT n-tiles at one key are NT consecutive floats of a K row, one vector
//   load; the swizzle keeps those loads on 32 banks.
// Q and dO (and the rows' LSE and delta) stay resident; K and V tiles,
// and the tile's key mask, are double-buffered: the next tile's 16-byte
// cp.async copies are issued before this tile's products.
template <int D>
struct DqSmem {
  static constexpr int kPitch = kTile + 8;  // P, dP rows
  static constexpr size_t kFloats =
      6 * (size_t)kBlock * D            // Q, dO, and two stages of K, V
      + 2 * (size_t)kBlock * kPitch     // P, dP - delta
      + 2 * (size_t)kTile;              // two stages of the key mask
};

template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 2 : 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ mask,  // [B, S] or null
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int H, long qsb, long qss, long qsh, long ksb,
                    long kss, long ksh, long vsb, long vss, long vsh,
                    long dsb, long dss, long dsh, float scale) {
  using Smem = DqSmem<D>;
  constexpr int kPitch = Smem::kPitch;
  constexpr int NT = D / 64;  // 8-column n-tiles of dQ per warp
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [kBlock][D] swizzled
  float* sdo = sq + kBlock * D;                 // [kBlock][D]
  float* sk = sdo + kBlock * D;                 // [2][kTile][D]
  float* sv = sk + 2 * kTile * D;               // [2][kTile][D]
  float* sp = sv + 2 * kTile * D;               // [kBlock][kPitch]  P
  float* sdp = sp + kBlock * kPitch;            // [kBlock][kPitch]  dP - delta
  float* smask = sdp + kBlock * kPitch;         // [2][kTile]  key mask > 0

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;

  auto copy_tile = [&](int k0, int buf) {
    copy_rows<D>(sk + buf * kTile * D, kb, kss, k0, S);
    copy_rows<D>(sv + buf * kTile * D, vb, vss, k0, S);
    if (threadIdx.x < kTile) {
      const int s = k0 + threadIdx.x;
      float* dst = smask + buf * kTile + threadIdx.x;
      if (mask == nullptr) {
        *dst = 1.f;
      } else {
        tf32::cp_async4(dst, mask + (long)b * S + (s < S ? s : 0), s < S);
      }
    }
  };
  copy_rows<D>(sq, q + b * qsb + h * qsh, qss, q0, S);
  copy_rows<D>(sdo, dout + b * dsb + h * dsh, dss, q0, S);
  copy_tile(0, 0);
  tf32::cp_async_commit();

  // products 1-2: this warp's product, query m-tile and key n-tiles
  const bool dp_warp = warp >= 4;
  const int mrow = 16 * ((warp >> 1) & 1) + g;  // query rows mrow, mrow + 8
  const int ncol = 16 * (warp & 1);             // keys ncol .. ncol + 15
  const float* a_tile = dp_warp ? sdo : sq;
  float row_stat[2];  // LSE (S warps) or delta (dP warps) of rows mrow, + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + mrow + 8 * i;
    row_stat[i] = s < S ? (dp_warp ? delta : lse)[((long)b * H + h) * S + s]
                        : 0.f;
  }
  // product 3: dQ columns [cb, cb + D / 8)
  const int cb = warp * (D / 8);
  float acc_q[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_q[m][n][e] = 0.f;

  const int n_tiles = (S + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, k0 = it * kTile;
    tf32::cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < n_tiles) copy_tile(k0 + kTile, buf ^ 1);
    tf32::cp_async_commit();
    const float* tk = sk + buf * kTile * D;
    const float* tv = sv + buf * kTile * D;
    const float* tmask = smask + buf * kTile;

    // products 1-2, over all of D
    {
      float acc[2][4] = {};
      tf32::rows_dot<D, D, 4>(acc, a_tile, mrow, dp_warp ? tv : tk, ncol, 0);
      // c0..c3 of tile n: (query mrow, key 2t), (mrow, 2t + 1), (mrow + 8, ..)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int kj = ncol + 8 * n + 2 * t;
        float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = kj + (e & 1);
          if (dp_warp) {
            out[e] = acc[n][e] - row_stat[e >> 1];
          } else {
            const float bias = tmask[kk] > 0.f ? 0.f : kMaskBias;
            out[e] = k0 + kk < S
                ? expf(acc[n][e] * scale + bias - row_stat[e >> 1])
                : 0.f;
          }
        }
        float* dst = dp_warp ? sdp : sp;
        *reinterpret_cast<float2*>(dst + mrow * kPitch + kj) = make_float2(out[0], out[1]);
        *reinterpret_cast<float2*>(dst + (mrow + 8) * kPitch + kj) = make_float2(out[2], out[3]);
      }
    }
    __syncthreads();  // P and dP - delta are in shared memory

    // product 3. K-step j covers keys 8j .. 8j + 7: k = t is key 8j + 2t
    // and k = t + 4 is key 8j + 2t + 1, in A (a float2 of the P and dP
    // rows) and in B (rows 8j + 2t, 8j + 2t + 1 of K) alike.
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const int kj = 8 * j + 2 * t;
      tf32::FragB fk[NT];
      float lo[NT], hi[NT];
      tf32::load_vec<NT>(lo, tk + swz<D>(kj, cb + NT * g));
      tf32::load_vec<NT>(hi, tk + swz<D>(kj + 1, cb + NT * g));
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        fk[n].set(0, lo[n]);
        fk[n].set(1, hi[n]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = 16 * m + g;
        const float2 p_lo = *reinterpret_cast<const float2*>(sp + r * kPitch + kj);
        const float2 p_hi = *reinterpret_cast<const float2*>(sp + (r + 8) * kPitch + kj);
        const float2 d_lo = *reinterpret_cast<const float2*>(sdp + r * kPitch + kj);
        const float2 d_hi = *reinterpret_cast<const float2*>(sdp + (r + 8) * kPitch + kj);
        tf32::FragA fs;
        fs.set(0, p_lo.x * d_lo.x); fs.set(1, p_hi.x * d_hi.x);
        fs.set(2, p_lo.y * d_lo.y); fs.set(3, p_hi.y * d_hi.y);
        tf32::mma3_row<NT>(acc_q[m], fs, fk);
      }
    }
  }

  // c0..c3 of (m, n): (query 16m + g, column cb + NT (2t) + n), (.., cb +
  // NT (2t + 1) + n), (query 16m + g + 8, ..): NT consecutive columns each
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = q0 + 16 * m + g + 8 * i;
      if (s >= S) continue;
      float* row = dq + (((long)b * S + s) * H + h) * D + cb + 2 * NT * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) x[n] = acc_q[m][n][2 * i + e] * scale;
        tf32::store_vec<NT>(row + NT * e, x);
      }
    }
}

struct Args {
  const float *q, *k, *v, *dout, *mask, *lse, *delta;
  int B, S, H;
  const long *qs, *ks, *vs, *ds;
  cudaStream_t stream;
};

template <int D>
int launch_dkv(const Args& a, float* dk, float* dv) {
  const size_t smem = DkvSmem<D>::kFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + kBlock - 1) / kBlock, a.H, a.B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.mask, a.lse, a.delta, dk, dv, a.S, a.H,
      a.qs[0], a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1],
      a.vs[2], a.ds[0], a.ds[1], a.ds[2], 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const Args& a, float* dq) {
  const size_t smem = DqSmem<D>::kFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + kBlock - 1) / kBlock, a.H, a.B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.mask, a.lse, a.delta, dq, a.S, a.H, a.qs[0],
      a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2],
      a.ds[0], a.ds[1], a.ds[2], 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* mask, const void* lse, const void* delta, int B,
               int S, int H, const long* qs, const long* ks, const long* vs,
               const long* ds, void* stream) {
  return Args{(const float*)q, (const float*)k, (const float*)v,
              (const float*)dout, (const float*)mask, (const float*)lse,
              (const float*)delta, B, S, H, qs, ks, vs, ds,
              (cudaStream_t)stream};
}

}  // namespace

// q, k, v, dout: float32 [B, S, H, D] with element strides {b, s, h} in
// *_strides and unit stride on D; mask: float32 [B, S] contiguous (> 0 =
// valid key) or null; lse, delta: float32 [B, H, S] contiguous; dk, dv
// (and dq): [B, S, H, D] contiguous. D must be 128 or 256 (returns
// cudaErrorInvalidValue otherwise). Each returns cudaGetLastError().
extern "C" int avsum_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* mask,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int S, int H,
                                   int D, const long* q_strides,
                                   const long* k_strides,
                                   const long* v_strides,
                                   const long* do_strides, void* stream) {
  const Args a = make_args(q, k, v, dout, mask, lse, delta, B, S, H,
                           q_strides, k_strides, v_strides, do_strides, stream);
  if (D == 128) return launch_dkv<128>(a, (float*)dk, (float*)dv);
  if (D == 256) return launch_dkv<256>(a, (float*)dk, (float*)dv);
  return (int)cudaErrorInvalidValue;
}

extern "C" int avsum_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* mask,
                                  const void* lse, const void* delta, void* dq,
                                  int B, int S, int H, int D,
                                  const long* q_strides, const long* k_strides,
                                  const long* v_strides,
                                  const long* do_strides, void* stream) {
  const Args a = make_args(q, k, v, dout, mask, lse, delta, B, S, H,
                           q_strides, k_strides, v_strides, do_strides, stream);
  if (D == 128) return launch_dq<128>(a, (float*)dq);
  if (D == 256) return launch_dq<256>(a, (float*)dq);
  return (int)cudaErrorInvalidValue;
}
