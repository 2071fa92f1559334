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
// What bounds it on an H100: 8 * S^2 * D flops per head (four S x S x D
// products in each kernel, counting the recomputed scores) against
// O(S * D) bytes, so arithmetic. The TPU grid walked its inner blocks in
// order, carrying dK/dV (or dQ) in VMEM scratch; here one block owns
// (b, h, 32 rows) and loops over the 32-row tiles of the other side
// itself, with its accumulators in registers.
//
// B3 runs its four products on the tensor cores, mma.sync m16n8k8 TF32 in
// the 3xTF32 split for float32-level accuracy (mma_tf32.cuh; see the
// note above the kernel for its tiling). mma.sync rather than wgmma: a
// wgmma takes 64 rows, so 64-key blocks (64 blocks at [1, 1024, 4, D] on
// 132 SMs) or 64-query tiles, and its shared-memory B operands would need
// split (big, small) planes of every streamed Q / dO tile, which at
// D = 256 do not fit beside the double buffers; mma.sync's fragments are
// split in registers as they are loaded, and P^T and dS^T go through
// shared memory in the layouts it takes. It reads q and dout with 16-byte
// cp.async, so their (b, s, h) strides must be multiples of 4 floats and
// their base addresses 16-byte aligned (the wrapper copies a tensor that
// is not). Block shape:
// 32 keys, so [1, 1024, 4, D] is 128 blocks, one wave on 132 SMs (a
// 64-key block would leave half the SMs idle), and S = 7168 is 896. At
// D = 256 its tiles are ~203 KB of shared memory, one block per SM; at
// D = 128 ~107 KB, two.
//
// B4 is plain FP32 FMAs (8 warps x 4 rows each; lane i holds columns i,
// i+32, ...). In the score phase each lane owns one row of the streamed
// tile, whose shared-memory rows are padded by one float so the 32 lanes
// hit 32 banks; the resident rows are read as float4 broadcasts. D = 256
// makes its four 32 x D tiles ~128 KB of dynamic shared memory, so one
// block runs per SM there.

#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kBlock = 32;  // rows a block owns
constexpr int kTile = 32;   // rows of the other side per loop step
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kBlock / kWarps;  // owned rows per warp
constexpr float kMaskBias = -1e30f;

template <int D>
constexpr size_t smem_floats() {
  // two resident [kBlock][D] tiles, two streamed [kTile][D + 1] tiles,
  // two [kBlock][kTile] score tiles, and two [kTile] row vectors
  return 2 * (size_t)kBlock * D + 2 * (size_t)kTile * (D + 1) +
         2 * (size_t)kBlock * kTile + 2 * (size_t)kTile;
}

// Copy rows [s0, s0 + kRowsTile) of a strided [S, D] head slice into
// shared memory with row pitch `pitch`; rows past S become zeros.
template <int D, int kRowsTile>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* src, long row_stride,
                                          int s0, int S) {
  for (int i = threadIdx.x; i < kRowsTile * D; i += kThreads) {
    const int r = i / D, d = i % D, s = s0 + r;
    dst[r * pitch + d] = s < S ? src[s * row_stride + d] : 0.f;
  }
}

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

__device__ __forceinline__ int swizzle(int r) { return (r & 6) ^ ((r & 1) << 2); }

// Offset of element (r, c) of a swizzled [rows][D] tile.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((((c >> 2) ^ swizzle(r)) << 2) | (c & 3));
}

// cp.async rows [s0, s0 + 32) of a strided [S, D] head slice into a
// swizzled tile; rows past S become zeros.
template <int D>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long row_stride, int s0, int S) {
  for (int i = threadIdx.x; i < kBlock * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4)), s = s0 + r;
    const bool in = s < S;
    tf32::cp_async16(dst + swz<D>(r, c), src + (in ? s * row_stride + c : 0),
                     in ? 16 : 0);
  }
}

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

    // products 1-2. Over each 16 columns d0 .. d0 + 15 of D, lane (g, t)
    // loads the float4 at d0 + 4t of its A and B rows: k-step 0 takes
    // columns d0 + 4t (k = t) and d0 + 4t + 1 (k = t + 4), k-step 1 the
    // other two; A and B agree, so the sum is over all 16, one mma3.
    {
      const float* bt = dp_warp ? tdo : tq;
      float acc[2][4] = {};
#pragma unroll 4
      for (int d0 = 0; d0 < D; d0 += 16) {
        const int c = d0 + 4 * t;
        const float4 lo = *reinterpret_cast<const float4*>(a_tile + swz<D>(mrow, c));
        const float4 hi = *reinterpret_cast<const float4*>(a_tile + swz<D>(mrow + 8, c));
        tf32::FragA fa[2];
        fa[0].set(0, lo.x); fa[0].set(1, hi.x); fa[0].set(2, lo.y); fa[0].set(3, hi.y);
        fa[1].set(0, lo.z); fa[1].set(1, hi.z); fa[1].set(2, lo.w); fa[1].set(3, hi.w);
        tf32::FragB fb[2][2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float4 x = *reinterpret_cast<const float4*>(bt + swz<D>(ncol + 8 * n + g, c));
          fb[0][n].set(0, x.x); fb[0][n].set(1, x.y);
          fb[1][n].set(0, x.z); fb[1][n].set(1, x.w);
        }
        tf32::mma3<2, 2>(acc, fa, fb);
      }
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

// B4: one block owns (b, h, queries [q0, q0 + 32)) and loops over key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ mask,  // [B, S] or null
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int H, long qsb, long qss, long qsh, long ksb,
                    long kss, long ksh, long vsb, long vss, long vsh,
                    long dsb, long dss, long dsh, float scale) {
  constexpr int kCols = D / 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sq = smem;                        // [kBlock][D]  resident queries
  float* sdo = sq + kBlock * D;            // [kBlock][D]  resident dO
  float* sk = sdo + kBlock * D;            // [kTile][D + 1]
  float* sv = sk + kTile * (D + 1);        // [kTile][D + 1]
  float* sds = sv + kTile * (D + 1);       // [kBlock][kTile]

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  load_tile<D, kBlock>(sq, D, q + b * qsb + h * qsh, qss, q0, S);
  load_tile<D, kBlock>(sdo, D, dout + b * dsb + h * dsh, dss, q0, S);

  float l[kRows], dl[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = q0 + warp * kRows + r;
    l[r] = s < S ? lse[((long)b * H + h) * S + s] : 0.f;
    dl[r] = s < S ? delta[((long)b * H + h) * S + s] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const float4* qrow4 = reinterpret_cast<const float4*>(sq + warp * kRows * D);
  const float4* dorow4 = reinterpret_cast<const float4*>(sdo + warp * kRows * D);
  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // Q, dO loaded / the previous tile consumed
    load_tile<D, kTile>(sk, D + 1, kb, kss, k0, S);
    load_tile<D, kTile>(sv, D + 1, vb, vss, k0, S);
    __syncthreads();

    // scores and dP: lane = key, warp = kRows queries
    float sc[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = dp[r] = 0.f;
    const float* krow = sk + lane * (D + 1);
    const float* vrow = sv + lane * (D + 1);
#pragma unroll 2
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float kd[4], vd[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        kd[t] = krow[4 * d4 + t];
        vd[t] = vrow[4 * d4 + t];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = qrow4[r * (D / 4) + d4];
        const float4 oo = dorow4[r * (D / 4) + d4];
        sc[r] = fmaf(qq.x, kd[0], sc[r]);
        sc[r] = fmaf(qq.y, kd[1], sc[r]);
        sc[r] = fmaf(qq.z, kd[2], sc[r]);
        sc[r] = fmaf(qq.w, kd[3], sc[r]);
        dp[r] = fmaf(oo.x, vd[0], dp[r]);
        dp[r] = fmaf(oo.y, vd[1], dp[r]);
        dp[r] = fmaf(oo.z, vd[2], dp[r]);
        dp[r] = fmaf(oo.w, vd[3], dp[r]);
      }
    }
    const int key = k0 + lane;
    const bool k_in = key < S;
    const float bias = k_in ? key_bias(mask, b, S, key) : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float p = k_in ? expf(sc[r] * scale + bias - l[r]) : 0.f;
      sds[(warp * kRows + r) * kTile + lane] = p * (dp[r] - dl[r]);
    }
    __syncwarp();

    // dQ += dS K over this warp's queries
    const float4* dsrow4 = reinterpret_cast<const float4*>(sds + warp * kRows * kTile);
    for (int j4 = 0; j4 < kTile / 4; ++j4) {
      float dsr[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 dd = dsrow4[r * (kTile / 4) + j4];
        dsr[r][0] = dd.x; dsr[r][1] = dd.y; dsr[r][2] = dd.z; dsr[r][3] = dd.w;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * j4 + t;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float kc = sk[j * (D + 1) + lane + 32 * c];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][c] = fmaf(dsr[r][t], kc, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = q0 + warp * kRows + r;
    if (s >= S) continue;
    const long row = (((long)b * S + s) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[row + lane + 32 * c] = acc[r][c] * scale;
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
  const size_t smem = smem_floats<D>() * sizeof(float);
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
