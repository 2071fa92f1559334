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
// fused qkv projection; dO is whatever autograd hands the Function); the
// strides must be multiples of 4 floats and the base addresses 16-byte
// aligned, as TMA needs (the wrapper copies a tensor that is not). LSE
// and delta are [B, H, S]; dQ, dK, dV are [B, S, H, D] contiguous. Rows
// past S (the ragged last tile) land as zeros, get P = 0 and are never
// written, so S needs no padding. Masked keys have bias -1e30, so P is
// exactly 0 there. A query row whose keys are all masked has LSE = -1e30
// in float32, so its recomputed P is 1 rather than 1/S (the TPU kernel
// does the same); the scorer multiplies every attention output by the
// mask, so dO, and with it every gradient term from such a row, is 0.
//
// What bounds them on an H100: arithmetic. B3 does 8 * S^2 * D flops per
// head (four S x S x D products, counting the recomputed scores), B4
// 6 * S^2 * D (three), against O(S * D) bytes; in 3xTF32 (three TF32
// products each) at the dense TF32 peak of 495 TFLOP/s that is at least
// 2.55 and 1.91 ms at [1, 7168, 4, 256], 52 and 39 us at [1, 1024, 4, 256],
// where q, k, v and dO take 5 us at 3.35 TB/s.
//
// Design (both kernels; the TPU grid walked its inner blocks in order
// with VMEM scratch, here a block loops over them itself; the tensor maps,
// the A-fragment gathers, the products in flight and the B planes are
// flash_tiles.cuh's, shared with K2). A block owns
// kBlock = 32 rows of the resident side (keys in B3, queries in B4) and
// streams the other side (T1, T2: B3 Q, dO; B4 K, V) in tiles of kTile =
// 64 rows. Every product runs on wgmma m64n32k8 TF32 in the 3xTF32 split
// (mma_tf32.cuh): A from registers, B read from shared memory, K-major
// (TF32 has no transposed B), and the block's 32 resident rows are the
// N of every product:
//   - Two warpgroups share the work by role. Over D, with the tile's 64
//     streamed rows as M and the resident rows as B: group 0 computes X =
//     T1 R1^T and P = exp(X * scale + bias - LSE) (B3 S = Q K^T; B4 S^T =
//     K Q^T), group 1 Y = T2 R2^T and dS = P o (Y - delta) (B3 dP = dO V^T;
//     B4 dP^T = V dO^T), reading P back from the planes group 0 writes.
//     Over the tile, with D as M and P or dS as B, the groups take the
//     64-row m-tiles of D in turn: B3 dV^T += T2^T P and dK^T += T1^T dS
//     (each group one of the two at every m-tile), B4 dQ^T += T1^T dS^T
//     (every other m-tile). So no streamed element is read twice for one
//     product, a group holds D / 8 (B3) or D / 16 (B4) accumulator floats a
//     thread, and the groups hand P and dS over through named barriers
//     (P ready, dS ready, P free). 32 resident rows a block make
//     [1, 1024, 4, D] 128 blocks, one wave on 132 SMs; 64 would leave half
//     of them idle there (the train run's shape).
//   - The resident rows are loaded once, split and stored as big and small
//     TF32 planes in wgmma's no-swizzle K-major core-matrix order
//     (tf32::wgmma_desc), 64 KB a tensor at D = 256; P and dS are split
//     into B planes the same way each tile, their rows in the order that
//     the A fragments below read them.
//   - The streamed tiles arrive by TMA, in chunks of [64 rows x 64 columns
//     of D] (two 128-byte-swizzled boxes of 32 floats, 16 KB), through a
//     ring of kStages stages tracked by mbarriers. Every chunk has one
//     reader group, so a stage's empty barrier waits for four warps, and
//     that group's first thread loads the chunk kStages ahead into the
//     stage as soon as it is released: no producer warp, and no group
//     waits for the other's loads. A tile's chunks: T1 and T2 by turns
//     over D (X, Y), then B3 T2 and T1 by turns (dV^T, dK^T) or B4 T1
//     (dQ^T). The threads read the A fragments from a landed chunk by row
//     (X, Y; columns 2t, 2t + 1 as k = t, t + 4, one 8-byte load) or by
//     column (the products over the tile; rows 2t, 2t + 1 as k = t, t + 4),
//     which puts each warp's loads on 32 banks, and split them in
//     registers (split_trunc), so no streamed tile is stored split.
//   - Each product of a chunk is 24 wgmmas (8 k-steps x 3) in two commit
//     groups of 4 k-steps. The A fragments of a group are read while the
//     group before runs, so the tensor cores have work queued through a
//     phase. The phase loops are unrolled: ptxas serializes wgmmas (note
//     C7514) where a loop keeps a group in flight across its back edge. A
//     product's sum starts from zero and is added to the float32
//     accumulator once (mma_tf32.cuh: the tensor cores round toward zero),
//     so a run is 8 k-steps long.
// Shared memory: kStages x 16 KB of ring, 32 x D x 16 bytes of resident
// planes and 32 KB of P and dS planes: 230,464 bytes at D = 256 (4
// stages) and 230,528 at D = 128 (8 stages), one block of 256 threads an
// SM. avsum_flash_bwd_layout reports this tiling; the wrapper checks it
// against its own (bwd_layout) before its first launch at a D.
//
// Time on an H100 at [1, 1024, 4, D] and [1, 7168, 4, D]: PERF.md
// (chip_smoke.py's check_b34). At [1, 7168, 4, 256] a tile's chunks come
// from L2 four times (B3) or three (B4), 25.7 and 19.3 GB a launch: 4.5
// and 3.7 TB/s at those times, so L2 may bind there (its rate on the card
// is not measured).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash;

constexpr int kBlock = 32;    // resident rows a block owns: wgmma's N
constexpr int kStep = 8 * kBlock;  // floats of a B plane's k-step
// named barriers: 1 + group (one group), and between the groups
constexpr int kBarPReady = 3, kBarDsReady = 4, kBarPFree = 5;

template <int D>
struct Layout {
  static constexpr int kStages = D == 256 ? 4 : 8;
  static constexpr int kChunks = D / kChunk;
  static constexpr int kPlane = kBlock * D;  // a resident plane
  static constexpr int kPds = kBlock * kTile;  // a P or dS plane
  static constexpr size_t kBytes =
      1024                                  // to align the ring
      + (size_t)kStages * kChunkBytes       // TMA ring
      + 4 * (size_t)(2 * 2 * kPlane)        // 2 tensors x big, small
      + 4 * (size_t)(2 * 2 * kPds)          // P, dS x big, small
      + 2 * 8 * (size_t)kStages;            // full and empty mbarriers
};
static_assert(Layout<256>::kBytes <= 232448, "B3/B4 fit at D = 256");
static_assert(Layout<128>::kBytes <= 232448, "B3/B4 fit at D = 128");

struct Params {
  const float *r1, *r2;   // resident tensors: B3 k, v; B4 q, dout
  long r1s[3], r2s[3];    // their (b, s, h) strides
  const float* mask;      // [B, S] or null
  const float *lse, *delta;  // [B, H, S]
  float *o1, *o2;         // B3 dk, dv; B4 dq
  int S, H;
  float scale;
};

// The body of both kernels (kDkv: B3, else B4). T1, T2: tensor maps of the
// streamed tensors (B3 q, dout; B4 k, v). Group 0 computes X = T1 R1^T
// and P, group 1 Y = T2 R2^T and dS; the products over the tile are
// shared out by 64-row m-tile of D.
template <int D, bool kDkv>
__device__ __forceinline__ void bwd_body(const CUtensorMap& t1,
                                         const CUtensorMap& t2,
                                         const Params& p, const void* smem) {
  using L = Layout<D>;
  constexpr int NC = L::kChunks;
  constexpr int kPerTile = (kDkv ? 4 : 3) * NC;  // chunks a tile
  constexpr uint64_t kChunkDesc = 4 * 8 * kStep >> 4;  // 8 k-steps
  // Shared addresses: the ring (1024-aligned for the 128-byte swizzle),
  // the resident planes [R1, R2][big, small], the P and dS planes [big,
  // small], the mbarriers full[stage], empty[stage].
  const uint32_t ring = (tf32::smem_addr(smem) + 1023) & ~1023u;
  const uint32_t res = ring + L::kStages * kChunkBytes;
  const uint32_t p_big = res + 4 * 4 * L::kPlane, p_small = p_big + 4 * L::kPds;
  const uint32_t ds_big = p_small + 4 * L::kPds, ds_small = ds_big + 4 * L::kPds;
  const uint32_t full = ds_small + 4 * L::kPds;
  const uint32_t empty = full + 8 * L::kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int S = p.S;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int n_chunks = n_tiles * kPerTile;

  // Chunk m of the stream into its stage. A tile's chunks: T1 c, T2 c for
  // c < NC (X, Y); then B3 T2 c, T1 c (dV^T, dK^T) or B4 T1 c (dQ^T).
  auto load = [&](int m) {
    const int s = m % L::kStages, it = m / kPerTile, pos = m % kPerTile;
    const int c = pos < 2 * NC ? pos / 2 : kDkv ? (pos - 2 * NC) / 2 : pos - 2 * NC;
    const bool second = pos < 2 * NC ? pos & 1 : kDkv && !(pos & 1);
    const CUtensorMap* map = second ? &t2 : &t1;
    const uint32_t dst = ring + s * kChunkBytes;
    tf32::mbar_expect_tx(full + 8 * s, kChunkBytes);
    tf32::tma_load_4d(dst, map, full + 8 * s, c * kChunk, h, it * kTile, b);
    tf32::tma_load_4d(dst + kBoxBytes, map, full + 8 * s, c * kChunk + kBox,
                      h, it * kTile, b);
  };
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      tf32::mbar_init(full + 8 * s, 1);
      tf32::mbar_init(empty + 8 * s, 4);  // the warps of the group reading it
    }
    tf32::mbar_fence_init();
    for (int m = 0; m < L::kStages && m < n_chunks; ++m) load(m);
  }
  __syncthreads();

  // The group index through a shuffle, so that the compiler knows it is
  // the same across the warp and keeps the planes' descriptors uniform.
  const int grp = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int w = warp & 3, g = lane >> 2, t = lane & 3;

  // Group 0 splits R1 into its B planes, group 1 R2: each its own.
  {
    const float* src = grp ? p.r2 : p.r1;
    const long sb = grp ? p.r2s[0] : p.r1s[0], ss = grp ? p.r2s[1] : p.r1s[1],
               sh = grp ? p.r2s[2] : p.r1s[2];
    const uint32_t big = res + 4 * grp * 2 * L::kPlane;
    split_rows<kBlock, D>(big, big + 4 * L::kPlane, src + b * sb + h * sh, ss,
                          r0, S, tid & 127);
  }
  tf32::fence_proxy_async();
  group_sync(grp);
  const uint32_t mine = res + 4 * grp * 2 * L::kPlane;
  const uint64_t r_big = tf32::wgmma_desc_at(mine);
  const uint64_t r_small = tf32::wgmma_desc_at(mine + 4 * L::kPlane);
  // the B planes of the products over the tile: P (0) or dS (1)
  auto pd_big = [&](int a) {
    return tf32::wgmma_desc_at(a ? ds_big : p_big);
  };
  auto pd_small = [&](int a) {
    return tf32::wgmma_desc_at(a ? ds_small : p_small);
  };
  const Gather ga(w, g, t);

  // This thread's resident columns 8i + 2t + j: B3 the key bias, B4 the
  // query's LSE (group 0) or delta (group 1).
  const long bh = (long)b * p.H + h;
  float col[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = r0 + 8 * i + 2 * t + j;
      col[i][j] = s >= S ? 0.f
                  : kDkv ? key_bias(p.mask, b, S, s)
                         : (grp ? p.delta : p.lse)[bh * S + s];
    }

  // The products over the tile this group takes, by m-tile c of D: B3
  // every c, dV^T (T2 c) where c + grp is even and dK^T (T1 c) where it is
  // odd, in acc[c]; B4 dQ^T (T1 c) where c % 2 == grp, in acc[c / 2].
  constexpr int kAcc = kDkv ? NC : NC / 2;
  float acc[kAcc][16];
#pragma unroll
  for (int c = 0; c < kAcc; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[c][i] = 0.f;

  // Chunk n of the stream: wait for it to land; -> its shared address.
  auto take = [&](int n) {
    const int s = n % L::kStages;
    tf32::mbar_wait(full + 8 * s, (n / L::kStages) & 1);
    return ring + s * kChunkBytes;
  };
  // This warp is done reading chunk n; the group's first thread then loads
  // chunk n + kStages into the stage once the group's four warps are done.
  auto release = [&](int n) {
    return [&, n]() {
      const int s = n % L::kStages;
      tf32::fence_proxy_async();  // these reads before the stage's next TMA
      __syncwarp();
      if (lane == 0) tf32::mbar_arrive(empty + 8 * s);
      if ((tid & 127) == 0 && n + L::kStages < n_chunks) {
        tf32::mbar_wait(empty + 8 * s, (n / L::kStages) & 1);
        load(n + L::kStages);
      }
      __syncwarp();
    };
  };
  Pipe<kBlock> q;

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = it * kPerTile;  // the tile's first chunk
    // This thread's tile rows 16w + g + 8e: whether < S, and B3 the
    // query's LSE (group 0) or delta (group 1), B4 the key bias.
    float row[2];
    bool row_in[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = it * kTile + 16 * w + g + 8 * e;
      row_in[e] = s < S;
      row[e] = !row_in[e] ? 0.f
               : kDkv ? (grp ? p.delta : p.lse)[bh * S + s]
                      : key_bias(p.mask, b, S, s);
    }

    // X = T1 R1^T (group 0) or Y = T2 R2^T (group 1) over D: chunks
    // n0 + 2c + grp
    float xy[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) xy[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; c += 2) {
      const int n = n0 + 2 * c + grp;
      issue<0, true>(q, c == 0, ga, take(n), r_big + c * kChunkDesc,
                     r_small + c * kChunkDesc, release(n), xy);
      issue<1, true>(q, false, ga, take(n + 2), r_big + (c + 1) * kChunkDesc,
                     r_small + (c + 1) * kChunkDesc, release(n + 2), xy);
    }
    drain<1>(q, xy);

    if (grp == 0) {
      // P = exp(S * scale + key bias - LSE), 0 on rows past S
      float pv[16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, j = e & 1;
          const float bias = kDkv ? col[i][j] : row[r];
          const float lse = kDkv ? row[r] : col[i][j];
          pv[4 * i + e] =
              row_in[r] ? expf(xy[4 * i + e] * p.scale + bias - lse) : 0.f;
        }
      if (it > 0) bar_wait(kBarPFree);  // group 1 is done with the last P
      store_planes<kBlock>(p_big, p_small, pv, w, g, t);
      bar_arrive(kBarPReady);
    } else {
      // dS = P o (dP - delta), P read back from its planes (big + small)
      bar_wait(kBarPReady);
      float ds[16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t at = 4 * pds_at<kBlock>(i, e, w, g, t);
          const float pv = tf32::lds(p_big + at) + tf32::lds(p_small + at);
          const float delta = kDkv ? row[e >> 1] : col[i][e & 1];
          ds[4 * i + e] = pv * (xy[4 * i + e] - delta);
        }
      if (!kDkv && it + 1 < n_tiles) bar_arrive(kBarPFree);
      // group 0's dK^T / dQ^T products of the last tile are done: it
      // wrote this tile's P after them
      store_planes<kBlock>(ds_big, ds_small, ds, w, g, t);
      bar_arrive(kBarDsReady);
    }

    // The products over the tile, this group's m-tiles
    if (kDkv) {
      // chunk n0 + 2NC + 2c is T2 c (dV^T, with P), + 1 is T1 c (dK^T,
      // with dS)
#pragma unroll
      for (int c = 0; c < NC; c += 2) {
        const int n = n0 + 2 * NC + 2 * c;
        const int a = (c + grp) & 1;  // product c: 0 dV^T, 1 dK^T
        issue<0, false>(q, c == 0, ga, take(n + a), pd_big(a), pd_small(a),
                        release(n + a), acc[c > 0 ? c - 1 : 0]);
        if (c == 0 && grp == 0) bar_wait(kBarDsReady);
        issue<1, false>(q, false, ga, take(n + 3 - a), pd_big(a ^ 1),
                        pd_small(a ^ 1), release(n + 3 - a), acc[c]);
      }
      drain<1>(q, acc[NC - 1]);
      if (grp == 1 && it + 1 < n_tiles) bar_arrive(kBarPFree);
    } else {
      // chunk n0 + 2NC + c is T1 c; group c % 2 takes it
      if (grp == 0) bar_wait(kBarDsReady);
#pragma unroll
      for (int j = 0; j < NC / 2; j += 2) {
        const int n = n0 + 2 * NC + 2 * j + grp;
        issue<0, false>(q, j == 0, ga, take(n), pd_big(1), pd_small(1),
                        release(n), acc[j > 0 ? j - 1 : 0]);
        if (j + 1 < NC / 2)
          issue<1, false>(q, false, ga, take(n + 2), pd_big(1), pd_small(1),
                          release(n + 2), acc[j]);
      }
      if (NC / 2 == 1) {
        drain<0>(q, acc[0]);
      } else {
        drain<1>(q, acc[NC / 2 - 1]);
      }
    }
  }

  // Accumulator row 16w + g + 8 (e / 2) of m-tile c is column 64c + 16w +
  // g + 8 (e / 2) of D; column 8i + 2t + e % 2 is resident row r0 + that.
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int c = kDkv ? j : 2 * j + grp;
    const bool dk = !kDkv || ((c + grp) & 1);  // dK^T or dQ^T, else dV^T
    float* out = dk ? p.o1 : p.o2;
    const float f = dk ? p.scale : 1.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = r0 + 8 * i + 2 * t + (e & 1);
        if (s < S)
          out[(((long)b * S + s) * p.H + h) * D + 64 * c + 16 * w + g +
              8 * (e >> 1)] = acc[j][4 * i + e] * f;
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo, const Params p) {
  extern __shared__ float4 smem4[];
  bwd_body<D, true>(tq, tdo, p, smem4);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ float4 smem4[];
  bwd_body<D, false>(tk, tv, p, smem4);
}

struct Args {
  const float *q, *k, *v, *dout, *mask, *lse, *delta;
  int B, S, H;
  const long *qs, *ks, *vs, *ds;
  cudaStream_t stream;
};

Params make_params(const Args& a, const float* r1, const long* r1s,
                   const float* r2, const long* r2s, float* o1, float* o2,
                   int D) {
  Params p;
  p.r1 = r1;
  p.r2 = r2;
  for (int i = 0; i < 3; ++i) {
    p.r1s[i] = r1s[i];
    p.r2s[i] = r2s[i];
  }
  p.mask = a.mask;
  p.lse = a.lse;
  p.delta = a.delta;
  p.o1 = o1;
  p.o2 = o2;
  p.S = a.S;
  p.H = a.H;
  p.scale = 1.f / sqrtf((float)D);
  return p;
}

// B3 (kDkv) or B4 at D: two tensor maps of the streamed tensors, then one
// launch of (ceil(S / kBlock), H, B) blocks.
template <int D, bool kDkv>
int launch(const Args& a, float* o1, float* o2) {
  CUtensorMap t1, t2;
  int err = kDkv ? make_map(&t1, a.q, a.B, a.S, a.H, D, a.qs)
                 : make_map(&t1, a.k, a.B, a.S, a.H, D, a.ks);
  if (err == 0)
    err = kDkv ? make_map(&t2, a.dout, a.B, a.S, a.H, D, a.ds)
               : make_map(&t2, a.v, a.B, a.S, a.H, D, a.vs);
  if (err) return err;
  const Params p = kDkv ? make_params(a, a.k, a.ks, a.v, a.vs, o1, o2, D)
                        : make_params(a, a.q, a.qs, a.dout, a.ds, o1, o2, D);
  auto kernel = kDkv ? flash_bwd_dkv_kernel<D> : flash_bwd_dq_kernel<D>;
  const size_t smem = Layout<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.S + kBlock - 1) / kBlock, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(t1, t2, p);
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

template <int D>
void layout(long* out) {
  constexpr long kSmSmem = 233472;  // an SM's shared memory, 228 KB
  const long v[] = {kBlock, kTile, Layout<D>::kStages, (long)Layout<D>::kBytes,
                    kSmSmem / ((long)Layout<D>::kBytes + 1024)};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
}

}  // namespace

// The tiling at head width d: out[0..4] = resident rows a block owns,
// streamed rows per tile, TMA stages, dynamic shared memory in bytes and
// blocks an SM holds by shared memory (each block also reserves 1 KB).
// Returns cudaErrorInvalidValue for a d other than 128 or 256.
extern "C" int avsum_flash_bwd_layout(int d, long* out) {
  if (d == 128) {
    layout<128>(out);
    return 0;
  }
  if (d == 256) {
    layout<256>(out);
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// q, k, v, dout: float32 [B, S, H, D] with element strides {b, s, h} in
// *_strides (multiples of 4) and unit stride on D, 16-byte aligned; mask:
// float32 [B, S] contiguous (> 0 = valid key) or null; lse, delta: float32
// [B, H, S] contiguous; dk, dv (and dq): [B, S, H, D] contiguous. D must be
// 128 or 256 (returns cudaErrorInvalidValue otherwise). Each returns 0 or
// a CUDA error code: that of a tensor map the driver refused, of the
// shared-memory opt-in, or cudaGetLastError() after the launch.
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
  if (D == 128) return launch<128, true>(a, (float*)dk, (float*)dv);
  if (D == 256) return launch<256, true>(a, (float*)dk, (float*)dv);
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
  if (D == 128) return launch<128, false>(a, (float*)dq, nullptr);
  if (D == 256) return launch<256, false>(a, (float*)dq, nullptr);
  return (int)cudaErrorInvalidValue;
}
