// Flash-attention backward, float32 throughout: the gradients of
// O = softmax(Q K^T / sqrt(D) + key bias) V in one kernel,
// flash_bwd_kernel, with the probabilities recomputed tile by tile as
// P = exp(S - LSE) from the forward's LSE, so the [S, S] matrices never
// reach device memory:
//
//   dP = dO V^T, dS = P o (dP - delta), delta = rowsum(dO o O) (computed
//   by the caller), dV = P^T dO, dK = D^-1/2 dS^T Q, dQ = D^-1/2 dS K.
//
// It replaces the TPU kernels avsum_tpu/ops/attention.py::
// _flash_bwd_dkv_kernel and ::_flash_bwd_dq_kernel (pallas_calls in
// _flash_bwd), which split the work in two so that no output was shared
// between blocks; here dQ is shared between the key blocks and summed by
// TMA reductions in float32. Python wrapper: avsum_torch/ops/attention.py
// (flash_bwd, and the autograd Function that runs flash_fwd.cu, then this).
//
// Layout: q, k, v, dO are [B, S, H, D] views read through their (b, s, h)
// strides with a unit stride on D (q, k, v are slices of the scorer's
// fused qkv projection; dO is whatever autograd hands the Function); the
// strides must be multiples of 4 floats and the base addresses 16-byte
// aligned, as TMA and the 16-byte loads need (the wrapper copies a tensor
// that is not). LSE and delta are [B, H, S]; dQ, dK, dV are [B, S, H, D]
// contiguous, dQ zeroed by the caller on the launch's stream. Rows past S
// (the ragged last tile) land as zeros, get P = 0 and are never written,
// so S needs no padding; the reductions skip rows past S. Masked keys have
// bias -1e30, so P is exactly 0 there. A query row whose keys are all
// masked has LSE = -1e30 in float32, so its recomputed P is 1 rather than
// 1/S (the TPU kernels do the same); the scorer multiplies every attention
// output by the mask, so dO, and with it every gradient term from such a
// row, is 0. dQ is summed in the order the blocks happen to run, so it is
// not bitwise the same from run to run.
//
// What bounds it on an H100: arithmetic. 10 * S^2 * D flops per head
// (five S x S x D products: S and dP recomputed, dV, dK, dQ) against
// O(S * D) bytes; in 3xTF32 (three TF32 products each) at the dense TF32
// peak of 495 TFLOP/s that is at least 3.19 ms at [1, 7168, 4, 256] and
// 1.59 ms at D = 128.
//
// Design. A cluster of C = D / 64 CTAs owns 64 keys of one (b, h); CTA c
// of it owns columns 64c .. 64c + 63 of D, so a CTA's share is the same
// at D = 128 (C = 2) and D = 256 (C = 4). The 64 keys are the N of every
// product but dQ's (wgmma m64n64k8 TF32 in the 3xTF32 split,
// mma_tf32.cuh; A from registers, B from K-major planes in shared memory).
// A CTA holds its K and V columns as big and small B planes, and K's also
// transposed (the B of dQ = dS K), 16 KB a plane; it streams the head's
// queries in tiles of 64 rows, its own 64 columns of Q and dO by TMA in
// [64 rows x 64 columns] chunks (flash_tiles.cuh's maps, gathers and
// products in flight). Two warpgroups by role, per tile:
//   group 0: S_c = Q_c K_c^T over the CTA's columns; the cluster's partial
//     sums exchanged (below); P = exp(S * scale + key bias - LSE) into the
//     P planes; dV_c^T += dO_c^T P (A the dO chunk by column);
//   group 1: dP_c = dO_c V_c^T; exchanged; dS = P o (dP - delta), P read
//     back from its planes, into the dS planes; dK_c^T += Q_c^T dS (A the
//     Q chunk by column); dQ_c = dS K_c with A = dS from the registers that
//     hold it (the accumulator's layout is the A fragment's with the keys
//     2t, 2t + 1 as k = t, t + 4, the order the transposed K planes are
//     written in); the 64 x 64 block of dQ, scaled, staged in the dS big
//     plane in the TMA box layout and added to dQ by two TMA reductions.
// dV^T and dK^T stay in registers, 32 floats a thread in their group, and
// are written once at the end. Each chunk is read from L2 once a CTA.
//
// The exchange. Each CTA's partial S (group 0) and dP (group 1) is summed
// over the cluster through distributed shared memory, moved by the TMA
// engine (cp.async.bulk from this CTA's shared memory to a peer's,
// completing on the peer's mbarrier), so no thread waits on a remote load.
// A group writes its partial into its own small plane (P's or dS's, 16 KB
// as [float4 j][128 threads]); the peers' data land in its big plane,
// whose P or dS of the last tile is then dead. At C = 2 each CTA copies
// its whole partial to the peer and adds the peer's to its own. At C = 4
// (reduce-scatter, all-gather) CTA c copies float4s 2r, 2r + 1 of its
// partial (keys 16r .. 16r + 15, 4 KB) to CTA r, sums its own two float4s
// over the four partials where its partial of them was, and copies the
// sums to every peer's small plane. Floats are added in pairs,
// (p0 + p1) + (p2 + p3), so every CTA forms the same S and dP. Four
// mbarriers a group: `free` (C arrivals, one a CTA: its big plane may take
// this tile's data; sent before the group's product, so it is rarely
// waited for), `got` and `all` (the copies' bytes), `freed` (C arrivals:
// every copy to that CTA has landed, so a CTA may overwrite its small
// plane, which it does with the small parts of P or dS after the big
// ones: that wait overlaps the exponentials). Signals are CTA-scope
// arrives: an arrive that releases at cluster scope fences, and costs as
// much as a fence. A group barrier ends the exchange: `freed` counts one
// thread's arrival a CTA, and each warp reads part of every other warp's
// share of the planes that P and dS then overwrite.
//
// What the parts cost at [1, 7168, 4, 128 / 256], against 3.47 / 8.31 ms
// for the kernel (patched copies of it, each timed in turns with it on an
// H100, before the two group barriers below were added; PERF.md says how
// each copy was made): without the exchange (wrong sums,
// the same work otherwise) 3.09 / 6.45 ms; without the dQ reductions
// 3.45 / 8.04; with signals that release at cluster scope 4.54 / 13.23;
// with each key block starting at its own query tile, so that the
// clusters of a head add to different rows of dQ at once, 3.49 / 8.48.
// So the exchange costs 11% / 22% of the time at C = 2 / 4, the
// reductions into dQ little. An exchange that read the peers' partials
// by ld.shared::cluster after a handshake, tried first, was slower: each
// thread then waits out the remote loads' latency.
//
// Between the groups: two named barriers (P ready, P free), and the TMA
// ring's empty barriers. Within group 1, a group barrier between dQ's
// product and its staging in the dS big plane: a warp's wgmma wait covers
// its own warp's part of the product that read the plane. Every chunk is read by both groups (Q by row in
// S and by column in dK^T, dO by row in dP and by column in dV^T), so a
// stage's empty barrier counts all 8 warps, and the group that reads the
// chunk last loads the chunk kStages ahead into it: group 1 for Q (it
// reads Q after P ready, which group 0 arrives at after its read), group 0
// for dO. The ring holds 4 chunks, two tiles.
//
// As in K2 (flash_fwd.cu's note): each product is 24 wgmmas in two commit
// groups of 4 k-steps, the next group's A fragments read while the group
// before runs, its sum started from zero and added to the float32
// accumulator once (8 k-steps a run); the loops are unrolled so that
// ptxas does not serialize the wgmmas (note C7514).
//
// Shared memory: 4 ring stages of 16 KB, 10 planes of 16 KB (K, K^T, V,
// P, dS, big and small), 16 mbarriers and 1 KB to align the ring: 230,528
// bytes at both D, one CTA an SM. avsum_flash_bwd_layout reports this
// tiling; the wrapper checks it against its own (bwd_layout) before its
// first launch at a D. The grid is ceil(S / 64) x H x B clusters: at
// [1, 7168, 4, D] 448 clusters (896 CTAs at D = 128, 1792 at D = 256); at
// [1, 1024, 4, 128] 128 CTAs, one wave on 132 SMs. The card runs 66
// clusters of 2 at once (all 132 SMs) but only 30 of 4 (120 SMs), a
// cluster's CTAs needing SMs of one GPC.
//
// Time on an H100: PERF.md (chip_smoke.py's check_bwd).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash;

constexpr int kKeys = 64;     // keys a cluster owns: wgmma's N
constexpr int kStages = 4;    // TMA ring: a tile's Q and dO chunks by turns
constexpr int kPlaneBytes = 4 * kKeys * kChunk;  // a 64 x 64 plane
// named barriers between the groups (1 + group: one group's own)
constexpr int kBarPReady = 3, kBarPFree = 4;

struct Layout {
  static constexpr size_t kBytes =
      1024                                  // to align the ring
      + (size_t)kStages * kChunkBytes       // TMA ring
      + 10 * (size_t)kPlaneBytes            // K, K^T, V, P, dS x big, small
      + 8 * (size_t)(2 * kStages + 8);      // full, empty; 4 a group
};
static_assert(Layout::kBytes <= 232448, "the backward fits one CTA an SM");

struct Params {
  const float *k, *v;     // resident: this cluster's keys
  long ks[3], vs[3];      // their (b, s, h) strides
  const float* mask;      // [B, S] or null
  const float *lse, *delta;  // [B, H, S]
  float *dk, *dv;         // [B, S, H, D]
  int S, H;
  float scale;
};

// Keys k0 .. k0 + 63 of a [S, 64] column chunk (row stride ss floats)
// split into big and small B planes transposed: n = column, k = key, the
// keys 2t, 2t + 1 of each k-step as k = t, t + 4 (dQ = dS K's B, in the
// order of dS's A fragments); zeros past S. By the 128 threads of a group.
__device__ __forceinline__ void split_cols(uint32_t big, uint32_t small,
                                           const float* src, long ss, int k0,
                                           int S, int i0) {
  for (int i = i0; i < kKeys * kChunk / 4; i += 128) {
    const int n = i / (kChunk / 4), d = 4 * (i % (kChunk / 4)), s = k0 + n;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) x = *reinterpret_cast<const float4*>(src + s * ss + d);
    const float v[4] = {x.x, x.y, x.z, x.w};
    const int o = n & 7, k = (o >> 1) + 4 * (o & 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t hi, lo;
      tf32::split(v[j], hi, lo);
      const uint32_t at = 4 * plane_at<kChunk>(n >> 3, d + j, k);
      tf32::sts(big + at, hi);
      tf32::sts(small + at, lo);
    }
  }
}

// One half of v split into a B plane (P or dS over the tile: k-step =
// query / 8, n = key): the big parts (kBig) or the small ones.
template <bool kBig>
__device__ __forceinline__ void store_half(uint32_t plane,
                                           const float (&v)[32], int w, int g,
                                           int t) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t hi, lo;
      tf32::split(v[4 * i + e], hi, lo);
      tf32::sts(plane + 4 * pds_at<kKeys>(i, e, w, g, t), kBig ? hi : lo);
    }
}

// A fragments of k-steps 4H .. 4H + 3 of dQ = dS K from this thread's dS
// in the accumulator layout (element v[4i + e]: query 16w + g + 8 (e / 2),
// key 8i + 2t + e % 2): k-step i's a0..a3 are v[4i], v[4i + 2], v[4i + 1],
// v[4i + 3].
template <int H>
__device__ __forceinline__ void ds_frags(AFrag& big, AFrag& small,
                                         const float (&v)[32]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * H + k;
    tf32::split_trunc(v[4 * i], big[k][0], small[k][0]);
    tf32::split_trunc(v[4 * i + 2], big[k][1], small[k][1]);
    tf32::split_trunc(v[4 * i + 1], big[k][2], small[k][2]);
    tf32::split_trunc(v[4 * i + 3], big[k][3], small[k][3]);
  }
}

// issue (flash_tiles.cuh) with A = dS from registers.
template <int P>
__device__ __forceinline__ void issue_ds(Pipe<kKeys>& q, const float (&ds)[32],
                                         uint64_t b_big, uint64_t b_small,
                                         float (&prev)[32]) {
  float(&d)[32] = q.d[P];
  float(&d_prev)[32] = q.d[P ^ 1];
  tf32::wgmma_wait<1>();
  tf32::fence_operand(q.big[0]);
  tf32::fence_operand(q.small[0]);
  ds_frags<0>(q.big[0], q.small[0], ds);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  tf32::fence_operand(d);
  issue_half<0, kKeys>(d, q.big[0], q.small[0], b_big, b_small);
  tf32::wgmma_wait<1>();
  tf32::fence_operand(d_prev);
  tf32::fence_operand(q.big[1]);
  tf32::fence_operand(q.small[1]);
  add(prev, d_prev);
  ds_frags<1>(q.big[1], q.small[1], ds);
  issue_half<1, kKeys>(d, q.big[1], q.small[1], b_big, b_small);
}

// Wait for every product in flight; -> the last one's sum, partial P.
template <int P>
__device__ __forceinline__ float (&settle(Pipe<kKeys>& q))[32] {
  tf32::wgmma_wait<0>();
  tf32::fence_operand(q.d[P]);
  tf32::fence_operand(q.big[0]);
  tf32::fence_operand(q.small[0]);
  tf32::fence_operand(q.big[1]);
  tf32::fence_operand(q.small[1]);
  return q.d[P];
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tdq, const Params p) {
  extern __shared__ float4 smem4[];
  // Shared addresses: the ring (1024-aligned for the 128-byte swizzle),
  // the planes [big, small] of K, K^T, V, P and dS, the mbarriers
  // full[stage], empty[stage], and a group's four of the exchange.
  const uint32_t ring = (tf32::smem_addr(smem4) + 1023) & ~1023u;
  const uint32_t k_big = ring + kStages * kChunkBytes;
  const uint32_t kt_big = k_big + 2 * kPlaneBytes;
  const uint32_t v_big = kt_big + 2 * kPlaneBytes;
  const uint32_t p_big = v_big + 2 * kPlaneBytes;
  const uint32_t ds_big = p_big + 2 * kPlaneBytes;
  const uint32_t full = ds_big + 2 * kPlaneBytes;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t xbar = empty + 8 * kStages;  // [group][free, got, all, freed]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = tf32::cluster_rank();  // this CTA's 64 columns of D
  const int k0 = (blockIdx.x / C) * kKeys, h = blockIdx.y, b = blockIdx.z;
  const int S = p.S;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int n_chunks = 2 * n_tiles;
  // Chunk m of the stream into its stage: tile m / 2, Q (m even) or dO.
  auto load = [&](int m) {
    const int s = m % kStages, it = m / 2;
    const CUtensorMap* map = (m & 1) ? &tdo : &tq;
    const uint32_t dst = ring + s * kChunkBytes;
    tf32::mbar_expect_tx(full + 8 * s, kChunkBytes);
    tf32::tma_load_4d(dst, map, full + 8 * s, c * kChunk, h, it * kTile, b);
    tf32::tma_load_4d(dst + kBoxBytes, map, full + 8 * s, c * kChunk + kBox,
                      h, it * kTile, b);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tf32::mbar_init(full + 8 * s, 1);
      tf32::mbar_init(empty + 8 * s, 8);  // both groups read every chunk
    }
    for (int grp = 0; grp < 2; ++grp) {
      const uint32_t bar = xbar + 32 * grp;
      tf32::mbar_init(bar, C);        // free: the CTAs' slots may take data
      tf32::mbar_init(bar + 8, 1);    // got: the peers' data in the slots
      tf32::mbar_init(bar + 16, 1);   // all: the peers' sums in the plane
      tf32::mbar_init(bar + 24, C);   // freed: the peers have this CTA's
    }
    tf32::mbar_fence_init();
    for (int m = 0; m < kStages && m < n_chunks; ++m) load(m);
  }

  // The group index through a shuffle, so that the compiler knows it is
  // the same across the warp and keeps the planes' descriptors uniform.
  const int grp = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int w = warp & 3, g = lane >> 2, t = lane & 3, gt = tid & 127;
  const long bh = (long)b * p.H + h;

  // The resident planes: group 0 K and K^T, group 1 V.
  if (grp == 0) {
    const float* src = p.k + b * p.ks[0] + h * p.ks[2] + c * kChunk;
    split_rows<kKeys, kChunk>(k_big, k_big + kPlaneBytes, src, p.ks[1], k0,
                              S, gt);
    split_cols(kt_big, kt_big + kPlaneBytes, src, p.ks[1], k0, S, gt);
  } else {
    const float* src = p.v + b * p.vs[0] + h * p.vs[2] + c * kChunk;
    split_rows<kKeys, kChunk>(v_big, v_big + kPlaneBytes, src, p.vs[1], k0,
                              S, gt);
  }
  tf32::fence_proxy_async();
  tf32::cluster_sync();  // the cluster's barriers initialized, planes in

  const Gather ga(w, g, t);
  auto desc = [](uint32_t plane) { return tf32::wgmma_desc_at(plane); };
  // Chunk n of the stream: wait for it to land; -> its shared address.
  auto take = [&](int n) {
    const int s = n % kStages;
    tf32::mbar_wait(full + 8 * s, (n / kStages) & 1);
    return ring + s * kChunkBytes;
  };
  // This warp is done reading chunk n; with `loads`, the group's first
  // thread then loads chunk n + kStages into the stage once all 8 warps
  // are done.
  auto release = [&](int n, bool loads) {
    return [&, n, loads]() {
      const int s = n % kStages;
      tf32::fence_proxy_async();  // these reads before the stage's next TMA
      __syncwarp();
      if (lane == 0) tf32::mbar_arrive(empty + 8 * s);
      if (loads && gt == 0 && n + kStages < n_chunks) {
        tf32::mbar_wait(empty + 8 * s, (n / kStages) & 1);
        load(n + kStages);
      }
      __syncwarp();
    };
  };
  // The exchange (the note's): the group's partial x (S or dP over this
  // CTA's columns) in its small plane `mine` as [float4 j][128 threads],
  // summed over the cluster into x, through the peers' `slots` (their big
  // planes). Floats are added in pairs, (p0 + p1) + (p2 + p3), so every
  // CTA forms the same sum.
  const uint32_t my_free = xbar + 32 * grp, my_got = my_free + 8;
  const uint32_t my_all = my_free + 16, my_freed = my_free + 24;
  constexpr int kSlice = kPlaneBytes / C;  // CTA r's keys: float4s of r
  // This CTA's slots may take the peers' data of the next step.
  auto offer = [&]() {
#pragma unroll
    for (int r = 0; r < C; ++r) tf32::mbar_arrive_cluster(tf32::mapa(my_free, r));
  };
  auto exchange = [&](float(&x)[32], uint32_t mine, uint32_t slots, int it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      tf32::sts4(mine + 16 * (128 * j + gt), x[4 * j], x[4 * j + 1],
                 x[4 * j + 2], x[4 * j + 3]);
    tf32::fence_proxy_async();  // for the copies' reads
    group_sync(grp);
    if constexpr (C == 2) {
      // the partial to the peer's slots; the peer's from this CTA's
      if (gt == 0) {
        tf32::mbar_expect_tx(my_got, kPlaneBytes);
        tf32::mbar_wait_cluster(my_free, it & 1);
        tf32::bulk_copy_cluster(tf32::mapa(slots, c ^ 1), mine, kPlaneBytes,
                                tf32::mapa(my_got, c ^ 1));
      }
      tf32::mbar_wait_cluster(my_got, it & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 y = tf32::lds4(slots + 16 * (128 * j + gt));
        x[4 * j] += y.x, x[4 * j + 1] += y.y;
        x[4 * j + 2] += y.z, x[4 * j + 3] += y.w;
      }
    } else {
      // reduce-scatter: CTA r's float4s 2r, 2r + 1 (keys 16r .. 16r + 15)
      // of the partial to CTA r's slot c; this CTA sums its own over the
      // cluster where its partial of them was, then sends the sums to
      // every peer's plane (all-gather)
      if (gt == 0) {
        tf32::mbar_expect_tx(my_got, 3 * kSlice);
        tf32::mbar_wait_cluster(my_free, it & 1);
#pragma unroll
        for (int o = 1; o < 4; ++o)
          tf32::bulk_copy_cluster(tf32::mapa(slots, c ^ o) + c * kSlice,
                                  mine + (c ^ o) * kSlice, kSlice,
                                  tf32::mapa(my_got, c ^ o));
      }
      tf32::mbar_wait_cluster(my_got, it & 1);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float4 y[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          y[r] = tf32::lds4((r == c ? mine : slots) + r * kSlice +
                            16 * (128 * j + gt));
        tf32::sts4(mine + c * kSlice + 16 * (128 * j + gt),
                   (y[0].x + y[1].x) + (y[2].x + y[3].x),
                   (y[0].y + y[1].y) + (y[2].y + y[3].y),
                   (y[0].z + y[1].z) + (y[2].z + y[3].z),
                   (y[0].w + y[1].w) + (y[2].w + y[3].w));
      }
      tf32::fence_proxy_async();
      group_sync(grp);
      if (gt == 0) {
        tf32::mbar_expect_tx(my_all, 3 * kSlice);
#pragma unroll
        for (int o = 1; o < 4; ++o)
          tf32::bulk_copy_cluster(tf32::mapa(mine, c ^ o) + c * kSlice,
                                  mine + c * kSlice, kSlice,
                                  tf32::mapa(my_all, c ^ o));
      }
      tf32::mbar_wait_cluster(my_all, it & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 z = tf32::lds4(mine + 16 * (128 * j + gt));
        x[4 * j] = z.x, x[4 * j + 1] = z.y, x[4 * j + 2] = z.z,
        x[4 * j + 3] = z.w;
      }
    }
    // every copy to this CTA has landed: the peers may reuse their planes
    if (gt == 0)
#pragma unroll
      for (int r = 0; r < C; ++r)
        tf32::mbar_arrive_cluster(tf32::mapa(my_freed, r));
    // every thread's reads of `slots` and `mine` done before any warp of
    // the group writes P or dS over them (a warp's share of a plane is
    // read by every warp)
    group_sync(grp);
  };

  float acc[32];  // group 0 dV^T, group 1 dK^T: [64 columns x 64 keys]
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  Pipe<kKeys> q;

  // Accumulator element v[4i + e] of the products over D: query row 16w +
  // g + 8 (e / 2) of the tile, key 8i + 2t + e % 2 of the block.
  if (grp == 0) {
    // The key bias of this thread's keys, -inf past S (so P = 0 there,
    // also for a row whose LSE is -1e30).
    float kb[16];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + 8 * i + 2 * t + j;
        kb[2 * i + j] = key < S ? key_bias(p.mask, b, S, key) : -INFINITY;
      }
    for (int it = 0; it < n_tiles; ++it) {
      // The LSE of this thread's rows, +inf past S (P = 0 there).
      float lse[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = it * kTile + 16 * w + g + 8 * e;
        lse[e] = s < S ? p.lse[bh * S + s] : INFINITY;
      }
      // S_c = Q_c K_c^T
      issue<0, true>(q, true, ga, take(2 * it), desc(k_big),
                     desc(k_big + kPlaneBytes), release(2 * it, false),
                     q.d[1]);
      if (it > 0) bar_wait(kBarPFree);  // group 1 has read the last P
      if (gt == 0) offer();  // the P big plane takes the peers' partials
      float(&x)[32] = settle<0>(q);
      exchange(x, p_big + kPlaneBytes, p_big, it);
      // P = exp(S * scale + key bias - LSE)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[4 * i + e] = expf(x[4 * i + e] * p.scale + kb[2 * i + (e & 1)] -
                              lse[e >> 1]);
      store_half<true>(p_big, x, w, g, t);
      tf32::mbar_wait_cluster(my_freed, it & 1);  // S_c has left
      store_half<false>(p_big + kPlaneBytes, x, w, g, t);
      tf32::fence_proxy_async();
      group_sync(0);
      bar_arrive(kBarPReady);
      // dV_c^T += dO_c^T P
      issue<0, false>(q, true, ga, take(2 * it + 1), desc(p_big),
                      desc(p_big + kPlaneBytes), release(2 * it + 1, true),
                      acc);
      drain<0>(q, acc);
    }
  } else {
    float ds[32];
    for (int it = 0; it < n_tiles; ++it) {
      float delta[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = it * kTile + 16 * w + g + 8 * e;
        delta[e] = s < S ? p.delta[bh * S + s] : 0.f;
      }
      // dP_c = dO_c V_c^T
      issue<0, true>(q, true, ga, take(2 * it + 1), desc(v_big),
                     desc(v_big + kPlaneBytes), release(2 * it + 1, false),
                     q.d[1]);
      if (gt == 0) {
        // the last tile's dQ block has left the dS big plane, which then
        // takes the peers' partials
        tf32::bulk_wait_read<0>();
        offer();
      }
      float(&x)[32] = settle<0>(q);
      exchange(x, ds_big + kPlaneBytes, ds_big, it);
      // dS = P o (dP - delta), P read back from its planes
      bar_wait(kBarPReady);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t at = 4 * pds_at<kKeys>(i, e, w, g, t);
          const float pv =
              tf32::lds(p_big + at) + tf32::lds(p_big + kPlaneBytes + at);
          ds[4 * i + e] = pv * (x[4 * i + e] - delta[e >> 1]);
        }
      tf32::fence_proxy_async();  // these reads before the peers' copies
      if (it + 1 < n_tiles) bar_arrive(kBarPFree);
      store_half<true>(ds_big, ds, w, g, t);
      tf32::mbar_wait_cluster(my_freed, it & 1);  // dP_c has left
      store_half<false>(ds_big + kPlaneBytes, ds, w, g, t);
      tf32::fence_proxy_async();
      group_sync(1);
      // dK_c^T += Q_c^T dS, then dQ_c = dS K_c
      issue<0, false>(q, true, ga, take(2 * it), desc(ds_big),
                      desc(ds_big + kPlaneBytes), release(2 * it, true), acc);
      issue_ds<1>(q, ds, desc(kt_big), desc(kt_big + kPlaneBytes), acc);
      const float(&dq)[32] = settle<1>(q);
      // The dQ block, scaled, into the dS big plane as two TMA boxes of
      // [64 rows x 32 columns] (128-byte rows, 16-byte chunks swizzled by
      // the row's low three bits), then added to dQ; once every warp's
      // wait has seen dK^T's product, the last to read the plane, done.
      group_sync(1);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * w + g + 8 * r, chunk = 2 * (i & 3) + (t >> 1);
          tf32::sts2(ds_big + (i >> 2) * kBoxBytes + row * 128 +
                         ((chunk ^ g) << 4) + 8 * (t & 1),
                     dq[4 * i + 2 * r] * p.scale,
                     dq[4 * i + 2 * r + 1] * p.scale);
        }
      tf32::fence_proxy_async();
      group_sync(1);
      if (gt == 0) {
        const int s0 = it * kTile;
        tf32::tma_reduce_add_4d(&tdq, ds_big, c * kChunk, h, s0, b);
        tf32::tma_reduce_add_4d(&tdq, ds_big + kBoxBytes,
                                c * kChunk + kBox, h, s0, b);
        tf32::bulk_commit();
      }
    }
    if (gt == 0) tf32::bulk_wait<0>();
  }

  // Accumulator row 16w + g + 8 (e / 2) is column 64c + that of D; column
  // 8i + 2t + e % 2 is key k0 + that.
  float* out = grp ? p.dk : p.dv;
  const float f = grp ? p.scale : 1.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = k0 + 8 * i + 2 * t + (e & 1);
      if (s < S)
        out[(((long)b * S + s) * p.H + h) * (C * kChunk) + c * kChunk +
            16 * w + g + 8 * (e >> 1)] = acc[4 * i + e] * f;
    }
  tf32::cluster_sync();  // no CTA leaves while its peers signal or copy to it
}

template <int C>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* mask, const float* lse, const float* delta, float* dq,
           float* dk, float* dv, int B, int S, int H, const long* qs,
           const long* ks, const long* vs, const long* ds,
           cudaStream_t stream) {
  constexpr int D = C * kChunk;
  CUtensorMap tq, tdo, tdq;
  const long dq_strides[3] = {(long)S * H * D, (long)H * D, D};
  int err = make_map(&tq, q, B, S, H, D, qs);
  if (err == 0) err = make_map(&tdo, dout, B, S, H, D, ds);
  if (err == 0) err = make_map(&tdq, dq, B, S, H, D, dq_strides);
  if (err) return err;
  Params p;
  p.k = k;
  p.v = v;
  for (int i = 0; i < 3; ++i) {
    p.ks[i] = ks[i];
    p.vs[i] = vs[i];
  }
  p.mask = mask;
  p.lse = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  p.S = S;
  p.H = H;
  p.scale = 1.f / sqrtf((float)D);
  const size_t smem = Layout::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((S + kKeys - 1) / kKeys), H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&tq, &tdo, &tdq, &p};
  e = cudaLaunchKernelExC(&cfg, (const void*)flash_bwd_kernel<C>, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int C>
int max_clusters(int* out) {
  const size_t smem = Layout::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * 1024, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      out, (const void*)flash_bwd_kernel<C>, &cfg);
}

}  // namespace

// The tiling at head width d: out[0..5] = keys a cluster owns, CTAs a
// cluster (D / 64), streamed rows per tile, TMA stages, dynamic shared
// memory in bytes and CTAs an SM holds by shared memory (each also
// reserves 1 KB). Returns cudaErrorInvalidValue for a d other than 128 or
// 256.
extern "C" int avsum_flash_bwd_layout(int d, long* out) {
  if (d != 128 && d != 256) return (int)cudaErrorInvalidValue;
  constexpr long kSmSmem = 233472;  // an SM's shared memory, 228 KB
  const long v[] = {kKeys, d / kChunk, kTile, kStages, (long)Layout::kBytes,
                    kSmSmem / ((long)Layout::kBytes + 1024)};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// How many clusters of the kernel at head width d the current device runs
// at once (cudaOccupancyMaxActiveClusters) into *out; 0 or a CUDA error.
extern "C" int avsum_flash_bwd_max_clusters(int d, int* out) {
  if (d == 128) return max_clusters<2>(out);
  if (d == 256) return max_clusters<4>(out);
  return (int)cudaErrorInvalidValue;
}

// q, k, v, dout: float32 [B, S, H, D] with element strides {b, s, h} in
// *_strides (multiples of 4) and unit stride on D, 16-byte aligned; mask:
// float32 [B, S] contiguous (> 0 = valid key) or null; lse, delta: float32
// [B, H, S] contiguous; dq (zeroed), dk, dv: [B, S, H, D] contiguous. D
// must be 128 or 256 (returns cudaErrorInvalidValue otherwise). Returns 0
// or a CUDA error code: that of a tensor map the driver refused, of the
// shared-memory opt-in, or of the launch.
extern "C" int avsum_flash_bwd(const void* q, const void* k, const void* v,
                               const void* dout, const void* mask,
                               const void* lse, const void* delta, void* dq,
                               void* dk, void* dv, int B, int S, int H, int D,
                               const long* q_strides, const long* k_strides,
                               const long* v_strides, const long* do_strides,
                               void* stream) {
  const float *qf = (const float*)q, *kf = (const float*)k,
              *vf = (const float*)v, *df = (const float*)dout,
              *mf = (const float*)mask, *lf = (const float*)lse,
              *ef = (const float*)delta;
  float *oq = (float*)dq, *ok = (float*)dk, *ov = (float*)dv;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return launch<2>(qf, kf, vf, df, mf, lf, ef, oq, ok, ov, B, S, H,
                     q_strides, k_strides, v_strides, do_strides, st);
  if (D == 256)
    return launch<4>(qf, kf, vf, df, mf, lf, ef, oq, ok, ov, B, S, H,
                     q_strides, k_strides, v_strides, do_strides, st);
  return (int)cudaErrorInvalidValue;
}
