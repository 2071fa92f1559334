// Float32 matrix products on Hopper's tensor cores at float32-level
// accuracy: C = A B^T (+ bias), A [M x K], B [N x K], C [M x N] row-major,
// in 3xTF32 on wgmma. The port's Linear layers run their three products
// through it (avsum_torch/ops/linear.py): the forward Y = X W^T + b, and
// the backward's dX = dY W and dW = dY^T X.
//
// Replaces no TPU kernel: the JAX package leaves its dense products to
// XLA's dots. It was added because cuBLAS runs a float32 product with
// TF32 off on the FMA pipes (SIMT sgemm, xmma ffma): about 67 TFLOP/s at
// best on an H100, where the TF32 tensor cores give 495 TFLOP/s, a third of
// that in 3xTF32 (mma_tf32.cuh). One TF32 pass is not float32: it misses
// the train cells' limits.
//
// What bounds it on an H100: arithmetic. 2 M N K flops, three TF32 passes
// each, at 495 TFLOP/s; shared memory is the next limit: every wgmma
// m64nNk8 reads its 8 x N B operand (1/16 byte a multiply-add), and the
// split planes, the TMA tiles and the A loads add as much again, near the
// SM's 128 bytes a clock at the 3-pass peak.
//
// Operand layouts. A is read by rows ([M x K], "K-major") or by columns
// (stored [K x M]), B by rows ([N x K]) or by columns (stored [K x N]), row
// strides in floats (multiples of 4, 16-byte aligned bases: TMA's rule):
//   the forward   A = X [M x K] rows,   B = W [N x K] rows;
//   dX = dY W     A = dY [M x N] rows,  B = W [N x K] columns;
//   dW = dY^T X   A = dY by columns,    B = X by columns.
// So the transposes of the backward cost no copy and no launch: they
// happen where the kernel reads its tiles into registers and planes.
//
// Design. A persistent grid (one block an SM, at most the SM count)
// walks the units of work: 128 x 128 tiles of C, each cut along K into
// `splits` parts where the tiles alone would leave SMs idle (the
// wrapper's choice, ops/linear.py plan_splits), rastered in groups of 8
// tile rows so that the blocks at work share their A rows and B columns
// in L2. A block has three warpgroups:
//   - warpgroup 0: one thread issues the TMA loads of the k-tiles (32
//     floats of K) of A and B into a ring of kStages stages, tracked by
//     full and empty mbarriers; its registers go to the others
//     (setmaxnreg).
//   - warpgroups 1 and 2 (the consumers), 64 rows of the tile each. Per
//     k-tile they split the landed B tile into big and small TF32 planes
//     in the K-major core-matrix order wgmma reads (mma_tf32.cuh), the
//     256 threads a quarter of it each; that is where B read by columns
//     is transposed. Each gathers its A fragments from the landed A tile
//     into registers and splits them there (tf32::split, round to
//     nearest), then releases the stage. A k-tile is 12 wgmmas m64n128k8
//     (small terms first), one commit group; two k-tiles make a run,
//     summed from zero into a partial that is added to the float32
//     accumulator by an ordinary add once the run is done: runs of 8
//     k-steps, as wgmma3 documents, since the tensor cores' own sums
//     round toward zero. Each k-tile's successor is made ready (a second
//     pair of planes, a second A register set) while its wgmmas run, and
//     a run's second k-tile is queued behind its first, so the tensor
//     cores wait only at the run's end, for the add. Barriers of the 256
//     consumer threads order the planes' writes before the wgmmas that
//     read them, and both groups' wgmmas before the planes are written
//     again. A run's groups are waited for before the loop's back edge,
//     so ptxas does not serialize the wgmmas (note C7514).
// The B tiles read by rows and all A tiles arrive with the 128-byte
// swizzle, so that the fragment gathers and the plane writes are free of
// bank conflicts; A read by columns takes its k-steps' rows in the order
// (0, 2, 4, 6, 1, 3, 5, 7), B's planes the same order where B is read by
// columns with it (a product's contraction order is free, as long as A
// and B agree).
//
// The epilogue writes C from the accumulators with the bias added. A
// tile cut into splits writes each part to the workspace [splits, M, N];
// the part that finds the tile's counter at splits - 1 (an atomic, after
// a fence) is the last, sums the parts in their order (so C does not
// depend on which part finished last), adds the bias, writes C and sets
// the counter back to 0 for the next launch on the stream. No part waits
// for another, so no block ever waits on one that is not running.
//
// Edges: TMA fills what lies past M, N or K with zeros, which add
// nothing; the epilogue writes only inside C. Time on an H100: PERF.md
// (chip_smoke.py's time_linear).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

constexpr int kTileM = 128;  // rows of C a block: two consumer groups of 64
constexpr int kTileN = 128;  // columns of C a block: wgmma's N
constexpr int kTileK = 32;   // K a stage: 128 bytes, one swizzled row
constexpr int kStages = 5;
constexpr int kThreads = 384;  // the producer's warpgroup, two consumers
constexpr int kGroupM = 8;     // tile rows a raster group
constexpr int kOperandBytes = 4 * kTileM * kTileK;  // 16 KB
constexpr int kStageBytes = 2 * kOperandBytes;      // A, then B
constexpr int kPlaneBytes = 4 * kTileN * kTileK;    // 16 KB: 4 k-steps
constexpr int kKStepBytes = 4 * 8 * kTileN;         // a plane's k-step
constexpr int kSmemBytes = 1024                        // to align the ring
                           + kStages * kStageBytes     // the ring
                           + 2 * 2 * kPlaneBytes       // 2 x (big, small)
                           + 8 * 2 * kStages           // full, empty
                           + 16;                       // the last-part flag
static_assert(kSmemBytes <= 232448, "a block's shared memory");
constexpr int kBarConsumers = 1;  // named barrier of the 256 consumers

struct Params {
  float* c;            // [M, N]
  const float* bias;   // [N] or null
  float* ws;           // [splits, M, N] where splits > 1
  int* counters;       // a tile's parts done, where splits > 1
  int M, N, splits, tiles_m, tiles_n, k_tiles;
};

// A unit of work: a tile (rows m0, columns n0) and its part's k-tiles
// [kb, ke).
struct Unit {
  int m0, n0, kb, ke, split, tile;
};

__device__ __forceinline__ Unit unit_at(const Params& p, int u) {
  const int tile = u / p.splits, s = u % p.splits;
  const int width = kGroupM * p.tiles_n;
  const int first = (tile / width) * kGroupM;
  const int rows = min(p.tiles_m - first, kGroupM);
  const int in = tile % width;
  Unit r;
  r.m0 = (first + in % rows) * kTileM;
  r.n0 = (in / rows) * kTileN;
  r.kb = (int)((long)s * p.k_tiles / p.splits);
  r.ke = (int)((long)(s + 1) * p.k_tiles / p.splits);
  r.split = s;
  r.tile = tile;
  return r;
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// d (+)= a * b, m64n128k8 .tf32; d is overwritten where scale_d is 0.
__device__ __forceinline__ void wgmma128(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// A fragments of a k-tile's 4 k-steps, big and small parts.
struct Frag {
  uint32_t big[4][4], small[4][4];
};

// Row r (0..7) of a k-step that holds the contraction's place l (0..7): A
// read by columns takes rows (0, 2, 4, 6, 1, 3, 5, 7), so that a warp's
// gathers hit 32 banks; elsewhere the order is the identity.
template <bool kPerm>
__device__ __forceinline__ int krow(int l) {
  return kPerm ? (l < 4 ? 2 * l : 2 * (l - 4) + 1) : l;
}

// This thread's A fragments (warp w of consumer group grp, lane (g, t))
// from the landed A tile at shared address `tile`:
//   by rows, one box [128 rows][32 k] with the 128-byte swizzle (16-byte
//     chunk c of row r at chunk c ^ (r % 8));
//   by columns, four boxes [32 k][32 rows of A] likewise swizzled.
template <bool kARows>
__device__ __forceinline__ void load_a(uint32_t tile, int grp, int w, int g,
                                       int t, Frag& f) {
  if constexpr (kARows) {
    const uint32_t r0 = tile + (64 * grp + 16 * w + g) * 128 + 4 * t;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t lo = ((2 * s) ^ g) << 4, hi = ((2 * s + 1) ^ g) << 4;
      tf32::split(tf32::lds(r0 + lo), f.big[s][0], f.small[s][0]);
      tf32::split(tf32::lds(r0 + 1024 + lo), f.big[s][1], f.small[s][1]);
      tf32::split(tf32::lds(r0 + hi), f.big[s][2], f.small[s][2]);
      tf32::split(tf32::lds(r0 + 1024 + hi), f.big[s][3], f.small[s][3]);
    }
  } else {
    // row m = 64 grp + 16 w + g (+ 8) of A: box 2 grp + w / 2, 16-byte
    // chunk cm (cm + 2) of its row, word g % 4
    const uint32_t box = tile + (2 * grp + (w >> 1)) * 4096 + 4 * (g & 3);
    const int cm = 4 * (w & 1) + (g >> 2);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k0 = 8 * s + 2 * t, k1 = k0 + 1;  // places t and t + 4
      const uint32_t at0 = box + k0 * 128, at1 = box + k1 * 128;
      tf32::split(tf32::lds(at0 + ((cm ^ (2 * t)) << 4)), f.big[s][0],
                  f.small[s][0]);
      tf32::split(tf32::lds(at0 + (((cm + 2) ^ (2 * t)) << 4)), f.big[s][1],
                  f.small[s][1]);
      tf32::split(tf32::lds(at1 + ((cm ^ (2 * t + 1)) << 4)), f.big[s][2],
                  f.small[s][2]);
      tf32::split(tf32::lds(at1 + (((cm + 2) ^ (2 * t + 1)) << 4)),
                  f.big[s][3], f.small[s][3]);
    }
  }
}

// The landed B tile at `tile` into the big and small planes at `big`,
// `small`, element (n, k) of k-step s at s * kKStepBytes + (n / 8) * 256 +
// (k / 4) * 128 + (n % 8) * 16 + (k % 4) * 4 (tf32::wgmma_desc's order);
// consumer thread ct (0..255) writes 16-byte groups q = ct / 128 + 2r of
// column n = ct % 128. B by rows is one box [128 n][32 k] with the
// 128-byte swizzle, by columns four boxes [32 k][32 n] likewise.
template <bool kBRows, bool kPerm>
__device__ __forceinline__ void split_b(uint32_t tile, uint32_t big,
                                        uint32_t small, int ct) {
  const int n = ct & 127;
  const uint32_t dst_n = (n >> 3) * 256 + (n & 7) * 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = (ct >> 7) + 2 * r;  // k-step q / 2, places 4 (q % 2) ..
    float v[4];
    if constexpr (kBRows) {
      const float4 x = tf32::lds4(tile + n * 128 + ((q ^ (n & 7)) << 4));
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    } else {
      const uint32_t col = tile + (n >> 5) * 4096 + (n & 3) * 4;
      const int cn = (n & 31) >> 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = 8 * (q >> 1) + krow<kPerm>(4 * (q & 1) + i);
        v[i] = tf32::lds(col + kp * 128 + ((cn ^ (kp & 7)) << 4));
      }
    }
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32::split(v[i], hi[i], lo[i]);
    const uint32_t at = (q >> 1) * kKStepBytes + dst_n + (q & 1) * 128;
    tf32::sts4(big + at, __uint_as_float(hi[0]), __uint_as_float(hi[1]),
               __uint_as_float(hi[2]), __uint_as_float(hi[3]));
    tf32::sts4(small + at, __uint_as_float(lo[0]), __uint_as_float(lo[1]),
               __uint_as_float(lo[2]), __uint_as_float(lo[3]));
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, 256;\n" ::"n"(kBarConsumers) : "memory");
}

// A consumer thread's state and its two phases of a k-tile.
template <bool kARows, bool kBRows>
struct Consumer {
  static constexpr bool kPerm = !kARows;  // B by columns follows A's rows
  uint32_t ring, planes, full, empty;
  uint64_t desc0;  // the first plane pair's big plane
  int ct, grp, w, g, t, lane;
  float acc[64], d[64];
  Frag fa[2];

  // K-tile `n` of the block's stream into plane pair P and A register set
  // P; then this warp releases the stage.
  template <int P>
  __device__ __forceinline__ void prepare(int n) {
    const int s = n % kStages;
    tf32::mbar_wait(full + 8 * s, (n / kStages) & 1);
    const uint32_t stage = ring + s * kStageBytes;
    const uint32_t big = planes + P * 2 * kPlaneBytes;
    split_b<kBRows, kPerm>(stage + kOperandBytes, big, big + kPlaneBytes, ct);
    tf32::fence_operand(fa[P].big);
    tf32::fence_operand(fa[P].small);
    load_a<kARows>(stage, grp, w, g, t, fa[P]);
    tf32::fence_proxy_async();  // the planes before the wgmmas, the
    __syncwarp();               // stage's reads before its next TMA
    if (lane == 0) tf32::mbar_arrive(empty + 8 * s);
  }

  // The 12 wgmmas of the k-tile in plane pair and register set P into d
  // (the first of a run overwrites d), committed as one group.
  template <int P>
  __device__ __forceinline__ void issue(int first) {
    constexpr uint64_t kDescPlane = kPlaneBytes >> 4;
    constexpr uint64_t kDescStep = kKStepBytes >> 4;
    const uint64_t db = desc0 + P * 2 * kDescPlane, ds = db + kDescPlane;
    tf32::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma128(d, fa[P].small[s], db + s * kDescStep, s > 0 || !first);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma128(d, fa[P].big[s], ds + s * kDescStep, 1);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma128(d, fa[P].big[s], db + s * kDescStep, 1);
    tf32::wgmma_commit();
  }

  // A run: k-tile n (ready in pair 0) and, if `two`, k-tile n + 1, summed
  // from zero in d, then added to the accumulator. Each k-tile's successor
  // is made ready in the other pair while its wgmmas run: n + 1 in pair 1,
  // then n + 2 in pair 0 (if `more`) once both groups are done with n.
  __device__ __forceinline__ void run(bool two, bool more, int n) {
    tf32::fence_operand(d);
    issue<0>(1);
    if (two) {
      prepare<1>(n + 1);
      consumer_sync();  // pair 1 written by both groups
      issue<1>(0);
      tf32::wgmma_wait<1>();  // k-tile n done: set 0 free
      tf32::fence_operand(fa[0].big);
      tf32::fence_operand(fa[0].small);
      consumer_sync();  // ... and pair 0, in both groups
      if (more) prepare<0>(n + 2);
    }
    tf32::wgmma_wait<0>();
    tf32::fence_operand(d);
    tf32::fence_operand(fa[0].big);
    tf32::fence_operand(fa[0].small);
    tf32::fence_operand(fa[1].big);
    tf32::fence_operand(fa[1].small);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
    consumer_sync();  // both groups' wgmmas done, pair 0 written
  }
};

// A consumer thread's 64 values of a tile (v[4i + 2h + e] at row row0 +
// 8h, column col0 + 8i + e) into the row-major [M, N] matrix at out, with
// bias[column] added where there is a bias; nothing outside [M, N].
__device__ __forceinline__ void store_tile(const float (&v)[64], float* out,
                                           const float* bias, int row0,
                                           int col0, int M, int N) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = col0 + 8 * i;
    if (col >= N) break;
    const float2 b = bias ? *reinterpret_cast<const float2*>(bias + col)
                          : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < M)
        *reinterpret_cast<float2*>(out + (long)row * N + col) =
            make_float2(v[4 * i + 2 * h] + b.x, v[4 * i + 2 * h + 1] + b.y);
    }
  }
}

template <bool kARows, bool kBRows>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb, const Params p) {
  extern __shared__ float4 smem4[];
  // Shared addresses: the ring (1024-aligned for the swizzle) of stages
  // [A tile | B tile], the planes [pair][big | small], the mbarriers
  // full[stage], empty[stage], the flag.
  const uint32_t ring = (tf32::smem_addr(smem4) + 1023) & ~1023u;
  const uint32_t planes = ring + kStages * kStageBytes;
  const uint32_t full = planes + 4 * kPlaneBytes;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t flag = empty + 8 * kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int units = p.tiles_m * p.tiles_n * p.splits;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tf32::mbar_init(full + 8 * s, 1);
      tf32::mbar_init(empty + 8 * s, 8);  // the consumers' eight warps
    }
    tf32::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {  // the producer's warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit un = unit_at(p, u);
        for (int kt = un.kb; kt < un.ke; ++kt, ++it) {
          const int s = it % kStages;
          tf32::mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t dst = ring + s * kStageBytes, bar = full + 8 * s;
          const int k0 = kt * kTileK;
          tf32::mbar_expect_tx(bar, kStageBytes);
          if (kARows) {
            tma_load_2d(dst, &ta, bar, k0, un.m0);
          } else {
#pragma unroll 1
            for (int b = 0; b < 4; ++b)
              tma_load_2d(dst + b * 4096, &ta, bar, un.m0 + 32 * b, k0);
          }
          if (kBRows) {
            tma_load_2d(dst + kOperandBytes, &tb, bar, k0, un.n0);
          } else {
#pragma unroll 1
            for (int b = 0; b < 4; ++b)
              tma_load_2d(dst + kOperandBytes + b * 4096, &tb, bar,
                          un.n0 + 32 * b, k0);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  Consumer<kARows, kBRows> c;
  c.ring = ring;
  c.planes = planes;
  c.full = full;
  c.empty = empty;
  c.desc0 = tf32::wgmma_desc_at(planes);
  c.ct = tid - 128;
  // the group index through a shuffle, so that the compiler knows it is
  // the same across the warp
  c.grp = __shfl_sync(0xffffffffu, (warp - 4) >> 2, 0);
  c.w = warp & 3;
  c.g = lane >> 2;
  c.t = lane & 3;
  c.lane = lane;
  const int grp = c.grp, w = c.w, g = c.g, t = c.t, ct = c.ct;
  float(&acc)[64] = c.acc;
  int it = 0;  // k-tiles taken by this block so far: the ring's position

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit un = unit_at(p, u);
    const int nk = un.ke - un.kb;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    c.template prepare<0>(it);
    consumer_sync();
    for (int j = 0; j < nk; j += 2) c.run(j + 1 < nk, j + 2 < nk, it + j);
    it += nk;

    // Accumulator element acc[4i + 2h + e]: row 64 grp + 16 w + g + 8h,
    // column 8i + 2t + e of the tile.
    const int row0 = un.m0 + 64 * grp + 16 * w + g;
    const int col0 = un.n0 + 2 * t;
    if (p.splits == 1) {
      store_tile(acc, p.c, p.bias, row0, col0, p.M, p.N);
      continue;
    }
    // A part of the tile: into the workspace; the last part done sums the
    // parts in their order (its own from its registers), then the bias.
    const long plane = (long)p.M * p.N;
    store_tile(acc, p.ws + un.split * plane, nullptr, row0, col0, p.M, p.N);
    __threadfence();
    consumer_sync();
    if (ct == 0) {
      const int before = atomicAdd(p.counters + un.tile, 1);
      const bool last = before == p.splits - 1;
      if (last) p.counters[un.tile] = 0;
      tf32::sts(flag, __float_as_uint(last ? 1.f : 0.f));
    }
    consumer_sync();
    if (tf32::lds(flag) == 0.f) continue;
    __threadfence();
    float(&sum)[64] = c.d;
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      if (s == un.split) {
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += acc[i];
        continue;
      }
      const float* part = p.ws + s * plane;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h, col = col0 + 8 * i;
          if (row < p.M && col < p.N) {
            const float2 x = __ldcg(reinterpret_cast<const float2*>(
                part + (long)row * p.N + col));
            sum[4 * i + 2 * h] += x.x;
            sum[4 * i + 2 * h + 1] += x.y;
          }
        }
    }
    store_tile(sum, p.c, p.bias, row0, col0, p.M, p.N);
  }
}

// The tensor map of a row-major [rows x cols] float32 matrix with row
// stride ld floats: boxes of [box_rows][32 floats] at coordinates (col,
// row), the 128-byte swizzle, zeros outside. Returns 0 or a CUDA error
// code.
int make_map(CUtensorMap* map, const float* base, int rows, int cols,
             long ld, int box_rows) {
  flash::EncodeTiled encode = flash::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(4 * ld)};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <bool kARows, bool kBRows>
int launch(const float* a, long lda, const float* b, long ldb,
           const float* bias, float* c, float* ws, int* counters, int M,
           int N, int K, int splits, cudaStream_t stream) {
  CUtensorMap ta, tb;
  int err = kARows ? make_map(&ta, a, M, K, lda, kTileM)
                   : make_map(&ta, a, K, M, lda, 32);
  if (err == 0)
    err = kBRows ? make_map(&tb, b, N, K, ldb, kTileN)
                 : make_map(&tb, b, K, N, ldb, 32);
  if (err) return err;
  Params p;
  p.c = c;
  p.bias = bias;
  p.ws = ws;
  p.counters = counters;
  p.M = M;
  p.N = N;
  p.splits = splits;
  p.tiles_m = (M + kTileM - 1) / kTileM;
  p.tiles_n = (N + kTileN - 1) / kTileN;
  p.k_tiles = (K + kTileK - 1) / kTileK;
  // the SM count and the shared-memory opt-in, once a device
  constexpr int kDevices = 64;
  static int sms_of[kDevices];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= kDevices) return (int)cudaErrorInvalidDevice;
  if (sms_of[device] == 0) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gemm_tf32x3_kernel<kARows, kBRows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    sms_of[device] = sms;
  }
  const int sms = sms_of[device];
  const long units = (long)p.tiles_m * p.tiles_n * splits;
  const int grid = (int)(units < sms ? units : sms);
  gemm_tf32x3_kernel<kARows, kBRows>
      <<<grid, kThreads, kSmemBytes, stream>>>(ta, tb, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The tiling: out[0..4] = rows and columns of C a tile, K a stage, TMA
// stages and dynamic shared memory in bytes.
extern "C" void avsum_gemm_tf32x3_layout(long* out) {
  const long v[] = {kTileM, kTileN, kTileK, kStages, kSmemBytes};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
}

// C [M, N] (row stride N) = A B^T (+ bias [N]) over K, float32, in
// 3xTF32. a_rows: A is [M, K] with row stride lda, else stored [K, M];
// b_rows: B is [N, K] with row stride ldb, else stored [K, N]. The pairs
// (1, 1), (1, 0) and (0, 0) are taken; row strides multiples of 4 floats,
// 16-byte aligned bases, N even. splits: parts along K a tile is cut
// into (1 .. K-tiles); above 1, ws is a [splits, M, N] float32 workspace
// and counters an int32 array of one zero per tile, set back to zeros by
// the launch. M, N, K > 0. Returns 0 or a CUDA error code: that of a
// tensor map the driver refused, of the shared-memory opt-in, or
// cudaGetLastError() after the launch; cudaErrorInvalidValue for what the
// kernel does not take.
extern "C" int avsum_gemm_tf32x3(const void* a, long lda, int a_rows,
                                 const void* b, long ldb, int b_rows,
                                 const void* bias, void* c, void* ws,
                                 void* counters, int M, int N, int K,
                                 int splits, void* stream) {
  const int k_tiles = (K + kTileK - 1) / kTileK;
  if (M <= 0 || N <= 0 || K <= 0 || N % 2 || splits < 1 ||
      splits > k_tiles || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* af = (const float*)a;
  const float* bf = (const float*)b;
  const float* biasf = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  if (a_rows && b_rows)
    return launch<true, true>(af, lda, bf, ldb, biasf, (float*)c, (float*)ws,
                              (int*)counters, M, N, K, splits, st);
  if (a_rows && !b_rows)
    return launch<true, false>(af, lda, bf, ldb, biasf, (float*)c, (float*)ws,
                               (int*)counters, M, N, K, splits, st);
  if (!a_rows && !b_rows)
    return launch<false, false>(af, lda, bf, ldb, biasf, (float*)c,
                                (float*)ws, (int*)counters, M, N, K, splits,
                                st);
  return (int)cudaErrorInvalidValue;
}
