// The int8 bit-plane GEMM over 512-row crossbar segments that K1
// (fused_crossbar.cu) and K2 (fused_spec_crossbar.cu) share: staging,
// tensor-core fragments, the per-segment reduction, the cluster reduction
// and the launch. Each kernel adds its own epilogue, which turns the 8
// bit-plane sums of one (b, c) and one (segment, plane) into a uint32
// contribution and counts its ADC events. Python mirror of the constants
// and the launch plan: repro_torch/kernels/bitplane.py.
//
// The identity it rests on: every input-slice, speculative and recovery
// column sum is a linear combination of the 8 bit-plane dots d[p] =
// bit_p(x[b, seg]) . w_j[seg, c]. So per segment s and plane j the work is
// one integer GEMM -- (64 columns) x (512 rows) x (8 bit planes of each
// batch row) -- and an epilogue on its 8 sums per (b, c).
//
// What bounds it on an H100. At decode (B <= 64) the planes are read once
// and nothing else is large: 16 int8 operations per plane byte per batch
// row (8 bit planes), below the int8 tensor-core ridge up to B ~ 37, so the
// floor is the plane bytes over HBM bandwidth. A layer call moves 3-9 MB, a
// few tens of KB per SM, so one call is a launch plus a few HBM round
// trips, and the kernel has to put its bytes in flight at once.
//
// Design, one answer per cause:
// - 16-byte loads, enough in flight. A block stages (128 rows x 64
//   columns) plane tiles and the matching x codes through a ring of
//   shared-memory stages with cp.async.cg (16 bytes a thread, zero-filled
//   past the edges, L2 128-byte prefetch hint), 8 KB of weights a stage;
//   the stage sequence runs through every (segment, plane) pair the block
//   owns, 4 stages a pair. Each warp stages exactly the 32 rows of each
//   stage that its k32 step reads, so a warp waits on its own copies and
//   its lanes alone, and the 4 warps meet only twice a pair. The ring
//   holds STAGES = 4 stages. Operands whose rows are not 16-byte aligned
//   (R not a multiple of 4 or C not a multiple of 16) take the same path
//   with bounds-checked word loads (VEC = false).
// - int8 tensor cores. mma.sync m16n8k32 s8.s8.s32: A is the plane tile
//   with output columns on the m16 side (the 4x4 __byte_perm transpose,
//   row XOR swizzle and column mapping of centered_int8_matmul.cu: MMA row
//   m of m16 tile i is column 32*(m/8) + 4*(m%8) + i), B is the bit planes:
//   one n8 tile holds the 8 bit planes of one batch row, so B fragment
//   register q of lane (g, t) is (x codes of 4 rows, one byte each) >> g &
//   0x01010101 -- one shift and one mask on the staged codes. Plane values
//   are int8 and bits 0/1, so s8 x s8 holds every product.
// - Batch tiles. A block holds 1, 2 or 4 batch rows (one n8 tile each)
//   and reads each weight byte once for all of them; the 4 warps split
//   each stage's 128 rows, one k32 step each, so each plane byte is
//   transposed once. 8 rows would halve the plane reads at B = 64, but
//   their 128 accumulators take a thread to 255 registers in K2. The grid
//   runs the batch tiles of one column tile next to each other, so they
//   share L2.
// - The clamp needs the whole segment. When a pair's 512 rows are in, the
//   warps add their accumulators into one shared-memory slab ([row][bit
//   plane][column] int32, shared atomics; the C fragment spreads one
//   (b, c)'s 8 sums over the 4 lanes of a quad, 2 each) and their x row
//   sums into a shared vector. After a barrier each thread reads back the
//   8 sums of its own (b, c) elements, zeroing them, and runs the
//   kernel's epilogue in registers, then adds the segment's center term at
//   plane 0; a second barrier keeps the next pair's adds out of the slab
//   until every thread has read. The running contribution stays in
//   registers across pairs.
// - No zeroed output, no global atomics on psum. The (segment, plane)
//   pairs of a column tile are split across the blocks of a thread-block
//   cluster at pair granularity: rank r owns pairs [r*ppr, (r+1)*ppr). The
//   cluster has ceil(P / ppr) ranks for P = n_seg * n_j pairs, 1 to 8 and
//   not always a power of two (6 for a 1024-row projection of 3 planes), so
//   no rank is empty. Each rank pushes its uint32 contribution for the
//   owner's slice of the tile into that owner's inbox in distributed shared
//   memory (remote stores behind one split barrier), and the owner writes
//   each psum element once; a lone block writes from registers. The
//   wrapper allocates psum with torch.empty.
// - No memset per call. The epilogue's counters are reduced per warp and
//   per block in shared memory and added with one atomicAdd per non-zero
//   counter per block into the call's counts, which the previous launch of
//   the same kernel on the stream zeroed: every launch zeroes the counts
//   buffer its next launch will use (the wrapper allocates it one call
//   ahead, per kernel and stream), so no extra kernel and no grid-wide
//   ordering is needed.
//
// Integer arithmetic wraps modulo 2^32 like the reference's int32: the
// s32 accumulators cannot overflow (|d| <= 512 * 128), and contributions,
// row sums and the center term add in uint32.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

namespace bitplane {

namespace cg = cooperative_groups;

constexpr int ROWS = 512;        // rows per crossbar segment (ADC span)
constexpr int BITS = 8;          // input code bits = bit planes = n8
constexpr int MAX_I = 8;         // input (or spec) slices
constexpr int MAX_J = 8;         // weight planes
constexpr int BN = 64;           // output columns per block: 4 m16 tiles
constexpr int BK = 128;          // rows per stage: 4 k32 steps
constexpr int SUBS = ROWS / BK;  // stages per (segment, plane) pair
constexpr int STAGES = 4;        // cp.async ring depth
constexpr int WARPS = 4;         // warps per block, one k32 step of a stage
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_CLUSTER = 8;   // portable cluster size
constexpr int XS = 4 * BK + 16;  // staged x row stride in bytes (int32 codes)
constexpr int W_STAGE = BK * BN;
constexpr int MAX_BT = 4;        // batch rows per block (n8 tiles)
constexpr int XSUM_BYTES = 2 * MAX_BT * 4;
constexpr int MAX_SLOTS = MAX_I + 1;  // counters an epilogue may keep
constexpr int TABLE_BYTES =  // mults, then the block's counters
    16 * ((4 * MAX_I * MAX_J + 8 * MAX_SLOTS + 15) / 16);
constexpr int SLAB_S = BN + 1;   // slab row stride in int32 (spreads banks)

__host__ __device__ constexpr int stage_bytes(int bt) {
  return W_STAGE + bt * XS;
}
// Shared memory: the ring; the slab the warps reduce into ([bt][8 bit
// planes] rows of SLAB_S int32, one per column); two parities of x row
// sums (2 x MAX_BT uint32); in a cluster of 2 or more the reduction's inbox
// (cluster slots of ceil(bt * BN / cluster) uint32); mults and the block's
// counters. Each part starts 16-byte aligned.
__host__ __device__ constexpr int slab_bytes(int bt) {
  return 16 * ((bt * BITS * SLAB_S * 4 + 15) / 16);
}
__host__ __device__ constexpr int per_rank(int bt, int cluster) {
  return (bt * BN + cluster - 1) / cluster;
}
__host__ __device__ constexpr int inbox_bytes(int bt, int cluster) {
  return cluster > 1 ? cluster * per_rank(bt, cluster) * 4 : 0;
}
__host__ __device__ constexpr int smem_bytes(int bt, int cluster) {
  return STAGES * stage_bytes(bt) + slab_bytes(bt) + XSUM_BYTES +
         16 * ((inbox_bytes(bt, cluster) + 15) / 16) + TABLE_BYTES;
}
__host__ __device__ constexpr int smem_bytes_max(int bt) {
  int m = 0;
  for (int c = 1; c <= MAX_CLUSTER; ++c)
    m = smem_bytes(bt, c) > m ? smem_bytes(bt, c) : m;
  return m;
}

// The launch plan (bitplane.py::tile_plan) against this header's
// constants: bn, bk, stages and smem must equal them; bt is the batch tile
// (1, 2 or 4 rows), cluster the ranks (1..8) and ppr the (segment, plane)
// pairs per rank, with no rank empty.
inline bool plan_ok(int B, int R, int C, int n_seg, int n_j, int bn, int bk,
                    int stages, int bt, int cluster, int ppr, int smem) {
  const int n_pairs = n_seg * n_j;
  return n_j >= 1 && n_j <= MAX_J && B >= 1 && C >= 1 && R >= 1 &&
         n_seg >= 1 && R <= n_seg * ROWS && bn == BN && bk == BK &&
         (bt == 1 || bt == 2 || bt == 4) && stages == STAGES &&
         cluster >= 1 && cluster <= MAX_CLUSTER && ppr >= 1 &&
         (long long)cluster * ppr >= n_pairs &&
         (cluster - 1) * ppr < n_pairs && smem == smem_bytes(bt, cluster) &&
         (C + BN - 1) / BN <= 65535;
}

// Per input slice i and input bit p, the slice's weight of the bit: 1 << (p
// - li[i]) where mask[i] holds it, else 0, so a slice's column sum is
// sum_p d[p] * sw[i][p]. False (refuse the launch) for a slice that
// leaves bits 0..7, which are all the GEMM computes.
inline bool slice_weights(int n_i, const int* li, const int* mask,
                          int (&sw)[MAX_I][BITS]) {
  for (int i = 0; i < n_i; ++i) {
    if (li[i] < 0 || mask[i] < 0 || (mask[i] << li[i]) >= (1 << BITS))
      return false;
    for (int p = 0; p < BITS; ++p) {
      const int q = p - li[i];
      sw[i][p] = (q >= 0 && ((mask[i] >> q) & 1)) ? (1 << q) : 0;
    }
  }
  return true;
}

// Operands whose rows all start 16-byte aligned take the cp.async path.
inline bool vec_ok(const void* x, const void* w, int R, int C) {
  return R % 4 == 0 && C % 16 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// split cluster barrier: arrive (no memory ordering) at the start, wait
// before the first store into another block's shared memory
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// byte offset of (row r, 16-byte column chunk c) in a staged plane tile
__device__ __forceinline__ int w_off_in_stage(int r, int c) {
  return r * BN + ((c ^ ((r >> 2) & 3)) << 4);
}

// Stage this warp's 32 rows of a stage -- stage rows 32*warp .. +31, the
// rows its k32 step reads -- of one plane (global row w_row0 = j * Rp + k0
// is the stage's first) for columns [col0, col0 + BN), and the matching x
// codes of batch rows [b0, b0 + BT); columns past C, batch rows past B and
// x rows past R read as zero (the planes hold every row below Rp).
template <int BT, bool VEC>
__device__ __forceinline__ void load_rows(
    uint8_t* st, const int32_t* __restrict__ x, const int8_t* __restrict__ w,
    int B, int R, int C, int b0, int col0, int k0, size_t w_row0, int warp,
    int lane) {
  uint8_t* xs = st + W_STAGE;
  const int rw = 32 * warp;  // the warp's first stage row
  if constexpr (VEC) {
    const int c = lane & 3, col = col0 + 16 * c, r = rw + (lane >> 2);
    const bool ok = col < C;
    const int8_t* src = w + (w_row0 + r) * (size_t)C + col;
#pragma unroll
    for (int q = 0; q < 4; ++q)  // rows r + 8q
      cp16(st + w_off_in_stage(r + 8 * q, c),
           ok ? src + (size_t)(8 * q) * C : w, ok ? 16 : 0);
    for (int e = lane; e < BT * 8; e += 32) {
      const int b = e >> 3, kr = rw + 4 * (e & 7), k = k0 + kr, row = b0 + b;
      const bool okx = row < B && k < R;  // R is a multiple of 4
      cp16(xs + b * XS + 4 * kr, okx ? x + (size_t)row * R + k : x,
           okx ? 16 : 0);
    }
  } else {
    for (int e = lane; e < 32 * (BN / 4); e += 32) {
      const int r = rw + (e >> 4), wd = e & 15, col = col0 + 4 * wd;
      const int8_t* src = w + (w_row0 + r) * (size_t)C;
      uint32_t v = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < C) v |= (uint32_t)(uint8_t)src[col + q] << (8 * q);
      *reinterpret_cast<uint32_t*>(st + w_off_in_stage(r, wd >> 2) +
                                   4 * (wd & 3)) = v;
    }
    for (int e = lane; e < BT * 32; e += 32) {
      const int b = e >> 5, kr = rw + (e & 31), k = k0 + kr, row = b0 + b;
      reinterpret_cast<int32_t*>(xs + b * XS)[kr] =
          (row < B && k < R) ? x[(size_t)row * R + k] : 0;
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// low bytes of 4 int32 codes, packed one byte per row
__device__ __forceinline__ uint32_t pack_bytes(int4 v) {
  return __byte_perm(__byte_perm(v.x, v.y, 0x0040),
                     __byte_perm(v.z, v.w, 0x0040), 0x5410);
}

// The body of a kernel on the grid (batch tiles * cluster, column tiles)
// with clusters of (cluster, 1, 1): cluster rank r owns the (segment,
// plane) pairs [r*ppr, (r+1)*ppr), pair p being segment p / n_j and plane
// p % n_j. `epi` is the kernel's epilogue:
//   uint32_t epi(const int (&d)[BITS], bool ok, const int32_t* mj)
//     one (b, c)'s contribution for one (segment, plane) from its 8
//     bit-plane sums d; mj[i * MAX_J] is mults(i, j) of the pair's plane;
//     counters only where ok (inside the true (B, C) extent);
//   epi.count(add) calls add(v, slot) for each counter held in registers;
//   epi.slots() counters of the call, Epi::SLOTS those its buffer holds.
// mults is (n_i, n_j) int32; counts (epi.slots(),) the call's counters,
// zero before the launch; next_counts (Epi::SLOTS,), zeroed here.
template <int BT, bool VEC, class Epi>
__device__ __forceinline__ void gemm(
    const int32_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ mults, const int32_t* __restrict__ centers,
    int32_t* __restrict__ out, unsigned long long* __restrict__ counts,
    unsigned long long* __restrict__ next_counts, int B, int R, int C,
    int n_seg, int n_j, int ppr, int n_i, Epi& epi) {
  constexpr int SB = stage_bytes(BT);
  constexpr int TILE = BT * BN;                     // (b, c) elements
  constexpr int EL = (TILE + THREADS - 1) / THREADS;  // per thread
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / cs) * BT;
  const int col0 = blockIdx.y * BN;
  const int n_pairs = n_seg * n_j;
  const int p_lo = min(n_pairs, rank * ppr);
  const int nk = (min(n_pairs, p_lo + ppr) - p_lo) * SUBS;
  const size_t Rp = (size_t)n_seg * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // slab[(b * BITS + p) * SLAB_S + c]: bit plane p's sum of (b, c)
  int32_t* slab = reinterpret_cast<int32_t*>(smem + STAGES * SB);
  uint8_t* tail = smem + STAGES * SB + slab_bytes(BT);
  uint32_t* xsum_s = reinterpret_cast<uint32_t*>(tail);  // [2][MAX_BT]
  tail += XSUM_BYTES;
  uint32_t* inbox = reinterpret_cast<uint32_t*>(tail);
  tail += 16 * ((inbox_bytes(BT, cs) + 15) / 16);
  int32_t* mults_s = reinterpret_cast<int32_t*>(tail);  // [MAX_I][MAX_J]
  unsigned long long* red = reinterpret_cast<unsigned long long*>(
      tail + 4 * MAX_I * MAX_J);                        // [MAX_SLOTS]
  cluster_arrive();  // waited on before the reduction's remote stores

  auto stage_rows = [&](int it, int& k0, size_t& w_row0) {
    const int pr = p_lo + it / SUBS;
    k0 = (pr / n_j) * ROWS + (it % SUBS) * BK;
    w_row0 = (size_t)(pr % n_j) * Rp + k0;
  };
  // the ring's first stages go out before anything else waits on memory
#pragma unroll 1
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) {
      int k0;
      size_t w_row0;
      stage_rows(st, k0, w_row0);
      load_rows<BT, VEC>(smem + st * SB, x, w, B, R, C, b0, col0, k0, w_row0,
                         warp, lane);
    }
    cp_commit();
  }
  for (int e = threadIdx.x; e < MAX_I * MAX_J; e += THREADS) {
    const int i = e / MAX_J, j = e % MAX_J;
    mults_s[e] = (i < n_i && j < n_j) ? mults[i * n_j + j] : 0;
  }
  for (int e = threadIdx.x; e < BT * BITS * SLAB_S; e += THREADS) slab[e] = 0;
  if (threadIdx.x < 2 * MAX_BT) xsum_s[threadIdx.x] = 0u;
  if (threadIdx.x < MAX_SLOTS) red[threadIdx.x] = 0ull;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x < Epi::SLOTS)
    next_counts[threadIdx.x] = 0ull;  // the next launch's counts
  __syncthreads();

  int acc[4][BT][4];
  uint32_t xs_acc[BT], contrib[EL], cen[EL];
#pragma unroll
  for (int n = 0; n < BT; ++n) {
    xs_acc[n] = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][n][r] = 0;
  }
#pragma unroll
  for (int k = 0; k < EL; ++k) contrib[k] = cen[k] = 0u;

  for (int it = 0; it < nk; ++it) {
    // A warp stages and reads only its own rows of each stage, so the
    // warps meet only at a pair's end.
    cp_wait<STAGES - 2>();  // this lane's part of stage `it` has landed
    __syncwarp();           // ... every lane's; slot of it-1 is free
    const int nx = it + STAGES - 1;
    if (nx < nk) {
      int k0;
      size_t w_row0;
      stage_rows(nx, k0, w_row0);
      load_rows<BT, VEC>(smem + (nx % STAGES) * SB, x, w, B, R, C, b0, col0,
                         k0, w_row0, warp, lane);
    }
    cp_commit();
    const uint8_t* ws = smem + (it % STAGES) * SB;
    const uint8_t* xsb = ws + W_STAGE;
    const bool plane0 = (p_lo + it / SUBS) % n_j == 0;  // row sums needed
    if (plane0 && it % SUBS == 0) {
      // the segment's centers of this thread's columns, read now and used
      // at the pair's end
      const int s = (p_lo + it / SUBS) / n_j;
#pragma unroll
      for (int k = 0; k < EL; ++k) {
        const int col = col0 + (threadIdx.x + THREADS * k) % BN;
        cen[k] = col < C ? (uint32_t)centers[(size_t)s * C + col] : 0u;
      }
    }
    // this warp's k32 step: stage rows 32*warp .. +31.
    // a[i][reg]: register reg of m16 tile i. reg = 2*kh + h holds rows
    // 32*warp + 16*kh + 4t .. +3 of column 32h + 4g + i.
    uint32_t a[4][4];
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int h = reg & 1, kh = reg >> 1;
      const int r0 = warp * 32 + 16 * kh + 4 * t;  // (r0 >> 2) & 3 == t
      const int off = (((2 * h + (g >> 2)) ^ t) << 4) + 4 * (g & 3);
      uint32_t r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r[q] = *reinterpret_cast<const uint32_t*>(ws + (r0 + q) * BN + off);
      const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
      a[0][reg] = __byte_perm(t0, t2, 0x5410);
      a[1][reg] = __byte_perm(t0, t2, 0x7632);
      a[2][reg] = __byte_perm(t1, t3, 0x5410);
      a[3][reg] = __byte_perm(t1, t3, 0x7632);
    }
    // B: n8 tile n is batch row n, its column g bit plane g; register q
    // holds rows 32*warp + 16q + 4t .. +3, one bit per byte
#pragma unroll
    for (int n = 0; n < BT; ++n) {
      const int4* xr = reinterpret_cast<const int4*>(
          xsb + n * XS + 4 * (warp * 32 + 4 * t));
      const int4 v0 = xr[0], v1 = xr[4];
      if (plane0)
        xs_acc[n] += (uint32_t)v0.x + (uint32_t)v0.y + (uint32_t)v0.z +
                     (uint32_t)v0.w + (uint32_t)v1.x + (uint32_t)v1.y +
                     (uint32_t)v1.z + (uint32_t)v1.w;
      const uint32_t bx0 = (pack_bytes(v0) >> g) & 0x01010101u;
      const uint32_t bx1 = (pack_bytes(v1) >> g) & 0x01010101u;
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_s8(acc[i][n], a[i], bx0, bx1);
    }
    if (it % SUBS != SUBS - 1) continue;

    // The pair's 512 rows are in. Add the warps' accumulators into the
    // slab: C register r of m16 tile i holds MMA row g + 8*(r/2) (column
    // 4g + i, +32) and bit plane 2t + r%2; and the
    // x row sums (after the quad's lanes, the same in every lane) into
    // parity q of xsum_s, the other parity being zeroed for the next pair.
    const int pi = it / SUBS, q = pi & 1;
#pragma unroll
    for (int n = 0; n < BT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int32_t* e0 = slab + (n * BITS + 2 * t) * SLAB_S + 4 * g + i;
        atomicAdd(e0, acc[i][n][0]);
        atomicAdd(e0 + SLAB_S, acc[i][n][1]);
        atomicAdd(e0 + 32, acc[i][n][2]);
        atomicAdd(e0 + SLAB_S + 32, acc[i][n][3]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][n][r] = 0;
      }
      if (plane0) {
        uint32_t v = xs_acc[n];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (lane == 0) atomicAdd(&xsum_s[q * MAX_BT + n], v);
        xs_acc[n] = 0u;
      }
    }
    if (threadIdx.x < MAX_BT) xsum_s[(q ^ 1) * MAX_BT + threadIdx.x] = 0u;
    __syncthreads();
    const int j = (p_lo + pi) % n_j;
    // thread element k: e = tid + THREADS*k, batch row e / BN, column e % BN
#pragma unroll
    for (int k = 0; k < EL; ++k) {
      const int e = threadIdx.x + THREADS * k;
      if (TILE % THREADS != 0 && e >= TILE) break;
      const int b = e / BN, c = e % BN, col = col0 + c;
      int d[BITS];
#pragma unroll
      for (int p = 0; p < BITS; ++p) {
        int32_t* sp = slab + (b * BITS + p) * SLAB_S + c;
        d[p] = *sp;
        *sp = 0;
      }
      const bool ok = b0 + b < B && col < C;
      contrib[k] += epi(d, ok, mults_s + j);
      if (j == 0) contrib[k] += xsum_s[q * MAX_BT + b] * cen[k];
    }
    __syncthreads();  // the slab is read before any warp adds the next pair
  }
  cp_wait<0>();

  // counters: warp, then block, then one global atomic per non-zero
  // counter into the counts the previous launch zeroed
  epi.count([&](unsigned v, int slot) {
    if (!__any_sync(0xffffffffu, v != 0u)) return;  // nothing to add
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) atomicAdd(&red[slot], (unsigned long long)v);
  });
  __syncthreads();
  if (threadIdx.x < epi.slots() && red[threadIdx.x])
    atomicAdd(&counts[threadIdx.x], red[threadIdx.x]);

  // Rank r owns tile elements [r*per, (r+1)*per), element e = b*BN + c.
  // Every rank pushes its contributions for those elements into slot
  // `rank` of r's inbox: stores into the other blocks' shared memory, no
  // round trips. The arrive at the kernel's start, waited on here, says
  // every block of the cluster is running.
  cluster_wait();
  if (cs == 1) {
#pragma unroll
    for (int k = 0; k < EL; ++k) {
      const int e = threadIdx.x + THREADS * k;
      if (TILE % THREADS != 0 && e >= TILE) break;
      const int row = b0 + e / BN, col = col0 + e % BN;
      if (row < B && col < C) out[(size_t)row * C + col] = (int32_t)contrib[k];
    }
    return;
  }
  const int per = per_rank(BT, cs);
#pragma unroll
  for (int k = 0; k < EL; ++k) {
    const int e = threadIdx.x + THREADS * k;
    if (TILE % THREADS != 0 && e >= TILE) break;
    cluster.map_shared_rank(inbox, e / per)[rank * per + e % per] = contrib[k];
  }
  cluster.sync();  // every push has landed; no block reads another after it
  for (int jj = threadIdx.x; jj < per; jj += THREADS) {
    const int e = rank * per + jj;
    if (e >= TILE) break;
    const int row = b0 + e / BN, col = col0 + e % BN;
    if (row >= B || col >= C) continue;
    uint32_t s = 0u;
    for (int q = 0; q < cs; ++q) s += inbox[q * per + jj];
    out[(size_t)row * C + col] = (int32_t)s;
  }
}

// Launch `kern` (one batch-tile instantiation BT of a kernel built on
// gemm) on the grid (batch tiles * cluster, column tiles) with a cluster of
// `cluster` blocks. `attr_set` is the instantiation's own flag: the first
// launch lifts its dynamic shared memory limit to what any cluster size
// needs.
template <int BT, class... KArgs, class... Args>
cudaError_t launch(void (*kern)(KArgs...), bool& attr_set, int B, int C,
                   int cluster, cudaStream_t stream, Args&&... args) {
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes_max(BT));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + BT - 1) / BT * cluster, (C + BN - 1) / BN, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(BT, cluster);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, std::forward<Args>(args)...);
}

}  // namespace bitplane
